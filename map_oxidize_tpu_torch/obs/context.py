"""Per-job observability context: which ``Obs`` owns the current work.
The port of the JAX package's ``obs/context.py`` (``current_obs`` :41,
``bind_current`` :46, ``use_obs`` :68).

:func:`use_obs` binds an ``Obs`` to the calling context (a
``contextvars.ContextVar``, so each job thread carries its own binding);
``Obs.recording`` enters it, so every driver body is context-scoped.
Seams that have no ``Obs`` passed to them (the device resolve's
``attrib/init_ms``, the fold engine's finalize fetch) record into
:func:`current_obs`.

Threads do NOT inherit a parent thread's binding: a prefetch or pool
worker spawned by a job thread starts unbound.  :func:`bind_current`
captures the spawning context's binding and runs the worker's target under
it; the pipeline's producer threads and the map pool's tasks spawn bound.
"""

from __future__ import annotations

import contextlib
import contextvars

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "moxt_torch_current_obs", default=None)


def current_obs():
    """The ``Obs`` bound to this context, or None outside any job body."""
    return _CURRENT.get()


def bind_current(fn):
    """Capture the CALLING context's job binding now and return a wrapper
    that runs ``fn`` under it.  Outside any job binding this is the
    identity (no wrapper object, no per-call overhead)."""
    obs = _CURRENT.get()
    if obs is None:
        return fn

    def _bound(*args, **kwargs):
        token = _CURRENT.set(obs)
        try:
            return fn(*args, **kwargs)
        finally:
            _CURRENT.reset(token)

    return _bound


@contextlib.contextmanager
def use_obs(obs):
    """Bind ``obs`` as this context's job for the duration of the block.
    Re-entrant: an inner binding shadows the outer one and restores it on
    exit."""
    token = _CURRENT.set(obs)
    try:
        yield obs
    finally:
        _CURRENT.reset(token)
