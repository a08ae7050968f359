"""Structured logging (a copy of the JAX package's).

Every subsystem logs through the stdlib logger under the ``moxt``
namespace (the port under ``moxt.torch``); the CLI wires -v/-q to levels.
"""

from __future__ import annotations

import logging

_ROOT = "moxt"
_configured = False


def configure(level: int = logging.INFO) -> None:
    global _configured
    root = logging.getLogger(_ROOT)
    if not _configured:
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("%(asctime)s %(levelname).1s %(name)s: %(message)s",
                              datefmt="%H:%M:%S")
        )
        root.addHandler(h)
        root.propagate = False
        _configured = True
    root.setLevel(level)


def get_logger(name: str) -> logging.Logger:
    short = name.replace("map_oxidize_tpu_torch", _ROOT + ".torch")
    return logging.getLogger(short)
