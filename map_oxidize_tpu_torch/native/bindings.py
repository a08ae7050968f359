"""The driver-facing entry to the native C++ map loop.

Unlike the JAX package's loader, nothing here falls back to the Python map:
a failed build raises with the compiler's output, and the caller asks for
the Python map explicitly (``mapper='python'``, ``--mapper python``)."""

from __future__ import annotations


def stream(ngram: int = 1, tokenizer: str = "ascii"):
    """A per-thread :class:`~map_oxidize_tpu_torch.native.build.StreamPool`
    (cross-chunk C++ dictionary, delta drains, one stream per map worker
    thread), building the library on first use."""
    from map_oxidize_tpu_torch.native.build import StreamPool, _load_lib

    try:
        _load_lib()
    except (RuntimeError, OSError) as e:
        raise RuntimeError(
            f"the native C++ mapper is unavailable ({e}); pass --mapper "
            "python (mapper='python') to run the Python map instead") from e
    return StreamPool(ngram, tokenizer)
