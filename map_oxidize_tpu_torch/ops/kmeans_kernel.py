"""Fused k-means assignment + partial sums: the hand-written Hopper kernel
and its plain PyTorch version.

The kernel, ``csrc/kmeans_assign_sum.cu``, replaces the JAX package's Pallas
TPU kernel (``map_oxidize_tpu/ops/kmeans_kernel.py``, ``_build`` /
``fused_assign_sum``).  One pass over the points gives ``(sums (k, d),
counts (k,))`` with no ``(n, k)`` intermediate in device memory; the source
says what bounds it on an H100 and how it replaces the TPU's sequential
grid with block partials and a fixed-order reduction.

:func:`fused_assign_sum` takes :func:`fused_assign_sum_plain` only for a
tensor on the CPU.  For a CUDA tensor it launches the kernel or raises.

Numerics per mode, in both versions:

* ``highest`` — f32 operands and f32 accumulation (no TF32);
* ``bf16`` — score-product operands rounded to bf16, f32 accumulation; the
  sums add the bf16-rounded points in f32; ``|c|^2`` stays f32.

Counts are exact integers in f32 up to 2^24 per centroid, as the
reference's f32 one-hot sum.
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: rows per tile of the CUDA kernel
TILE_N = 128
_LIB = "kmeans_assign_sum"


def fused_assign_sum_plain(p, c, k: int, precision: str = "highest", w=None):
    """Plain PyTorch form of one k-means assignment + partial sum (the JAX
    package's ``assign_and_sum``): the ``(n, k)`` score matrix, its argmin
    (first index on ties), then a per-centroid sum.  Returns ``(sums (k, d),
    counts (k,))`` in f32.  A float32 product on CUDA must run with TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default)."""
    if precision == "bf16":
        # bf16 values are exact in f32, and so are their products: an f32
        # product of the rounded operands is a bf16 product with f32
        # accumulation
        pm = p.to(torch.bfloat16).float()
        cm = c.to(torch.bfloat16).float()
    elif precision == "highest":
        if p.dtype != torch.float32:
            raise ValueError(f"highest precision takes f32 points, got {p.dtype}")
        pm, cm = p, c
    else:
        raise ValueError(f"unknown kmeans precision {precision!r}")
    n, d = p.shape
    scores = pm @ cm.T
    scores.mul_(-2.0).add_((c * c).sum(1))
    cid = torch.argmin(scores, dim=1)
    del scores
    wts = (torch.ones(n, dtype=torch.float32, device=p.device) if w is None
           else w.to(torch.float32))
    rows = torch.cat([pm * wts[:, None], wts[:, None]], dim=1)
    acc = torch.zeros((k, d + 1), dtype=torch.float32, device=p.device)
    acc.index_add_(0, cid, rows)
    return acc[:, :d], acc[:, d]


def _check(p, c, k: int, precision: str, w) -> None:
    if precision not in ("highest", "bf16"):
        raise ValueError(f"unknown kmeans precision {precision!r}")
    if p.ndim != 2 or not p.is_contiguous():
        raise ValueError("points must be a contiguous (n, d) tensor")
    allowed = (torch.float32, torch.bfloat16) if precision == "bf16" else (
        torch.float32,)
    if p.dtype not in allowed:
        raise ValueError(f"{precision} mode takes points of {allowed}, "
                         f"got {p.dtype}")
    if (c.device != p.device or c.dtype != torch.float32
            or tuple(c.shape) != (k, p.shape[1]) or not c.is_contiguous()):
        raise ValueError(f"centroids must be a contiguous f32 ({k}, "
                         f"{p.shape[1]}) tensor on {p.device}")
    if w is not None and (w.device != p.device or w.dtype != torch.float32
                          or tuple(w.shape) != (p.shape[0],)
                          or not w.is_contiguous()):
        raise ValueError(f"weights must be a contiguous f32 ({p.shape[0]},) "
                         f"tensor on {p.device}")


@functools.cache
def _library() -> ctypes.CDLL:
    from map_oxidize_tpu_torch.ops.build import load

    lib = load(_LIB)
    fn = lib.moxt_kmeans_assign_sum
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.moxt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.moxt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_assign_sum(p, c, k: int, precision: str = "highest", w=None):
    """``(sums (k, d), counts (k,))`` of one k-means assignment.

    ``p``: ``(n, d)`` points (f32, or bf16 in bf16 mode), ``c``: ``(k, d)``
    f32 centroids on the same device, ``w``: optional ``(n,)`` f32 row
    weights (None = every row counts).  CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream, without
    synchronising, and add one to ``fused_assign_sum.launches``."""
    if p.device.type == "cpu":
        return fused_assign_sum_plain(p, c, k, precision, w)
    if p.device.type != "cuda":
        raise ValueError(f"no kernel for device {p.device}")
    _check(p, c, k, precision, w)
    n, d = p.shape
    dev = p.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(-(-n // TILE_N), 2 * sms))
    cn = torch.empty(k, dtype=torch.float32, device=dev)
    partials = torch.empty((grid, k, d + 1), dtype=torch.float32, device=dev)
    out = torch.empty((k, d + 1), dtype=torch.float32, device=dev)
    lib = _library()
    rc = lib.moxt_kmeans_assign_sum(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        p.data_ptr(), int(p.dtype == torch.bfloat16),
        int(precision == "bf16"), None if w is None else w.data_ptr(),
        c.data_ptr(), n, d, k, grid, cn.data_ptr(), partials.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"kmeans_assign_sum launch failed (n={n}, d={d}, k={k}): "
            f"{lib.moxt_cuda_error_string(rc).decode()}")
    fused_assign_sum.launches += 1
    return out[:, :d], out[:, d]


#: launches of the CUDA kernel in this process
fused_assign_sum.launches = 0
