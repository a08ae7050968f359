"""Operations and bytes of one ``kmeans_assign_sum`` call (the fused
k-means assignment and partial sums) from its shapes.

Operations: the scores the assignment needs, a multiply and an add per
point, centroid and dimension (``2 n k d``), and the sums, an add per
point and dimension (``n d``).  Bytes: the points read once, the
centroids read once, the ``(k, d + 1)`` sums and counts written once, all
float32 (bf16 points in bf16 mode)."""

from __future__ import annotations


def count(n: int, d: int, k: int, precision: str = "highest") -> tuple[int, int]:
    point_bytes = 2 if precision == "bf16" else 4
    flops = 2 * n * k * d + n * d
    nbytes = n * d * point_bytes + k * d * 4 + k * (d + 1) * 4
    return flops, nbytes


def peak_flops(peaks: dict, precision: str = "highest") -> float:
    """The peak the call runs against: float32 outside the tensor cores for
    'highest', bf16 on the tensor cores for 'bf16'."""
    return peaks["bf16_flops_per_s" if precision == "bf16"
                 else "f32_flops_per_s"]
