"""The roofline counts from shapes, against values worked by hand."""

from __future__ import annotations

import pytest

from portbench import roofline
from portbench.roofline import kmeans_assign_sum, tokenize_compact

H100 = roofline.peaks("NVIDIA H100 80GB HBM3")


def test_published_peaks():
    assert H100["f32_flops_per_s"] == 67e12
    assert H100["bf16_flops_per_s"] == 989e12
    assert H100["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError):
        roofline.peaks("NVIDIA A100-SXM4-80GB")


def test_kmeans_at_sift1m_ivf4096():
    # 2 * 1e6 * 4096 * 128 = 1,048,576,000,000 score operations, plus
    # 1e6 * 128 = 128,000,000 adds of the sums
    flops, nbytes = kmeans_assign_sum.count(1_000_000, 128, 4096)
    assert flops == 1_048_704_000_000
    # points 512,000,000 + centroids 2,097,152 + sums and counts 2,113,536
    assert nbytes == 516_210_688
    pct, bound = roofline.share(flops, nbytes, 0.040,
                                kmeans_assign_sum.peak_flops(H100),
                                H100["hbm_bytes_per_s"])
    # 1.048704e12 / 67e12 = 15.652 ms of 40 ms
    assert bound == "operations"
    assert pct == pytest.approx(39.1310, abs=1e-3)


def test_kmeans_bf16_counts_half_the_point_bytes():
    _, nbytes = kmeans_assign_sum.count(1_000_000, 128, 4096, "bf16")
    assert nbytes == 256_000_000 + 2_097_152 + 2_113_536
    assert kmeans_assign_sum.peak_flops(H100, "bf16") == 989e12


def test_tokenize_at_hibench_large():
    # a 3.2e9-byte corpus of 2.9e8 words: the bytes read once and a
    # 12-byte row per word written once
    flops, nbytes = tokenize_compact.count(3_200_000_000, 290_000_000)
    assert flops == 0
    assert nbytes == 3_200_000_000 + 12 * 290_000_000 == 6_680_000_000
    # 6.68e9 B / 3.35e12 B/s = 1.99403 ms; at 10 ms that is 19.9403%
    pct, bound = roofline.share(flops, nbytes, 0.010, 1.0,
                                H100["hbm_bytes_per_s"])
    assert bound == "bytes"
    assert pct == pytest.approx(19.9403, abs=1e-3)
