"""Device ops of the port: hashing, the sort + segment-combine fold, top-k,
and the fused k-means kernel (CUDA, with its plain PyTorch version)."""


def kernel_launches() -> dict[str, int]:
    """Launches of each hand-written CUDA kernel in this process, by kernel
    name: the count each wrapper adds one to where it launches its kernel
    (``fused_assign_sum.launches``, ``tokenize_compact.launches``)."""
    from map_oxidize_tpu_torch.ops.device_tokenize import tokenize_compact
    from map_oxidize_tpu_torch.ops.kmeans_kernel import fused_assign_sum

    return {"kmeans_assign_sum": fused_assign_sum.launches,
            "tokenize_compact": tokenize_compact.launches}
