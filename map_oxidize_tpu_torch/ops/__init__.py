"""Device ops of the port: hashing, the sort + segment-combine fold, top-k,
and the fused k-means kernel (CUDA, with its plain PyTorch version)."""
