"""Job configuration of the port.

The fields the ported paths read (word count on one device with the native
or Python host map, k-means in its three single-device modes, and
checkpoint/resume for both), with the JAX package's defaults and
validation.  ``backend``
names a torch device family: ``cuda`` (the default) or ``cpu``; nothing
falls back from one to the other.
"""

from __future__ import annotations

from dataclasses import dataclass

#: workloads this slice of the port runs
WORKLOADS = ("wordcount", "kmeans")


@dataclass
class JobConfig:
    #: input corpus path (a text file, or a .npy points file for kmeans)
    input_path: str = "shakes.txt"
    #: host map worker threads (the Python map; the native mmap path maps
    #: inline in C++)
    num_map_workers: int = 8
    #: input chunks; 0 = derive from file size / chunk_bytes; N > 0 = the
    #: reference's round-robin line chunking into N chunks
    num_chunks: int = 0
    #: target bytes per streamed chunk (the corpus is never host-resident)
    chunk_bytes: int = 32 * 1024 * 1024
    #: max rows per device feed batch; short batches are padded only to the
    #: next power of two, so tiny chunks don't pay full-batch sort cost
    batch_size: int = 1 << 18
    #: bounded-prefetch pipeline depth: how many chunks of host work
    #: (read+tokenize) may run ahead of the device feed (runtime/pipeline.py).
    #: 1 = the strictly serial schedule; outputs are byte-identical at any
    #: depth (the pipeline preserves chunk order)
    pipeline_depth: int = 2
    #: full feed batches shipped per host->device transfer by the fold
    #: engine (0 = auto, which the fold engine treats as 1; N > 1 stacks N
    #: batches into one transfer).  Outputs are identical at any value.
    dispatch_batch: int = 0
    #: hard upper bound on distinct keys on device (accumulator max size)
    key_capacity: int = 1 << 22
    #: starting accumulator capacity; grows by sentinel-padding toward
    #: key_capacity as distinct keys accumulate
    initial_key_capacity: int = 1 << 16
    #: top-k to report
    top_k: int = 10
    #: 'cuda' | 'cpu' — the torch device family; 'cuda' requires a card
    backend: str = "cuda"
    #: mesh shards; 0 and 1 both mean the single-device engine here
    num_shards: int = 0
    #: tokenizer mode: 'ascii' (byte path) or 'unicode'
    tokenizer: str = "ascii"
    #: map-phase placement.  wordcount: 'native' (the C++ host loop),
    #: 'python', or 'auto' (= 'native'); 'device' is not ported yet.
    #: kmeans: 'device' (points resident on the device), 'auto' (resident
    #: when 4n(d+2k) fits kmeans_device_fit_bytes, else streamed through
    #: the device), 'native' / 'python' (host assign)
    mapper: str = "auto"
    #: reduce engine: 'fold' (the streaming device accumulator) or 'auto'
    reduce_mode: str = "auto"
    #: output file
    output_path: str = "final_result.txt"
    #: directory for spill/checkpoint artifacts; None disables checkpointing
    checkpoint_dir: str | None = None
    #: keep the checkpoint directory after success instead of deleting it
    keep_intermediates: bool = False
    #: per-chunk map retry budget (the Python map's worker pool)
    max_retries: int = 2
    #: use the C++ native tokenizer when available (the JAX package's field;
    #: ``mapper`` alone chooses the map path)
    use_native: bool = True
    #: k-means device-fit budget in bytes for mapper='auto'; 0 = half the
    #: device's memory
    kmeans_device_fit_bytes: int = 0
    #: k-means: cluster count (init = first k points of the input)
    kmeans_k: int = 16
    #: k-means: iterations to run
    kmeans_iters: int = 1
    #: k-means matmul precision: "highest" (plain f32) or "bf16" (bf16
    #: operands, f32 accumulation)
    kmeans_precision: str = "highest"
    #: log the metrics dict at the end of a job
    metrics: bool = True

    def validate(self) -> "JobConfig":
        if self.tokenizer not in ("ascii", "unicode"):
            raise ValueError(
                f"tokenizer must be ascii|unicode, got {self.tokenizer!r}")
        if self.backend not in ("cuda", "cpu"):
            raise ValueError(
                f"backend must be cuda|cpu, got {self.backend!r}")
        if self.batch_size <= 0 or self.key_capacity <= 0:
            raise ValueError("batch_size and key_capacity must be positive")
        if self.initial_key_capacity <= 0:
            raise ValueError("initial_key_capacity must be positive")
        if self.mapper not in ("auto", "device", "native", "python"):
            raise ValueError(
                f"mapper must be auto|device|native|python, got {self.mapper!r}")
        if self.reduce_mode not in ("auto", "fold", "collect"):
            raise ValueError(
                f"reduce_mode must be auto|fold|collect, got {self.reduce_mode!r}")
        if self.num_shards < 0:
            raise ValueError("num_shards must be >= 0")
        if self.num_chunks <= 0 and self.chunk_bytes <= 0:
            raise ValueError("chunk_bytes must be positive (or set num_chunks)")
        if self.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1 (1 = serial)")
        if not 0 <= self.dispatch_batch <= 1024:
            raise ValueError(
                "dispatch_batch must be 0 (auto) or 1..1024 batches per "
                f"transfer, got {self.dispatch_batch}")
        if self.kmeans_device_fit_bytes < 0:
            raise ValueError(
                "kmeans_device_fit_bytes must be >= 0 (0 = probe the device)")
        if self.top_k <= 0 or self.num_map_workers <= 0:
            raise ValueError("top_k and num_map_workers must be positive")
        if self.kmeans_k <= 0 or self.kmeans_iters <= 0:
            raise ValueError("kmeans_k and kmeans_iters must be positive")
        if self.kmeans_precision not in ("highest", "bf16"):
            raise ValueError(f"kmeans_precision must be highest|bf16, "
                             f"got {self.kmeans_precision!r}")
        return self
