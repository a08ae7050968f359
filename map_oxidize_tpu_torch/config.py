"""Job configuration of the port.

The fields the ported paths read (word count and bigram through the fold,
the collect reduce or the device map, the inverted index, distinct,
k-means in its three single-device modes, sort, join and sessionize,
checkpoint/resume, the shuffle transports and the observability
outputs), with the JAX package's defaults
and validation (JAX ``config.py:94-365``).  ``backend``
names a torch device family: ``cuda`` (the default) or ``cpu``; nothing
falls back from one to the other.
"""

from __future__ import annotations

from dataclasses import dataclass

#: workloads the port runs
WORKLOADS = ("wordcount", "bigram", "invertedindex", "kmeans", "distinct",
             "sort", "join", "sessionize")


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
    #: map-phase placement.  wordcount, bigram: 'native' (the C++ host
    #: loop), 'python', 'device' (tokenize, hash and combine on the device;
    #: ascii only) or 'auto' (= 'native'); other workloads resolve 'device'
    #: to 'native', as the JAX package does.
    #: kmeans: 'device' (points resident on the device), 'auto' (resident
    #: when 4n(d+2k) fits kmeans_device_fit_bytes, else streamed through
    #: the device), 'native' / 'python' (host assign)
    mapper: str = "auto"
    #: per-chunk unique-key slots for the device mapper output
    device_chunk_keys: int = 1 << 19
    #: reduce engine: 'fold' = the streaming device accumulator (narrow key
    #: spaces), 'collect' = host collect + one vectorized sort/reduce (wide
    #: key spaces, runtime/host_reduce.py); 'auto' picks by the mapper's
    #: wide_keys declaration
    reduce_mode: str = "auto"
    #: inverted-index pair sort: 'host' = the host radix / np.lexsort,
    #: 'device' = the pairs on the device and one sort there
    #: (runtime/collect.py); 'auto' = host
    collect_sort: str = "auto"
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
    #: hash-only rescan: scan the whole corpus when resolving winner
    #: strings instead of stopping once every queried hash is found (the
    #: full scan extends the collision byte-check to every occurrence)
    rescan_full: bool = False
    #: distinct (HyperLogLog): register-count precision p (2^p registers;
    #: relative standard error ~1.04/sqrt(2^p))
    hll_precision: int = 14
    #: collect engines: resident-row cap before the disk-bucket spill
    #: (counts, (key, value) rows and (key, doc) pairs all spill); 0 =
    #: engine defaults (host collect 2^28, pair collect 2^27).  What
    #: happens AT the cap is the shuffle transport's call
    collect_max_rows: int = 0
    #: join (hash equi-join): the RIGHT/probe record corpus
    #: (``input_path`` is the left/build side): a ``.npy`` of (u64 key,
    #: u64 payload) rows, payloads < 2^63 (the top bit tags the side
    #: inside the shared engine) — see workloads/join.py
    join_input_path: str = ""
    #: sessionize: the gap (in the timestamp column's own units) above
    #: which consecutive same-key events split into separate sessions
    session_gap: int = 3600
    #: sort: target key-sample size for the range splitters (an
    #: every-kth-row strided sample; the sharded sort's, unused on one
    #: device)
    sort_sample: int = 4096
    #: shuffle transport of the collect engines (map_oxidize_tpu_torch.
    #: shuffle): 'hbm' = strictly resident (the cap is a hard error),
    #: 'disk' = top-bits disk buckets from the first row, 'hybrid' =
    #: resident until the cap, then a one-way demotion to disk, 'pipelined'
    #: = hybrid's placement plus the push cadence (the map runs ahead at
    #: depth >= 2; see push_combine), 'remote' = staged from the first row
    #: like disk.  'auto' routes on corpus size vs the cap: estimated rows
    #: (corpus_bytes // 16) past collect_max_rows pick disk, else hybrid
    shuffle_transport: str = "auto"
    #: map-side combiner: 'auto' combines each push window's rows when the
    #: transport resolves to pipelined and the reducer's combine is
    #: sum/min/max, 'on' forces it for any eligible reducer, 'off'
    #: disables it; outputs are byte-identical either way
    push_combine: str = "auto"
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
    #: ``torch.profiler`` trace output directory (host activity, and the
    #: device's kernels and copies on a CUDA backend); None disables it
    trace_dir: str | None = None
    #: write the structured metrics document (phases, counters, gauges,
    #: histograms, attribution, data audit) here as JSON; None skips
    metrics_out: str | None = None
    #: capture framework spans and write Chrome trace-event JSON here
    #: (chrome://tracing / Perfetto); "-" collects the trace onto
    #: ``result.trace`` without writing a file; None disables tracing
    trace_out: str | None = None
    #: failure flight recorder: on an abort, dump a post-mortem bundle
    #: (config, metrics so far, the trace with open spans closed,
    #: traceback) under this directory before propagating; None disables
    crash_dir: str | None = None
    #: emit periodic progress lines (rows/sec, percent, ETA, phase) for
    #: long streamed jobs
    progress: bool = False
    #: minimum seconds between progress lines
    progress_interval_s: float = 10.0
    #: the data-plane audit (obs/dataplane.py): per-partition row
    #: conservation, key skew and reduction ratio (``data/*``); host-side
    #: accounting, on by default
    data_audit: bool = True
    #: device sampler (obs/xprof.py): seconds between background reads of
    #: the live device memory (``hbm/live_bytes_device<i>``); 0 = off
    hbm_sample_s: float = 0.0
    #: stall detector: warn, naming the open spans, when no chunk
    #: completes within this multiple of the median inter-chunk interval;
    #: 0 = off
    stall_warn_factor: float = 0.0
    #: persistent calibration store (obs/calib.py): directory whose
    #: ``calib.json`` accumulates measured per-(platform, devices,
    #: topology) program and workload rows, loaded at job start and
    #: merged at finish; None disables
    calib_dir: str | None = None
    #: job planner (runtime/planner.py + obs/plan.py): 'auto' solves the
    #: tunable knobs from the calibration store's curves before the run
    #: and records the plan (per-knob value + provenance, and a predicted
    #: wall scored at finish as ``plan/model_error_pct``); 'off' skips it
    plan: str = "auto"
    #: the collective chooser's evidence floor: sampled latencies
    #: required in the exact payload bucket before a curve may steer it
    calib_min_samples: int = 3

    def validate(self) -> "JobConfig":
        if self.plan not in ("auto", "off"):
            raise ValueError(f"plan must be auto|off, got {self.plan!r}")
        if self.calib_min_samples < 1:
            raise ValueError(
                "calib_min_samples must be >= 1 sampled latencies")
        if self.hbm_sample_s < 0:
            raise ValueError("hbm_sample_s must be >= 0 (0 = off)")
        if self.stall_warn_factor < 0:
            raise ValueError("stall_warn_factor must be >= 0 (0 = off)")
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
        if self.collect_sort not in ("auto", "host", "device"):
            raise ValueError(
                f"collect_sort must be auto|host|device, got {self.collect_sort!r}")
        if self.device_chunk_keys <= 0:
            raise ValueError("device_chunk_keys must be positive")
        if self.collect_max_rows < 0:
            raise ValueError("collect_max_rows must be >= 0 (0 = default)")
        if self.session_gap < 1:
            raise ValueError("session_gap must be >= 1 (timestamp units)")
        if self.sort_sample < 1:
            raise ValueError("sort_sample must be >= 1 sampled keys")
        from map_oxidize_tpu_torch.shuffle.base import TRANSPORTS

        if self.shuffle_transport not in TRANSPORTS:
            raise ValueError(
                f"shuffle_transport must be one of {'|'.join(TRANSPORTS)}, "
                f"got {self.shuffle_transport!r}")
        if self.push_combine not in ("auto", "on", "off"):
            raise ValueError(
                f"push_combine must be auto|on|off, "
                f"got {self.push_combine!r}")
        from map_oxidize_tpu_torch.workloads.distinct import (
            HLL_P_MAX,
            HLL_P_MIN,
        )

        if not HLL_P_MIN <= self.hll_precision <= HLL_P_MAX:
            raise ValueError(
                f"hll_precision must be in [{HLL_P_MIN}, {HLL_P_MAX}], "
                f"got {self.hll_precision}")
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
        if self.progress_interval_s <= 0:
            raise ValueError("progress_interval_s must be positive")
        if self.kmeans_precision not in ("highest", "bf16"):
            raise ValueError(f"kmeans_precision must be highest|bf16, "
                             f"got {self.kmeans_precision!r}")
        return self
