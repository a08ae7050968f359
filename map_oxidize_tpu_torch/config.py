"""Job and server configuration of the port.

:class:`JobConfig` has every field of the JAX package's (JAX
``config.py:32-365``), with its defaults and validation.
``num_shards`` > 1 runs the sharded engines on a mesh of device slots in
one process (:mod:`map_oxidize_tpu_torch.parallel`); 0 is the backend's
real pool.  ``dist_coordinator`` with ``dist_num_processes`` and
``dist_process_id`` runs the job over several processes under a Gloo
process group (:mod:`map_oxidize_tpu_torch.parallel.distributed`).
``backend`` names a torch device family: ``cuda`` (the default) or
``cpu``; nothing falls back from one to the other.  :class:`FleetConfig` is the fleet collector's (JAX
``config.py:435-500``) and :class:`ServeConfig` the resident job server's
(JAX ``config.py:505-593``), both field for field.
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: workloads the port runs
WORKLOADS = ("wordcount", "bigram", "invertedindex", "kmeans", "distinct",
             "sort", "join", "sessionize")

#: workloads the resident job service serves: every built-in runs through
#: the drivers the scheduler multiplexes (JAX ``config.py:29``); the
#: scheduler's submit allowlist and the submit CLI's choices read it
SERVE_WORKLOADS = WORKLOADS


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
    #: remote transport: the shared-filesystem stage directory every
    #: process of the job can reach.  Empty = ``<output_path>.stage``
    remote_stage_dir: str = ""
    #: remote transport: how long a process waits for its peers' final
    #: stage manifests before declaring them dead and taking over their
    #: partitions from the staged objects
    remote_stage_timeout_s: float = 60.0
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
    #: append every finished job's summary (metrics, phase times, config
    #: hash, version, workload, corpus size) to ``<dir>/ledger.jsonl``
    #: (obs/ledger.py, the JAX package's format); None disables
    ledger_dir: str | None = None
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
    #: live telemetry HTTP server (obs/serve.py): the port this job's
    #: /metrics, /status, /series, /alerts and /healthz endpoints bind on
    #: 127.0.0.1.  0 = ephemeral (the bound port is logged); -1 disables
    obs_port: int = -1
    #: time-series recorder (obs/timeseries.py): seconds between ring
    #: snapshots of every counter, gauge and histogram quantile (the
    #: metrics document's ``series`` section and /series).  0 = off,
    #: unless obs_port is set (serving implies sampling, 1 s)
    obs_sample_s: float = 0.0
    #: fleet-discovery spool: where the live obs server publishes its
    #: ``moxt-obs-port-v1`` record.  None = $MOXT_OBS_SPOOL or a per-user
    #: spool under the temporary directory; "none" disables publishing
    obs_spool: str | None = None
    #: SLO rule set (obs/slo.py) for the alert evaluator that watches the
    #: time-series ring whenever it runs.  None = the built-in defaults;
    #: else a JSON file path or inline JSON — a list EXTENDS the defaults,
    #: {"defaults": false, "rules": [...]} replaces them
    slo_rules: str | None = None
    #: where alert incident bundles land (series window + /status
    #: snapshot per firing); None = the crash_dir, if any
    incident_dir: str | None = None
    #: deep-profiling plane (obs/profiler.py): where ``POST /profile``
    #: captures land (the torch.profiler device trace, host sampling
    #: stacks and profile.json).  None = next to the crash bundles or the
    #: metrics document, else ./moxt-profiles
    profile_dir: str | None = None
    #: host sampling profiler rate of a ``POST /profile`` capture: Python
    #: thread stacks snapshotted this many times per second
    host_sample_hz: float = 50.0
    #: persistent calibration store (obs/calib.py): directory whose
    #: ``calib.json`` accumulates measured per-(platform, devices,
    #: topology) program and workload rows, loaded at job start and
    #: merged at finish; None disables
    calib_dir: str | None = None
    #: multi-process: the rendezvous address ("host:port") of the Gloo
    #: process group; empty = the single-process path.  With it set,
    #: dist_num_processes and dist_process_id select this process's slot,
    #: and the mesh's S slots are dealt S/P to each process
    dist_coordinator: str = ""
    dist_num_processes: int = 0
    dist_process_id: int = -1
    #: job planner (runtime/planner.py + obs/plan.py): 'auto' solves the
    #: tunable knobs from the calibration store's curves before the run
    #: and records the plan (per-knob value + provenance, and a predicted
    #: wall scored at finish as ``plan/model_error_pct``); 'off' skips it
    plan: str = "auto"
    #: the sharded exchange's wire program: 'auto' lets the planner's
    #: collective chooser pick from the calibration store's measured
    #: curves between the monolithic 'all_to_all' and the decomposed
    #: 'all_gather' + slice, falling back to all_to_all with a named
    #: reason on a cold, out-of-range or thin store.  Explicit values
    #: pin.  Outputs are byte-identical either way
    exchange_collective: str = "auto"
    #: the collective chooser's evidence floor: sampled latencies
    #: required in the exact payload bucket before a curve may steer it
    calib_min_samples: int = 3

    def validate(self) -> "JobConfig":
        if self.plan not in ("auto", "off"):
            raise ValueError(f"plan must be auto|off, got {self.plan!r}")
        if self.exchange_collective not in ("auto", "all_to_all",
                                            "all_gather"):
            raise ValueError(
                "exchange_collective must be one of "
                "auto|all_to_all|all_gather, "
                f"got {self.exchange_collective!r}")
        if self.calib_min_samples < 1:
            raise ValueError(
                "calib_min_samples must be >= 1 sampled latencies")
        if self.remote_stage_timeout_s <= 0:
            raise ValueError(
                "remote_stage_timeout_s must be positive seconds")
        if self.hbm_sample_s < 0:
            raise ValueError("hbm_sample_s must be >= 0 (0 = off)")
        if self.stall_warn_factor < 0:
            raise ValueError("stall_warn_factor must be >= 0 (0 = off)")
        if self.obs_port < -1 or self.obs_port > 65535:
            raise ValueError(
                "obs_port must be -1 (off), 0 (ephemeral), or a port")
        if (self.obs_port > 0 and self.dist_num_processes > 1
                and self.obs_port + self.dist_num_processes - 1 > 65535):
            raise ValueError(
                f"obs_port {self.obs_port} + the per-process offset for "
                f"{self.dist_num_processes} processes exceeds 65535; "
                "use a lower port or 0 (ephemeral)")
        if self.obs_sample_s < 0:
            raise ValueError("obs_sample_s must be >= 0 (0 = off)")
        if not 0 < self.host_sample_hz <= 1000:
            raise ValueError(
                "host_sample_hz must be in (0, 1000] samples/sec, got "
                f"{self.host_sample_hz}")
        if self.slo_rules:
            from map_oxidize_tpu_torch.obs.slo import load_rules

            try:
                load_rules(self.slo_rules)
            except (OSError, ValueError) as e:
                raise ValueError(f"invalid slo_rules: {e}") from e
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
        if self.dist_coordinator and (
                self.dist_num_processes < 2 or self.dist_process_id < 0
                or self.dist_process_id >= self.dist_num_processes):
            raise ValueError(
                "distributed mode needs dist_num_processes >= 2 and "
                "0 <= dist_process_id < dist_num_processes")
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


@dataclass
class FleetConfig:
    """Fleet observatory configuration (``python -m map_oxidize_tpu_torch
    obs fleet``; JAX ``config.py:435``): the collector that polls any
    number of obs endpoints (one-shot jobs, resident servers), merges their
    telemetry into one fleet model, serves the fleet HTTP plane and
    optionally archives the fleet series to disk
    (:mod:`map_oxidize_tpu_torch.obs.fleet`)."""

    #: explicit endpoints to watch ("http://host:port" or "host:port");
    #: explicit targets never depart the model
    targets: list[str] = field(default_factory=list)
    #: a MOXT_OBS_PORT_FILE-format file ("<process> <port>" lines) to
    #: derive 127.0.0.1 targets from
    port_file: str = ""
    #: resident-server spool directories: each one's ``obs_port.json``
    #: (written by the server at start) names a target
    spool_dirs: list[str] = field(default_factory=list)
    #: well-known port-record spool to scan for live processes
    #: (``moxt-obs-port-v1`` records published by every serving obs
    #: server): "" = $MOXT_OBS_SPOOL / the per-user tempdir default,
    #: "none" disables scanning
    discover_dir: str = ""
    #: the collector's own HTTP bind (fleet /metrics /status /alerts
    #: /series /healthz); 0 = ephemeral (logged, and written to
    #: MOXT_OBS_PORT_FILE as "fleet <port>")
    host: str = "127.0.0.1"
    port: int = 0
    #: seconds between scrape sweeps over the target set
    poll_interval_s: float = 1.0
    #: a target unreachable (or refusing payloads) for this long is
    #: marked stale — a fleet alert, never a crash
    stale_after_s: float = 30.0
    #: persistent fleet series archive (``moxt-archive-v1``): a bounded
    #: ring of JSONL segments under this directory, plus the latest
    #: fleet status/alerts/target snapshots for post-mortem reads
    #: (``obs trend/top/where --archive``).  None disables
    archive_dir: str | None = None
    #: archive bounds: records per segment file, and segments kept (the
    #: ring overwrites oldest-first)
    archive_segment_records: int = 512
    archive_max_segments: int = 16
    #: fleet SLO rule set (same spelling as JobConfig.slo_rules); the
    #: built-in defaults are obs.fleet.FLEET_RULES
    slo_rules: str | None = None

    def validate(self) -> "FleetConfig":
        if not 0 <= self.port <= 65535:
            raise ValueError("fleet port must be 0 (ephemeral) or a port")
        if self.poll_interval_s <= 0:
            raise ValueError("poll_interval_s must be positive")
        if self.stale_after_s <= 0:
            raise ValueError("stale_after_s must be positive")
        if self.archive_segment_records < 1 or self.archive_max_segments < 2:
            raise ValueError("archive needs >= 1 record per segment and "
                             ">= 2 segments (the ring rotates into the "
                             "next segment before pruning the oldest)")
        if self.slo_rules:
            from map_oxidize_tpu_torch.obs.fleet import FLEET_RULES
            from map_oxidize_tpu_torch.obs.slo import load_rules

            try:
                load_rules(self.slo_rules, defaults=FLEET_RULES)
            except (OSError, ValueError) as e:
                raise ValueError(f"invalid fleet slo_rules: {e}") from e
        return self


@dataclass
class ServeConfig:
    """Resident job service configuration (``python -m
    map_oxidize_tpu_torch serve``): the long-lived server that holds CUDA,
    the launch ledger's program signatures, the loaded kernel libraries
    and opened corpora across jobs, and multiplexes submitted jobs over
    the drivers (JAX ``config.py:505``).  Per-JOB knobs stay on
    :class:`JobConfig`; clients send overrides with each submission."""

    #: HTTP bind: the obs telemetry plane (/metrics /status /series) plus
    #: the job endpoints (/jobs, submit, cancel, shutdown).  0 = ephemeral
    #: (logged, and written to ``MOXT_OBS_PORT_FILE``)
    host: str = "127.0.0.1"
    port: int = 0
    #: concurrent job slots: worker threads multiplexing admitted jobs
    #: (each runs a full driver under its own Obs)
    workers: int = 2
    #: bounded submission queue: submissions past it are REJECTED with a
    #: named reason (``queue_full``), never silently dropped
    max_queue: int = 16
    #: device-memory admission budget in bytes: jobs whose estimated
    #: working set can never fit are rejected, jobs that do not fit NEXT
    #: TO the running set are deferred until memory frees.  0 = the
    #: card's total memory (read once CUDA is initialised); a host
    #: without a card leaves admission open
    hbm_budget_bytes: int = 0
    #: server working directory: per-job artifact spool
    #: (``<spool>/<job_id>/`` holds the metrics doc and crash bundles)
    #: plus the default ledger location
    spool_dir: str = "moxt-serve-spool"
    #: run ledger shared by every job the server finishes; empty =
    #: ``<spool>/ledger``; "none" disables
    ledger_dir: str = ""
    #: cached-corpus idle eviction: an opened corpus unused by any job
    #: for this long is closed; 0 disables eviction
    idle_evict_s: float = 300.0
    #: graceful-drain budget: on shutdown, running + already-admitted
    #: jobs get this long to finish before remaining ones are cancelled
    drain_timeout_s: float = 60.0
    #: server-level telemetry cadence (the time-series ring + device
    #: sampler on the server's own obs bundle)
    obs_sample_s: float = 1.0
    #: SLO rule set for the SERVER's alert evaluator (serve-scoped rules
    #: see the server-lifetime registry: queue-wait p95, warm recompiles,
    #: the memory watermark); same spelling as JobConfig.slo_rules ("" =
    #: built-in defaults)
    slo_rules: str = ""
    #: per-job silent-heartbeat/series cadence (gives every job's /jobs
    #: row live rows/sec without progress lines); 0 disables
    job_sample_s: float = 0.5
    #: persistent calibration store shared by every job the server runs;
    #: empty = ``<spool>/calib``; "none" disables
    calib_dir: str = ""
    #: terminal-job retention: /jobs lists at most this many finished or
    #: rejected jobs; older ones are dropped from memory (their spool
    #: artifacts remain on disk)
    max_history: int = 512

    def validate(self) -> "ServeConfig":
        if not 0 <= self.port <= 65535:
            raise ValueError("serve port must be 0 (ephemeral) or a port")
        if self.workers < 1:
            raise ValueError("serve workers must be >= 1")
        if self.max_queue < 1:
            raise ValueError("serve max_queue must be >= 1")
        if self.hbm_budget_bytes < 0:
            raise ValueError("hbm_budget_bytes must be >= 0 (0 = probe)")
        if self.idle_evict_s < 0 or self.drain_timeout_s < 0:
            raise ValueError("idle_evict_s and drain_timeout_s must be "
                             ">= 0")
        if self.obs_sample_s < 0 or self.job_sample_s < 0:
            raise ValueError("obs_sample_s and job_sample_s must be >= 0")
        if self.max_history < 1:
            raise ValueError("max_history must be >= 1 (a finished job "
                             "must stay visible to its waiting client)")
        if self.slo_rules:
            from map_oxidize_tpu_torch.obs.slo import load_rules

            try:
                load_rules(self.slo_rules)
            except (OSError, ValueError) as e:
                raise ValueError(f"invalid slo_rules: {e}") from e
        if not self.spool_dir:
            raise ValueError("spool_dir must be set")
        return self
