"""Command-line driver: ``python -m mpi_k_selection_tpu_torch``.

The k-th, quantiles and top-k (1-D or ``--batch``) modes of the JAX
package's CLI (``cli.py:_run_kth``, ``_run_quantiles``, ``_run_topk``) on
the ``cuda``, ``seq`` and ``mpi`` backends, one device or ``--devices``
ranks::

    # median of 2^30 int32, checked against a NumPy oracle
    python -m mpi_k_selection_tpu_torch --n 1073741824 --verify --json

    # the reference's sequential operating point (k=250) on the CPU
    python -m mpi_k_selection_tpu_torch --n 100000000 --k 250 --device cpu

    # p50/p90/p99 of 2^27 float64, one shared walk
    python -m mpi_k_selection_tpu_torch --n 134217728 --dtype float64 --gen normal \
        --quantiles 0.5,0.9,0.99 --verify

    # the 128 largest of 2^26 float32 (values and indices)
    python -m mpi_k_selection_tpu_torch --n 67108864 --dtype float32 --gen normal --topk 128 --verify

    # the 8 largest of each of 4096 rows of 32768 float32 (the block kernel)
    python -m mpi_k_selection_tpu_torch --n 32768 --batch 4096 --dtype float32 --gen normal --topk 8 --verify

    # median of 2^30 int32 streamed in chunks of 2^26 (chunk i: seed + i),
    # checked by the streamed rank certificate and a NumPy oracle
    python -m mpi_k_selection_tpu_torch --streaming --n 1073741824 --chunk-elems 67108864 --verify

    # the same through the spill store (later passes read the shrinking
    # spilled survivors), certified from the spilled generation 0
    python -m mpi_k_selection_tpu_torch --streaming --n 1073741824 --chunk-elems 67108864 --spill force --check

    # a wide first digit and packed spill records (format v2)
    python -m mpi_k_selection_tpu_torch --streaming --n 1073741824 --chunk-elems 67108864 --spill force \
        --width-schedule auto --pack-spill auto --check

    # the reference's CGM over 4 ranks (4 spawned processes; gloo when they
    # share a card or run on the CPU, nccl with a card each), with its rounds
    python -m mpi_k_selection_tpu_torch --devices 4 --algorithm cgm --n 16000000 --verify --json

    # the distributed radix select over 2 ranks on the CPU
    python -m mpi_k_selection_tpu_torch --devices 2 --distribute always --device cpu --verify

    # the oracle backends: NumPy / std::nth_element, and the native forked-rank CGM
    python -m mpi_k_selection_tpu_torch --backend seq --n 100000000 --k 250
    python -m mpi_k_selection_tpu_torch --backend mpi --num-procs 4 --n 100000000 --k 150 --verify

    # the spilled median under a seeded fault plan (the same SEED, the same
    # faults), certified against the clean stream, with the debug bundle
    python -m mpi_k_selection_tpu_torch --streaming --n 1073741824 --chunk-elems 67108864 --spill force \
        --chaos 7 --check --debug-bundle bundle.json

    # continuous p50/p90/p99 over a drifting stream, 8 samples, served as
    # Prometheus text on a free port
    python -m mpi_k_selection_tpu_torch monitor --buckets 8 --drift 1000 --prometheus-port 0 --port-file port.txt

    # the resident-dataset query server: 2^28 int32 on the card, its
    # programs built at startup, JSON queries over HTTP on port 8080
    python -m mpi_k_selection_tpu_torch serve --n 268435456 --warmup --device cuda
    curl -s localhost:8080/v1/query -d '{"dataset": "default", "op": "quantiles", "qs": [0.5, 0.99]}'
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile

import numpy as np
import torch

from mpi_k_selection_tpu_torch import config
from mpi_k_selection_tpu_torch.backends import BACKENDS
from mpi_k_selection_tpu_torch.ops.topk import METHODS
from mpi_k_selection_tpu_torch.streaming.pipeline import DEFAULT_PIPELINE_DEPTH
from mpi_k_selection_tpu_torch.utils import datagen
from mpi_k_selection_tpu_torch.utils import dtypes as _dt
from mpi_k_selection_tpu_torch.utils.timing import ResultRecord, time_fn

DTYPES = (
    "int32",
    "int64",
    "uint32",
    "float32",
    "float64",
    "float16",
    "int16",
    "bfloat16",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi_k_selection_tpu_torch",
        description="exact k-selection on a CUDA device (PyTorch port)",
    )
    p.add_argument(
        "--backend", choices=BACKENDS, default="cuda",
        help="cuda: this package (on --device); seq: the host oracle (NumPy, std::nth_element); "
        "mpi: the native forked-rank CGM (int32, k-th mode)",
    )
    p.add_argument("--n", type=int, default=1 << 20, help="number of elements")
    p.add_argument(
        "--k", type=int, default=None,
        help="1-indexed rank (default: N/2, the reference's median operating point)",
    )
    p.add_argument("--gen", choices=datagen.PATTERNS, default="uniform")
    p.add_argument("--dtype", choices=DTYPES, default="int32")
    p.add_argument("--seed", type=int, default=config.DEFAULT_SEED)
    p.add_argument(
        "--algorithm", choices=("auto", "radix", "sort", "cgm"), default="auto",
        help="selection algorithm (cuda backend); cgm is the reference-parity protocol (distributed only)",
    )
    p.add_argument(
        "--distribute", choices=("auto", "never", "always"), default="auto",
        help="shard over the --devices ranks (cuda backend; auto: from 2 ranks and 2^20 elements)",
    )
    p.add_argument(
        "--devices", type=int, default=None,
        help="ranks of a distributed run (cuda backend, k-th and --quantiles modes): DEVICES processes "
        "started by the launcher, each with its shard on --device; gloo when ranks share a card or run "
        "on the CPU, nccl with a card for each. With --streaming: the cards the pipelined passes stage "
        "onto, round robin (capped at the cards present; with --device cpu, that many CPU slots)",
    )
    p.add_argument("--num-procs", type=int, default=4, help="process count for the mpi backend (mpirun -np P)")
    p.add_argument(
        "--c", type=int, default=config.REFERENCE_C,
        help="CGM coarseness constant (mpi backend; TODO-kth-problem-cgm.c:44)",
    )
    p.add_argument(
        "--quantiles", default=None,
        help="comma-separated quantiles in [0,1] (e.g. 0.5,0.9,0.99): exact nearest-rank "
        "order statistics from one shared walk",
    )
    p.add_argument("--topk", type=int, default=None, help="return the top-k instead of the k-th")
    p.add_argument("--smallest", action="store_true", help="top-k smallest instead of largest")
    p.add_argument(
        "--batch", type=int, default=None,
        help="batch rows for top-k: the input becomes shape (batch, n), batch independent rows "
        "of n elements each (total batch*n)",
    )
    p.add_argument(
        "--topk-method", choices=METHODS, default="auto",
        help="top-k algorithm (ops/topk.py); block is the batched kernel: --batch, largest only, "
        "float32 or bfloat16, k <= 16",
    )
    p.add_argument(
        "--streaming", action="store_true",
        help="k-th mode over a stream of chunks of --chunk-elems (chunk i generated with seed "
        "SEED + i), staged to the device one at a time and never materialized whole; per-chunk "
        "patterns (sequential/descending/seqlike) become per-chunk ramps",
    )
    p.add_argument("--chunk-elems", type=int, default=1 << 22, help="chunk size (elements) for --streaming")
    p.add_argument(
        "--pipeline-depth", type=int, default=DEFAULT_PIPELINE_DEPTH,
        help="--streaming: chunks staged ahead of the descent on a producer thread (0 = synchronous)",
    )
    p.add_argument(
        "--ingest-workers", default=None, metavar="auto|N",
        help="--streaming: host data-plane workers (auto = min(4, cores); 1 = the one producer thread): above 1 "
        "a puller, N staging workers and a reorder sequencer, and the spill records decoded on N threads; "
        "answers are the same at every width",
    )
    p.add_argument(
        "--spill", choices=("auto", "off", "force"), default="auto",
        help="--streaming survivor spill store: tee pass 0's keys to disk and serve later passes from the "
        "shrinking spilled survivors instead of replaying the source (auto = only for one-shot sources, so "
        "the CLI's replayable stream stays on the replay path; force = always; off = never). The same "
        "answers in every mode",
    )
    p.add_argument(
        "--spill-dir", default=None,
        help="directory of --spill stores (default: the temp dir); at worst about 2x the stream's key bytes "
        "(3x for a store that keeps its generation 0, as --spill force does for --check)",
    )
    p.add_argument(
        "--width-schedule", default="off", metavar="auto|off|W0,W1,...",
        help="--streaming per-pass digit widths: off (default) = radix_bits every pass, auto = one wide first "
        "digit (up to 16 bits; 64-bit keys a second one), or a comma-separated width list summing to the key "
        "width. The same answers for every schedule",
    )
    p.add_argument(
        "--pack-spill", choices=("auto", "off"), default="off",
        help="--streaming spill record format: auto = format v2 (each survivor's unresolved low bits, "
        "bit-packed per segment with a CRC each; the pass-0 tee segmented by the top digit, so later passes "
        "read only the surviving segments), off (default) = format v1. The same answers either way",
    )
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--repeats", type=int, default=1)
    p.add_argument("--verify", action="store_true", help="check against a NumPy oracle")
    p.add_argument(
        "--check", action="store_true",
        help="verify the answer's rank certificate (an O(n) count, no oracle sort; k-th mode; with "
        "--streaming --spill force it reads the spilled generation 0, not the source)",
    )
    p.add_argument("--json", action="store_true", help="emit a JSON result record")
    p.add_argument("--profile", action="store_true", help="print per-phase wall timing")
    p.add_argument(
        "--trace-dir", default=None,
        help="write a torch.profiler trace of the solve (host and, with a card, its kernels and copies) as "
        "Chrome trace JSON into this directory",
    )
    p.add_argument(
        "--metrics-json", default=None, metavar="PATH",
        help="write the run's metrics registry (StagingPool hits/misses, pipeline stall seconds, in-flight "
        "window occupancy, chunks/bytes per ingest slot, spilled bytes, per-phase wall time) as JSON to "
        "PATH; counters and phase totals add up over all --repeats (the run.repeats gauge is the divisor)",
    )
    p.add_argument(
        "--trace-events", default=None, metavar="PATH",
        help="write host-thread spans (the producer's produce/encode/stage/spill, the consumer's "
        "stall/pass/collect) as Chrome trace-event JSON to PATH (open in https://ui.perfetto.dev); "
        "composes with --trace-dir",
    )
    p.add_argument(
        "--retry", choices=("default", "off"), default="default",
        help="--streaming resilience policies: default = bounded retry (3 attempts, exponential backoff) of "
        "transient source and staging failures, pass re-runs, the corrupt-record re-read/rebuild ladder and the "
        "ENOSPC spill downgrade; off = fail on the first fault. Recovered answers are the same bits",
    )
    p.add_argument(
        "--chaos", type=int, default=None, metavar="SEED",
        help="--streaming fault injection: run the solve under FaultPlan.seeded(SEED) (transient source and "
        "staging raises, spill-record corruption, stalls; the same SEED, the same faults) and record what fired "
        "in the record's 'chaos' entry; --verify and --check judge the recovered answer against the clean "
        "stream. Faults strike the first touch of each chosen site and index, so later --repeats run clean",
    )
    p.add_argument(
        "--debug-bundle", default=None, metavar="PATH",
        help="arm the flight recorder (the recent events and spans) and write its JSON debug bundle (events, "
        "metrics, ledger, spans, faults) to PATH at exit, success or failure; a terminal failure also dumps one "
        "ksel-flight-*.json bundle under the temp dir the moment it fires",
    )
    return p


def build_monitor_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi_k_selection_tpu_torch monitor",
        description="continuous quantiles over an unbounded stream: a sliding ring of per-time-bucket RadixSketches "
        "counted on the card, one p50/p90/p99 sample per window advance, each value with its exact rank and value "
        "bounds; --decay switches to the fixed-point exponentially decayed aggregate",
    )
    p.add_argument("--chunk-elems", type=int, default=1 << 16, help="elements a chunk (one chunk = one tick)")
    p.add_argument("--gen", choices=datagen.PATTERNS, default="uniform")
    p.add_argument("--dtype", choices=DTYPES, default="int32")
    p.add_argument("--seed", type=int, default=config.DEFAULT_SEED)
    p.add_argument(
        "--drift", type=float, default=0.0,
        help="additive drift of the stream a chunk (chunk i is shifted by round(drift * i))",
    )
    p.add_argument("--window", type=int, default=32, help="ring length in time buckets (the open one included)")
    p.add_argument(
        "--emit-every", type=int, default=1, metavar="CHUNKS",
        help="chunks a time bucket: the window advances and a sample comes out every this many chunks",
    )
    p.add_argument(
        "--decay", type=float, default=None,
        help="exponential decay a window advance, in (0, 1] (fixed-point counts; 1.0 is the undecayed window's "
        "bits; default: the exact sliding window)",
    )
    p.add_argument("--quantiles", default="0.5,0.9,0.99", help="comma-separated quantiles (default p50/p90/p99)")
    p.add_argument(
        "--buckets", type=int, default=None, metavar="N",
        help="stop after N samples (default: run until interrupted; the stream is unbounded)",
    )
    p.add_argument("--sketch-bits", type=int, default=4)
    p.add_argument("--sketch-levels", type=int, default=4)
    p.add_argument("--pipeline-depth", type=int, default=None, help="staging depth, as in --streaming")
    p.add_argument("--devices", type=int, default=None, help="round-robin staging over this many cards")
    p.add_argument("--device", default="cuda", help="torch device the buckets count on (default cuda)")
    p.add_argument(
        "--metrics-json", default=None, metavar="PATH",
        help="write the monitor's metrics registry (monitor.quantile{q=} gauges, ingest counters) as JSON at exit",
    )
    p.add_argument(
        "--prometheus-port", type=int, default=None, metavar="PORT",
        help="serve the registry's Prometheus text exposition on PORT (GET /metrics; 0 = a free port, see "
        "--port-file) for the whole run",
    )
    p.add_argument("--port-file", default=None, metavar="PATH", help="write the bound Prometheus port here")
    p.add_argument("--json", action="store_true", help="one JSON object a sample (JSONL)")
    return p


def monitor_main(argv=None) -> int:
    """``python -m mpi_k_selection_tpu_torch monitor ...``: the continuous
    quantile monitor over a synthetic (optionally drifting) chunk stream,
    one sample line a window advance, until ``--buckets`` samples or an
    interrupt. Exit 0 on a clean stop (Ctrl-C included)."""
    import json

    from mpi_k_selection_tpu_torch import obs as obs_lib
    from mpi_k_selection_tpu_torch.monitor import Monitor, start_metrics_server
    from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype

    args = build_monitor_parser().parse_args(argv)
    if args.chunk_elems < 1:
        raise SystemExit("error: --chunk-elems must be >= 1")
    try:
        qs = [float(q) for q in args.quantiles.split(",") if q.strip()]
    except ValueError as e:
        raise SystemExit(f"error: bad --quantiles value: {e}") from e
    dtype = numpy_dtype(args.dtype)
    max_chunks = None if args.buckets is None else args.buckets * args.emit_every

    def source():  # the JAX CLI's stream: chunk i of seed SEED + i, shifted by round(drift * i)
        i = 0
        while max_chunks is None or i < max_chunks:
            c = datagen.generate(args.chunk_elems, pattern=args.gen, seed=args.seed + i, dtype=dtype)
            if args.drift:
                off = args.drift * i
                if np.issubdtype(dtype, np.integer):
                    off = int(round(off))
                c = (c + dtype.type(off)).astype(dtype, copy=False)
            yield c
            i += 1

    obs = None
    if args.metrics_json or args.prometheus_port is not None:
        obs = obs_lib.Observability(metrics=obs_lib.MetricsRegistry())
    exporter = None
    try:
        mon = Monitor(qs=qs, window=args.window, emit_every=args.emit_every, decay=args.decay,
                      radix_bits=args.sketch_bits, levels=args.sketch_levels, pipeline_depth=args.pipeline_depth,
                      device=args.device, devices=args.devices, obs=obs)
        if args.prometheus_port is not None:
            exporter = start_metrics_server(obs.metrics, port=args.prometheus_port)
            if args.port_file:
                with open(args.port_file, "w") as f:
                    f.write(str(exporter.port))
        try:
            for sample in mon.run(source(), dtype, max_samples=args.buckets):
                print(json.dumps(sample.as_dict()) if args.json else sample.format_line(), flush=True)
        except KeyboardInterrupt:
            pass
    except (ValueError, RuntimeError, TypeError) as e:
        raise SystemExit(f"error: {e}") from e
    finally:
        if exporter is not None:
            exporter.close()
        if obs is not None and args.metrics_json:
            with open(args.metrics_json, "w") as f:
                f.write(obs.metrics.to_json(indent=2))
    return 0


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi_k_selection_tpu_torch serve",
        description=(
            "resident-dataset query server: place a dataset once, answer "
            "kselect/quantile/top-k/rank-certificate queries from many "
            "concurrent clients (POST /v1/query, GET /v1/datasets, "
            "GET /metrics, GET /healthz)"
        ),
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080, help="listen port (0 = ephemeral; see --port-file)")
    p.add_argument(
        "--port-file", default=None, metavar="PATH", help="write the bound port here after listen (for --port 0 callers)"
    )
    p.add_argument("--dataset-id", default="default", help="id the generated dataset registers under")
    p.add_argument("--n", type=int, default=1 << 20, help="dataset elements")
    p.add_argument("--gen", choices=datagen.PATTERNS, default="uniform")
    p.add_argument("--dtype", choices=DTYPES, default="int32")
    p.add_argument("--seed", type=int, default=config.DEFAULT_SEED)
    p.add_argument("--device", default="cuda", help="torch device the dataset lives and counts on (default cuda)")
    p.add_argument(
        "--streaming", action="store_true",
        help="register the dataset as an out-of-core stream (sketched once at startup; exact-tier queries replay "
        "the generated chunk source, chunk i of seed SEED + i) instead of a resident tensor",
    )
    p.add_argument("--chunk-elems", type=int, default=1 << 22, help="chunk size (elements) for --streaming")
    p.add_argument(
        "--no-sketch", action="store_true",
        help="skip the resident sketch (disables the sketch/auto fast tiers; every query runs exact)",
    )
    p.add_argument("--sketch-bits", type=int, default=4)
    p.add_argument("--sketch-levels", type=int, default=4)
    p.add_argument(
        "--batch-window", type=float, default=0.002, metavar="SECONDS",
        help="cross-request coalescing window: after a query arrives the dispatch thread waits this long for more "
        "against the same dataset and answers them with ONE shared-pass walk (0 = no coalescing; answers "
        "bit-identical either way)",
    )
    p.add_argument("--max-batch", type=int, default=1024, help="coalesced-request ceiling per dispatch")
    p.add_argument(
        "--warmup", action="store_true",
        help="build the dataset's selection programs (cached sort, walk closure and one width-1 query: the kernel "
        "build and first launches) at registration, so the first client query excludes that wall (the ledger's "
        "serve.programs book shows it)",
    )
    p.add_argument(
        "--lanes", default="auto", metavar="N|auto",
        help="dispatch lanes: 'auto' (default) opens one supervised dispatch thread per distinct device; an integer "
        "folds devices onto N lanes (1 = a single batcher; answers bit-identical at every setting)",
    )
    p.add_argument(
        "--no-fast-path", action="store_true",
        help="route sketch-tier (and auto-pinned) answers through the dispatch lane instead of answering inline on "
        "the request thread: the bit-for-bit oracle for the default fast path",
    )
    p.add_argument(
        "--quit-after", type=int, default=None, metavar="N",
        help="serve N HTTP requests, then exit cleanly (default: serve until interrupted)",
    )
    p.add_argument(
        "--latency-windows", type=int, default=0, metavar="BUCKETS",
        help="back the per-tier serve.latency_seconds histograms with a BUCKETS-deep sliding-window RadixSketch, so "
        "/metrics p50/p90/p99 become windowed quantiles with exact rank/value bounds (gauge series "
        "ksel_serve_latency_seconds_windowed{tier,quantile}; 0 = off, the default)",
    )
    p.add_argument(
        "--latency-advance-every", type=int, default=256, metavar="OBS",
        help="observations per latency window bucket (with --latency-windows; the window advances on observation "
        "counts, never clocks)",
    )
    p.add_argument(
        "--debug-bundle", default=None, metavar="PATH",
        help="arm the server's flight recorder (a bounded ring of recent serve events and request/walk spans; also "
        "live at GET /debug/bundle) and write the JSON debug bundle to PATH at shutdown; a dispatch-loop crash "
        "auto-dumps one when the supervisor restarts it",
    )
    return p


def serve_main(argv=None) -> int:
    """``python -m mpi_k_selection_tpu_torch serve ...``: build the server,
    register the generated dataset on ``--device``, run the HTTP front on
    this thread until interrupted (or ``--quit-after`` requests), then tear
    everything down (request and dispatch threads joined) and exit 0."""
    from mpi_k_selection_tpu_torch import obs as obs_lib
    from mpi_k_selection_tpu_torch.serve import KSelectHTTPServer, KSelectServer
    from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype

    args = build_serve_parser().parse_args(argv)
    obs = obs_lib.Observability(metrics=obs_lib.MetricsRegistry())
    latency_windows = (
        dict(window=args.latency_windows, advance_every=args.latency_advance_every) if args.latency_windows else None
    )
    try:
        lanes = args.lanes if args.lanes == "auto" else int(args.lanes)
    except ValueError:
        raise SystemExit(f"error: --lanes must be 'auto' or an integer, got {args.lanes!r}") from None
    server = KSelectServer(
        window=args.batch_window, max_batch=args.max_batch, obs=obs, latency_windows=latency_windows,
        fast_path=not args.no_fast_path, lanes=lanes, flight=True if args.debug_bundle else None,
    )
    sketch_kw = dict(sketch=not args.no_sketch, sketch_bits=args.sketch_bits, sketch_levels=args.sketch_levels,
                     device=args.device)
    try:
        if args.streaming:
            if args.chunk_elems < 1:
                raise SystemExit("error: --chunk-elems must be >= 1")
            server.add_dataset(args.dataset_id, source=chunk_source(args), warmup=args.warmup, **sketch_kw)
        else:
            x = datagen.generate(args.n, pattern=args.gen, seed=args.seed, dtype=numpy_dtype(args.dtype))
            server.add_dataset(args.dataset_id, x, warmup=args.warmup, **sketch_kw)
        httpd = KSelectHTTPServer((args.host, args.port), server)
        try:
            if args.port_file:
                with open(args.port_file, "w") as f:
                    f.write(str(httpd.port))
            ds = server.list_datasets()[0]
            print(
                f"serving dataset {args.dataset_id!r} (n={ds['n']}, dtype={ds['dtype']}, "
                f"residency={ds['residency']}, sketch={ds['sketch']}, device={args.device}) on "
                f"http://{args.host}:{httpd.port} — POST /v1/query, GET /v1/datasets, GET /metrics, GET /healthz",
                flush=True,
            )
            if args.quit_after is not None:
                for _ in range(args.quit_after):
                    httpd.handle_request()
            else:
                httpd.serve_forever(poll_interval=0.2)
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"error: {e}") from e
    finally:
        if args.debug_bundle and server.flight is not None:
            # through the server, so the bundle carries its `server`
            # section; a failed write must not replace the error in flight
            try:
                server.dump_debug_bundle(args.debug_bundle, reason="serve-shutdown")
            except OSError as write_err:
                print(f"warning: --debug-bundle {args.debug_bundle}: {write_err}", file=sys.stderr)
        server.close()
    return 0


def oracle_many(x: np.ndarray, ks, *, sort_order: bool = False) -> np.ndarray:
    """The k-th smallest of ``x`` for each k in ``ks``: in the sortable
    keys' order (utils/dtypes.py; the radix paths) by one ``np.partition``
    over the keys, or with ``sort_order`` in ``lax.sort``'s order (the sort
    paths, ops/sort.py: ``-0.0 == +0.0``, NaNs equal and last, ties by
    position) by a stable argsort, returning each element's own bits."""
    x = x.reshape(-1)
    idx = np.asarray(ks, dtype=np.int64) - 1
    keys = _dt.np_to_sortable_bits(x)
    if sort_order:
        if _dt.torch_dtype(x.dtype).is_floating_point:
            keys = np.where(x == 0, _dt.np_to_sortable_bits(np.zeros(1, x.dtype))[0], keys)
            keys = np.where(np.isnan(x), np.iinfo(keys.dtype).max, keys)
        return x[np.argsort(keys, kind="stable")[idx]]
    return _dt.np_from_sortable_bits(np.partition(keys, np.unique(idx))[idx], x.dtype)


def oracle(x: np.ndarray, k: int, *, sort_order: bool = False):
    """:func:`oracle_many` for one k."""
    return oracle_many(x, [k], sort_order=sort_order)[0]


def topk_oracle(x: np.ndarray, k: int, largest: bool = True):
    """``(values, indices)`` of the top-k of 1-D ``x`` in key order, ties
    by ascending position: the threshold key by ``np.partition``, then
    its candidates (every key at or beyond it) sorted by (key, position)."""
    keys = _dt.np_to_sortable_bits(x)
    n = keys.size
    if not largest:
        keys = ~keys  # unsigned: reverses the order
    tau = np.partition(keys, n - k)[n - k]
    cand = np.flatnonzero(keys >= tau)
    idx = cand[np.lexsort((cand, ~keys[cand]))[:k]]
    return x[idx], idx


def batched_topk_oracle(x: np.ndarray, k: int, largest: bool = True):
    """:func:`topk_oracle` of every row of 2-D ``x``: ``(values, indices)``
    of shape ``(B, k)``."""
    rows = [topk_oracle(r, k, largest) for r in x]
    return np.stack([v for v, _ in rows]), np.stack([i for _, i in rows])


def _same_value(a, b) -> bool:
    """Value equality of two scalars, NaN equal to NaN (the seq oracle's
    order does not tell -0.0 from +0.0 or one NaN from another)."""
    a, b = np.asarray(a), np.asarray(b)
    return bool(a == b) or bool(np.isnan(a.astype(np.float64)) and np.isnan(b.astype(np.float64)))


def _run_kth(args, x: np.ndarray):
    from mpi_k_selection_tpu_torch.backends import cuda as backend
    from mpi_k_selection_tpu_torch.utils.interop import tensor_from_numpy, tensor_to_numpy

    n = x.size
    k = args.k if args.k is not None else max(1, n // 2)
    if not 1 <= k <= n:
        raise SystemExit(f"error: k={k} out of range [1, {n}]")
    if args.backend != "cuda":
        return _run_kth_host(args, x, k)
    if (args.devices or 1) > 1:
        return _run_ranks(args, x, k)
    algorithm, _ = backend.plan(n, args.algorithm, args.distribute)
    xd = tensor_from_numpy(x, args.device)
    seconds, answer = time_fn(
        lambda: backend.kselect(xd, k, algorithm=algorithm, distribute=args.distribute, device=args.device),
        repeats=args.repeats, warmup=1, device=args.device,
    )
    answer = tensor_to_numpy(answer.reshape(1))[0]
    record = _record(args, n, k, answer.item(), algorithm, seconds)
    ok = True
    if args.verify:
        want = oracle(x, k, sort_order=algorithm == "sort")
        ok = answer.tobytes() == want.tobytes()  # bit for bit
        record.extra["oracle"] = want.item()
        record.extra["exact_match"] = ok
    return record, ok


def _run_kth_host(args, x: np.ndarray, k: int):
    """The k-th on a host backend: ``seq`` (NumPy / ``std::nth_element``,
    checked against the literal sort-then-index) or ``mpi`` (the native
    CGM over ``--num-procs`` forked ranks, checked bit for bit)."""
    from mpi_k_selection_tpu_torch.backends import get_backend

    backend = get_backend(args.backend)
    rounds = None
    if args.backend == "seq":
        seconds, answer = time_fn(lambda: backend.kselect(x, k), repeats=args.repeats, device="cpu")
        algorithm = "partition"
    else:
        from mpi_k_selection_tpu_torch.native import cgm_driver

        seconds, (answer, rounds) = time_fn(
            lambda: cgm_driver.kselect_full(x, k, num_procs=args.num_procs, c=args.c)[:2],
            repeats=args.repeats, device="cpu",
        )
        algorithm = "cgm"
    record = ResultRecord(
        answer=np.asarray(answer).item(), n=x.size, k=k, backend=args.backend, algorithm=algorithm,
        dtype=args.dtype, seconds=seconds, device="host",
        n_devices=args.num_procs if args.backend == "mpi" else 1, rounds=rounds,
    )
    ok = True
    if args.verify:
        if args.backend == "seq":
            want = get_backend("seq").kselect_sort(x, k)
            ok = _same_value(answer, want)
        else:
            want = oracle(x, k)
            ok = np.asarray(answer).tobytes() == want.tobytes()
        record.extra["oracle"] = np.asarray(want).item()
        record.extra["exact_match"] = ok
    return record, ok


def _rank_run(mesh, args, path: str):
    """One rank of ``--devices P``: the global array memory-mapped from
    ``path`` (written once by the parent), this rank's shard placed once,
    then the timed selection (a barrier first). Returns the answer's bits,
    the rounds, the mesh's counts per call and the number of distinct
    devices the ranks ran on."""
    from mpi_k_selection_tpu_torch import api
    from mpi_k_selection_tpu_torch.backends import cuda as backend
    from mpi_k_selection_tpu_torch.parallel import cgm as pcgm, mesh as mesh_lib, radix as pradix
    from mpi_k_selection_tpu_torch.utils.interop import tensor_from_numpy, tensor_to_numpy

    x = np.load(path, mmap_mode="r")
    n = x.size
    if args.quantiles is not None:
        ks = api.quantile_ranks(args.qs, n)
        _, distributed = backend.plan(n, "radix", args.distribute, n_dev=mesh.size)
        algorithm = "quantiles-distributed" if distributed else "quantiles"
        if distributed:
            xs = mesh_lib.shard_1d(x, mesh)
            call = lambda: (pradix.distributed_radix_select_many(xs, ks, mesh=mesh), None)  # noqa: E731
        else:
            xd = tensor_from_numpy(np.array(x), mesh.device)
            call = lambda: (api.kselect_many(xd, ks), None)  # noqa: E731
    else:
        k = args.k if args.k is not None else max(1, n // 2)
        algorithm, distributed = backend.plan(n, args.algorithm, args.distribute, n_dev=mesh.size)
        if distributed:
            xs = mesh_lib.shard_1d(x, mesh)
            if algorithm == "cgm":
                call = lambda: pcgm.distributed_cgm_select(xs, k, mesh=mesh, return_rounds=True)  # noqa: E731
            else:
                call = lambda: (pradix.distributed_radix_select(xs, k, mesh=mesh), None)  # noqa: E731
            algorithm += "-distributed"
        else:
            xd = tensor_from_numpy(np.array(x), mesh.device)
            call = lambda: (api.kselect(xd, k, algorithm=algorithm), None)  # noqa: E731

    def timed():
        mesh.barrier()
        return call()

    # ranks that share a card count it once in the per-chip rate
    where = torch.tensor([mesh.device.index if mesh.device.type == "cuda" else -1])
    n_cards = len(set(mesh.all_gather(where).reshape(-1).tolist()))
    timed()  # warm-up: builds nothing (the launcher built the kernels), fills caches
    mesh.reset_stats()
    seconds, (answer, rounds) = time_fn(timed, repeats=args.repeats, device=mesh.device)
    reps = max(1, args.repeats)
    return {
        "answer": tensor_to_numpy(answer.reshape(-1)), "rounds": rounds, "seconds": seconds,
        "algorithm": algorithm, "process_group": mesh.backend, "collectives": mesh.collectives // reps,
        "collective_seconds": mesh.collective_seconds() / reps, "device": str(mesh.device),
        "n_cards": n_cards,
    }


def _run_ranks(args, x: np.ndarray, k: int | None):
    """``--devices P`` on the cuda backend: P ranks through the launcher
    (parallel/multihost.py:run_ranks), each answering; rank 0's answer is
    checked against the oracle."""
    from mpi_k_selection_tpu_torch import api
    from mpi_k_selection_tpu_torch.parallel.multihost import run_ranks

    with tempfile.TemporaryDirectory(prefix="kselect-cli-") as tmp:
        # one copy on disk that every rank maps, never one per rank
        path = os.path.join(tmp, "x.npy")
        np.save(path, x)
        out = run_ranks(_rank_run, args.devices, args, path, device=args.device)
    answer = out["answer"]
    algorithm = out["algorithm"]
    value = answer.tolist() if args.quantiles is not None else answer[0].item()
    record = _record(args, x.size, k or 0, value, algorithm, out["seconds"])
    record.n_devices = out["n_cards"]
    record.rounds = out["rounds"]
    record.extra.update(
        ranks=args.devices, process_group=out["process_group"], collectives=out["collectives"],
        collective_seconds=out["collective_seconds"],
    )
    ok = True
    if args.verify:
        if args.quantiles is not None:
            ks = api.quantile_ranks(args.qs, x.size)
            want = oracle_many(x, ks, sort_order=algorithm == "quantiles" and api.many_takes_sort(x.size, len(ks)))
            record.extra["oracle"] = want.tolist()
        else:
            want = oracle(x, k, sort_order=algorithm == "sort")
            record.extra["oracle"] = want.item()
        ok = answer.tobytes() == want.tobytes()
        record.extra["exact_match"] = ok
    return record, ok


def _record(args, n, k, answer, algorithm, seconds):
    from mpi_k_selection_tpu_torch.backends import cuda as backend

    dev = torch.device(args.device)
    return ResultRecord(
        answer=answer, n=n, k=k, backend=backend.NAME, algorithm=algorithm, dtype=args.dtype,
        seconds=seconds,
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
    )


def _run_quantiles(args, x: np.ndarray):
    from mpi_k_selection_tpu_torch import api
    from mpi_k_selection_tpu_torch.backends import cuda as backend
    from mpi_k_selection_tpu_torch.utils.interop import tensor_from_numpy, tensor_to_numpy

    qs = args.qs
    if (args.devices or 1) > 1:
        return _run_ranks(args, x, None)
    xd = tensor_from_numpy(x, args.device)
    seconds, values = time_fn(
        lambda: backend.quantiles(xd, qs, distribute=args.distribute), repeats=args.repeats, warmup=1,
        device=args.device,
    )
    values = tensor_to_numpy(values)
    record = _record(args, x.size, 0, values.tolist(), "quantiles", seconds)
    record.extra["quantiles"] = qs
    ok = True
    if args.verify:
        want = oracle_many(x, api.quantile_ranks(qs, x.size), sort_order=api.many_takes_sort(x.size, len(qs)))
        ok = values.tobytes() == want.tobytes()
        record.extra["oracle"] = want.tolist()
        record.extra["exact_match"] = ok
    return record, ok


def chunk_source(args):
    """The replayable chunk source of ``--streaming``, as the JAX CLI's:
    chunk i is ``datagen.generate(m, seed=SEED + i)``, so every pass reads
    the same stream while no more than ``--chunk-elems`` elements exist at
    once."""
    from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype

    n, chunk, dtype = args.n, args.chunk_elems, numpy_dtype(args.dtype)

    def source():
        off = i = 0
        while off < n:
            m = min(chunk, n - off)
            yield datagen.generate(m, pattern=args.gen, seed=args.seed + i, dtype=dtype)
            off += m
            i += 1

    return source


def _parse_ingest_workers(raw):
    """``--ingest-workers`` as given: ``auto`` and None stay symbolic,
    digits become an int, and the pipeline's resolver rejects the rest
    with its own message."""
    if raw is None or raw == "auto":
        return raw
    try:
        return int(raw)
    except (TypeError, ValueError):
        raise SystemExit(f"error: --ingest-workers must be auto or an int, got {raw!r}") from None


def _parse_width_schedule(raw):
    """``--width-schedule`` as the JAX CLI parses it: the mode strings,
    or a comma-separated width list, checked before any stream is read."""
    from mpi_k_selection_tpu_torch.streaming.chunked import validate_width_schedule

    schedule = raw
    if raw not in ("auto", "off"):
        try:
            schedule = tuple(int(w) for w in raw.split(",") if w.strip())
        except ValueError:
            raise SystemExit(f"error: --width-schedule must be auto, off, or comma-separated ints, got {raw!r}") from None
    try:
        return validate_width_schedule(schedule)
    except ValueError as e:
        raise SystemExit(f"error: {e}") from None


def _run_streaming(args, obs=None):
    from mpi_k_selection_tpu_torch import api
    from mpi_k_selection_tpu_torch.backends import cuda as backend
    from mpi_k_selection_tpu_torch.streaming import pipeline as _pl
    from mpi_k_selection_tpu_torch.streaming.spill import SpillStore
    from mpi_k_selection_tpu_torch.utils.profiling import PhaseTimer

    n = args.n
    if args.chunk_elems < 1:
        raise SystemExit("error: --chunk-elems must be >= 1")
    k = args.k if args.k is not None else max(1, n // 2)
    if not 1 <= k <= n:
        raise SystemExit(f"error: k={k} out of range [1, {n}]")
    source = chunk_source(args)
    depth = args.pipeline_depth
    workers = _parse_ingest_workers(args.ingest_workers)
    schedule = _parse_width_schedule(args.width_schedule)
    # --devices caps the round-robin ingest set; the record names what it resolved to
    devices = args.devices
    n_ingest = len(_pl.resolve_ingest(args.device, devices)[1])
    knobs = dict(pipeline_depth=depth, ingest_workers=workers, width_schedule=schedule, pack_spill=args.pack_spill,
                 device=args.device, devices=devices)
    # a timer of the pipeline's own: its producer phases run beside the
    # solve, so folding them into the solve timer would overstate its total
    ptimer = PhaseTimer() if args.profile or args.trace_events or args.metrics_json else None
    # --spill force with one run tees into a store the CLI owns, so the
    # certificate reads the spilled generation 0 instead of the source;
    # with --repeats each run makes (and removes) a store of its own
    store = SpillStore(args.spill_dir) if args.spill == "force" and args.repeats <= 1 else None
    try:
        # --chaos SEED: the solve reads the stream through the seeded plan's
        # injector; --verify and --check read the clean stream
        injector, solve_source, armed = None, source, contextlib.nullcontext()
        if args.chaos is not None:
            from mpi_k_selection_tpu_torch.faults import FaultInjector, FaultPlan, inject

            injector = FaultInjector(FaultPlan.seeded(args.chaos, n_chunks=max(1, -(-n // args.chunk_elems))),
                                     obs=obs)
            solve_source, armed = injector.wrap_chunk_source(source), inject(injector)
        with armed:
            seconds, answer = time_fn(
                lambda: backend.kselect_streaming(solve_source, k, spill=store if store is not None else args.spill,
                                                  spill_dir=args.spill_dir, retry=args.retry, timer=ptimer, obs=obs,
                                                  **knobs),
                repeats=args.repeats, device=args.device,
            )
        record = _record(args, n, k, answer.item(), "streaming-chunked", seconds)
        record.n_devices = n_ingest
        record.extra.update(chunks=-(-n // args.chunk_elems), chunk_elems=args.chunk_elems, pipeline_depth=depth,
                            ingest_devices=n_ingest, ingest_workers=workers, spill=args.spill,
                            width_schedule=list(schedule) if isinstance(schedule, tuple) else schedule,
                            pack_spill=args.pack_spill, retry=args.retry)
        if injector is not None:
            record.extra["chaos"] = {
                "seed": args.chaos,
                "plan": [{"site": f.site, "index": f.index, "kind": f.kind, "attempts": list(f.attempts)}
                         for f in injector.plan.specs],
                "fired": list(injector.fired),
            }
        if ptimer is not None and ptimer.phases:
            reps = max(1, args.repeats)
            record.extra["pipeline_phases"] = {
                name: {"seconds": d["seconds"] / reps, "calls": max(1, d["calls"] // reps)}
                for name, d in ptimer.as_dict().items()
            }
            # a ratio of sums over the same runs: --repeats leaves it as it is
            hidden = _pl.ingest_hidden_frac(ptimer)
            if hidden is not None:
                record.extra["ingest_hidden_frac"] = round(hidden, 4)
        ok = True
        if args.verify or args.check:
            # the certificate shares only the trace channel: its spans belong
            # on the same timeline, its counters not in the solve's registry
            from mpi_k_selection_tpu_torch import obs as obs_lib

            cert_obs = obs_lib.Observability(trace=obs.trace) if obs is not None and obs.trace is not None else None
            # under --chaos a persistent disk fault may have damaged the
            # store's generation 0 (the solve rebuilt from the source): certify
            # against the clean source, the stronger check
            cert_src = store if store is not None and injector is None else source
            less, leq = api.streaming_rank_certificate(cert_src, answer, retry=args.retry, obs=cert_obs, **knobs)
            cert_ok = less < k <= leq
            record.extra.update(rank_certificate=[less, leq], certificate_ok=cert_ok)
            ok = cert_ok
        if args.verify:
            want = oracle(np.concatenate(list(source())), k)  # the streamed descent answers in key order
            exact = np.asarray(answer).tobytes() == want.tobytes()
            ok = ok and exact
            record.extra.update(oracle=want.item(), exact_match=exact)
        return record, ok
    finally:
        if store is not None:
            store.close()


def _check_resident(args, x: np.ndarray, record, ok: bool) -> bool:
    """``--check`` of a resident k-th answer: its rank certificate over the
    whole array (utils/debug.py), ``less < k <= leq``."""
    from mpi_k_selection_tpu_torch.utils.debug import rank_certificate
    from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype, tensor_from_numpy

    value = np.asarray(record.answer, numpy_dtype(args.dtype))
    less, leq = (int(c) for c in rank_certificate(tensor_from_numpy(x, "cpu"), tensor_from_numpy(value, "cpu")))
    cert_ok = less < record.k <= leq
    record.extra.update(rank_certificate=[less, leq], certificate_ok=cert_ok)
    return ok and cert_ok


def _run_topk_seq(args, x: np.ndarray):
    """Top-k on the seq backend (NumPy), values checked against the
    key-order oracle by value."""
    from mpi_k_selection_tpu_torch.backends import seq

    k = args.topk
    seconds, (values, _) = time_fn(lambda: seq.topk(x, k, largest=not args.smallest), repeats=args.repeats, device="cpu")
    record = ResultRecord(
        answer=values.reshape(-1)[:8].tolist(), n=x.size, k=k, backend="seq", algorithm="topk", dtype=args.dtype,
        seconds=seconds, device="host",
    )
    ok = True
    if args.verify:
        oracle_fn = batched_topk_oracle if x.ndim == 2 else topk_oracle
        want, _ = oracle_fn(x, k, largest=not args.smallest)
        ok = bool(np.array_equal(values.astype(np.float64), want.astype(np.float64), equal_nan=True))
        record.extra["exact_match"] = ok
    return record, ok


def _run_topk(args, x: np.ndarray):
    from mpi_k_selection_tpu_torch.backends import cuda as backend
    from mpi_k_selection_tpu_torch.utils.interop import tensor_from_numpy, tensor_to_numpy

    if args.backend == "seq":
        return _run_topk_seq(args, x)
    k = args.topk
    xd = tensor_from_numpy(x, args.device)
    seconds, (values, idx) = time_fn(
        lambda: backend.topk(xd, k, largest=not args.smallest, method=args.topk_method),
        repeats=args.repeats, warmup=1, device=args.device,
    )
    values = tensor_to_numpy(values)
    record = _record(args, x.size, k, values.reshape(-1)[:8].tolist(), "topk", seconds)
    if args.batch:
        record.extra["batch"] = args.batch
    ok = True
    if args.verify:
        oracle_fn = batched_topk_oracle if x.ndim == 2 else topk_oracle
        want_v, want_i = oracle_fn(x, k, largest=not args.smallest)
        ok = values.tobytes() == want_v.tobytes() and np.array_equal(idx.cpu().numpy(), want_i)
        record.extra["exact_match"] = ok
    return record, ok


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        return serve_main(argv[1:])
    if argv and argv[0] == "monitor":
        return monitor_main(argv[1:])
    args = build_parser().parse_args(argv)
    from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype

    if args.quantiles is not None and args.topk is not None:
        raise SystemExit("error: --quantiles and --topk are exclusive")
    if args.batch and args.topk is None:
        raise SystemExit("error: --batch only applies to --topk mode")
    if args.streaming and (args.quantiles is not None or args.topk is not None):
        raise SystemExit("error: --streaming is k-th mode only")
    if args.check and (args.quantiles is not None or args.topk is not None):
        raise SystemExit("error: --check applies to k-th selection; use --verify for top-k and --quantiles")
    if args.backend == "mpi" and (args.topk is not None or args.quantiles is not None):
        raise SystemExit("error: the mpi backend runs the k-th mode only")
    if args.backend != "cuda" and (args.streaming or args.quantiles is not None):
        raise SystemExit("error: --streaming and --quantiles run on the cuda backend")
    if args.devices is not None and args.devices < 1:
        raise SystemExit("error: --devices must be >= 1")
    if (args.devices or 1) > 1 and (args.backend != "cuda" or args.topk is not None):
        raise SystemExit("error: --devices runs the cuda backend's k-th, --quantiles and --streaming modes")
    if args.quantiles is not None:
        try:
            args.qs = [float(q) for q in args.quantiles.split(",") if q.strip()]
        except ValueError as e:
            raise SystemExit(f"error: bad --quantiles value: {e}") from e
    from mpi_k_selection_tpu_torch.obs import wiring as _wr
    from mpi_k_selection_tpu_torch.utils import profiling

    # the telemetry behind --metrics-json / --trace-events / --debug-bundle
    # (None: off); the flight ring keeps the recent tail for the bundle
    obs = None
    if args.metrics_json or args.trace_events or args.debug_bundle:
        from mpi_k_selection_tpu_torch import obs as obs_lib

        obs = obs_lib.Observability(metrics=obs_lib.MetricsRegistry() if args.metrics_json else None,
                                    trace=obs_lib.TraceRecorder() if args.trace_events else None,
                                    flight=True if args.debug_bundle else None)
    timer = profiling.PhaseTimer(recorder=_wr.span_recorder(obs))
    tracer = (lambda: profiling.trace(args.trace_dir)) if args.trace_dir else contextlib.nullcontext
    try:
        if args.streaming:
            with tracer(), timer.phase("solve"):
                record, ok = _run_streaming(args, obs)
        else:
            run = _run_quantiles if args.quantiles is not None else _run_topk if args.topk is not None else _run_kth
            batch = (args.batch,) if args.batch else ()
            with timer.phase("generate"):
                x = datagen.generate(args.n, pattern=args.gen, seed=args.seed, dtype=numpy_dtype(args.dtype),
                                     batch=batch)
            with tracer(), timer.phase("solve"):
                record, ok = run(args, x)
            if args.check:
                with timer.phase("check"):
                    ok = _check_resident(args, x, record, ok)
    except (ValueError, RuntimeError, TimeoutError) as e:
        # a failing run still writes the bundle it was asked for
        _write_debug_bundle(args, None, obs, reason="cli-error", exc=e)
        raise SystemExit(f"error: {e}") from e
    return _finish(args, record, ok, timer, obs)


def _write_debug_bundle(args, record, obs, *, reason, exc=None) -> None:
    """``--debug-bundle PATH``: the flight ring's debug bundle
    (obs/flight.py) written to PATH, on the success exit and on the error
    exit. An unwritable PATH warns instead of masking the run's outcome."""
    path = args.debug_bundle
    if not path or obs is None or obs.flight is None:
        return
    try:
        obs.flight.dump(path, obs=obs, reason=reason,
                        extra=None if exc is None else {"error": f"{type(exc).__name__}: {exc}"})
    except OSError as write_err:
        print(f"warning: --debug-bundle {path}: {write_err}", file=sys.stderr)
        return
    if record is not None:
        record.extra["debug_bundle"] = path


def _finish(args, record, ok: bool, timer, obs=None) -> int:
    """The run's telemetry files, its record (JSON or the reference's
    style) and the exit code."""
    _write_debug_bundle(args, record, obs, reason="cli")
    if obs is not None:
        if obs.metrics is not None:
            from mpi_k_selection_tpu_torch.obs.metrics import collect_runtime

            # the driver's phases (generate / solve / check) on top of what
            # the descent collected; counters span every repeat
            collect_runtime(obs.metrics, timer=timer)
            obs.metrics.gauge("run.repeats").set(max(1, args.repeats))
            with open(args.metrics_json, "w") as f:
                f.write(obs.metrics.to_json(indent=2))
            record.extra["metrics_json"] = args.metrics_json
        if obs.trace is not None:
            obs.trace.write(args.trace_events)
            record.extra["trace_events"] = args.trace_events
    if args.trace_dir:
        record.extra["trace_dir"] = args.trace_dir
    if args.profile:
        record.extra["phases"] = timer.as_dict()
    if args.json:
        print(record.to_json())
    else:
        record.print_reference_style()
        if args.verify:
            print(f"oracle check: {'exact match' if ok else 'MISMATCH'}")
        if args.check:
            print(f"rank certificate: {'ok' if record.extra.get('certificate_ok') else 'FAILED'}")
        if args.profile:
            print(timer.report())
            phases = record.extra.get("pipeline_phases")
            if phases:  # the producer's phases run beside the solve
                print("streaming phases (producer concurrent with solve, per repeat):")
                for name, d in sorted(phases.items(), key=lambda kv: -kv[1]["seconds"]):
                    print(f"  {name:<24} {d['seconds'] * 1e3:10.3f} ms  ({d['calls']}x)")
                hidden = record.extra.get("ingest_hidden_frac")
                if hidden is not None:
                    print(f"  ingest_hidden_frac       {hidden:10.4f}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
