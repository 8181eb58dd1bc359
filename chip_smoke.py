#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mpi_k_selection_tpu_torch``) on one
CUDA card: ``python3 chip_smoke.py`` from the root of the repository.

Phases, each of which must pass (any failure exits non-zero):

1. Build the kernels of ``mpi_k_selection_tpu_torch/csrc`` with ``nvcc``
   (one process per source, all at once) and print ``ptxas`` registers,
   shared memory and spills.
2. Hold each kernel against its plain PyTorch version, exactly (integer
   counts, no tolerance; top-k values as bit patterns), on 2^26 seeded
   random words, 32- and 64-bit and every ``key_op``: the histogram with
   and without a prefix, ``match_counts``, the multi-prefix histogram at K
   in {1, 3, 64} with a repeated prefix and radix widths 4 and 8 and on
   its hardest prefix sets (reversed, shuffled, 16 prefixes 4 times each,
   absent from the data, all equal on all-equal words, K=300 at radix
   width 8, a misaligned view), ``match_counts`` also at K in {1, 3, 4,
   64, 120, 160, 2100} (two launches) with repeated prefixes and prefixes
   no key holds, at every resolved width under both of its lookups, on one
   hot prefix every key holds, on misaligned views and ragged tails and at
   K=64 on widened 8- and 16-bit keys, and
   ``tau_counts`` in both directions against a key of the data and one
   absent from it; and the batched top-k kernel at (4096, 32768) float32
   for k in {1, 8, 9, 16} and bfloat16 for k in {8, 16}, values and
   positions (and its values-only launch), on normal rows, on adversarial
   rows (a top-16 inside one lane, ascending and descending rows, -inf
   rows, heavy ties, +-0.0 at the k boundary, NaNs of both signs) and on
   rows of equal keys that straddle lanes and loads; and the sweep kernel
   (``sweep_ingest``) on a 2^26-word bucket of random words, 32- and
   64-bit, ``n_valid`` below the bucket, two key
   transforms, exactly: each part alone and all five together, K in {1, 4}
   histogram prefixes at radix widths 4 and 8 and K=70 (35 prefixes twice,
   more than go by value), a sparse collect spec, one every key matches,
   four specs and a two-spec tee union, a certificate key present and
   absent, sketches of 8, 16 and 20 bits; the sketch part at 15, 16 and
   20 bits on skewed buckets (one hot counter, the last counter, two hot
   counters sharing a word in alternating keys, one block's counter
   brought exactly to 2^16 and to 2^16 + 1, pads only), and 16-bit keys
   of each 16-bit dtype (random, all one key) through the sketch
   consumer's launch (the histogram part at a 16-bit digit).
3. Drive the main paths, each with the launch counts set to 0 just before
   it and read just after (each of its kernels must have launched and no
   plain version may have run), each answer equal
   bit for bit to a NumPy oracle over the same ``datagen`` data: the
   median and k in {1, 250, N/2, N} of 2^30 int32 ``uniform`` (seed 0),
   2^27 float64 ``normal`` and 2^27 int32 ``equal`` (the median's rank
   certificate checked); ``quantiles`` at 0.5/0.9/0.99/0.999 of the 2^30
   int32 and the 2^27 float64 array; ``kselect_many`` with 64 evenly
   spaced ranks of 2^27 int32 (its peak memory printed); ``topk`` (k=128,
   largest and smallest, indices and value bits) of 2^26 float32
   ``normal`` and of the 2^27 float64 array; ``batched_topk`` through
   ``auto`` (one launch of the block kernel: values and positions) of
   (4096, 32768) float32 ``normal`` (BASELINE.md's batched top-k) for k in
   {1, 8, 9, 16}, of its bfloat16 cast for k in {8, 16}, and of the
   adversarial rows of phase 2, against a per-row oracle on every row
   (indices and value bits; its peak memory printed);
   ``batched_median`` of
   the float32 array against ``np.sort``. Then the streamed paths (the
   launch counts, per call, of the sweep kernel only: once per chunk per
   pass, counted at the source): ``kselect_streaming`` of 2^31 int32
   ``uniform`` held on the host as 32 chunks of 2^26 (chunk i of seed i;
   halved when the host has less than 48 GiB free) at k in {1, 250, N/2,
   N}, at depth 2 and 0; ``kselect_streaming_many`` at the p50/p90/p99/
   p99.9 ranks; the median of 2^30 float64 ``normal`` (32 chunks of 2^25);
   ``streaming_rank_certificate`` of each answer; the int32 median again
   with ``ingest_workers=4`` (the pooled host data plane), the same bits.
   Each answer passes NumPy's certificate over the host chunks (sum of
   #(key < v) < k <= sum of #(key <= v), in key space) and each streamed
   certificate equals it; the device's peak stays within depth + 1 staged
   chunks (depth + 1 + W with W > 1 ingest workers) plus the collect
   buffers. Every kernel must have launched over the paths.
4. Time on the card with CUDA events (warm), each time beside its bound
   (the larger of the bytes the work must move at 3.35 TB/s and its
   operations at the 67 TFLOP/s scalar rate): the selects with
   ``torch.kthvalue`` as a one-call yardstick; ``quantiles`` at K=4
   against four single selects; the shared radix walk against the sort
   leg at K = 4, 64 and 128 (the crossover of the many-ranks dispatch);
   the multi-prefix histogram at the answers' prefixes: K=4 at pass 1 of
   2^30 int32, 2^27 float64 and 2^27 int32 ``equal``, K=64 and 128 at pass
   1 and K=64 at a deep pass of 2^27 int32, K=64 at pass 1 of 2^27 float64,
   each with its share of the bound; the match count at the collects of
   more than one rank (the quantiles' K=4 of 2^30 int32 and 2^27 float64,
   the many-ranks walk's K=64 and K=120 of 2^27 int32, at the cutover
   width), beside its bound (the read and the K x R counts), its plain
   version and ``searchsorted`` + ``bincount``;
   ``topk`` against ``torch.topk`` and a full ``torch.sort`` (yardsticks
   only: the port calls neither for top-k); the batched top-k kernel
   (values and positions, and its values-only launch), ``batched_topk``
   end to end and ``batched_median``, with ``torch.topk`` /
   ``torch.kthvalue`` along the rows as yardsticks; each kernel at its
   main-path shape beside its plain version, held exactly against it on
   the same tensor first (the kernels
   line reports that comparison's error); the streaming median and
   quantiles of the 2^31 int32 stream at depth 2 and 0 (best of two
   calls each) beside their bound
   (passes x bytes over the host-to-card rate of a pinned 2^26-word copy
   timed in the same run) and beside the resident median of the same data
   whole on the card (a fault there is printed and the resident median
   timed at half the size); the sweep kernel at each launch kind the streamed paths
   issue, on the int32 stream's chunk 0 and the float64 stream's chunk 0
   (a first pass, one and 4 prefixes, the collect of one and of 4 specs, a
   certificate, the sketch alone at 16 bits), on a one-hot 2^26-word int32
   chunk (the sketch alone, every key in one counter) and on 2^26
   bfloat16 keys through the sketch consumer's launch (the 16-bit
   histogram part), each sketch launch also as its plain version and
   beside ``torch.bincount`` of the top 16 key bits (of the 16-bit digit)
   and ``torch.aminmax``, its counts summing to the chunk's length; held
   exactly against its plain version first, the kernel
   alone (torch.profiler) and the whole call beside a bound that counts
   the returned survivor buffers (L words each) and beside the old bound
   that counted the survivors only; and the sweep kernel at a 2^26-word
   bucket (a histogram with one collect spec, and all five parts) beside
   ``torch.bincount`` + ``torch.masked_select`` on the same tensor.
5. Profile two medians, one K=4 ``quantiles`` of 2^30 int32, one
   ``topk`` of 2^26 float32, one ``batched_topk`` k=8 of (4096, 32768)
   float32 and one streaming median of the 2^31 int32 stream with
   ``torch.profiler``: device time by kernel and copy, and the device's
   idle share.
6. The distributed paths on 4 ranks spawned by
   ``parallel/multihost.py:run_ranks``, every rank on ``cuda:0`` over gloo
   (one card: NCCL takes one card a rank), the global arrays written once
   to a temporary directory and memory-mapped by every rank, which places
   only its own shard: the median and the 0.5/0.9/0.99/0.999 quantiles of
   2^30 int64 ``uniform`` (seed 0; BASELINE.md's "N=1B int64"), CGM over
   16M int32 at k = N/2 (BASELINE's CGM config) and over 10^8 int32 at
   k = 150 (the reference's own), ``distributed_topk`` k=128 of 2^26
   float32 ``normal``: each answer equal to its NumPy oracle (and to the
   rank's second run); each path driven with the launch counts set to 0
   on every rank just before it and read just after (its kernels launched
   on every rank, no plain call); its wall time on rank 0 (CUDA events
   after a barrier), each rank's launches, collectives and time in them,
   the CGM rounds. ``distributed_sketch`` (16 bits) of the 10^8 int32 and
   (every key of a shard in one counter) of the 2^30 int64, each timed:
   every rank's sketch equal, rank 0's equal to NumPy's sketch of the
   whole array bit for bit. Then the native ``mpi`` backend (4 forked host
   ranks) on the 10^8 case, equal to NumPy and to the CGM on the card, and
   the resident single-device median of the same 2^30 int64 as a yardstick.
7. This slice's paths on the streams of phase 3 (``phase_sketch_staging``):
   the host-copy probe (host copies into pinned memory from 1, 2 and 4
   threads, the link idle and busy: whether a pool of ingest workers could
   copy faster); the streamed median of the int32 and of the float64
   stream at depth 2, each under the profiler (answer against phase 3's,
   wall ms, idle share, the host copy per chunk, pinned bytes in use and
   peak device memory against the ``depth + 1`` staging bounds);
   ``StreamingQuantiles.update_stream`` of the int32 stream against
   NumPy's sketch bit for bit (and once under the profiler: the sweep
   kernel's device time over the stream), the p50/p90/p99/p99.9 answers inside its bounds, and
   ``refine_quantiles`` exact, its passes beside the unseeded descent's;
   the float64 stream's sketch and refined median; the ``Monitor`` over a
   one-shot generator of the int32 chunks (window 8, a sample every 8
   chunks), exact and decayed, each window against NumPy's counts.

8. The spill descent (``phase_spill``, run after phase 7 and before phase
   6) on the int32 stream of phase 3, halved when the disk under the temp
   dir has less than 1.5x its bytes free: the median of the first half of
   the stream (the run's time, since PR 13) read as a one-shot generator
   with ``spill="auto"``, under the profiler (answer against NumPy's
   certificate, wall ms, its ``pass_log``, the bytes over the link
   against the replay's, the peak bytes on disk sampled after each
   commit, the sweep kernel's device time and the idle share); on the
   first quarter (2^29 keys; the run's time), the p50/p90/p99/p99.9 with
   ``spill="force"`` (against NumPy's
   certificates, with its ``pass_log``),
   ``StreamingQuantiles.update_stream(one_shot, spill=store)``, then
   ``refine_quantiles`` and ``streaming_rank_certificate`` from the store
   (against those answers and NumPy's certificate); each call's sweep launches
   counted against the chunks each pass read; and row 8's tee launch kind
   (a histogram under one 8-bit prefix and a one-spec tee) on chunk 0 of
   each stream, held exactly against the plain version, then timed as
   phase 4 times the other kinds, beside its bound (the read and the
   L-word survivor buffer), the plain version and ``torch.bincount`` +
   ``torch.masked_select``.

9. The width schedule and packed spill records (``phase_width_pack``, run
   after phase 8 and before phase 6): the replay median of each stream
   with ``width_schedule="off"`` and ``"auto"`` under the profiler (answer
   against phase 3's, wall ms, reads and bytes over the link, idle share);
   the one-shot median of the int32 stream's first half with ``spill="auto"``
   and both knobs on ``"auto"`` under the profiler beside phase 8's
   format-v1 call on the same chunks (its
   ``pass_log`` with logical and physical bytes, each pass's host ms in
   the record work from ``spill.HOST_TIMES``, the peak on disk, the bytes
   over the link, the idle share); on the first quarter, as phase 8's
   twins: quantiles K=4 ``spill="force"`` with both knobs;
   ``StreamingQuantiles(width_schedule="auto",
   pack_spill="auto")``'s one-shot ``update_stream`` into a store, then
   ``refine_quantiles`` and the rank certificate from it; the digit pack
   of chunk 0 on the card against the host's; and row 8 at each launch
   kind ``"auto"`` adds (the 16-bit first pass; digits under 16- and
   32-bit prefixes, one and four; the spill pass's tee beside one), held
   exactly against the plain version, then timed as phase 4 times the
   other kinds, beside ``torch.bincount`` of the same digits. Phase 2
   also holds the histogram part at 16-20-bit digits (no prefix, one and
   four prefixes) and a tee beside an 8- and a 16-bit digit.

10. Multi-device staging and the telemetry (``phase_multidevice_obs``,
   run after phase 9 and before phase 6) on the streams of phase 3: the
   int32 replay median at depth 2 on one slot, on two slots of ``cuda:0``
   (a window of two bundles) and on two slots with every telemetry
   channel on, each under the profiler (answers against phase 3's, wall
   ms, idle share; the instrumented stream's invariants, chunk events,
   ``ingest.*`` and ``staging_pool.*`` metrics and trace tracks checked);
   the float64 median bare and instrumented; the one-shot spilled median
   with both width knobs ``"auto"`` on two slots with telemetry, on the
   first half of the int32 stream (its ``stream.pass`` events against the
   ``pass_log``, its ``spill.*`` counters against the log's sums);
   ``kselect`` and ``kselect_many`` of the 2^30 int32 array with telemetry
   (``resident.select`` events, the ledger's ``api.select`` site); and,
   with two cards or more, the int32 median with one slot a card (per-card
   chunk counts and sweep launches from the profiler, per-card busy time,
   the wall beside one slot). ``python3 chip_smoke.py --phase10`` runs the
   build, the streams (certified by NumPy) and phase 10 alone: the
   measurement for a host of several cards.

11. The fault harness and the recovery policies (``phase_faults``, run
   after phase 10 and before phase 6) on the int32 stream's first half
   (2^30 keys, 16 chunks of 2^26): the spilled median with no injector
   (the twin, against NumPy's certificate), then under a plan that strikes
   every streamed site and kind once (source raise and stall, stage raise
   and stall, a survivor write raised, a record read corrupt once, one
   corrupted and one truncated on disk): its answer the twin's bits,
   ``injector.fired`` the plan, a rebuilt pass read from the source in the
   pass log, the ``faults.*`` counters by site and action, row 8's
   histogram, tee and collect kinds launched; ``spill="auto"`` on a
   one-shot stream with an ENOSPC on the first survivor generation (the
   pass run again without its tee, a ``degrade`` event); the hard form
   (a stage fault on every attempt) raising ``RetryExhaustedError(site=
   "stage", attempts=3)`` with exactly one flight bundle and nothing left
   behind (threads, stores, files, the card's allocated memory); the
   ``Monitor`` with its registry served by ``start_metrics_server`` (a
   mid-run scrape parsed, the last equal to the registry's text); and the
   CLI in subprocesses (``--chaos 7 --check --debug-bundle`` on 2^28 keys,
   ``monitor --buckets 8``). ``python3 chip_smoke.py --phase11`` runs the
   build, the stream's first half and phase 11 alone.

12. The resident-dataset query server (``phase_serve``, run after phase 11
   and before phase 6): one ``KSelectServer(window=0.002, flight=True)``
   with telemetry holding the 2^30 int32 array of phase 3 (cloned, warmed),
   the 2^27 float64 array (warmed) and the int32 stream's first half as
   a stream dataset, served by ``start_http_server(port=0)``: each op alone
   with the launch counts set to 0 around it (rows 1-6 and 8 launched, no
   plain version called), then 8 HTTP client threads (exact ranks,
   ``kselect_many`` of 4 ranks, p50/p90/p99/p99.9 in each tier, ``topk``
   k=128 largest and smallest, the median's certificate, two exact stream
   queries), every exact answer NumPy's (the stream's by NumPy's
   certificate), sketch bounds around the truth, auto answers the exact
   ones, a coalesced batch wider than 1, no build on the request path
   after warmup; the latency a tier, the queries a second at window 0 and
   0.002, one exact rank served beside a direct ``kselect``, the warmup's
   and the cached sort's time and peak memory, the program cache's
   counts; nothing left after ``close()`` (threads, allocated bytes); the
   CLI's ``serve --n 2^28 --warmup --quit-after 4`` in a subprocess
   against ``datagen`` data. ``python3 chip_smoke.py --phase12`` runs the
   build and phase 12 alone.
13. The analyzer and the 16-bit repair (``phase_analysis``; after phase 12
   and before phase 6): the median and quantiles K=4 of the 2^30 int32
   array at ``radix_bits=16`` beside the default 4 (the 16-bit passes on
   row 8, every answer NumPy's), the 16-bit route's launch kinds against
   their bound and ``torch.bincount``; the port's analyzer over its tree
   (0 findings, 0 stale suppressions); the contracts KSC101-105 on the
   card; the lock-order sanitizer around a ``KSelectServer(window=0.002)``
   session (8 clients x 16 exact ranks of 2^26 int32) and a two-slot
   streamed median of the int32 stream's first half: 0 cycles, no
   conflict with the static lock graph, queries a second with it on and
   off, a flight bundle carrying the observed graph. Phase 2 holds the
   16-bit route (the top digit, one prefix, K=4 and 64 prefixes) against
   the plain version. ``python3 chip_smoke.py --phase13`` runs the build
   and phase 13 alone.
14. The pooled host data plane and spill decode (``phase_ingest_pool``;
   after phase 13 and before phase 6), on the int32 stream's first half
   (phase 11's 16 chunks of 2^26), at ``ingest_workers`` 1 and 4: the
   one-shot spilled median with ``pack_spill="auto"`` into a store of the
   script's, then ``streaming_rank_certificate`` from the packed store it
   keeps, each under the profiler with a PhaseTimer: the answers the same
   bits at both widths and NumPy's certificate, every generation's files
   byte-identical across the widths, the sweep kernel alone launched, no
   ``ksel-ingest-*`` thread left; wall ms, ``pass_host_ms``, ``HOST_COPY``,
   the idle share, ``ingest_hidden_frac``, ``encode_hidden_frac`` and the
   peak device memory of each. ``python3 chip_smoke.py --phase14`` runs the
   build, the stream's first half and phase 14 alone.
15. ``early_exit_budget`` (``phase_early_exit``; after phase 14 and before
   phase 6), on phase 3's resident arrays: the median and k in {1, N} of
   2^30 int32 ``uniform`` and the medians of 2^27 float64 ``normal``, 2^26
   float32 ``normal`` and 2^27 int32 ``equal``, at budgets 8192 and 4096
   beside ``cutover="auto"`` and ``cutover=None``: each answer NumPy's bits,
   the histogram kernel once a pass and ``match_counts`` once a collect as
   the data predicts, no plain call, the host syncs counted; each
   configuration timed warm with CUDA events (10 interleaved calls), the
   medians' peak device memory, the int32 medians profiled.
   ``python3 chip_smoke.py --phase15`` runs the build, those arrays and
   phase 15 alone.

The timed kernel rows of phase 4 also time the nearest torch composition
of each of rows 1-6 on the same tensor (a ``torch.bincount`` of the digits
under the prefix mask; a row-wise compare-and-sum), held equal to the
kernel's output first: the kernels line's ``library_ms``.

The last lines are the card's ``nvidia-smi`` name and power limit, one JSON
object describing every kernel, and
``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
OPS_PER_KEY = 5  # xor mask, xor, shift, mask or compare, count
# the multi-prefix histogram: those, and one prefix lookup whatever K (a
# range test and one probe of its prefix table, csrc/histogram.cu)
MULTI_OPS_PER_KEY = OPS_PER_KEY + 2
HIST_SRC = "mpi_k_selection_tpu/ops/pallas/histogram.py"
HIST_CU = "mpi_k_selection_tpu_torch/csrc/histogram.cu"
TOPK_CU = "mpi_k_selection_tpu_torch/csrc/topk.cu"
SWEEP_CU = "mpi_k_selection_tpu_torch/csrc/sweep_ingest.cu"
SWEEP_SRC = "mpi_k_selection_tpu/ops/pallas/sweep_ingest.py:283"
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "radix_histogram32": (HIST_CU, HIST_SRC + ":369"),  # pallas_radix_histogram
    "radix_histogram64": (HIST_CU, HIST_SRC + ":534"),  # pallas_radix_histogram64
    "match_counts32": (HIST_CU, HIST_SRC + ":1023"),  # pallas_match_counts
    "match_counts64": (HIST_CU, HIST_SRC + ":1023"),  # pallas_match_counts (64-bit keys)
    "radix_histogram_multi32": (HIST_CU, HIST_SRC + ":765"),  # pallas_radix_histogram_multi
    "radix_histogram_multi64": (HIST_CU, HIST_SRC + ":861"),  # pallas_radix_histogram64_multi
    "tau_counts32": (HIST_CU, HIST_SRC + ":1142"),  # pallas_tau_counts
    "tau_counts64": (HIST_CU, HIST_SRC + ":1142"),  # pallas_tau_counts (64-bit keys)
    "batched_topk32": (TOPK_CU, "mpi_k_selection_tpu/ops/pallas/topk.py:183"),  # float32, values and positions
    "batched_topk16": (TOPK_CU, "mpi_k_selection_tpu/ops/pallas/topk.py:183"),  # bfloat16
    "sweep_ingest32": (SWEEP_CU, SWEEP_SRC),  # sweep_ingest_core, 32-bit key words
    "sweep_ingest64": (SWEEP_CU, SWEEP_SRC),  # 64-bit key words (the JAX package's XLA tier there)
}
QS = (0.5, 0.9, 0.99, 0.999)
TOPK = 128
BATCH, WIDTH = 4096, 32768  # BASELINE.md's batched top-k: (B, D) float32, k=8
BATCH_KS = {torch.float32: (1, 8, 9, 16), torch.bfloat16: (8, 16)}
SWEEP_BUCKET = 1 << 26  # the sweep kernel's checks and timings: one streamed chunk
CHECK_WORDS = 1 << 26  # phase 2's random words (phase 4 holds each kernel at its main-path shape)
BUDGET_S = 1200  # the whole script's time budget, the build included
# 2^31 int32 uniform, chunk i of seed i (8 GiB on the host): past one int32 count, and half of 2^32 for the run's time
STREAM_CHUNK, STREAM_CHUNKS = 1 << 26, 32
F64_CHUNK, F64_CHUNKS = 1 << 25, 32  # 2^30 float64 normal (8 GiB)
SKETCH_BITS = 16  # the sketches' default resolution: 4-bit digits x 4 levels
HOST_GIB_NEEDED = 48  # below this much free host memory the streams are halved


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound(nbytes: float, nkeys: float, ops_per_key: float = OPS_PER_KEY):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the key operations over the scalar rate."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = nkeys * ops_per_key / SCALAR_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def rand_words(n: int, bits: int, gen) -> torch.Tensor:
    """``n`` uniformly random ``bits``-wide words on the card (every bit
    pattern, NaNs included when read as floats)."""
    w = torch.randint(-(1 << 31), 1 << 31, (n * bits // 32,), dtype=torch.int64, device="cuda", generator=gen)
    w = w.to(torch.int32)
    return w if bits == 32 else w.view(torch.int64)


def absent_key(keys: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """A key near ``start`` that no element of ``keys`` holds."""
    for d in range(1, 1 << 16):
        t = start ^ d
        if not bool((keys == t).any()):
            return t
    fail("no absent key found")


def phase_build():
    from mpi_k_selection_tpu_torch.ops.cuda import build

    libs = build.build_all()
    for stem, path in libs.items():
        print(f"[build] {stem}: {path.name}")
        for line in build.build_log(path).splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "entry function" in line:
                print(f"[build]   {line.strip()}")
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
    from mpi_k_selection_tpu_torch.ops.cuda import topk as T

    H._lib()  # load and bind once
    T._lib()
    S._lib()


def adversarial_rows(x: torch.Tensor, gen) -> torch.Tensor:
    """A copy of the (B, D) float32 ``x`` in which every 64th row, from row
    f, carries fixture f: a top-16 at a stride of 128 elements (one lane of
    32 x 4 float32, from the lane's first loads or later), at a stride of
    256 (one lane of 32 x 8 bfloat16), ascending and descending rows, -inf
    rows, heavy ties, +-0.0 at the boundary of k in {1, 8, 9, 16} in either
    position order and in one lane, and NaNs of both signs. The fixtures
    that put a NaN among a row's top k take every 512th row only (32 rows
    each)."""
    a = x.clone()
    b, d = a.shape
    dev = a.device
    big = 100.0 + torch.arange(16, dtype=a.dtype, device=dev)
    nan, neg_nan = float("nan"), -float("nan")
    inf = float("inf")

    def rows(f, every=64):
        return slice(f, b, every)

    def at(*pos):
        return torch.tensor(pos, device=dev).reshape(-1)

    a[rows(0), 5 + 128 * torch.arange(16, device=dev)] = big
    a[rows(1), (128 * torch.arange(4, device=dev)[:, None] + torch.arange(4, device=dev)).reshape(-1)] = big
    a[rows(2), 2 + 128 * torch.arange(40, 56, device=dev)] = big
    a[rows(3), (256 * torch.arange(2, device=dev)[:, None] + torch.arange(8, device=dev)).reshape(-1)] = big
    a[rows(4), 7 + 256 * torch.arange(100, 116, device=dev)] = big.flip(0)
    a[rows(5)] = torch.arange(d, dtype=a.dtype, device=dev)
    a[rows(6)] = torch.arange(d, dtype=a.dtype, device=dev).flip(0)
    a[rows(7)] = -inf
    a[rows(8), : d - 4] = -inf
    a[rows(9)] = torch.randint(0, 11, a[rows(9)].shape, device=dev, generator=gen).to(a.dtype)
    f = 10
    for k in (1, 8, 9, 16):  # k-1 winners, then +0.0 (the k-th) and -0.0
        for pneg, ppos in ((1000, 2000), (2000, 1000), (1000 + 128, 1000)):
            a[rows(f)] = -1.0
            a[rows(f), 64 * torch.arange(k - 1, device=dev)] = 5.0
            a[rows(f), at(pneg)] = -0.0
            a[rows(f), at(ppos)] = 0.0
            f += 1
    a[rows(f)] = torch.where(torch.rand(a[rows(f)].shape, device=dev, generator=gen) < 0.5, -0.0, 0.0)
    a[rows(f + 1, 512), at(3, 999, 20000)] = nan
    a[rows(f + 1, 512), at(4, 1000, 30000)] = neg_nan
    a[rows(f + 2, 512)] = neg_nan
    a[rows(f + 3)] = torch.where(torch.rand(a[rows(f + 3)].shape, device=dev, generator=gen) < 0.5, neg_nan, -inf)
    a[rows(f + 4, 512), 37 * torch.arange(40, device=dev)] = nan
    pool = torch.tensor([0.0, -0.0, 1.0, -1.0, inf, -inf, nan, 2.5, neg_nan], dtype=a.dtype, device=dev)
    pick = torch.randint(0, len(pool), a[rows(f + 5, 512)].shape, device=dev, generator=gen)
    a[rows(f + 5, 512)] = pool[pick]
    w = a.view(torch.int32)
    for nan_bits in (0x7FC00000, 0xFFC00000 - (1 << 32)):
        if not bool((w == nan_bits).any()):
            fail(f"adversarial rows hold no NaN of pattern {nan_bits & 0xFFFFFFFF:#x}")
    return a


def tie_rows(x: torch.Tensor, gen) -> torch.Tensor:
    """A copy of the (B, D) float32 ``x`` whose rows hold equal keys across
    lanes and loads: in each row, 50.0 at 24 positions and then 60.0 at 3 of
    them, drawn from the first 256 elements of blocks 0, 1, 5 and 40 of 256
    (float32 loads 0-1, 2-3, 10-11 and 80-81 of all 32 lanes; bfloat16
    loads 0, 1, 5 and 40), so a row's top k <= 16 takes the 60s and then
    the earliest 50s, which lie in several lanes: a merge that broke ties
    by lane and not by position would differ."""
    a = x.clone()
    dev = a.device
    span = (256 * torch.tensor([0, 1, 5, 40], device=dev)[:, None] + torch.arange(256, device=dev)).reshape(-1)
    pick = torch.rand((a.shape[0], span.numel()), device=dev, generator=gen).topk(24, dim=1).indices
    cols = span[pick]
    a.scatter_(1, cols, 50.0)
    a.scatter_(1, cols[:, :3], 60.0)
    return a


def bf16_truncated(a: torch.Tensor) -> torch.Tensor:
    """float32 ``a`` cut to bfloat16 by dropping the low 16 bits of each
    word: exact for the adversarial fixtures (both NaN signs kept, which a
    rounding cast may not keep)."""
    return (a.view(torch.int32) >> 16).to(torch.int16).view(torch.bfloat16)


def phase_kernels_vs_plain(gen):
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.utils import dtypes as dt

    n = CHECK_WORDS
    err = {name: 0 for name in KERNELS}

    def hold(name, kernel, plain, what, **kw):
        d = (kernel(**kw) - plain(**kw)).abs().max().item()
        err[name] = max(err[name], d)
        if d:
            fail(f"{name} != plain at {what}")

    for bits in (32, 64):
        w = rand_words(n, bits, gen)
        for key_op, key_xor in (("none", 0), ("xor", 1 << (bits - 1)), ("float", 0)):
            keys = dt.keys_from_raw(w, key_op, key_xor)
            probe = keys[n // 3 : n // 3 + 1]
            for rb in (4, 8):
                for shift, live in ((bits - rb, False), (bits - 3 * rb, True), (0, True)):
                    p = dt.shift_right_logical(probe, shift + rb, bits).contiguous() if live else None
                    hold(f"radix_histogram{bits}", H.radix_histogram, H.radix_histogram_plain,
                         f"{key_op} rb={rb} shift={shift} prefix={live}",
                         words=w, shift=shift, radix_bits=rb, prefix=p, key_op=key_op, key_xor=key_xor)
                # K prefixes of data keys, the last one repeated
                for nq in (1, 3, 64):
                    pos = [7 + (n - 8) * i // max(1, nq - 2) for i in range(max(1, nq - 1))]
                    picks = keys[(pos + pos[-1:])[:nq]]
                    for shift in (bits - 3 * rb, 0):
                        p = dt.shift_right_logical(picks, shift + rb, bits).contiguous()
                        hold(f"radix_histogram_multi{bits}", H.radix_histogram_multi, H.radix_histogram_multi_plain,
                             f"{key_op} rb={rb} shift={shift} K={nq}",
                             words=w, shift=shift, radix_bits=rb, prefixes=p, key_op=key_op, key_xor=key_xor)
            # the 16-bit route (the sweep kernel's histogram part): the top
            # digit, one prefix, and K=4 and 64 prefixes of data keys
            name16 = f"sweep_ingest{bits}"
            hold(name16, H.radix_histogram, H.radix_histogram_plain, f"{key_op} rb=16 top digit",
                 words=w, shift=bits - 16, radix_bits=16, key_op=key_op, key_xor=key_xor)
            p = dt.shift_right_logical(probe, bits - 16, bits).contiguous()
            hold(name16, H.radix_histogram, H.radix_histogram_plain, f"{key_op} rb=16 one prefix",
                 words=w, shift=bits - 32, radix_bits=16, prefix=p, key_op=key_op, key_xor=key_xor)
            for nq in (4, 64):
                picks = keys[[7 + (n - 8) * i // (nq - 1) for i in range(nq)]]
                p = dt.shift_right_logical(picks, bits - 16, bits).contiguous()
                hold(name16, H.radix_histogram_multi, H.radix_histogram_multi_plain, f"{key_op} rb=16 K={nq}",
                     words=w, shift=bits - 32, radix_bits=16, prefixes=p, key_op=key_op, key_xor=key_xor)
            print(f"[check] the 16-bit route ({name16}) == plain at {n} {key_op} keys: the top digit, one prefix, "
                  "K=4 and K=64 prefixes")
            # the cutover's widths at K=3, and at K=1 every width the early
            # exit collects at with 4-bit digits (phase 15; 64-bit: 20-60)
            early = range(4, 32, 4) if bits == 32 else (20, 36, 44, 52, 60)
            for res, nq in ((24, 1), (bits // 2 + 4, 3), *((r, 1) for r in early)):
                p = dt.shift_right_logical(keys[[7, n // 3, n - 1]][:nq], bits - res, bits).contiguous()
                hold(f"match_counts{bits}", H.match_counts, H.match_counts_plain, f"{key_op} res={res} K={nq}",
                     words=w, resolved_bits=res, prefixes=p, key_op=key_op, key_xor=key_xor)
            for tau in (probe.clone(), absent_key(keys, probe)):
                for largest in (True, False):
                    hold(f"tau_counts{bits}", H.tau_counts, H.tau_counts_plain, f"{key_op} largest={largest}",
                         words=w, tau=tau, largest=largest, key_op=key_op, key_xor=key_xor)
            del keys
        # a storage offset breaks 16-byte alignment: the scalar loop
        kw = dict(shift=bits - 4, radix_bits=4)
        if not torch.equal(H.radix_histogram(w[1:], **kw), H.radix_histogram_plain(w[1:], **kw)):
            fail(f"radix_histogram{bits} != plain on a misaligned view")
        for label, words, kw in multi_prefix_sets(w, bits, gen):
            if not torch.equal(H.radix_histogram_multi(words, **kw), H.radix_histogram_multi_plain(words, **kw)):
                fail(f"radix_histogram_multi{bits} != plain on {label}")
            print(f"[check] radix_histogram_multi{bits} == plain on {label}")
        cases = match_count_cases(w, bits, gen)
        for label, kw in cases:
            H.reset_counts()
            hold(f"match_counts{bits}", H.match_counts, match_plain, label, **kw)
            want = -(-kw["prefixes"].numel() // H.MATCH_MAX_QUERIES)
            if H.LAUNCHES[f"match_counts{bits}"] != want:
                fail(f"match_counts{bits} at {label}: {H.LAUNCHES[f'match_counts{bits}']} launches, not {want}")
        print(f"[check] match_counts{bits} == plain on {len(cases)} cases: K in {{1, 3, 4, 64, 120, 160, 2100}} "
              "(two launches), every resolved width at both lookups, a hot prefix, misaligned views")
        del cases
        del w
    # widened 8- and 16-bit keys (the key in a word's low bits, key_op
    # "none"): the early exit's collect at r key bits reads r + 32 - key
    # bits of the word, every width a digit of 1, 2, 4 or 8 bits reaches
    for dtype in (torch.int8, torch.int16):
        kb = dt.key_bits(dtype)
        w = dt.to_sortable_bits(torch.randint(-(1 << (kb - 1)), 1 << (kb - 1), (n,), dtype=torch.int32,
                                              device="cuda", generator=gen).to(dtype))
        picks = w[torch.randint(0, n, (64,), device="cuda", generator=gen)]
        for res in range(1, kb):
            wres = res + 32 - kb
            p = dt.shift_right_logical(w[n // 3 : n // 3 + 1], 32 - wres, 32).contiguous()
            hold("match_counts32", H.match_counts, H.match_counts_plain, f"widened {dtype} res={res}",
                 words=w, resolved_bits=wres, prefixes=p)
            p = dt.shift_right_logical(picks, 32 - wres, 32).contiguous()
            hold("match_counts32", H.match_counts, match_plain, f"widened {dtype} res={res} K=64",
                 words=w, resolved_bits=wres, prefixes=p, key_op="none", key_xor=0)
        print(f"[check] match_counts32 == plain on {n} widened {dtype} keys at K=1 and 64, key bits 1-{kb - 1} "
              f"(word bits {33 - kb}-31)")
        del w
    from mpi_k_selection_tpu_torch.ops.cuda import topk as T

    x = torch.randn((BATCH, WIDTH), device="cuda", generator=gen)
    for label, data in (("normal", x), ("adversarial", adversarial_rows(x, gen)), ("tie", tie_rows(x, gen))):
        for dtype, ks in BATCH_KS.items():
            xd = data if dtype == torch.float32 else bf16_truncated(data) if label == "adversarial" else data.to(dtype)
            want_v, want_i = T.batched_topk_plain(xd, 16)  # every smaller k's answer is its prefix
            name = f"batched_topk{8 * xd.element_size()}"
            for k in ks:
                what = f"batched_topk {dtype} k={k} on {label} rows"
                v, i = T.batched_topk(xd, k)
                err[name] = max(err[name], batched_err(v, want_v[:, :k].contiguous(), what))
                if not torch.equal(i, want_i[:, :k]):
                    fail(f"{what}: kernel positions != plain")
                batched_err(T.batched_topk_values(xd, k), want_v[:, :k].contiguous(), what + " (values only)")
            print(f"[check] {name} == plain on {label} rows, {dtype}, k in {ks}: values, positions and the "
                  "values-only launch")
    del x, data, xd, want_v, want_i, v, i
    torch.cuda.synchronize()
    sweep_vs_plain(gen, err)
    for name, e in err.items():
        print(f"[check] {name} vs plain at n={n} / ({BATCH}, {WIDTH}) / a {SWEEP_BUCKET}-word bucket: max_abs_err={e}")
    return err


def multi_prefix_sets(w: torch.Tensor, bits: int, gen):
    """(label, words, kwargs) of the multi-prefix histogram's hardest
    prefix sets on the random words ``w`` (keys: the sign bit flipped):
    64 data prefixes in reverse and in shuffled order, 16 of them 4 times
    each (shuffled) and 64 prefixes that no key holds, each at a pass-1
    digit (4 prefix bits: the prefix is the table index) and at the last
    digit (bits - 4 prefix bits: a hashed table); K=64 equal prefixes on
    all-equal words (one hot bin) at both; K=300 at radix width 8 (more
    than one launch); and a misaligned view."""
    from mpi_k_selection_tpu_torch.utils import dtypes as dt

    sign = -(1 << (bits - 1))
    kw = dict(radix_bits=4, key_op="xor", key_xor=1 << (bits - 1))
    keys = w ^ sign

    def top(t, shift):
        return dt.shift_right_logical(t, shift + kw["radix_bits"], bits)

    def shuffled(p):
        return p[torch.randperm(p.numel(), device="cuda", generator=gen)].contiguous()

    picks = keys[torch.randint(0, w.numel(), (64,), device="cuda", generator=gen)]
    equal = torch.full_like(w, 42)
    out = []
    for shift in (bits - 8, 0):
        p = top(picks, shift)
        if shift:  # 4 prefix bits: prefixes past the width, which no key holds
            absent = 16 + 7 * torch.arange(64, device="cuda", dtype=w.dtype)
        else:  # data prefixes with the low bit flipped, where no key holds one
            cand = torch.unique(p ^ 1)
            absent = cand[~torch.isin(cand, top(keys, shift))]
            if absent.numel() == 0:
                fail(f"no absent {bits}-bit prefix found")
        for label, ps, words in (
            ("reversed", p.sort().values.flip(0), w), ("shuffled", shuffled(p), w),
            ("16 prefixes 4 times each", shuffled(p[:16].repeat(4)), w), ("absent prefixes", absent, w),
            ("one hot bin (all-equal words), equal prefixes", top(equal[:1] ^ sign, shift).repeat(64), equal),
        ):
            out.append((f"{label}, K={ps.numel()} shift={shift}", words,
                        dict(kw, shift=shift, prefixes=ps.contiguous())))
    p300 = dt.shift_right_logical(keys[torch.randint(0, w.numel(), (300,), device="cuda", generator=gen)],
                                  bits - 8, bits)
    out.append(("K=300 rb=8 (more than one launch)", w, dict(kw, shift=bits - 16, radix_bits=8, prefixes=p300)))
    out.append(("a misaligned view, K=64 shuffled with repeats", w[1:],
                dict(kw, shift=bits - 12, prefixes=shuffled(top(picks[:16], bits - 12).repeat(4)))))
    return out


def match_count_cases(w: torch.Tensor, bits: int, gen):
    """(label, kwargs) of the match count's checks on views of the random
    words ``w`` (keys: the sign bit flipped), each with prefixes of data
    keys, the second repeated at the end, one past every key's top bits and
    one in range that no key holds where the width has one: K in {1, 3, 4,
    64, 120, 160, 2100} (the last over two launches) at 24 resolved bits
    (40 of 64-bit keys) on 2^22 + 37 words (a ragged tail, not a multiple of
    4); every resolved width at K = 1, MATCH_COMPARE_MAX (the compare in
    registers) and one more (the prefix table: exact up to 12 bits, hashed
    beyond) on 2^20 + 5 words; one hot prefix every key holds, repeated
    among K = 8 and 64; misaligned views (a storage offset of one and of
    three words) at K = 1 and 64."""
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.utils import dtypes as dt

    sign = -(1 << (bits - 1))
    base = dict(key_op="xor", key_xor=1 << (bits - 1))

    def prefixes(words, res, nq):
        keys = words ^ sign
        tops = dt.shift_right_logical(keys, bits - res, bits)
        live = tops[torch.randint(0, words.numel(), (max(1, nq - 3),), device="cuda", generator=gen)]
        extra = [live[1:2]]
        if res < bits:  # past any key's top bits
            extra.append(torch.tensor([dt.signed_const(1 << res, bits)], dtype=w.dtype, device="cuda"))
        cand = torch.unique(live ^ 1)
        absent = cand[~torch.isin(cand, tops)][:1]
        p = torch.cat([live, *extra, absent])
        return p.repeat(-(-nq // p.numel()))[:nq].contiguous()

    out = []
    ragged = w[: (1 << 22) + 37]
    wide = 24 if bits == 32 else 40
    for nq in (1, 3, 4, 64, 120, 160, 2100):
        out.append((f"K={nq} res={wide} on {ragged.numel()} words",
                    dict(base, words=ragged, resolved_bits=wide, prefixes=prefixes(ragged, wide, nq))))
    small = w[: (1 << 20) + 5]
    for res in range(1, bits + 1):
        for nq in (1, H.MATCH_COMPARE_MAX, H.MATCH_COMPARE_MAX + 1):
            out.append((f"K={nq} res={res} on {small.numel()} words",
                        dict(base, words=small, resolved_bits=res, prefixes=prefixes(small, res, nq))))
    equal = torch.full(((1 << 22) + 37,), 42, dtype=w.dtype, device="cuda")
    hot = dt.shift_right_logical(equal[:1] ^ sign, bits - 24, bits)
    for nq in (1, 8, 64):
        others = hot + 1 + torch.arange(max(0, nq - 2), device="cuda", dtype=w.dtype)
        p = torch.cat([hot, others, hot])[:nq].contiguous()
        out.append((f"one hot prefix (all-equal words) K={nq}", dict(base, words=equal, resolved_bits=24, prefixes=p)))
    for lo in (1, 3):
        view = w[lo : lo + (1 << 22) + 3]
        for nq in (1, 64):
            out.append((f"a misaligned view (offset {lo}) K={nq}",
                        dict(base, words=view, resolved_bits=wide, prefixes=prefixes(view, wide, nq))))
    return out


def sweep_cases(bits: int, keys: torch.Tensor):
    """(label, parts) of the sweep kernel's checks: each part alone and all
    five together; K in {1, 4} histogram prefixes (one repeated) at radix
    widths 4 and 8, and K=70 (35 prefixes twice: more than go by value); a
    sparse collect spec (the top 8 bits of a key: about 1/256 of random
    words survive), a spec every key matches (0 resolved bits, a shift of
    the word width), four specs in one scan and a two-spec tee union; a
    certificate key present in and absent from the data; sketches of 8, 16
    (the default width, in 16-bit counters) and 20 bits, and of 1 bit
    alone (in registers) and beside a collect (the ordered route counts
    it in shared memory)."""
    u = [v & ((1 << bits) - 1) for v in keys[:64].tolist()]

    def top(i, r):
        return u[i] >> (bits - r)

    absent = int(absent_key(keys, keys[7:8])) & ((1 << bits) - 1)
    hist1 = dict(hist_prefixes=[0], shift=bits - 4, radix_bits=4)  # a first pass: no prefix
    hist4 = dict(hist_prefixes=[top(0, 8), top(1, 8), top(2, 8), top(0, 8)], shift=bits - 16, radix_bits=8)
    sparse, every = (bits - 8, top(3, 8)), (bits, 0)
    tee = dict(tee=[(bits - 8, top(4, 8)), (bits - 8, top(5, 8))])
    return [
        ("hist K=1 rb=4", hist1), ("hist K=4 rb=8", hist4),
        ("hist K=1 rb=8 under a 16-bit prefix", dict(hist_prefixes=[top(6, 16)], shift=bits - 24, radix_bits=8)),
        ("hist K=4 rb=4", dict(hist4, shift=bits - 12, radix_bits=4)),
        ("hist K=70, 35 prefixes twice (a device array)",
         dict(hist_prefixes=[top(i, 12) for i in range(35)] * 2, shift=bits - 20, radix_bits=8)),
        ("collect sparse", dict(collect=[sparse])), ("collect every key", dict(collect=[every])),
        ("collect four specs", dict(collect=[sparse, (bits - 8, top(8, 8)), (bits - 16, top(9, 16)), every])),
        ("tee union of two specs", tee),
        ("cert, key present", dict(vkey=u[7])), ("cert, key absent", dict(vkey=absent)),
        ("sketch 8", dict(sketch_bits=8)), ("sketch 16", dict(sketch_bits=16)), ("sketch 20", dict(sketch_bits=20)),
        ("sketch 1", dict(sketch_bits=1)), ("collect sparse, sketch 1", dict(collect=[sparse], sketch_bits=1)),
        ("all five, K=4 rb=8, sketch 20", dict(hist4, collect=[sparse, every], **tee, vkey=u[7], sketch_bits=20)),
        ("all five, K=1 rb=4, sketch 8", dict(hist1, collect=[sparse], **tee, vkey=absent, sketch_bits=8)),
        # the width schedule's launches: a wide first pass, one and four
        # prefixes above a wide digit, and a spill pass's tee beside them
        *((f"hist K={len(ps)} rb={wd}" + (" under 8-bit prefixes" if ps != [0] else ", no prefix"),
           dict(hist_prefixes=ps, shift=bits - wd - (8 if ps != [0] else 0), radix_bits=wd))
          for wd in WIDE_BITS for ps in ([0], [top(10, 8)], [top(11, 8), top(12, 8), top(13, 8), top(11, 8)])),
        ("hist K=1 rb=8 under a 16-bit prefix + its tee",
         dict(hist_prefixes=[top(6, 16)], shift=bits - 24, radix_bits=8, tee=[(bits - 16, top(6, 16))])),
        ("hist K=1 rb=16 under a 16-bit prefix + its tee",
         dict(hist_prefixes=[top(6, 16)], shift=bits - 32, radix_bits=16, tee=[(bits - 16, top(6, 16))])),
    ]


TEE_CHECK_SHARES = (0.01, 0.17, 0.5, 1.0)  # phase 2: the tee's survivor shares under its one 8-bit prefix
TEE_SHARES = TEE_CHECK_SHARES[:-1]  # the tee kinds' shares below pass 0's every key (phase 8)


def tee_checks(bits: int, gen):
    """Yields (label, words, n_valid, parts, key_op, key_xor) of phase 2's
    checks of the spill passes' histogram + tee launch on 2^26-word buckets of
    random keys, under the xor and the float key ops, pads present: the
    histogram of the 8 bits below one 8-bit prefix beside the tee of that
    prefix, on keys of which about 1%, 17%, 50% and 100% hold it (the 17%
    bucket also with a base not 16-byte aligned, with ``n_valid`` 100 words
    short of its end, and cut below one tile); 4 such 16-bit prefixes, each
    on a tenth of the keys, beside the tee of their union and of a parked
    rank's 12-bit spec (on 1%); and pass 0's every-key tee beside the
    prefix-free first pass."""
    from mpi_k_selection_tpu_torch.utils import dtypes as dt

    n = SWEEP_BUCKET
    base = rand_words(n, bits, gen)
    u = [v & ((1 << bits) - 1) for v in base[:16].tolist()]

    def holding(keys, share, width, prefix):  # a share of the keys moved under the prefix
        low = (1 << (bits - width)) - 1
        moved = (keys & low) | dt.signed_const(prefix << (bits - width), bits)
        return torch.where(torch.rand(n, device="cuda", generator=gen) < share, moved, keys)

    def raw_of(keys, key_op):  # the words whose keys under key_op are keys
        msb = dt.signed_const(1 << (bits - 1), bits)
        return keys ^ msb if key_op == "xor" else torch.where(keys < 0, keys ^ msb, ~keys)

    p8 = u[0] >> (bits - 8)
    one = dict(hist_prefixes=[p8], shift=bits - 16, radix_bits=8, tee=[(bits - 8, p8)])
    cases = [(f"one 8-bit prefix, {s:.0%} of keys", holding(base, s, 8, p8), one) for s in TEE_CHECK_SHARES]
    q16 = sorted({v >> (bits - 16) for v in u[1:9]})[:4]
    keys = base
    for q in q16:
        keys = holding(keys, 0.1, 16, q)
    p12 = u[9] >> (bits - 12)
    cases.append(("4 16-bit prefixes and a parked 12-bit spec", holding(keys, 0.01, 12, p12), dict(
        hist_prefixes=q16, shift=bits - 24, radix_bits=8, tee=[(bits - 16, q) for q in q16] + [(bits - 12, p12)])))
    cases.append(("every key (pass 0)", base, dict(hist_prefixes=[0], shift=bits - 8, radix_bits=8, tee=[(bits, 0)])))
    for key_op, key_xor in (("xor", 1 << (bits - 1)), ("float", 0)):
        for i, (label, keys, parts) in enumerate(cases):
            w = raw_of(keys, key_op)
            yield label, w, n - 12345, parts, key_op, key_xor
            if i == 1:  # the spill pass's share at the edge shapes
                yield f"{label}, a base not 16-byte aligned", w[1:], n - 12346, parts, key_op, key_xor
                yield f"{label}, n_valid 100 words short", w, n - 100, parts, key_op, key_xor
                yield f"{label}, below one tile", w[:5000], 4990, parts, key_op, key_xor


def sweep_outputs(out):
    """The tensors of a sweep_ingest result, in order."""
    flat = []
    for part in out:
        if part is None:
            continue
        for t in part if isinstance(part, tuple) else (part,):
            flat.extend(t if isinstance(t, tuple) else (t,))
    return flat


def sweep_err(got, want, what: str) -> int:
    """Fails unless every output of the kernel equals the plain version's,
    buffers to the last word; returns their max |difference| (0)."""
    g, w = sweep_outputs(got), sweep_outputs(want)
    if len(g) != len(w) or not all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(g, w)):
        fail(f"{what}: kernel != plain")
    return max((int((a.long() - b.long()).abs().max()) for a, b in zip(g, w) if a.numel()), default=0)


def sweep_vs_plain(gen, err):
    """Phase 2 for the sweep kernel: every case of :func:`sweep_cases` on a
    2^26-word bucket of random words, 32- and 64-bit, with ``n_valid``
    below the bucket (the rest are pads); the sketch part at 15, 16 and 20
    bits on the skewed buckets of :func:`skewed_sketch_buckets`; 16-bit
    keys (each 16-bit dtype, random and all one key) through the sketch
    consumer's launch, the 16-bit histogram part: all exactly against the
    plain version."""
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
    from mpi_k_selection_tpu_torch.utils import dtypes as dt

    n_valid = SWEEP_BUCKET - 12345
    two_byte = torch.zeros(256, dtype=torch.int16, device="cuda")
    for bad in (two_byte, torch.zeros(512, dtype=torch.int32, device="cuda")[::2]):
        S.reset_counts()
        try:
            S.sweep_ingest(bad, 100)
            fail(f"sweep_ingest took a {bad.dtype} tensor of strides {bad.stride()}")
        except ValueError as e:  # raised on the card, with no fallback to the plain version
            if any(S.PLAIN_CALLS.values()) or any(S.LAUNCHES.values()):
                fail("sweep_ingest fell back or launched on a tensor it does not take")
            print(f"[check] sweep_ingest raises on a CUDA tensor it does not take: {e}")
    for bits in (32, 64):
        w = rand_words(SWEEP_BUCKET, bits, gen)
        for key_op, key_xor in (("float", 0), ("xor", 1 << (bits - 1))):
            keys = dt.keys_from_raw(w, key_op, key_xor)
            for label, parts in sweep_cases(bits, keys):
                kw = dict(key_op=key_op, key_xor=key_xor, **parts)
                e = sweep_err(S.sweep_ingest(w, n_valid, **kw), S.sweep_ingest_plain(w, n_valid, **kw),
                              f"sweep_ingest{bits} {key_op} {label}")
                err[f"sweep_ingest{bits}"] = max(err[f"sweep_ingest{bits}"], e)
            del keys
        del w
        torch.cuda.empty_cache()
        for label, w, n_valid, parts, key_op, key_xor in tee_checks(bits, gen):
            kw = dict(key_op=key_op, key_xor=key_xor, **parts)
            e = sweep_err(S.sweep_ingest(w, n_valid, **kw), S.sweep_ingest_plain(w, n_valid, **kw),
                          f"sweep_ingest{bits} {key_op} histogram + tee, {label}")
            err[f"sweep_ingest{bits}"] = max(err[f"sweep_ingest{bits}"], e)
        print(f"[check] sweep_ingest{bits} histogram + tee == plain: one 8-bit prefix at 1-100% of keys (and edge "
              f"shapes), 4 teed prefixes and a parked spec, pass 0's every key; xor and float keys")
        torch.cuda.empty_cache()
        for sketch_bits in SKEWED_SKETCH_BITS:
            for label, w, n_valid in skewed_sketch_buckets(bits, sketch_bits, gen):
                e = sweep_err(S.sweep_ingest(w, n_valid, sketch_bits=sketch_bits),
                              S.sweep_ingest_plain(w, n_valid, sketch_bits=sketch_bits),
                              f"sweep_ingest{bits} sketch {sketch_bits} on {label}")
                err[f"sweep_ingest{bits}"] = max(err[f"sweep_ingest{bits}"], e)
                del w
            print(f"[check] sweep_ingest{bits} sketch of {sketch_bits} bits == plain on the skewed buckets")
    # 16-bit keys widened into 32-bit words: the sketch consumer's launch,
    # the prefix-free histogram part at a 16-bit digit and a 1-bit sketch
    kw = dict(hist_prefixes=[0], shift=0, radix_bits=16, sketch_bits=1)
    for name in ("int16", "uint16", "float16", "bfloat16"):
        raw = torch.randint(-(1 << 15), 1 << 15, (SWEEP_BUCKET,), dtype=torch.int32, device="cuda", generator=gen)
        raw = raw.to(torch.int16)
        for label, r in (("random keys", raw), ("one key", raw[:1].expand(SWEEP_BUCKET).contiguous())):
            keys = dt.to_sortable_bits(r.view(dt.torch_dtype(name)))
            for n_valid in (SWEEP_BUCKET, SWEEP_BUCKET - 12345):
                e = sweep_err(S.sweep_ingest(keys, n_valid, **kw), S.sweep_ingest_plain(keys, n_valid, **kw),
                              f"sweep_ingest32 {name} keys ({label}, {n_valid} valid) through the 16-bit histogram")
                err["sweep_ingest32"] = max(err["sweep_ingest32"], e)
            del keys
        print(f"[check] sweep_ingest32 {name} keys through the 16-bit histogram part == plain "
              f"(random keys, one key; all and all but 12345 valid)")
        del raw
    torch.cuda.empty_cache()


WIDE_BITS = (16, 17, 18, 19, 20)  # histogram digits of the width schedule: 16 from "auto", up to 20 in a tuple
SKEWED_SKETCH_BITS = (15, 16, 20)  # 16-bit counters in shared memory at 15 and 16 bits; int32 in global memory at 20


def skewed_sketch_buckets(bits: int, sketch_bits: int, gen):
    """(label, raw words on the card, n_valid) of skewed buckets of
    ``SWEEP_BUCKET`` words for the sketch part at ``sketch_bits`` (key_op
    "none": the words are the keys), made one at a time: one hot counter
    (every block's counter passes 2^16 many times); the last counter;
    two hot counters that share a 32-bit word, in alternating keys;
    counters that one block's keys bring exactly to 2^16 and to 2^16 + 1
    (the block's words from the launch plan, the rest of the bucket
    spread over other counters); pads only."""
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
    from mpi_k_selection_tpu_torch.utils import dtypes as dt

    n, low, last = SWEEP_BUCKET, bits - sketch_bits, (1 << sketch_bits) - 1
    wdt = torch.int32 if bits == 32 else torch.int64

    def key(bin_):  # a key of counter bin_, its low bits those of the bin
        return dt.signed_const((bin_ << low) | (bin_ & ((1 << low) - 1)), bits)

    yield "one hot counter", torch.full((n,), key(12345), dtype=wdt, device="cuda"), n
    yield "the last counter", torch.full((n,), key(last), dtype=wdt, device="cuda"), n
    w = torch.full((n,), key(last - 1), dtype=wdt, device="cuda")
    w[1::2] = key(last)
    yield "two hot counters alternating", w, n
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = S.sweep_plan(bits, n, nd=0, sketch_bits=sketch_bits, sms=sms)
    v = 16 // (bits // 8)
    vec = torch.arange(n // v, device="cuda")
    for extra, block in ((0, 0), (1, 1)):
        mine = vec[(vec % (plan.blocks * plan.threads)) // plan.threads == block]
        pos = (mine[:, None] * v + torch.arange(v, device="cuda")).flatten()[: (1 << 16) + extra]
        spread = torch.randint(0, last - 7, (n,), device="cuda", generator=gen, dtype=torch.int64) << low
        spread[pos] = key(last - 1 - block)
        yield f"a counter at 2^16 + {extra} in block {block}", spread.to(wdt), n
        del spread
    yield "pads only", torch.full((n,), key(7), dtype=wdt, device="cuda"), 0


def batched_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Fails unless the top-k values ``got`` equal ``want`` bit for bit;
    returns their max |difference| (0.0)."""
    iv = torch.int16 if got.element_size() == 2 else torch.int32
    if got.shape != want.shape or not torch.equal(got.view(iv), want.view(iv)):
        fail(f"{what}: kernel != plain")
    finite = torch.isfinite(want)
    return (got[finite].double() - want[finite].double()).abs().max().item() if finite.any() else 0.0


def oracle(x: np.ndarray, ks):
    """k-th smallest for each k in key order, as raw bytes."""
    from mpi_k_selection_tpu_torch.cli import oracle_many

    ks = sorted(set(ks))
    return dict(zip(ks, (v.tobytes() for v in oracle_many(x, ks))))


def phase_main_path(gen):
    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch import api
    from mpi_k_selection_tpu_torch.cli import batched_topk_oracle, topk_oracle
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.ops.cuda import topk as T
    from mpi_k_selection_tpu_torch.utils import datagen
    from mpi_k_selection_tpu_torch.utils.debug import rank_certificate
    from mpi_k_selection_tpu_torch.utils.interop import tensor_from_numpy, tensor_to_numpy

    cases = (
        ("int32 uniform 2^30", 1 << 30, "uniform", np.int32),
        ("float64 normal 2^27", 1 << 27, "normal", np.float64),
        ("int32 equal 2^27", 1 << 27, "equal", np.int32),
        ("float32 normal 2^26", 1 << 26, "normal", np.float32),
    )
    n27 = 1 << 27
    many_ks = [round(n27 * (i + 1) / 64) for i in range(64)]  # 64 evenly spaced ranks, the last n
    data, wants, tops = {}, {}, {}
    for label, n, pattern, dtype in cases:
        x = datagen.generate(n, pattern=pattern, seed=0, dtype=dtype)
        if n > 1 << 26:  # the selects' arrays
            wants[label] = oracle(x, [1, 250, n // 2, n] + api.quantile_ranks(QS, n))
        else:  # phase 15's median of the float32 array
            wants[label] = oracle(x, [n // 2])
        if dtype != np.int32:
            tops[label] = {largest: topk_oracle(x, TOPK, largest) for largest in (True, False)}
        if n == 1 << 30:
            wants["int32 uniform 2^27"] = oracle(x[:n27], many_ks)
        data[label] = tensor_from_numpy(x, "cuda")
        del x
    xb = datagen.generate(WIDTH, pattern="normal", seed=0, dtype=np.float32, batch=(BATCH,))
    median_want = np.sort(xb, axis=1)[:, WIDTH // 2 - 1]
    data["batched float32 normal"] = tensor_from_numpy(xb, "cuda")
    del xb
    data["batched float32 adversarial"] = adversarial_rows(data["batched float32 normal"], gen)
    batched = ("batched float32 normal", "batched float32 adversarial",
               "batched bfloat16 normal", "batched bfloat16 adversarial")
    data["batched bfloat16 normal"] = data["batched float32 normal"].to(torch.bfloat16)
    data["batched bfloat16 adversarial"] = bf16_truncated(data["batched float32 adversarial"])
    # the top-16 with ties by position: the top-k of every smaller k is its prefix
    batch_tops = {label: batched_topk_oracle(tensor_to_numpy(data[label]), 16) for label in batched}
    torch.cuda.synchronize()

    launches = {kn: 0 for kn in {**H.LAUNCHES, **T.LAUNCHES} if kn in KERNELS}  # summed over every path below
    answers, many, per_call = {}, {}, {}

    def counted(what, fn, bits, kinds):
        """Drives one path with every count set to 0 just before it and read
        just after; fails unless each of its kernels ``kinds`` (at the key
        width ``bits``) launched and no plain version ran."""
        H.reset_counts()
        T.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got, plain = {**H.LAUNCHES, **T.LAUNCHES}, {**H.PLAIN_CALLS, **T.PLAIN_CALLS}
        per_call[what] = {kn: v for kn, v in got.items() if v}
        missing = [f"{kind}{bits}" for kind in kinds if not got[f"{kind}{bits}"]]
        if missing or any(plain.values()):
            fail(f"{what}: kernels {missing} never launched; plain calls {plain}")
        for kn, v in per_call[what].items():
            launches[kn] += v
        return out

    select = ("radix_histogram", "match_counts")
    many_kinds = ("radix_histogram", "radix_histogram_multi", "match_counts")
    for label in ("int32 uniform 2^30", "float64 normal 2^27", "int32 equal 2^27"):
        x = data[label]
        n = x.numel()
        bits = 8 * x.element_size()
        # one hot bin: both rungs overflow and the full schedule runs, no collect
        kinds = select[:1] if "equal" in label else select
        answers[(label, n // 2)] = counted(f"median, {label}", lambda: kt.median(x), bits, kinds)
        for k in (1, 250, n):
            answers[(label, k)] = counted(f"kselect k={k}, {label}", lambda: kt.kselect(x, k), bits, select[:1])
    for label in ("int32 uniform 2^30", "float64 normal 2^27"):
        x = data[label]
        many[label] = (api.quantile_ranks(QS, x.numel()),
                       counted(f"quantiles, {label}", lambda: kt.quantiles(x, QS), 8 * x.element_size(), many_kinds))
    x27 = data["int32 uniform 2^30"][:n27]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    many["int32 uniform 2^27"] = (many_ks, counted("kselect_many K=64, int32 uniform 2^27",
                                                   lambda: kt.kselect_many(x27, many_ks), 32, many_kinds))
    extra_peak = torch.cuda.max_memory_allocated() - base
    topk_out = {}
    for label in ("float32 normal 2^26", "float64 normal 2^27"):
        for largest in (True, False):
            topk_out[(label, largest)] = counted(
                f"topk k={TOPK} largest={largest}, {label}", lambda: kt.topk(data[label], TOPK, largest=largest),
                8 * data[label].element_size(), select + ("tau_counts",),
            )
    batched_out = {}
    for label in batched:
        x = data[label]
        for k in BATCH_KS[x.dtype]:
            what = f"batched_topk k={k}, {label}"
            batched_out[(label, k)] = counted(what, lambda: kt.batched_topk(x, k), 8 * x.element_size(),
                                              ("batched_topk",))
            if per_call[what] != {f"batched_topk{8 * x.element_size()}": 1}:
                fail(f"{what}: launches {per_call[what]}, not one of the block kernel")
    x = data["batched float32 normal"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counted("batched_topk k=8, batched float32 normal", lambda: kt.batched_topk(x, 8), 32, ("batched_topk",))
    batched_peak = torch.cuda.max_memory_allocated() - base
    bmedian = counted("batched_median, batched float32 normal", lambda: kt.batched_median(x), 32, ())

    for (label, k), ans in answers.items():
        got = tensor_to_numpy(ans.reshape(1))
        if got.tobytes() != wants[label][k]:
            fail(f"{label} k={k}: got {got[0]!r}, oracle {np.frombuffer(wants[label][k], got.dtype)[0]!r}")
        print(f"[main] {label} k={k}: {got[0]!r} == oracle")
    for label, (ks, ans) in many.items():
        got = tensor_to_numpy(ans)
        want = b"".join(wants[label][k] for k in ks)
        if got.shape != (len(ks),) or got.tobytes() != want:
            fail(f"{label} ranks {ks[:4]}...: got {got[:4]!r}..., oracle mismatch")
        print(f"[main] {label}: {len(ks)} ranks == oracle (first {got[:4].tolist()})")
    for (label, largest), (v, i) in topk_out.items():
        wv, wi = tops[label][largest]
        if not np.array_equal(i.cpu().numpy(), wi) or tensor_to_numpy(v).tobytes() != wv.tobytes():
            fail(f"topk {label} largest={largest} != oracle")
        print(f"[main] topk k={TOPK} largest={largest} {label}: indices and value bits == oracle")
    for (label, k), (v, i) in batched_out.items():
        wv, wi = batch_tops[label]
        if not np.array_equal(i.cpu().numpy(), wi[:, :k]) or tensor_to_numpy(v).tobytes() != wv[:, :k].tobytes():
            fail(f"batched_topk k={k} {label} != per-row oracle")
        print(f"[main] batched_topk k={k} {label} ({BATCH}, {WIDTH}): indices and value bits == per-row oracle "
              "on every row")
    if tensor_to_numpy(bmedian).tobytes() != median_want.tobytes():
        fail("batched_median != np.sort per row")
    print(f"[main] batched_median ({BATCH}, {WIDTH}) float32 normal == np.sort per row")
    for label in ("int32 uniform 2^30", "float64 normal 2^27", "int32 equal 2^27"):
        n = data[label].numel()
        less, leq = rank_certificate(data[label], answers[(label, n // 2)])
        if not int(less) < n // 2 <= int(leq):
            fail(f"{label} median rank certificate ({int(less)}, {int(leq)}]")
    for what, counts in per_call.items():
        print(f"[main] launches of one {what}: {counts}")
    print(f"[main] kselect_many K=64 of 2^27 int32: peak device memory above the resident data "
          f"{extra_peak / 2**20:.1f} MiB")
    print(f"[main] batched_topk k=8 of ({BATCH}, {WIDTH}) float32: peak device memory above the resident "
          f"data {batched_peak / 2**20:.1f} MiB")
    print(f"[main] launches over every path {launches}; plain calls 0 on each path")
    if any(v == 0 for v in launches.values()):
        fail(f"a kernel of the main paths never launched: {launches}")
    notes = {"kselect_many_k64_extra_peak_bytes": extra_peak, "batched_topk_k8_extra_peak_bytes": batched_peak}
    # phases 12 and 15 check their answers against the same oracles
    oracles = {"i32": wants["int32 uniform 2^30"], "f64": wants["float64 normal 2^27"],
               "f64_tops": tops["float64 normal 2^27"], "i32_equal": wants["int32 equal 2^27"],
               "f32": wants["float32 normal 2^26"]}
    return data, launches, per_call, notes, oracles


def library_ms(fn, want: torch.Tensor, what: str) -> float:
    """The time of a yardstick composition of torch calls, once held
    equal to the kernel's output (it must compute the same function)."""
    from mpi_k_selection_tpu_torch.utils.timing import cuda_ms

    if not torch.equal(fn().to(want.dtype), want):
        fail(f"the torch yardstick of {what} disagrees with the kernel")
    ms = cuda_ms(fn, iters=3, warmup=1)
    torch.cuda.empty_cache()
    return ms


def library_histogram(words, shift, radix_bits, key_op, key_xor, prefix=None):
    """Rows 1-2's nearest torch composition: the keys, the digit under the
    prefix mask, ``torch.bincount``."""
    from mpi_k_selection_tpu_torch.utils import dtypes as dt

    bits = words.element_size() * 8
    keys = dt.keys_from_raw(words, key_op, key_xor)
    d = dt.shift_right_logical(keys, shift, bits) & ((1 << radix_bits) - 1)
    if prefix is not None:
        d = d[dt.shift_right_logical(keys, shift + radix_bits, bits) == prefix]
    return torch.bincount(d, minlength=1 << radix_bits)


def library_histogram_multi(words, shift, radix_bits, prefixes, key_op, key_xor):
    """Rows 3-4's nearest torch composition: each key's prefix looked up in
    the sorted prefixes (``torch.searchsorted``), then one ``torch.bincount``
    of (prefix slot, digit) over the keys that match, spread back to the K
    queries."""
    from mpi_k_selection_tpu_torch.utils import dtypes as dt

    bits = words.element_size() * 8
    r = 1 << radix_bits
    keys = dt.keys_from_raw(words, key_op, key_xor)
    top = dt.shift_right_logical(keys, shift + radix_bits, bits)
    uniq, inv = torch.unique(prefixes, return_inverse=True)  # ascending, as the top bits compare
    slot = torch.searchsorted(uniq, top).clamp_(max=uniq.numel() - 1)
    hit = uniq[slot] == top
    d = dt.shift_right_logical(keys, shift, bits) & (r - 1)
    hist = torch.bincount((slot * r + d)[hit], minlength=uniq.numel() * r).view(-1, r)
    return hist[inv]


def library_match_counts(words, resolved_bits, prefixes, key_op, key_xor):
    """Row 5's nearest torch composition. One prefix: the row-wise
    compare-and-sum of each 128-key row's matches. K prefixes: each key's
    top bits looked up in the sorted distinct prefixes
    (``torch.searchsorted``), one ``torch.bincount`` of (prefix slot * R +
    row) over the keys that match, spread back to the K queries. Takes n a
    multiple of 128 (the main path's arrays)."""
    from mpi_k_selection_tpu_torch.utils import dtypes as dt

    bits = words.element_size() * 8
    top = dt.shift_right_logical(dt.keys_from_raw(words, key_op, key_xor), bits - resolved_bits, bits)
    if prefixes.numel() == 1:
        return (top.view(-1, 128) == prefixes.view(-1)).sum(1, dtype=torch.int32)[None]
    rows = top.numel() // 128
    uniq, inv = torch.unique(prefixes, return_inverse=True)  # ascending, as searchsorted compares
    slot = torch.searchsorted(uniq, top).clamp_(max=uniq.numel() - 1)
    hit = uniq[slot] == top
    row = torch.arange(top.numel(), device=top.device) // 128
    counts = torch.bincount((slot * rows + row)[hit], minlength=uniq.numel() * rows)
    return counts.view(-1, rows).to(torch.int32)[inv]


def match_bytes(n: int, bits: int, nq: int) -> int:
    """The bytes a match count must move: the n words read once and the
    (K, R) int32 counts written once."""
    return n * bits // 8 + nq * -(-n // 128) * 4


def match_plain(words, resolved_bits, prefixes, key_op, key_xor):
    """Row 5's plain version (``match_counts_plain``) over slices of the
    prefixes, at most 24 GiB of its (K, n) temporaries a slice: whole, it
    needs 60 GiB at K=120 of 2^27 words."""
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H

    step = max(1, (24 << 30) // (6 * words.numel()))
    return torch.cat([H.match_counts_plain(words, resolved_bits=resolved_bits, prefixes=prefixes[i:i + step],
                                           key_op=key_op, key_xor=key_xor)
                      for i in range(0, prefixes.numel(), step)])


def library_tau_counts(words, tau, largest, key_op, key_xor):
    """Row 6's nearest torch composition: the row-wise compare-and-sum of
    each 128-key row's keys beyond and equal to tau (largest)."""
    from mpi_k_selection_tpu_torch.utils import dtypes as dt

    bits = words.element_size() * 8
    kb = dt.order_bias(dt.keys_from_raw(words, key_op, key_xor), bits).view(-1, 128)
    tb = dt.order_bias(tau, bits)
    return torch.stack([(kb > tb).sum(1, dtype=torch.int32), (kb == tb).sum(1, dtype=torch.int32)])


def phase_timing(data):
    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch import api
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.ops.radix import radix_select_many, row_cumsum
    from mpi_k_selection_tpu_torch.ops.sort import sort_select
    from mpi_k_selection_tpu_torch.utils import dtypes as dt
    from mpi_k_selection_tpu_torch.utils.timing import cuda_ms

    x30 = data["int32 uniform 2^30"]
    f64 = data["float64 normal 2^27"]
    eq = data["int32 equal 2^27"]
    f32 = data["float32 normal 2^26"]
    x27 = x30[: 1 << 27]
    i64 = x27.to(torch.int64)
    rows = []
    library = {}

    def row(what, n, itemsize, ms, extra="", ops_per_key=OPS_PER_KEY, nbytes=None):
        b, by = bound(n * itemsize if nbytes is None else nbytes, n, ops_per_key)
        rows.append({"what": what, "n": n, "ms": ms, "bound_ms": b, "bound_by": by})
        print(f"[time] {what:<52} {ms:10.4f} ms   bound {b:8.4f} ms ({by}){extra}")
        return b, by

    for label, x in (("median int32 uniform 2^30", x30), ("median int32 uniform 2^27", x27),
                     ("median int64 uniform 2^27", i64), ("median float64 normal 2^27", f64),
                     ("median int32 equal 2^27", eq)):
        ms = cuda_ms(lambda: kt.median(x), iters=5)
        row(label, x.numel(), x.element_size(), ms)
        kms = cuda_ms(lambda: torch.kthvalue(x, max(1, x.numel() // 2)), iters=2, warmup=1)
        row(label.replace("median", "torch.kthvalue"), x.numel(), x.element_size(), kms)

    # many ranks: one shared walk against K single selects, and against the
    # sort leg (the crossover of api.many_sort_dispatch_queries)
    for label, x in (("int32 uniform 2^30", x30), ("float64 normal 2^27", f64)):
        ranks = api.quantile_ranks(QS, x.numel())
        ms = cuda_ms(lambda: kt.quantiles(x, QS), iters=5)
        row(f"quantiles K=4 {label}", x.numel(), x.element_size(), ms)
        ms4 = cuda_ms(lambda: [kt.kselect(x, k) for k in ranks], iters=3)
        row(f"4 x kselect at the same ranks {label}", x.numel(), x.element_size(), ms4)
    for nq in (4, 64, 128):
        ks = torch.tensor([round((1 << 27) * (i + 1) / nq) for i in range(nq)], device="cuda")
        ms = cuda_ms(lambda: radix_select_many(x27, ks), iters=3)
        row(f"radix walk K={nq} int32 uniform 2^27", 1 << 27, 4, ms, ops_per_key=MULTI_OPS_PER_KEY)
        sms = cuda_ms(lambda: sort_select(x27, ks), iters=3)
        row(f"sort leg K={nq} int32 uniform 2^27", 1 << 27, 4, sms)
    print(f"[time] many_sort_dispatch_queries(2^27) = {api.many_sort_dispatch_queries(1 << 27)}")
    # the K=4 collect's running sums over its (4, 2^23) row counts: one scan
    # along the rows against the flattened scan the port uses (row_cumsum)
    qk = dt.to_sortable_bits(kt.quantiles(x30, QS))
    cnt = H.match_counts(x30.view(torch.int32), resolved_bits=24, key_op="xor", key_xor=1 << 31,
                         prefixes=dt.shift_right_logical(qk, 8, 32).contiguous())
    if not torch.equal(row_cumsum(cnt), torch.cumsum(cnt, 1, dtype=torch.int64)):
        fail("row_cumsum != torch.cumsum along the rows")
    nbytes = cnt.numel() * 12  # int32 counts read, int64 sums written
    row("torch.cumsum(dim=1), (4, 2^23) row counts", cnt.numel(), 4,
        cuda_ms(lambda: torch.cumsum(cnt, 1, dtype=torch.int64), iters=3), nbytes=nbytes)
    row("row_cumsum, (4, 2^23) row counts", cnt.numel(), 4, cuda_ms(lambda: row_cumsum(cnt)), nbytes=nbytes)
    del cnt

    # top-k against one-call yardsticks (timed only)
    for label, x in (("float32 normal 2^26", f32), ("float64 normal 2^27", f64)):
        ms = cuda_ms(lambda: kt.topk(x, TOPK), iters=5)
        row(f"topk k={TOPK} {label}", x.numel(), x.element_size(), ms)
        tms = cuda_ms(lambda: torch.topk(x, TOPK), iters=5)
        row(f"torch.topk k={TOPK} {label}", x.numel(), x.element_size(), tms)
        sms = cuda_ms(lambda: torch.sort(x, descending=True, stable=True), iters=3)
        row(f"torch.sort {label}", x.numel(), x.element_size(), sms)

    def exact(kernel, plain, what, **kw):
        """max |kernel - plain| over the outputs; any difference fails."""
        d = (kernel(**kw) - plain(**kw)).abs().max().item()
        if d:
            fail(f"{what} != plain at the main path's shape: max_abs_err={d}")
        return d

    # each kernel at the shapes the main path gives it, held exactly against
    # its plain version on the same tensor it is timed on (the prefix-free
    # first pass, a pass under the prefix of a key in the data, and the
    # collect's count at the cutover width of the 2^30 median, 24 bits)
    kern = {}
    for name, words, key_op, key_xor, bits in (
        ("32 int32 2^30", x30, "xor", 1 << 31, 32), ("32 int32 2^27", x27, "xor", 1 << 31, 32),
        ("32 int32 equal 2^27", eq, "xor", 1 << 31, 32), ("64 int64 2^27", i64, "xor", 1 << 63, 64),
        ("64 float64 2^27", f64, "float", 0, 64),
    ):
        w = words.view(torch.int32 if bits == 32 else torch.int64)
        n = w.numel()
        key = dt.keys_from_raw(w[n // 2 : n // 2 + 1], key_op, key_xor)
        kw = dict(words=w, shift=bits - 4, radix_bits=4, key_op=key_op, key_xor=key_xor)
        kwp = dict(kw, shift=bits - 12, prefix=dt.shift_right_logical(key, bits - 8, bits).contiguous())
        mkw = dict(words=w, resolved_bits=24, key_op=key_op, key_xor=key_xor,
                   prefixes=dt.shift_right_logical(key, bits - 24, bits).contiguous())
        herr = max(exact(H.radix_histogram, H.radix_histogram_plain, f"radix_histogram{name}", **kw),
                   exact(H.radix_histogram, H.radix_histogram_plain, f"radix_histogram{name} prefix", **kwp))
        merr = exact(H.match_counts, H.match_counts_plain, f"match_counts{name}", **mkw)
        print(f"[check] radix_histogram{name} (with and without a prefix) and match_counts{name} "
              f"== plain: max_abs_err {herr}, {merr}")
        ms = cuda_ms(lambda: H.radix_histogram(**kw))
        pms = cuda_ms(lambda: H.radix_histogram_plain(**kw), iters=3, warmup=1)
        lms = library_ms(lambda: library_histogram(**kw), H.radix_histogram(**kw), f"radix_histogram{name}")
        row(f"radix_histogram{name}", n, bits // 8, ms, f"   plain {pms:.4f} ms; library {lms:.4f} ms")
        mms = cuda_ms(lambda: H.match_counts(**mkw))
        mpms = cuda_ms(lambda: H.match_counts_plain(**mkw), iters=3, warmup=1)
        mlms = library_ms(lambda: library_match_counts(**mkw), H.match_counts(**mkw), f"match_counts{name}")
        b, by = row(f"match_counts{name}", n, bits // 8, mms, f"   plain {mpms:.4f} ms; library {mlms:.4f} ms",
                    nbytes=match_bytes(n, bits, 1))
        if name in ("32 int32 2^30", "64 float64 2^27"):
            kern[f"radix_histogram{bits}"] = (ms, pms, *bound(n * bits // 8, n), herr)
            kern[f"match_counts{bits}"] = (mms, mpms, b, by, merr)
            library[f"radix_histogram{bits}"] = lms
            library[f"match_counts{bits}"] = mlms
        torch.cuda.empty_cache()

    # the match count at the collects of more than one rank, on the answers'
    # prefixes at the cutover width: the quantiles of 2^30 int32 (K=4, 24
    # bits) and of 2^27 float64 (K=4, 20 bits), and the many-ranks walk of
    # 2^27 int32 at K=64 and K=120 evenly spaced ranks (20 bits)
    for name, words, key_op, key_xor, bits, nq, res in (
        ("32 int32 2^30 K=4", x30, "xor", 1 << 31, 32, 4, 24),
        ("64 float64 2^27 K=4", f64, "float", 0, 64, 4, 20),
        ("32 int32 2^27 K=64", x27, "xor", 1 << 31, 32, 64, 20),
        ("32 int32 2^27 K=120", x27, "xor", 1 << 31, 32, 120, 20),
    ):
        w = words.view(torch.int32 if bits == 32 else torch.int64)
        n = w.numel()
        ranks = api.quantile_ranks(QS, n) if nq == 4 else [round(n * (i + 1) / nq) for i in range(nq)]
        qkeys = dt.to_sortable_bits(kt.kselect_many(words, ranks))
        mkw = dict(words=w, resolved_bits=res, key_op=key_op, key_xor=key_xor,
                   prefixes=dt.shift_right_logical(qkeys, bits - res, bits).contiguous())
        err = exact(H.match_counts, match_plain, f"match_counts{name}", **mkw)
        mms = cuda_ms(lambda: H.match_counts(**mkw))
        mpms = cuda_ms(lambda: match_plain(**mkw), iters=3, warmup=1)
        mlms = library_ms(lambda: library_match_counts(**mkw), H.match_counts(**mkw), f"match_counts{name}")
        b, _ = row(f"match_counts{name}", n, bits // 8, mms, f"   plain {mpms:.4f} ms; library {mlms:.4f} ms",
                   nbytes=match_bytes(n, bits, nq))
        print(f"[check] match_counts{name} == plain: max_abs_err {err}; {b / mms:.0%} of bound")
        torch.cuda.empty_cache()

    # the multi-prefix histogram at the many-ranks passes: the answers' K=4
    # quantile prefixes at pass 1 (2^30 int32, 2^27 float64, 2^27 int32
    # equal: one prefix, one hot bin); K=64 and 128 evenly spaced ranks at
    # pass 1 of 2^27 int32 and K=64 of 2^27 float64; K=64 at a deep pass of
    # 2^27 int32 (12-bit prefixes: most keys match none); tau_counts at the
    # top-k collect (tau = the 128th largest)
    for name, words, key_op, key_xor, bits, nq, shift, main in (
        ("32 int32 2^30 K=4", x30, "xor", 1 << 31, 32, 4, 24, True),
        ("64 float64 2^27 K=4", f64, "float", 0, 64, 4, 56, True),
        ("32 int32 2^27 K=64", x27, "xor", 1 << 31, 32, 64, 24, False),
        ("32 int32 2^27 K=128", x27, "xor", 1 << 31, 32, 128, 24, False),
        ("32 int32 2^27 K=64 shift=16", x27, "xor", 1 << 31, 32, 64, 16, False),
        ("32 int32 equal 2^27 K=4", eq, "xor", 1 << 31, 32, 4, 24, False),
        ("64 float64 2^27 K=64", f64, "float", 0, 64, 64, 56, False),
    ):
        w = words.view(torch.int32 if bits == 32 else torch.int64)
        n = w.numel()
        ranks = api.quantile_ranks(QS, n) if nq == 4 else [round(n * (i + 1) / nq) for i in range(nq)]
        qkeys = dt.to_sortable_bits(kt.kselect_many(words, ranks))  # the answers' keys
        kw = dict(words=w, shift=shift, radix_bits=4, key_op=key_op, key_xor=key_xor,
                  prefixes=dt.shift_right_logical(qkeys, shift + 4, bits).contiguous())
        err = exact(H.radix_histogram_multi, H.radix_histogram_multi_plain, f"radix_histogram_multi{name}", **kw)
        ms = cuda_ms(lambda: H.radix_histogram_multi(**kw))
        pms = cuda_ms(lambda: H.radix_histogram_multi_plain(**kw), iters=3, warmup=1)
        distinct = torch.unique(kw["prefixes"]).numel()
        b, by = bound(n * bits // 8, n, MULTI_OPS_PER_KEY)
        lms = None
        if main:
            lms = library_ms(lambda: library_histogram_multi(**kw), H.radix_histogram_multi(**kw),
                             f"radix_histogram_multi{name}")
        row(f"radix_histogram_multi{name}", n, bits // 8, ms, f"   {b / ms:.0%} of bound; plain {pms:.4f} ms; "
            f"{distinct} distinct prefixes" + ("" if lms is None else f"; library {lms:.4f} ms"),
            ops_per_key=MULTI_OPS_PER_KEY)
        print(f"[check] radix_histogram_multi{name} == plain: max_abs_err {err}")
        if main:
            kern[f"radix_histogram_multi{bits}"] = (ms, pms, b, by, err)
            library[f"radix_histogram_multi{bits}"] = lms
        torch.cuda.empty_cache()
    for name, words, key_op, key_xor, bits in (
        ("32 float32 2^26", f32, "float", 0, 32), ("64 float64 2^27", f64, "float", 0, 64),
    ):
        w = words.view(torch.int32 if bits == 32 else torch.int64)
        n = w.numel()
        tau = dt.to_sortable_bits(kt.kselect(words, n - TOPK + 1)).reshape(1)  # the 128th largest key
        kw = dict(words=w, tau=tau, largest=True, key_op=key_op, key_xor=key_xor)
        err = exact(H.tau_counts, H.tau_counts_plain, f"tau_counts{name}", **kw)
        ms = cuda_ms(lambda: H.tau_counts(**kw))
        pms = cuda_ms(lambda: H.tau_counts_plain(**kw), iters=3, warmup=1)
        lms = library_ms(lambda: library_tau_counts(**kw), H.tau_counts(**kw), f"tau_counts{name}")
        b, by = row(f"tau_counts{name}", n, bits // 8, ms, f"   plain {pms:.4f} ms; library {lms:.4f} ms",
                    nbytes=n * bits // 8 + -(-n // 128) * 8)
        print(f"[check] tau_counts{name} == plain: max_abs_err {err}")
        kern[f"tau_counts{bits}"] = (ms, pms, b, by, err)
        library[f"tau_counts{bits}"] = lms
        torch.cuda.empty_cache()

    # the batched top-k at (4096, 32768): the block kernel (values and
    # positions; and its values-only launch) beside its plain version and
    # torch.topk along the rows (a yardstick: it orders NaNs otherwise),
    # batched_topk end to end, and batched_median beside torch.kthvalue
    from mpi_k_selection_tpu_torch.ops.cuda import topk as T

    xbf = data["batched float32 normal"]
    n = xbf.numel()
    for label, x, k in (("float32 k=8", xbf, 8), ("float32 k=16", xbf, 16),
                        ("bfloat16 k=8", data["batched bfloat16 normal"], 8)):
        esz = x.element_size()
        nbytes = n * esz + BATCH * k * (esz + 8)  # the read, the values and the int64 positions
        v, i = T.batched_topk(x, k)
        want_v, want_i = T.batched_topk_plain(x, k)
        err = batched_err(v, want_v, f"batched_topk {label}")
        if not torch.equal(i, want_i):
            fail(f"batched_topk {label}: kernel positions != plain")
        ms = cuda_ms(lambda: T.batched_topk(x, k))
        pms = cuda_ms(lambda: T.batched_topk_plain(x, k), iters=3, warmup=1)
        b, by = bound(nbytes, n)
        row(f"batched_topk kernel {label} (values and positions)", n, esz, ms,
            f"   {b / ms:.0%} of bound; plain {pms:.4f} ms", nbytes=nbytes)
        vms = cuda_ms(lambda: T.batched_topk_values(x, k))
        row(f"batched_topk kernel {label} (values only)", n, esz, vms, nbytes=n * esz + BATCH * k * esz)
        tms = cuda_ms(lambda: torch.topk(x, k, dim=-1))
        row(f"torch.topk(dim=-1) {label}", n, esz, tms, nbytes=nbytes)
        print(f"[check] batched_topk {label} == plain: max_abs_err {err}, positions equal")
        if k == 8:
            kern[f"batched_topk{8 * esz}"] = (ms, pms, b, by, err)
            library[f"batched_topk{8 * esz}"] = tms
        ems = cuda_ms(lambda: kt.batched_topk(x, k), iters=20)
        row(f"batched_topk {label} (values and indices)", n, esz, ems, nbytes=nbytes)
        del v, i, want_v, want_i
        torch.cuda.empty_cache()
    mms = cuda_ms(lambda: kt.batched_median(xbf), iters=3)
    row("batched_median float32", n, 4, mms, nbytes=n * 4 + BATCH * 4)
    kms = cuda_ms(lambda: torch.kthvalue(xbf, WIDTH // 2, dim=-1), iters=3)
    row("torch.kthvalue(dim=-1) float32", n, 4, kms, nbytes=n * 4 + BATCH * 12)
    torch.cuda.empty_cache()
    return rows, kern, library


def phase_profile(fn, label: str, call_ms: float, reps: int = 3):
    """Device time by kernel (and copy) over ``reps`` calls of ``fn``
    (torch.profiler), and the device's busy share of the call's
    event-timed latency."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a window that recorded no device event is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        # device-side events only (kernels, copies): the host ops that launch
        # them report the same time again
        dev = [
            (e.key, e.count // reps, e.self_device_time_total / 1e3 / reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
        ]
        dev = sorted((d for d in dev if d[2] > 0), key=lambda d: -d[2])
        if dev:
            break
    busy = sum(d[2] for d in dev)
    if not dev:
        print(f"[profile] {label}: the profiler saw no device time; breakdown not measured")
        return None
    for name, calls, ms in dev[:12]:
        print(f"[profile] {label}: {ms:9.4f} ms  {calls:4d}x  {name[:90]}")
    idle = max(0.0, 1.0 - busy / call_ms)
    print(f"[profile] {label}: device busy {busy:.4f} ms of {call_ms:.4f} ms per call; idle share {idle:.3f}")
    return {"what": label, "busy_ms": busy, "call_ms": call_ms, "idle_share": idle,
            "top": [{"name": n[:120], "calls": c, "ms": m} for n, c, m in dev[:12]]}


class Replay:
    """A replayable chunk source that counts the passes read from it."""

    def __init__(self, chunks):
        self.chunks = chunks
        self.passes = 0

    def __call__(self):
        self.passes += 1
        return iter(self.chunks)


POOL_WIDTHS = (1, 4)  # phases 3 and 14: the one producer, and the pooled host data plane's width


def staged_bound(depth: int, window: int, workers: int) -> int:
    """Staged chunks a pipelined pass holds at most (streaming/pipeline.py):
    ``depth + window``, and one more a worker of a pooled plane."""
    return depth + window + (workers if workers > 1 else 0)


def free_host_gib() -> int:
    """The host's available memory, GiB (``free -g``)."""
    out = subprocess.run(["free", "-g"], capture_output=True, text=True, timeout=60, check=True).stdout
    return int(next(line for line in out.splitlines() if line.startswith("Mem:")).split()[6])


def make_chunks(count: int, size: int, pattern: str, dtype) -> list:
    """``datagen`` chunks, chunk i of seed i, made on 8 threads."""
    from concurrent.futures import ThreadPoolExecutor

    from mpi_k_selection_tpu_torch.utils import datagen

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(lambda i: datagen.generate(size, pattern=pattern, seed=i, dtype=dtype), range(count)))


def host_keys(x: np.ndarray) -> np.ndarray:
    """The sortable keys of a host array, with NumPy alone: an integer's
    bits with the sign bit flipped; a float's bits all flipped when
    negative, else with the sign bit set."""
    u = x.view(np.uint32 if x.itemsize == 4 else np.uint64)
    msb = u.dtype.type(1 << (8 * x.itemsize - 1))
    return np.where(u >= msb, ~u, u | msb) if x.dtype.kind == "f" else u ^ msb


def np_certificates(chunks, values) -> list:
    """[(less, leq)] for each value: the sums over the host chunks of
    #(key < v) and #(key <= v), in key space, on 8 threads: NumPy's
    certificate, independent of the port."""
    from concurrent.futures import ThreadPoolExecutor

    vkeys = host_keys(np.array(values, chunks[0].dtype))

    def one(c):
        k = host_keys(c)
        return np.array([[np.count_nonzero(k < v), np.count_nonzero(k <= v)] for v in vkeys], np.int64)

    with ThreadPoolExecutor(8) as pool:
        return [tuple(int(c) for c in row) for row in sum(pool.map(one, chunks))]


def phase_streaming():
    """Phase 3 for the streamed paths: ``kselect_streaming`` of 2^31 int32
    ``uniform`` (32 host chunks of 2^26, chunk i of seed i) at k in {1,
    250, N/2, N} at depth 2 and 0, ``kselect_streaming_many`` at the
    p50/p90/p99/p99.9 ranks, the median of 2^30 float64 ``normal`` (32
    chunks of 2^25), and ``streaming_rank_certificate`` of each answer.
    Every answer passes NumPy's certificate over the host chunks, each
    streamed certificate equals it, the sweep kernel launched once per
    chunk per pass and no plain version ran, and the device's peak stays
    in the staging window."""
    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch import api
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
    from mpi_k_selection_tpu_torch.ops.cuda import topk as T
    from mpi_k_selection_tpu_torch.utils.timing import time_fn

    free = free_host_gib()
    scale = 1 if free >= HOST_GIB_NEEDED else 2
    print(f"[stream] host memory available: {free} GiB"
          + ("" if scale == 1 else f" < {HOST_GIB_NEEDED} GiB: the streams are halved"))
    ints = Replay(make_chunks(STREAM_CHUNKS // scale, STREAM_CHUNK, "uniform", np.int32))
    f64 = Replay(make_chunks(F64_CHUNKS // scale, F64_CHUNK, "normal", np.float64))
    n32, n64 = len(ints.chunks) * STREAM_CHUNK, len(f64.chunks) * F64_CHUNK
    print(f"[stream] int32 uniform: {n32} elements in {len(ints.chunks)} chunks "
          f"({n32 * 4 / 2**30:.0f} GiB; n > 2^31 - 1: {n32 > 2**31 - 1}); float64 normal: {n64} elements in "
          f"{len(f64.chunks)} chunks ({n64 * 8 / 2**30:.0f} GiB)")
    launches = {"sweep_ingest32": 0, "sweep_ingest64": 0}
    per_call, peaks = {}, {}

    def counted(what, fn, src, bits, depth, buffers, workers=1):
        """Drives one streamed call with every count at 0 just before it;
        fails unless the sweep kernel launched once per chunk per pass (the
        passes counted at the source), nothing else launched, no plain
        version ran, and the device's peak above the resident data stays
        within the staged chunks of :func:`staged_bound` plus ``buffers``
        chunk-sized collect buffers and 64 MiB."""
        for m in (H, T, S):
            m.reset_counts()
        src.passes = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        want = src.passes * len(src.chunks)
        got = dict(S.LAUNCHES)
        others = {k: v for k, v in {**H.LAUNCHES, **T.LAUNCHES}.items() if v}
        plain = {k: v for k, v in {**H.PLAIN_CALLS, **T.PLAIN_CALLS, **S.PLAIN_CALLS}.items() if v}
        if got[f"sweep_ingest{bits}"] != want or sum(got.values()) != want or others or plain:
            fail(f"{what}: launches {got} for {src.passes} passes of {len(src.chunks)} chunks; "
                 f"other kernels {others}; plain calls {plain}")
        chunk_bytes = src.chunks[0].nbytes
        staged = staged_bound(depth, 1, workers)
        limit = (staged + buffers) * chunk_bytes + (64 << 20)
        if peak > limit:
            fail(f"{what}: peak device memory {peak} bytes over the staging window {limit}")
        print(f"[stream] {what}: {src.passes} passes x {len(src.chunks)} chunks = {want} launches of "
              f"sweep_ingest{bits}, no plain call; peak device memory {peak / 2**20:.1f} MiB "
              f"(limit {limit / 2**20:.1f} MiB: {staged} staged chunks and {buffers} collect buffers "
              f"of {chunk_bytes / 2**20:.0f} MiB, and 64 MiB)")
        for kn in launches:
            launches[kn] += got[kn]
        per_call[what] = {kn: v for kn, v in got.items() if v}
        peaks[what] = (peak, limit)
        return out

    ranks = [1, 250, n32 // 2, n32]
    answers = {}
    for depth in (2, 0):
        for k in ranks:
            answers[(k, depth)] = counted(f"kselect_streaming k={k} depth={depth}, int32 uniform 2^31",
                                          lambda: kt.kselect_streaming(ints, k, pipeline_depth=depth),
                                          ints, 32, depth, 1)
    for k in ranks:
        if answers[(k, 2)].tobytes() != answers[(k, 0)].tobytes():
            fail(f"kselect_streaming k={k}: depth 2 {answers[(k, 2)]!r} != depth 0 {answers[(k, 0)]!r}")
    what = f"kselect_streaming k={n32 // 2} depth=2 ingest_workers={POOL_WIDTHS[-1]}, int32 uniform 2^31"
    secs, pooled = time_fn(lambda: counted(what, lambda: kt.kselect_streaming(
        ints, n32 // 2, pipeline_depth=2, ingest_workers=POOL_WIDTHS[-1]), ints, 32, 2, 1, workers=POOL_WIDTHS[-1]))
    if pooled.tobytes() != answers[(n32 // 2, 2)].tobytes():
        fail(f"kselect_streaming median: ingest_workers={POOL_WIDTHS[-1]} {pooled!r} != one producer "
             f"{answers[(n32 // 2, 2)]!r}")
    print(f"[stream] {what}: {secs * 1e3:.1f} ms (one call; phase 4 times the one producer's)")
    qranks = api.quantile_ranks(QS, n32)
    qans = counted("kselect_streaming_many p50/p90/p99/p99.9 depth=2, int32 uniform 2^31",
                   lambda: kt.kselect_streaming_many(ints, qranks, pipeline_depth=2), ints, 32, 2, len(QS))
    fmed = counted("kselect_streaming median depth=2, float64 normal 2^30",
                   lambda: kt.kselect_streaming(f64, n64 // 2, pipeline_depth=2), f64, 64, 2, 1)
    checks = [(ints, 32, k, answers[(k, 2)]) for k in ranks] + [(ints, 32, k, v) for k, v in zip(qranks, qans)]
    checks.append((f64, 64, n64 // 2, fmed))
    np_certs = {}
    for src, bits, label in ((ints, 32, "int32 uniform 2^31"), (f64, 64, "float64 normal 2^30")):
        mine = [(k, v) for s, _, k, v in checks if s is src]
        want = np_certificates(src.chunks, [v for _, v in mine])
        for (k, v), (less, leq) in zip(mine, want):
            np_certs[(bits, k)] = (less, leq)
            if not less < k <= leq:
                fail(f"k={k}: answer {v!r} fails NumPy's certificate ({less}, {leq}]")
            got = counted(f"streaming_rank_certificate k={k}, {label}",
                          lambda: kt.streaming_rank_certificate(src, v), src, bits, 2, 0)
            if tuple(got) != (less, leq):
                fail(f"streaming_rank_certificate of {v!r}: {got} != NumPy's ({less}, {leq})")
            print(f"[stream] k={k}: {v!r}, NumPy certificate {less} < k <= {leq}; streamed certificate equal")
    if launches["sweep_ingest32"] == 0 or launches["sweep_ingest64"] == 0:
        fail(f"a sweep kernel never launched on the streamed paths: {launches}")
    notes = {"stream_peaks": {k: {"peak_bytes": p, "limit_bytes": lim} for k, (p, lim) in peaks.items()},
             "stream_answers": {str(k): repr(v) for k, v in answers.items()}, "stream_pooled_median_ms": secs * 1e3}
    certified = {"median32": answers[(n32 // 2, 2)], "qranks": qranks, "quantiles32": qans, "median64": fmed,
                 "median32_certificate": np_certs[(32, n32 // 2)],
                 "median_passes": per_call[f"kselect_streaming k={n32 // 2} depth=2, int32 uniform 2^31"]
                 ["sweep_ingest32"] // len(ints.chunks),
                 "quantile_passes": per_call["kselect_streaming_many p50/p90/p99/p99.9 depth=2, int32 uniform 2^31"]
                 ["sweep_ingest32"] // len(ints.chunks)}
    return ints, f64, launches, per_call, notes, certified


def phase_streaming_timing(ints, f64):
    """Phase 4 for the streamed paths: the sweep kernel at each launch kind
    of the streamed paths (:func:`sweep_kind_rows`); the streaming median
    and quantiles of the 2^31 int32 stream at depth 2 and 0, each beside
    its bound (the passes it read times the stream's bytes over the
    host-to-card rate of a pinned 2^26-word copy timed here) and beside
    the resident ``median`` of the same data placed whole on the card; then
    the sweep kernel at a 2^26-word bucket, 32- and 64-bit, beside its
    bound, its plain version and ``torch.bincount`` +
    ``torch.masked_select`` on the same tensor (a yardstick the port never
    calls)."""
    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch import api
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
    from mpi_k_selection_tpu_torch.utils import dtypes as dt
    from mpi_k_selection_tpu_torch.utils.timing import cuda_ms, time_fn

    rows, kern, library = [], {}, {}

    def row(what, ms, b, by, extra=""):
        rows.append({"what": what, "ms": ms, "bound_ms": b, "bound_by": by})
        print(f"[time] {what:<60} {ms:11.4f} ms   bound {b:9.4f} ms ({by}){extra}")

    # the sweep kernel at the launch kinds of the streamed paths, on the
    # int32 stream's chunk 0 and the float64 stream's chunk 0
    kinds = {}
    for bits, src, key_op, key_xor in ((32, ints, "xor", 1 << 31), (64, f64, "float", 0)):
        c = src.chunks[0]
        w = torch.from_numpy(c.view(np.int32 if bits == 32 else np.int64)).cuda()
        kinds[f"sweep_ingest{bits}"] = sweep_kind_rows(row, bits, w, sweep_kinds(bits, c), key_op, key_xor)
        del w
        torch.cuda.empty_cache()
    # the sketch's skewed chunks: every key of a 2^26-word int32 chunk in
    # one counter (distributed_sketch's skewed shards), and 2^26 bfloat16
    # normal values widened into 32-bit key words, as the sketch consumer
    # counts them (the prefix-free histogram part at a 16-bit digit)
    w = torch.full((STREAM_CHUNK,), 12345, dtype=torch.int32, device="cuda")
    kinds["one-hot int32"] = sweep_kind_rows(row, 32, w, [("sketch, 16 bits, one counter", dict(
        sketch_bits=SKETCH_BITS))], "xor", 1 << 31)
    gen = torch.Generator(device="cuda").manual_seed(16)
    w = dt.to_sortable_bits(torch.randn(STREAM_CHUNK, device="cuda", generator=gen).to(torch.bfloat16))
    kinds["bfloat16 keys"] = sweep_kind_rows(row, 32, w, [("bfloat16 keys, 16-bit histogram + 1-bit sketch", dict(
        hist_prefixes=[0], shift=0, radix_bits=16, sketch_bits=1))], "none", 0)
    del w, gen
    torch.cuda.empty_cache()

    pinned = torch.empty(STREAM_CHUNK, dtype=torch.int32, pin_memory=True)
    pinned.copy_(torch.from_numpy(ints.chunks[0]))
    dev = torch.empty(STREAM_CHUNK, dtype=torch.int32, device="cuda")
    link_ms = cuda_ms(lambda: dev.copy_(pinned, non_blocking=True), iters=10)
    link_rate = STREAM_CHUNK * 4 / (link_ms / 1e3)
    print(f"[time] host-to-card rate, a pinned 2^26-word copy: {link_ms:.4f} ms, {link_rate / 1e9:.2f} GB/s")
    # the producer's side of each staging: a host chunk into a pinned buffer
    host_s, _ = time_fn(lambda: pinned.copy_(torch.from_numpy(ints.chunks[1])), repeats=5, device="cpu")
    print(f"[time] host copy of a 2^26-word chunk into a pinned buffer: {host_s * 1e3:.4f} ms, "
          f"{STREAM_CHUNK * 4 / host_s / 1e9:.2f} GB/s")
    rows.append({"what": "host copy of a 2^26-word chunk into a pinned buffer", "ms": host_s * 1e3})
    del pinned, dev
    n32 = len(ints.chunks) * STREAM_CHUNK
    stream_ms = {}
    for label, fn in (("median", lambda d: kt.kselect_streaming(ints, n32 // 2, pipeline_depth=d)),
                      ("quantiles K=4", lambda d: kt.kselect_streaming_many(ints, api.quantile_ranks(QS, n32),
                                                                           pipeline_depth=d))):
        for depth in (2, 0):
            ints.passes = 0
            secs, _ = time_fn(lambda: fn(depth), repeats=2, device="cuda")  # best of two: the host is noisy
            b = ints.passes // 2 * n32 * 4 / link_rate * 1e3
            what = f"streaming {label} depth={depth}, int32 uniform 2^31"
            stream_ms[what] = secs * 1e3
            row(what, secs * 1e3, b, "bytes", f"   ({ints.passes // 2} passes over the host-to-card link)")
    # the resident yardstick: the same data whole on the card
    x = torch.empty(n32, dtype=torch.int32, device="cuda")
    for i, c in enumerate(ints.chunks):
        x[i * STREAM_CHUNK:(i + 1) * STREAM_CHUNK].copy_(torch.from_numpy(c))
    resident_fault = None
    want = kt.kselect_streaming(ints, n32 // 2)
    for n in (n32, n32 // 2):
        try:
            got = kt.median(x[:n])
            if n == n32 and got.item() != want:
                raise RuntimeError(f"resident median {got.item()} != streamed median {want}")
            ms = cuda_ms(lambda: kt.median(x[:n]), iters=2, warmup=1)
            row(f"resident median, int32 uniform {n} elements on the card", ms, *bound(n * 4, n))
            break
        except (RuntimeError, ValueError) as e:  # recorded, then timed at half the size
            resident_fault = f"resident median at n={n}: {type(e).__name__}: {e}"
            print(f"[time] FAULT {resident_fault}")
    del x
    torch.cuda.empty_cache()

    # the kernel alone at a 2^26-word bucket: a pass's histogram of the top
    # digit with one collect spec (the main path's shape), and all parts
    w32 = torch.from_numpy(ints.chunks[0]).cuda()
    w64 = torch.from_numpy(np.concatenate(f64.chunks[:2])).cuda()
    for bits, w, key_op, key_xor in ((32, w32, "xor", 1 << 31), (64, w64.view(torch.int64), "float", 0)):
        n = w.numel()
        keys = host_keys((ints.chunks[0] if bits == 32 else f64.chunks[0])[:8])
        p8 = int(keys[0]) >> (bits - 8)
        main = dict(key_op=key_op, key_xor=key_xor, hist_prefixes=[0], shift=bits - 8, radix_bits=8,
                    collect=[(bits - 24, int(keys[0]) >> (bits - 24))])
        full = dict(key_op=key_op, key_xor=key_xor, hist_prefixes=[p8, int(keys[1]) >> (bits - 8)],
                    shift=bits - 16, radix_bits=8, collect=[(bits - 16, int(keys[2]) >> (bits - 16))],
                    tee=[(bits - 8, p8), (bits - 16, int(keys[3]) >> (bits - 16))], vkey=int(keys[4]), sketch_bits=20)
        for label, kw in (("hist K=1 + one collect spec", main), ("all five parts", full)):
            out = S.sweep_ingest(w, n, **kw)
            err = sweep_err(out, S.sweep_ingest_plain(w, n, **kw), f"sweep_ingest{bits} {label}")
            ms = cuda_ms(lambda: S.sweep_ingest(w, n, **kw))
            pms = cuda_ms(lambda: S.sweep_ingest_plain(w, n, **kw), iters=3, warmup=1)
            # the bound: the read, the survivor buffers (L words each) and the
            # sketch's counters written once; the old bound counted only the
            # survivors among the buffers' words
            buffers = len(out[1]) + (out[2] is not None)
            written = sum(int(c) for _, c in out[1]) + (int(out[2][1]) if out[2] is not None else 0)
            deep = 4 << kw.get("sketch_bits", 0) if kw.get("sketch_bits") else 0
            compares = 1 + len(kw.get("collect", ())) + len(kw.get("tee", ()))  # one prefix lookup, the specs
            b, by = bound(n * bits // 8 + buffers * n * bits // 8 + deep, n, OPS_PER_KEY + compares)
            old_b, _ = bound(n * bits // 8 + written * bits // 8, n, OPS_PER_KEY + compares)
            kms = kernel_device_ms(lambda: S.sweep_ingest(w, n, **kw), "sweep_ingest_kernel")
            row(f"sweep_ingest{bits} {label}, 2^26 words", ms, b, by,
                f"   plain {pms:.4f} ms; old bound {old_b:.4f} ms; kernel alone "
                + ("not measured" if kms is None else f"{kms:.4f} ms"))
            print(f"[check] sweep_ingest{bits} {label} == plain at the timed bucket: max_abs_err {err}")
            if label == "hist K=1 + one collect spec":
                kern[f"sweep_ingest{bits}"] = (ms, pms, b, by, err)
        # yardstick: the digit histogram and the compaction as two library
        # calls on the same tensor (the digit and the mask made untimed)
        keys_t = w.view(torch.int32) ^ -(1 << 31) if bits == 32 else torch.where(w < 0, ~w, w | -(1 << 63))
        digit = ((keys_t >> (bits - 8)) & 255).long()
        mask = ((keys_t >> (bits - 8)) & 255) == p8
        lms = cuda_ms(lambda: (torch.bincount(digit, minlength=256), torch.masked_select(w, mask)))
        library[f"sweep_ingest{bits}"] = lms
        row(f"torch.bincount + torch.masked_select, {bits}-bit 2^26 words", lms, *bound(n * bits // 8, n))
        del keys_t, digit, mask
        torch.cuda.empty_cache()
    del w32, w64
    torch.cuda.empty_cache()
    return rows, kern, library, stream_ms, resident_fault, kinds


PROBE_THREADS = (1, 2, 4)  # threads of the host-copy probe
MONITOR_WINDOW, MONITOR_EVERY, MONITOR_DECAY = 8, 8, 0.5
DECAY_SHIFT = 20  # the monitor's fixed-point scale (its weights are recomputed here with NumPy)


PROBE_COPIES = 4  # host copies a thread makes in the host-copy probe


def host_copy_probe(chunks) -> list:
    """The host side of staging alone: W threads (W in
    :data:`PROBE_THREADS`) each copy :data:`PROBE_COPIES` chunks of the int32
    stream into a pinned buffer of their own, all at once, first with the
    host-to-card link idle, then with it busy (a thread copying a pinned
    chunk to the card back to back on a stream of its own, as the staging
    does). Per-copy ms, the aggregate host-copy rate, and the link's rate
    while the copies ran: what the pooled host data plane's workers
    (``ingest_workers`` > 1, phase 14) can gain on this host's copies."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from mpi_k_selection_tpu_torch.utils.timing import Stopwatch, time_fn

    nbytes = chunks[0].nbytes
    link_src = torch.empty(STREAM_CHUNK, dtype=torch.int32, pin_memory=True)
    link_dst = torch.empty(STREAM_CHUNK, dtype=torch.int32, device="cuda")
    out = []
    for with_link in (False, True):
        for w in PROBE_THREADS:
            bufs = [torch.empty(STREAM_CHUNK, dtype=torch.int32, pin_memory=True) for _ in range(w)]
            copies = Stopwatch()
            stop = threading.Event()
            fed = [0]

            def feed():  # the card's own copies from pinned memory, one after another
                stream = torch.cuda.Stream()
                with torch.cuda.stream(stream):
                    while not stop.is_set():
                        link_dst.copy_(link_src, non_blocking=True)
                        stream.synchronize()
                        fed[0] += 1

            def work(j):
                for i in range(PROBE_COPIES):
                    src = torch.from_numpy(chunks[(j * PROBE_COPIES + i) % len(chunks)])
                    with copies.timing():
                        bufs[j].copy_(src)

            feeder = threading.Thread(target=feed) if with_link else None
            if feeder is not None:
                feeder.start()
            try:
                with ThreadPoolExecutor(w) as pool:
                    secs, _ = time_fn(lambda: list(pool.map(work, range(w))), device="cpu")
            finally:
                stop.set()
                if feeder is not None:
                    feeder.join()
            rec = {"threads": w, "link_busy": with_link, "copy_ms": copies.seconds / copies.count * 1e3,
                   "aggregate_gb_s": w * PROBE_COPIES * nbytes / secs / 1e9,
                   "link_gb_s": fed[0] * nbytes / secs / 1e9 if with_link else None}
            out.append(rec)
            print(f"[phase7] host-copy probe: {w} thread(s), link {'busy' if with_link else 'idle'}: "
                  f"{rec['copy_ms']:.2f} ms a 256 MiB copy, {rec['aggregate_gb_s']:.2f} GB/s in all"
                  + (f"; the link meanwhile {rec['link_gb_s']:.2f} GB/s" if with_link else ""))
            del bufs
    return out


def profiled_call(fn):
    """One call of ``fn`` under torch.profiler, timed with CUDA events
    inside it: ``(result, ms, busy_ms, idle_share, top)``. ``busy_ms`` is
    the union of the device's kernel and copy intervals (copies on the
    staging stream overlap the compute stream's kernels); None
    when the profiler saw no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
    ms = a.elapsed_time(b)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return out, ms, None, None, []
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo = busy + hi - lo, start
        hi = max(hi, end)
    busy = (busy + hi - lo) / 1e3
    top = sorted(((e.key[:90], e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA), key=lambda t: -t[2])
    return out, ms, busy, max(0.0, 1.0 - busy / ms), top


def np_chunk_sketches(chunks, bits: int = SKETCH_BITS) -> list:
    """Each chunk's deepest sketch level (the count of each value of its
    keys' top ``bits`` bits), key min, key max and size, with NumPy alone
    on 8 threads."""
    from concurrent.futures import ThreadPoolExecutor

    def one(c):
        k = host_keys(c)
        top = k >> k.dtype.type(8 * k.itemsize - bits)
        return np.bincount(top.astype(np.int64), minlength=1 << bits), int(k.min()), int(k.max()), k.size

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(one, chunks))


def np_sketch(parts, weights=None):
    """The NumPy sketch ``(deep, n, key min, key max)`` of per-chunk
    sketches, each count scaled by its chunk's integer weight."""
    weights = [1] * len(parts) if weights is None else weights
    deep = sum(p[0] * w for p, w in zip(parts, weights))
    return deep, sum(p[3] * w for p, w in zip(parts, weights)), min(p[1] for p in parts), max(p[2] for p in parts)


def check_sketch(sk, want, what: str) -> None:
    """Fails unless the port's sketch equals NumPy's ``want`` bit for bit:
    every level (the shallower ones are sums of the deepest), n and the
    extremes."""
    deep, n, kmin, kmax = want
    levels_ok = all(
        np.array_equal(h, deep.reshape(1 << (sk.radix_bits * (i + 1)), -1).sum(axis=1)) for i, h in enumerate(sk.hists)
    )
    if not (levels_ok and sk.n == n and int(sk._min_key) == kmin and int(sk._max_key) == kmax):
        fail(f"{what}: the sketch != NumPy's (n {sk.n} vs {n}; min {sk._min_key} vs {kmin}; "
             f"max {sk._max_key} vs {kmax}; levels equal {levels_ok})")


def phase_sketch_staging(ints, f64, certified):
    """Phase 7, this slice's paths on the card, each driven with the launch
    counts set to 0 just before it and read just after (the sweep kernel
    once per chunk per pass, no plain call):

    - the staging: :func:`host_copy_probe` (the host copies alone, at
      1, 2 and 4 threads, the link idle and busy); the streamed median of
      the 2^31 int32 stream and of the 2^30 float64 stream at depth 2,
      each one call under the profiler: its answer against phase 3's
      certified answer, wall ms, the device's idle share, the host copy
      into a pinned buffer per chunk, the most pinned bytes in use and
      the peak device memory against the staging bounds (``depth + 1``
      chunks);
    - the sketch: ``StreamingQuantiles(int32).update_stream`` of the int32
      stream, against NumPy's sketch of the host chunks
      bit for bit, and one more such call under the profiler (the sweep
      kernel's device time over the stream); the true ranks and values of p50/p90/p99/p99.9 inside
      its bounds; ``refine_quantiles`` exact against phase 3, its passes
      beside the unseeded descent's; the float64 stream's sketch and its
      refined median;
    - the monitor over the int32 stream given as a one-shot generator
      (window 8, a sample every 8 chunks), exact and with ``decay=0.5``:
      each sample's window sketch against NumPy's counts of that window's
      chunks, and ms a sample."""
    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
    from mpi_k_selection_tpu_torch.ops.cuda import topk as T
    from mpi_k_selection_tpu_torch.streaming import pipeline as pl
    from mpi_k_selection_tpu_torch.utils.timing import time_fn

    launches = {"sweep_ingest32": 0, "sweep_ingest64": 0}
    per_call, out = {}, {"staging": [], "sketch": {}, "monitor": {}}

    def counted(what, fn, src, bits):
        """Drives one call with every count at 0; fails unless the sweep
        kernel launched once per chunk per pass read (counted at the
        source) and nothing else ran. Returns the call's result."""
        for m in (H, T, S):
            m.reset_counts()
        src.passes = 0
        res = fn()
        torch.cuda.synchronize()
        want = src.passes * len(src.chunks)
        others = {k: v for k, v in {**H.LAUNCHES, **T.LAUNCHES}.items() if v}
        plain = {k: v for k, v in {**H.PLAIN_CALLS, **T.PLAIN_CALLS, **S.PLAIN_CALLS}.items() if v}
        if S.LAUNCHES[f"sweep_ingest{bits}"] != want or sum(S.LAUNCHES.values()) != want or others or plain:
            fail(f"{what}: launches {dict(S.LAUNCHES)} for {src.passes} passes of {len(src.chunks)} chunks; "
                 f"other kernels {others}; plain calls {plain}")
        for kn in launches:
            launches[kn] += S.LAUNCHES[kn]
        per_call[what] = {kn: v for kn, v in S.LAUNCHES.items() if v}
        print(f"[phase7] {what}: {src.passes} passes x {len(src.chunks)} chunks = {want} launches of "
              f"sweep_ingest{bits}, no plain call")
        return res

    # the staging: the host side alone, then the streamed median of each stream
    out["host_copy_probe"] = host_copy_probe(ints.chunks)
    n32, n64 = len(ints.chunks) * STREAM_CHUNK, len(f64.chunks) * F64_CHUNK
    runs = [(ints, 32, n32 // 2, certified["median32"]), (f64, 64, n64 // 2, certified["median64"])]
    for src, bits, k, want in runs:
        what = f"streaming median depth=2, {'int32 uniform 2^31' if bits == 32 else 'float64 normal 2^30'}"
        pl.STAGING_POOL.clear()
        pl.STAGING_POOL.reset_peaks()
        pl.HOST_COPY.reset()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got, ms, busy, idle, top = counted(
            what, lambda: profiled_call(lambda: kt.kselect_streaming(src, k, pipeline_depth=2)),
            src, bits)
        if got.tobytes() != want.tobytes():
            fail(f"{what}: {got!r} != phase 3's certified answer {want!r}")
        peak_dev = torch.cuda.max_memory_allocated() - base
        chunk_bytes = src.chunks[0].nbytes
        pinned_bound = (2 + 1) * chunk_bytes
        dev_bound = (2 + 1 + 1) * chunk_bytes + (64 << 20)  # the staged chunks, one collect buffer
        if not 0 < pl.STAGING_POOL.peak_live_bytes <= pinned_bound or pl.STAGING_POOL.live_bytes:
            fail(f"{what}: pinned bytes in use peaked at {pl.STAGING_POOL.peak_live_bytes} (bound {pinned_bound}), "
                 f"{pl.STAGING_POOL.live_bytes} still out")
        if peak_dev > dev_bound:
            fail(f"{what}: peak device memory {peak_dev} over the staging bound {dev_bound}")
        copy_ms = pl.HOST_COPY.seconds / max(1, pl.HOST_COPY.count) * 1e3
        rec = {"what": what, "ms": ms, "busy_ms": busy, "idle_share": idle,
               "host_copy_ms_per_chunk": copy_ms, "host_copies": pl.HOST_COPY.count,
               "peak_pinned_in_use_bytes": pl.STAGING_POOL.peak_live_bytes,
               "peak_pinned_held_bytes": pl.STAGING_POOL.peak_bytes, "pinned_bound_bytes": pinned_bound,
               "peak_device_bytes": peak_dev, "device_bound_bytes": dev_bound, "answer": repr(got),
               "top": [{"name": n, "calls": c, "ms": m} for n, c, m in top[:4]]}
        out["staging"].append(rec)
        print(f"[phase7] {what}: {got!r} == phase 3; {ms:.1f} ms; device busy "
              + ("not measured" if busy is None else f"{busy:.1f} ms, idle share {idle:.3f}")
              + f"; host copy {copy_ms:.2f} ms a chunk over {pl.HOST_COPY.count} copies; pinned in use peak "
              f"{pl.STAGING_POOL.peak_live_bytes / 2**20:.0f} MiB (bound {pinned_bound / 2**20:.0f}); device peak "
              f"{peak_dev / 2**20:.0f} MiB (bound {dev_bound / 2**20:.0f})")
    pl.STAGING_POOL.clear()

    # the sketch: update_stream, against NumPy
    parts32 = np_chunk_sketches(ints.chunks)
    what = "StreamingQuantiles(int32).update_stream, int32 uniform 2^31"
    sq = kt.StreamingQuantiles(np.int32)
    secs, _ = time_fn(lambda: counted(what, lambda: sq.update_stream(ints), ints, 32), device="cuda")
    check_sketch(sq.sketch, np_sketch(parts32), what)
    out["sketch"][what] = {"ms": secs * 1e3}
    print(f"[phase7] {what}: {secs * 1e3:.1f} ms; the sketch == NumPy's bit for bit (n {sq.n})")
    # one more call of a fresh sketch under the profiler (after one
    # unprofiled): the sweep kernel's device time over the stream
    prof = phase_profile(lambda: kt.StreamingQuantiles(np.int32).update_stream(ints), what, secs * 1e3, reps=1)
    if prof is not None:
        sweep = [t for t in prof["top"] if "sweep_ingest_kernel" in t["name"]]
        out["sketch"][what]["sweep_device_ms"] = sum(t["ms"] for t in sweep)
        out["sketch"][what]["sweep_launches"] = sum(t["calls"] for t in sweep)
        out["sketch"][what]["profile"] = prof
        print(f"[phase7] {what}: sweep_ingest_kernel device time {out['sketch'][what]['sweep_device_ms']:.4f} ms "
              f"over {out['sketch'][what]['sweep_launches']} launches (torch.profiler)")
    for k, v in zip(certified["qranks"], certified["quantiles32"]):
        lo, hi = sq.sketch.rank_bounds(k)
        vlo, vhi = sq.sketch.value_bounds(k)
        if not (lo < k <= hi and host_keys(np.array([vlo, v, vhi], np.int32)).tolist()
                == sorted(host_keys(np.array([vlo, v, vhi], np.int32)).tolist())):
            fail(f"k={k}: rank bounds ({lo}, {hi}] or value bounds [{vlo!r}, {vhi!r}] miss the answer {v!r}")
        print(f"[phase7] k={k}: rank bounds ({lo}, {hi}] (error bound {hi - lo}), values [{vlo!r}, {vhi!r}] "
              f"hold the certified {v!r}")
    what = "refine_quantiles p50/p90/p99/p99.9, int32 uniform 2^31"
    secs, refined = time_fn(lambda: counted(what, lambda: sq.refine_quantiles(QS, ints), ints, 32), device="cuda")
    if np.array(refined).tobytes() != np.array(certified["quantiles32"]).tobytes():
        fail(f"{what}: {refined!r} != phase 3's {certified['quantiles32']!r}")
    seeded = per_call[what]["sweep_ingest32"] // len(ints.chunks)
    out["sketch"][what] = {"ms": secs * 1e3, "passes": seeded, "unseeded_passes": certified["quantile_passes"]}
    print(f"[phase7] {what}: exact; {secs * 1e3:.1f} ms; {seeded} passes read against the unseeded descent's "
          f"{certified['quantile_passes']}")
    parts64 = np_chunk_sketches(f64.chunks)
    what = "StreamingQuantiles(float64).update_stream, float64 normal 2^30"
    t64 = kt.StreamingQuantiles(np.float64)
    secs, _ = time_fn(lambda: counted(what, lambda: t64.update_stream(f64), f64, 64), device="cuda")
    check_sketch(t64.sketch, np_sketch(parts64), what)
    out["sketch"][what] = {"ms": secs * 1e3}
    what = "RadixSketch.refine median, float64 normal 2^30"
    secs, med = time_fn(lambda: counted(what, lambda: t64.sketch.refine(f64, n64 // 2), f64, 64), device="cuda")
    if med.tobytes() != certified["median64"].tobytes():
        fail(f"{what}: {med!r} != phase 3's {certified['median64']!r}")
    out["sketch"][what] = {"ms": secs * 1e3, "passes": per_call[what]["sweep_ingest64"] // len(f64.chunks)}
    print(f"[phase7] float64: the sketch == NumPy's; refined median {med!r} exact in "
          f"{out['sketch'][what]['passes']} passes, {secs * 1e3:.1f} ms")

    # the monitor over a one-shot generator, exact and decayed
    for decay in (None, MONITOR_DECAY):
        what = f"Monitor window={MONITOR_WINDOW} emit_every={MONITOR_EVERY} decay={decay}, int32 uniform 2^31"
        mon = kt.Monitor(window=MONITOR_WINDOW, emit_every=MONITOR_EVERY, decay=decay)
        windows = []

        def drive():
            for sample in mon.run((c for c in ints()), np.int32):  # a one-shot generator over one read
                windows.append((sample, mon.ws.query()))

        secs, _ = time_fn(lambda: counted(what, drive, ints, 32), device="cuda")
        if len(windows) != len(ints.chunks) // MONITOR_EVERY:
            fail(f"{what}: {len(windows)} samples")
        for i, (sample, sk) in enumerate(windows):
            buckets = list(range(max(0, i - MONITOR_WINDOW + 1), i + 1))
            chunks_in, weights = [], []
            for age, bucket in enumerate(reversed(buckets)):
                w = 1 if decay is None else int(round(decay**age * (1 << DECAY_SHIFT)))
                for j in range(bucket * MONITOR_EVERY, (bucket + 1) * MONITOR_EVERY):
                    chunks_in.append(parts32[j])
                    weights.append(w)
            check_sketch(sk, np_sketch(chunks_in, weights), f"{what} sample {i}")
            if sample.n != sk.n:
                fail(f"{what} sample {i}: n {sample.n} != its window's {sk.n}")
        out["monitor"][what] = {"ms": secs * 1e3, "samples": len(windows), "ms_per_sample": secs * 1e3 / len(windows),
                                "last": windows[-1][0].as_dict()}
        print(f"[phase7] {what}: {len(windows)} samples, each window == NumPy's counts; {secs * 1e3:.1f} ms, "
              f"{secs * 1e3 / len(windows):.1f} ms a sample; last: {windows[-1][0].format_line()}")
    return launches, per_call, out


SPILL_DISK_FACTOR = 1.5  # free disk under the spill root needed, times the int32 stream's bytes
# The arithmetic of the int32 stream's spill median (values in [1, 10^8]:
# the top 8-bit key digit takes 6 values, the median's about 16.8% of N):
# (pass, GiB read, GiB written), and the collect's read
SPILL_PREDICTED = ((0, 16.0, 16.0), (1, 16.0, 2.69), (2, 2.69, 10.7 / 1024), ("collect", 10.7 / 1024, None))


def disk_bytes(root: str) -> int:
    """Bytes of the files under ``root`` (``os.scandir``)."""
    total = 0
    for entry in os.scandir(root):
        if entry.is_dir(follow_symlinks=False):
            total += disk_bytes(entry.path)
        elif entry.is_file(follow_symlinks=False):
            total += entry.stat(follow_symlinks=False).st_size
    return total


class SpillWatch:
    """While active, every generation committed under ``root`` is noted
    with its record count, and the bytes on disk under ``root`` are
    sampled after each commit (the peak is what the store held at once):
    ``SpillWriter.commit`` is wrapped for the call's duration."""

    def __init__(self, root: str, base: int | None = None):
        self.root = root
        self.base = base  # records of a generation read before the first commit (a store as source)
        self.stores, self.records, self.samples = [], [], []

    def __enter__(self):
        from mpi_k_selection_tpu_torch.streaming import spill as sp

        self._sp, self._commit = sp, sp.SpillWriter.commit
        watch = self

        def commit(writer):
            gen = watch._commit(writer)
            if writer.store not in watch.stores:
                watch.stores.append(writer.store)
            watch.records.append(len(gen.records))
            watch.samples.append(disk_bytes(watch.root))
            return gen

        sp.SpillWriter.commit = commit
        return self

    def __exit__(self, *exc):
        self._sp.SpillWriter.commit = self._commit

    @property
    def peak(self) -> int:
        return max(self.samples, default=0)


def print_pass_log(what: str, log, predicted=None) -> None:
    """One line a pass: keys and bytes read and written (GiB), beside the
    arithmetic where given; then the bytes over the link and to disk."""
    pred = {p: (r, w) for p, r, w in predicted or ()}
    for e in log:
        line = (f"[spill] {what}: pass {e['pass']!s:>7} read {e['read']:<6} {e['keys_read']:>11} keys "
                f"{e['bytes_read'] / 2**30:8.4f} GiB")
        if "keys_written" in e:
            line += f", wrote {e['keys_written']:>11} keys {e['bytes_written'] / 2**30:8.4f} GiB"
        if e["pass"] in pred:
            r, w = pred[e["pass"]]
            line += f"   (arithmetic: read {r:.4f} GiB" + ("" if w is None else f", write {w:.4f} GiB") + ")"
        print(line)
    link = sum(e["bytes_read"] for e in log)
    disk = sum(e.get("bytes_written", 0) for e in log)
    print(f"[spill] {what}: {link / 2**30:.3f} GiB read over the link, {disk / 2**30:.3f} GiB written to disk")


def phase_spill(ints, f64, certified):
    """Phase 8, the spill descent (this slice's path), on the 2^31 int32
    stream of phase 3, each call driven with the launch counts set to 0
    just before it and read just after (the sweep kernel once per chunk
    read in each pass, counted from the generations' records; no other
    kernel, no plain call):

    - the free disk under the spill root (``shutil.disk_usage``): below
      1.5x the stream's bytes the stream is halved, and the cut printed;
    - the median of the first half of the stream (the run's time: 2^30
      keys, 4 GiB) read as a
      ONE-SHOT generator, ``spill="auto"``, one call under the profiler:
      its answer against NumPy's certificate (phase 3's certified median
      when the whole stream is read), wall ms, its ``pass_log`` (beside
      the arithmetic above on the whole stream), the bytes over the link
      against the replay's, the peak bytes on disk (sampled after each
      commit), the sweep kernel's device time and the idle share;
    - on the first quarter of the stream (2^29 keys; the run's time;
      phase 9 runs the format-v2 twins on the same
      quarter): the p50/p90/p99/p99.9 with
      ``spill="force"``, against NumPy's certificates, with its
      ``pass_log``; ``StreamingQuantiles.update_stream(one_shot,
      spill=store)`` into a store this phase owns, ``refine_quantiles``
      from the store (equal to the spill-forced answers) and
      ``streaming_rank_certificate(store, median)`` equal to NumPy's
      certificate;
    - row 8's tee launch kind (the histogram under one 8-bit prefix and a
      one-spec tee, a later spill pass's launch) on chunk 0 of each
      stream, timed as phase 4 times the other kinds.
    """
    import shutil
    import tempfile

    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
    from mpi_k_selection_tpu_torch.ops.cuda import topk as T
    from mpi_k_selection_tpu_torch.utils.timing import time_fn

    out = {"calls": {}}
    launches = {"sweep_ingest32": 0, "sweep_ingest64": 0}
    per_call = {}
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    chunks = ints.chunks
    print(f"[spill] free disk under {tmp}: {free / 2**30:.1f} GiB (needed "
          f"{SPILL_DISK_FACTOR * sum(c.nbytes for c in chunks) / 2**30:.1f} GiB)")
    cuts = []
    while len(chunks) > 1 and free < SPILL_DISK_FACTOR * sum(c.nbytes for c in chunks):
        chunks = chunks[: len(chunks) // 2]
        cuts.append(f"free disk {free} bytes < {SPILL_DISK_FACTOR}x the stream: halved to {len(chunks)} chunks")
        print(f"[spill] CUT: {cuts[-1]}")
    if cuts:
        out["cut"] = cuts
    # the first half, for the run's time
    chunks = chunks[: max(1, min(len(chunks), len(ints.chunks) // 2))]
    out.setdefault("cut", []).append(f"the one-shot median on the first {len(chunks)} chunks (the run's time)")
    print(f"[spill] CUT: {out['cut'][-1]}")
    full = len(chunks) == len(ints.chunks)
    n = len(chunks) * STREAM_CHUNK
    root = tempfile.mkdtemp(prefix="chip-smoke-spill-root-", dir=tmp)

    def counted(what, fn, watch, source_chunks):
        """One call with every count at 0 just before it: fails unless the
        sweep kernel launched once for each chunk read in each pass (the
        source's chunks in pass 0 when it reads the source, then the
        records of each generation read) and nothing else ran."""
        for m in (H, T, S):
            m.reset_counts()
        res = fn()
        torch.cuda.synchronize()
        log = watch.stores[-1].pass_log
        want, prev = 0, watch.base
        gens = iter(watch.records)
        for e in log:
            want += source_chunks if e["read"] == "source" else prev
            if "keys_written" in e:
                prev = next(gens)
        others = {k: v for k, v in {**H.LAUNCHES, **T.LAUNCHES}.items() if v}
        plain = {k: v for k, v in {**H.PLAIN_CALLS, **T.PLAIN_CALLS, **S.PLAIN_CALLS}.items() if v}
        if S.LAUNCHES["sweep_ingest32"] != want or S.LAUNCHES["sweep_ingest64"] or others or plain:
            fail(f"{what}: launches {dict(S.LAUNCHES)}, expected {want} from the pass log {log} and the "
                 f"generations' records {watch.records}; other kernels {others}; plain calls {plain}")
        for kn in launches:
            launches[kn] += S.LAUNCHES[kn]
        per_call[what] = {kn: v for kn, v in S.LAUNCHES.items() if v}
        if glob.glob(os.path.join(root, "ksel-spill-*")) and what not in out.get("keep", ()):
            fail(f"{what}: a spill store outlived the call: {os.listdir(root)}")
        print(f"[spill] {what}: {want} launches of sweep_ingest32 over {len(log)} passes, no plain call")
        return res

    try:
        # the median of a one-shot generator, spill="auto", under the profiler
        what = f"streaming median spill=auto one-shot depth=2, int32 uniform {n} elements"
        k = n // 2
        with SpillWatch(root) as watch:
            got, ms, busy, idle, top = counted(what, lambda: profiled_call(lambda: kt.kselect_streaming(
                (c for c in chunks), k, spill="auto", spill_dir=root)), watch, len(chunks))
        if full and got.tobytes() != certified["median32"].tobytes():
            fail(f"{what}: {got!r} != phase 3's certified median {certified['median32']!r}")
        if not full:
            less, leq = np_certificates(chunks, [got])[0]
            if not less < k <= leq:
                fail(f"{what}: {got!r} fails NumPy's certificate ({less}, {leq}]")
        log = watch.stores[-1].pass_log
        sweep = sum(m for name, _, m in top if "sweep_ingest_kernel" in name)
        sweep_calls = sum(c for name, c, _ in top if "sweep_ingest_kernel" in name)
        print_pass_log(what, log, SPILL_PREDICTED if full else None)
        link = sum(e["bytes_read"] for e in log)
        replay = certified["median_passes"] * n * 4  # the replay's reads of the same chunks
        print(f"[spill] {what}: {got!r} certified; {ms:.1f} ms; peak on disk "
              f"{watch.peak / 2**30:.3f} GiB (samples {[round(b / 2**30, 3) for b in watch.samples]}); over the "
              f"link {link / 2**30:.2f} GiB against the replay's {replay / 2**30:.0f} GiB "
              f"({certified['median_passes']} reads); device busy "
              + ("not measured" if busy is None else f"{busy:.1f} ms, idle share {idle:.3f}")
              + f"; sweep_ingest_kernel {sweep:.3f} ms over {sweep_calls} launches (torch.profiler)")
        out["calls"][what] = {"ms": ms, "busy_ms": busy, "idle_share": idle, "answer": repr(got),
                              "pass_log": log, "peak_disk_bytes": watch.peak, "disk_samples": watch.samples,
                              "generation_records": watch.records, "link_bytes": link, "replay_link_bytes": replay,
                              "sweep_device_ms": sweep, "sweep_launches_profiled": sweep_calls,
                              "top": [{"name": nm, "calls": c, "ms": m} for nm, c, m in top[:6]]}

        # the later calls read the first quarter of the stream, for the
        # run's time: phase 9 runs their format-v2 twins on the same quarter
        chunks, full = chunks[: max(1, len(chunks) // 2)], False
        n = len(chunks) * STREAM_CHUNK
        out.setdefault("cut", []).append(f"quantiles K=4 spill=force and the sketch flow on the first {len(chunks)} "
                                         "chunks (the run's time)")
        print(f"[spill] CUT: {out['cut'][-1]}")

        # quantiles K=4 of the replayable chunks, spill="force"
        what = f"streaming quantiles K=4 spill=force depth=2, int32 uniform {n} elements"
        qranks = certified["qranks"] if full else [max(1, min(n, int(np.ceil(q * n)))) for q in QS]
        with SpillWatch(root) as watch:
            secs, qans = time_fn(lambda: counted(what, lambda: kt.kselect_streaming_many(
                chunks, qranks, spill="force", spill_dir=root), watch, len(chunks)), device="cuda")
        if full and np.array(qans).tobytes() != np.array(certified["quantiles32"]).tobytes():
            fail(f"{what}: {qans!r} != phase 3's {certified['quantiles32']!r}")
        if not full:
            for kq, v, (less, leq) in zip(qranks, qans, np_certificates(chunks, qans)):
                if not less < kq <= leq:
                    fail(f"{what}: k={kq}: {v!r} fails NumPy's certificate ({less}, {leq}]")
        log = watch.stores[-1].pass_log
        print_pass_log(what, log)
        print(f"[spill] {what}: {[repr(v) for v in qans]} exact; {secs * 1e3:.1f} ms; peak on disk "
              f"{watch.peak / 2**30:.3f} GiB")
        out["calls"][what] = {"ms": secs * 1e3, "answers": [repr(v) for v in qans], "pass_log": log,
                              "peak_disk_bytes": watch.peak, "generation_records": watch.records}

        # the sketch-then-refine flow through a store this phase owns
        with kt.SpillStore(root) as store:
            sq = kt.StreamingQuantiles(np.int32)
            what = f"StreamingQuantiles.update_stream(one-shot, spill=store), int32 uniform {n} elements"
            out["keep"] = {what}
            with SpillWatch(root) as watch:
                for m in (H, T, S):
                    m.reset_counts()
                secs, _ = time_fn(lambda: sq.update_stream((c for c in chunks), spill=store), device="cuda")
                torch.cuda.synchronize()
            if S.LAUNCHES["sweep_ingest32"] != len(chunks) or any(S.PLAIN_CALLS.values()):
                fail(f"{what}: launches {dict(S.LAUNCHES)} for {len(chunks)} chunks; plain {dict(S.PLAIN_CALLS)}")
            launches["sweep_ingest32"] += S.LAUNCHES["sweep_ingest32"]
            per_call[what] = {"sweep_ingest32": S.LAUNCHES["sweep_ingest32"]}
            gen0 = store.latest_generation()
            if gen0.keys != n:
                fail(f"{what}: generation 0 holds {gen0.keys} keys, not {n}")
            print(f"[spill] {what}: {secs * 1e3:.1f} ms; generation 0 {gen0.keys} keys, "
                  f"{gen0.nbytes / 2**30:.3f} GiB on disk, {len(gen0.records)} records")
            out["calls"][what] = {"ms": secs * 1e3, "generation0_bytes": gen0.nbytes}
            what = f"refine_quantiles p50/p90/p99/p99.9 from the store, int32 uniform {n} elements"
            out["keep"].add(what)
            with SpillWatch(root, base=len(gen0.records)) as watch:
                watch.stores.append(store)
                secs, refined = time_fn(lambda: counted(
                    what, lambda: sq.refine_quantiles(QS, store), watch, 0), device="cuda")
            if full and np.array(refined).tobytes() != np.array(certified["quantiles32"]).tobytes():
                fail(f"{what}: {refined!r} != phase 3's {certified['quantiles32']!r}")
            if not full and np.array(refined).tobytes() != np.array(qans).tobytes():
                fail(f"{what}: {refined!r} != the spill-forced quantiles {qans!r}")
            print_pass_log(what, store.pass_log)
            print(f"[spill] {what}: exact; {secs * 1e3:.1f} ms")
            out["calls"][what] = {"ms": secs * 1e3, "pass_log": list(store.pass_log)}
            what = f"streaming_rank_certificate(store, median), int32 uniform {n} elements"
            med = certified["median32"] if full else got
            for m in (H, T, S):
                m.reset_counts()
            secs, cert = time_fn(lambda: kt.streaming_rank_certificate(store, med), device="cuda")
            want = certified["median32_certificate"] if full else np_certificates(chunks, [med])[0]
            if tuple(cert) != tuple(want) or S.LAUNCHES["sweep_ingest32"] != len(chunks):
                fail(f"{what}: {cert} != NumPy's {want}, or launches {dict(S.LAUNCHES)} != {len(chunks)}")
            launches["sweep_ingest32"] += S.LAUNCHES["sweep_ingest32"]
            per_call[what] = {"sweep_ingest32": S.LAUNCHES["sweep_ingest32"]}
            print(f"[spill] {what}: {cert} == NumPy's certificate; {secs * 1e3:.1f} ms from disk")
            out["calls"][what] = {"ms": secs * 1e3, "certificate": list(cert)}
        out.pop("keep")
        if glob.glob(os.path.join(root, "ksel-spill-*")):
            fail(f"a spill store outlived phase 8: {os.listdir(root)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # row 8's tee launch kinds on chunk 0 of each stream
    rows = []

    def row(what, ms, b, by, extra=""):
        rows.append({"what": what, "ms": ms, "bound_ms": b, "bound_by": by})
        print(f"[time] {what:<60} {ms:11.4f} ms   bound {b:9.4f} ms ({by}){extra}")

    kinds = {}
    for bits, src, key_op, key_xor in ((32, ints, "xor", 1 << 31), (64, f64, "float", 0)):
        c = src.chunks[0]
        w = torch.from_numpy(c.view(np.int32 if bits == 32 else np.int64)).cuda()
        kinds[f"sweep_ingest{bits}"] = sweep_kind_rows(row, bits, w, tee_kinds(bits, c), key_op, key_xor)
        del w
        torch.cuda.empty_cache()
    out["tee_kind"] = kinds
    out["timings"] = rows
    return launches, per_call, out


def auto_kinds(bits: int, chunk: np.ndarray):
    """(label, sweep_ingest parts) of each launch kind ``width_schedule=
    "auto"`` adds on one chunk of a stream, with the prefixes its own
    median and quantile keys give: the 16-bit first pass; for 32-bit keys
    an 8-bit digit under the median's 16-bit prefix (pass 1), under the
    4 quantile keys' 16-bit prefixes, beside the tee of that prefix (a
    spill pass 1) and of the 4 (the spilled quantiles' pass 1), and the
    last 16 bits under one and under the 4
    prefixes (the refinement of a 16-bit sketch); for 64-bit keys a 16-bit digit under one and under
    the 4 quantile keys' 16-bit prefixes (pass 1), and an 8-bit digit
    under a 32-bit prefix (pass 2)."""
    keys = host_keys(chunk)
    n = keys.size
    ranks = [n // 2] + [max(0, int(np.ceil(q * n)) - 1) for q in QS]
    part = np.partition(keys, ranks)
    med = int(part[ranks[0]])
    q16 = sorted({int(part[r]) >> (bits - 16) for r in ranks[1:]})
    kinds = [("hist 16 bits, no prefix (auto pass 0)", dict(hist_prefixes=[0], shift=bits - 16, radix_bits=16))]
    if bits == 32:
        one = dict(hist_prefixes=[med >> 16], shift=8, radix_bits=8)
        return kinds + [
            ("hist 8 bits under a 16-bit prefix (auto pass 1)", one),
            (f"hist 8 bits under {len(q16)} 16-bit prefixes (auto quantiles pass 1)",
             dict(hist_prefixes=q16, shift=8, radix_bits=8)),
            ("hist 8 bits under a 16-bit prefix + its tee (auto spill pass 1)", dict(one, tee=[(16, med >> 16)])),
            (f"hist 8 bits under {len(q16)} 16-bit prefixes + their tee (auto spilled quantiles pass 1)",
             dict(hist_prefixes=q16, shift=8, radix_bits=8, tee=[(16, q) for q in q16])),
            ("hist 16 bits under a 16-bit prefix (auto refine of a 16-bit sketch)",
             dict(hist_prefixes=[med >> 16], shift=0, radix_bits=16)),
            (f"hist 16 bits under {len(q16)} 16-bit prefixes (auto refine_quantiles)",
             dict(hist_prefixes=q16, shift=0, radix_bits=16)),
        ]
    return kinds + [
        ("hist 16 bits under a 16-bit prefix (auto pass 1)", dict(hist_prefixes=[med >> 48], shift=32, radix_bits=16)),
        (f"hist 16 bits under {len(q16)} 16-bit prefixes (auto quantiles pass 1)",
         dict(hist_prefixes=q16, shift=32, radix_bits=16)),
        ("hist 8 bits under a 32-bit prefix (auto pass 2)", dict(hist_prefixes=[med >> 32], shift=24, radix_bits=8)),
    ]


def print_pack_log(what: str, log, host) -> None:
    """One line a pass of a spilled call: the keys and the logical and
    physical bytes it read and wrote (GiB), and its host ms in the record
    work (prepare: checksums, and the pack of format v2; write; read: file
    reads, checksums and the v2 decode), from ``SpillStore.pass_host_ms``."""
    for e, h in zip(log, host):
        line = (f"[width] {what}: pass {e['pass']!s:>7} read {e['read']:<6} {e['keys_read']:>11} keys "
                f"{e['bytes_read'] / 2**30:8.4f} GiB ({e['disk_bytes_read'] / 2**30:8.4f} on disk)")
        if "keys_written" in e:
            line += (f", wrote {e['keys_written']:>11} keys {e['bytes_written'] / 2**30:8.4f} GiB "
                     f"({e['disk_bytes_written'] / 2**30:8.4f} on disk)")
        line += f"; host ms prepare {h['prepare_ms']:.1f}, write {h['write_ms']:.1f}, read {h['read_ms']:.1f}"
        print(line)


def phase_width_pack(ints, f64, certified, v1):
    """Phase 9, the width schedule and packed spill records (this slice's
    paths) on the streams of phase 3, each call driven with the launch
    counts set to 0 just before it and read just after (the sweep kernel
    of the stream's width at least once a pass, no other kernel, no plain
    call):

    - the replay median of each stream with ``width_schedule="off"`` and
      ``"auto"``, each under the profiler: answer against phase 3's, wall
      ms, passes read and bytes over the link, the sweep kernel's device
      time and the idle share; quantiles K=4 of each stream, ``"off"``
      beside ``"auto"`` (the same answers; the int32 ones phase 3's);
    - the int32 stream's median read as a one-shot generator with
      ``spill="auto"``, ``width_schedule="auto"``, ``pack_spill="auto"``,
      under the profiler, beside phase 8's format-v1 call (``v1``): its
      ``pass_log`` with logical and physical bytes, each pass's host ms
      in the record work, the peak bytes on disk, the bytes over the link,
      wall ms and idle share, on the first half of the stream as phase 8's
      call (the run's time; halved again when the disk under the temp dir
      holds less than 1.5x its bytes);
    - on the first quarter (the run's time, the same chunks as phase 8's
      format-v1 twins): quantiles K=4 of the replayable chunks,
      ``spill="force"`` with both knobs on ``"auto"``;
    - ``StreamingQuantiles(width_schedule="auto", pack_spill="auto")``:
      ``update_stream(one_shot, spill=store)`` (generation 0 packed on the
      card), then ``refine_quantiles`` and ``streaming_rank_certificate``
      from the store;
    - the card's digit pack of a chunk against the host's (each whole,
      through the record's checksums), on chunk 0 of each stream;
    - row 8 at each launch kind ``"auto"`` adds (:func:`auto_kinds`), on
      chunk 0 of each stream, held exactly against the plain version, the
      kernel alone and the call beside its bound, the plain version and
      ``torch.bincount``."""
    import shutil
    import tempfile

    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch.api import quantile_ranks
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
    from mpi_k_selection_tpu_torch.ops.cuda import topk as T
    from mpi_k_selection_tpu_torch.streaming import spill as sp
    from mpi_k_selection_tpu_torch.utils import dtypes as dt
    from mpi_k_selection_tpu_torch.utils.timing import time_fn

    out = {"calls": {}}
    launches = {"sweep_ingest32": 0, "sweep_ingest64": 0}
    per_call = {}

    def counted(what, fn, bits, passes_fn):
        """One call with every count at 0 just before it; fails unless the
        sweep kernel of ``bits`` launched at least once for each pass
        ``passes_fn()`` counts, and nothing else ran."""
        for m in (H, T, S):
            m.reset_counts()
        res = fn()
        torch.cuda.synchronize()
        passes = passes_fn()
        kn = f"sweep_ingest{bits}"
        others = {k: v for k, v in {**H.LAUNCHES, **T.LAUNCHES}.items() if v}
        plain = {k: v for k, v in {**H.PLAIN_CALLS, **T.PLAIN_CALLS, **S.PLAIN_CALLS}.items() if v}
        if S.LAUNCHES[kn] < max(1, passes) or sum(S.LAUNCHES.values()) != S.LAUNCHES[kn] or others or plain:
            fail(f"{what}: launches {dict(S.LAUNCHES)} over {passes} passes; other kernels {others}; plain {plain}")
        for k in launches:
            launches[k] += S.LAUNCHES[k]
        per_call[what] = {k: v for k, v in S.LAUNCHES.items() if v}
        print(f"[width] {what}: {S.LAUNCHES[kn]} launches of {kn} over {passes} passes, no plain call")
        return res

    # the replay medians, "off" beside "auto"
    for src, bits, label, want in ((ints, 32, "int32 uniform", certified["median32"]),
                                   (f64, 64, "float64 normal", certified["median64"])):
        n = len(src.chunks) * src.chunks[0].size
        for ws in ("off", "auto"):
            what = f"streaming median width_schedule={ws} depth=2, {label} {n} elements"
            src.passes = 0
            got, ms, busy, idle, top = counted(what, lambda: profiled_call(
                lambda: kt.kselect_streaming(src, n // 2, width_schedule=ws)), bits, lambda: src.passes)
            if got.tobytes() != want.tobytes():
                fail(f"{what}: {got!r} != phase 3's certified median {want!r}")
            link = src.passes * n * bits // 8
            sweep = sum(m for nm, _, m in top if "sweep_ingest_kernel" in nm)
            print(f"[width] {what}: {got!r} == phase 3; {ms:.1f} ms; {src.passes} reads, {link / 2**30:.1f} GiB over "
                  f"the link; device busy " + ("not measured" if busy is None else f"{busy:.1f} ms, idle share "
                                                f"{idle:.3f}") + f"; sweep_ingest_kernel {sweep:.3f} ms")
            out["calls"][what] = {"ms": ms, "busy_ms": busy, "idle_share": idle, "passes": src.passes,
                                  "link_bytes": link, "sweep_device_ms": sweep, "answer": repr(got),
                                  "top": [{"name": nm, "calls": c, "ms": m} for nm, c, m in top[:6]]}

    # quantiles K=4 of each stream on the replay path, "off" beside "auto"
    # (the float64 stream's "auto" pass 1 is a 16-bit digit under 4 prefixes)
    for src, bits, label in ((ints, 32, "int32 uniform"), (f64, 64, "float64 normal")):
        n = len(src.chunks) * src.chunks[0].size
        ranks = quantile_ranks(QS, n)
        answers = {}
        for ws in ("off", "auto"):
            what = f"streaming quantiles K=4 width_schedule={ws} depth=2, {label} {n} elements"
            src.passes = 0
            secs, answers[ws] = time_fn(lambda: counted(what, lambda: kt.kselect_streaming_many(
                src, ranks, width_schedule=ws), bits, lambda: src.passes), device="cuda")
            print(f"[width] {what}: {[repr(v) for v in answers[ws]]}; {secs * 1e3:.1f} ms; {src.passes} reads")
            out["calls"][what] = {"ms": secs * 1e3, "passes": src.passes, "answers": [repr(v) for v in answers[ws]]}
        if np.array(answers["auto"]).tobytes() != np.array(answers["off"]).tobytes() or (
                bits == 32 and np.array(answers["off"]).tobytes() != np.array(certified["quantiles32"]).tobytes()):
            fail(f"quantiles K=4, {label}: auto {answers['auto']!r} != off {answers['off']!r} (or phase 3's)")

    # the spilled calls: the one-shot median on the first half, as phase 8's
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    chunks = ints.chunks[: max(1, len(ints.chunks) // 2)]
    cuts = [f"the one-shot median on the first {len(chunks)} chunks (the run's time)"]
    print(f"[width] CUT: {cuts[-1]}")
    while len(chunks) > 1 and free < SPILL_DISK_FACTOR * sum(c.nbytes for c in chunks):
        chunks = chunks[: len(chunks) // 2]
        cuts.append(f"free disk {free} bytes < {SPILL_DISK_FACTOR}x the stream: halved to {len(chunks)} chunks")
        print(f"[width] CUT: {cuts[-1]}")
    if cuts:
        out["cut"] = cuts
    full = len(chunks) == len(ints.chunks)
    n = len(chunks) * STREAM_CHUNK
    qranks = certified["qranks"] if full else [max(1, min(n, int(np.ceil(q * n)))) for q in QS]
    root = tempfile.mkdtemp(prefix="chip-smoke-width-root-", dir=tmp)
    knobs = dict(width_schedule="auto", pack_spill="auto")

    def check(what, vals, ks):
        if full:
            want = [certified["median32"]] if len(ks) == 1 else certified["quantiles32"]
            if np.array(vals).tobytes() != np.array(want).tobytes():
                fail(f"{what}: {vals!r} != phase 3's {want!r}")
            return
        for kq, v, (less, leq) in zip(ks, vals, np_certificates(chunks, vals)):
            if not less < kq <= leq:
                fail(f"{what}: k={kq}: {v!r} fails NumPy's certificate ({less}, {leq}]")

    try:
        what = f"streaming median spill=auto one-shot width_schedule=auto pack_spill=auto, int32 uniform {n} elements"
        k = n // 2
        with SpillWatch(root) as watch:
            got, ms, busy, idle, top = counted(what, lambda: profiled_call(lambda: kt.kselect_streaming(
                (c for c in chunks), k, spill="auto", spill_dir=root, **knobs)), 32,
                lambda: len(watch.stores[-1].pass_log))
        check(what, [got], [k])
        store = watch.stores[-1]
        log, host = store.pass_log, store.pass_host_ms
        print_pack_log(what, log, host)
        link = sum(e["bytes_read"] for e in log)
        sweep = sum(m for nm, _, m in top if "sweep_ingest_kernel" in nm)
        v1_call = next((c for w_, c in v1.get("calls", {}).items() if w_.startswith("streaming median spill=auto")
                        and c["pass_log"][0]["keys_read"] == n), None)  # phase 8's on the same chunks
        print(f"[width] {what}: {got!r} exact; {ms:.1f} ms; peak on disk {watch.peak / 2**30:.3f} GiB (samples "
              f"{[round(b / 2**30, 3) for b in watch.samples]}); over the link {link / 2**30:.3f} GiB; device busy "
              + ("not measured" if busy is None else f"{busy:.1f} ms, idle share {idle:.3f}")
              + f"; sweep_ingest_kernel {sweep:.3f} ms"
              + ("" if v1_call is None else f"; format v1 (phase 8): {v1_call['ms']:.1f} ms, peak on disk "
                 f"{v1_call['peak_disk_bytes'] / 2**30:.3f} GiB, over the link {v1_call['link_bytes'] / 2**30:.3f} GiB"))
        out["calls"][what] = {"ms": ms, "busy_ms": busy, "idle_share": idle, "answer": repr(got), "pass_log": log,
                              "pass_host_ms": host, "peak_disk_bytes": watch.peak, "disk_samples": watch.samples,
                              "generation_records": watch.records, "link_bytes": link, "sweep_device_ms": sweep,
                              "top": [{"name": nm, "calls": c, "ms": m} for nm, c, m in top[:6]]}

        # the later calls read the first quarter, the chunks of phase 8's
        # format-v1 twins (the run's time)
        chunks, full = chunks[: max(1, len(chunks) // 2)], False
        n = len(chunks) * STREAM_CHUNK
        qranks = [max(1, min(n, int(np.ceil(q * n)))) for q in QS]
        out.setdefault("cut", []).append(f"quantiles K=4 spill=force and the sketch flow on the first {len(chunks)} "
                                         "chunks (the run's time)")
        print(f"[width] CUT: {out['cut'][-1]}")

        what = f"streaming quantiles K=4 spill=force width_schedule=auto pack_spill=auto, int32 uniform {n} elements"
        with SpillWatch(root) as watch:
            secs, qans = time_fn(lambda: counted(what, lambda: kt.kselect_streaming_many(
                chunks, qranks, spill="force", spill_dir=root, **knobs), 32,
                lambda: len(watch.stores[-1].pass_log)), device="cuda")
        check(what, qans, qranks)
        store = watch.stores[-1]
        print_pack_log(what, store.pass_log, store.pass_host_ms)
        print(f"[width] {what}: exact; {secs * 1e3:.1f} ms; peak on disk {watch.peak / 2**30:.3f} GiB")
        out["calls"][what] = {"ms": secs * 1e3, "pass_log": store.pass_log, "pass_host_ms": store.pass_host_ms,
                              "peak_disk_bytes": watch.peak}

        with kt.SpillStore(root) as store:
            sq = kt.StreamingQuantiles(np.int32, **knobs)
            what = f"StreamingQuantiles(auto, auto).update_stream(one-shot, spill=store), int32 uniform {n} elements"
            marks = {name: sw.seconds for name, sw in sp.HOST_TIMES.items()}
            secs, _ = time_fn(lambda: counted(what, lambda: sq.update_stream((c for c in chunks), spill=store), 32,
                                              lambda: 1), device="cuda")
            gen0 = store.latest_generation()
            if gen0.keys != n or not gen0.packed:
                fail(f"{what}: generation 0 holds {gen0.keys} keys (packed: {gen0.packed}), not {n} packed")
            host = {f"{name}_ms": (sw.seconds - marks[name]) * 1e3 for name, sw in sp.HOST_TIMES.items()}
            print(f"[width] {what}: {secs * 1e3:.1f} ms; generation 0 {gen0.keys} keys, {gen0.nbytes / 2**30:.3f} GiB "
                  f"on disk ({gen0.logical_nbytes / 2**30:.3f} logical); host ms {host}")
            out["calls"][what] = {"ms": secs * 1e3, "generation0_bytes": gen0.nbytes,
                                  "generation0_logical_bytes": gen0.logical_nbytes, "host_ms": host}
            what = f"refine_quantiles (auto, auto) from the packed store, int32 uniform {n} elements"
            secs, refined = time_fn(lambda: counted(what, lambda: sq.refine_quantiles(QS, store), 32,
                                                    lambda: len(store.pass_log)), device="cuda")
            check(what, refined, qranks)
            print_pack_log(what, store.pass_log, store.pass_host_ms)
            print(f"[width] {what}: exact; {secs * 1e3:.1f} ms")
            out["calls"][what] = {"ms": secs * 1e3, "pass_log": list(store.pass_log),
                                  "pass_host_ms": list(store.pass_host_ms)}
            what = f"streaming_rank_certificate(packed store, median), int32 uniform {n} elements"
            med = certified["median32"] if full else got
            marks = {name: sw.seconds for name, sw in sp.HOST_TIMES.items()}
            secs, cert = time_fn(lambda: counted(what, lambda: kt.streaming_rank_certificate(store, med), 32,
                                                 lambda: 1), device="cuda")
            want = certified["median32_certificate"] if full else np_certificates(chunks, [med])[0]
            if tuple(cert) != tuple(want):
                fail(f"{what}: {cert} != NumPy's {want}")
            host = {f"{name}_ms": (sw.seconds - marks[name]) * 1e3 for name, sw in sp.HOST_TIMES.items()}
            print(f"[width] {what}: {cert} == NumPy's certificate; {secs * 1e3:.1f} ms from disk; host ms {host}")
            out["calls"][what] = {"ms": secs * 1e3, "certificate": list(cert), "host_ms": host}
        if glob.glob(os.path.join(root, "ksel-spill-*")):
            fail(f"a spill store outlived phase 9: {os.listdir(root)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the digit pack of a chunk, on the card and on the host, to a record
    rows = []

    def row(what, ms, b, by, extra=""):
        rows.append({"what": what, "ms": ms, "bound_ms": b, "bound_by": by})
        print(f"[time] {what:<60} {ms:11.4f} ms   bound {b:9.4f} ms ({by}){extra}")

    out["digit_pack"] = {}
    for bits, src in ((32, ints), (64, f64)):
        c = src.chunks[0]
        keys = host_keys(c)
        carrier = dt.keys_from_raw(torch.from_numpy(c.view(np.int32 if bits == 32 else np.int64)).cuda(),
                                   "xor" if bits == 32 else "float", 1 << 31 if bits == 32 else 0)

        def on_card():
            counts, payload = sp.pack_digits(carrier, sp.GEN0_SEGMENT_BITS, bits)
            segs = sp.digit_segments_from(counts.cpu().numpy(), payload.cpu().numpy(), sp.GEN0_SEGMENT_BITS, bits)
            return sp.prepared_record(lambda: keys, keys.size, keys.dtype, c.dtype, segs)

        def on_host():
            return sp.prepared_record(lambda: keys, keys.size, keys.dtype, c.dtype,
                                      sp._digit_segments(keys, sp.GEN0_SEGMENT_BITS))

        a, b_ = on_card(), on_host()
        if a.segments != b_.segments or b"".join(bytes(p.data) for p in a.parts) != b"".join(
                bytes(p.data) for p in b_.parts):
            fail(f"digit pack of {bits}-bit chunk 0: the card's record != the host's")
        card_s, _ = time_fn(on_card, repeats=3, device="cpu")
        host_s, _ = time_fn(on_host, repeats=2, device="cpu")
        out["digit_pack"][bits] = {"card_ms": card_s * 1e3, "host_ms": host_s * 1e3, "record_bytes": a.nbytes,
                                   "keys": keys.size}
        print(f"[width] digit pack of {bits}-bit chunk 0 ({keys.size} keys) to a format-v2 record of "
              f"{a.nbytes / 2**20:.1f} MiB: on the card (and back, with the record's checksums) {card_s * 1e3:.1f} ms; "
              f"on the host {host_s * 1e3:.1f} ms (host clock, best of 3 and 2)")
        del carrier
        torch.cuda.empty_cache()

    # row 8 at the launch kinds "auto" adds
    kinds = {}
    for bits, src, key_op, key_xor in ((32, ints, "xor", 1 << 31), (64, f64, "float", 0)):
        c = src.chunks[0]
        w = torch.from_numpy(c.view(np.int32 if bits == 32 else np.int64)).cuda()
        kinds[f"sweep_ingest{bits}"] = sweep_kind_rows(row, bits, w, auto_kinds(bits, c), key_op, key_xor,
                                                       library_hist=True)
        del w
        torch.cuda.empty_cache()
    out["auto_kinds"] = kinds
    out["timings"] = rows
    return launches, per_call, out


TWO_SLOTS = ("cuda:0", "cuda:0")  # phase 10: two ingest slots on one card, a window of two bundles


def profiled_per_card(fn):
    """One call of ``fn`` under torch.profiler, timed with CUDA events on
    card 0 (the call returns after every card's bundles were waited on):
    ``(result, ms, {card: busy ms}, {card: sweep kernel launches})``, the
    busy time the union of each card's kernel and copy intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cards = range(torch.cuda.device_count())
    for i in cards:
        torch.cuda.synchronize(i)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a.record()
        out = fn()
        b.record()
        for i in cards:
            torch.cuda.synchronize(i)
    ms = a.elapsed_time(b)
    spans, sweeps = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.setdefault(e.device_index, []).append((e.time_range.start, e.time_range.end))
            if "sweep_ingest_kernel" in e.name:
                sweeps[e.device_index] = sweeps.get(e.device_index, 0) + 1
    busy = {}
    for dev, iv in spans.items():
        iv.sort()
        total, (lo, hi) = 0.0, iv[0]
        for start, end in iv[1:]:
            if start > hi:
                total, lo = total + hi - lo, start
            hi = max(hi, end)
        busy[dev] = (total + hi - lo) / 1e3
    return out, ms, busy, sweeps


def phase_multidevice_obs(ints, f64, certified, x30):
    """Phase 10, multi-device staging and the telemetry on the streams of
    phase 3, each call driven with the launch counts set to 0 just before
    it and read just after (the sweep kernel once per chunk per pass read,
    nothing else, no plain version):

    - the int32 replay median at depth 2 three ways, each under the
      profiler: one slot without telemetry, two slots on ``cuda:0`` (a
      window of two bundles) without, and two slots with
      ``Observability.collecting()`` and a ``PhaseTimer``: each answer
      against phase 3's; the instrumented stream holds
      ``check_stream_invariants``, 64 ``stream.chunk`` events a pass,
      ``ingest.chunks`` / ``ingest.bytes`` equal to the chunks and key
      bytes its passes read, ``staging_pool.*`` equal to the pool's own
      counters, and at least two thread tracks in its trace; wall ms and
      the idle share of each;
    - the float64 replay median, one slot bare beside two slots with
      telemetry, the same checks;
    - the one-shot spilled median (``spill="auto"``, ``width_schedule`` and
      ``pack_spill`` ``"auto"``) on two slots with telemetry, on the first
      half of the int32 stream (the run's time, as phase 8's later calls),
      against NumPy's certificate: its ``stream.pass`` events equal the
      store's ``pass_log`` entry for entry, and the ``spill.*`` counters
      the log's sums;
    - ``kselect`` twice and ``kselect_many`` (p50/p90/p99/p99.9) of the 2^30
      int32 array with telemetry: one ``resident.select`` event a call,
      the answers those of the calls without it, the histogram kernels
      launched, and the ledger's ``api.select`` site counting one compile
      a key in the process (the repeat a hit);
    - with two cards or more, the int32 replay median with
      ``devices=torch.cuda.device_count()``: its answer, each card's
      ``ingest.chunks{device=i}`` (64 / p a pass, exactly) and the
      profiler's sweep kernels on that card (never more than its chunks,
      none on another card, at least 95% of them seen: the profiler may
      drop a record), each card's busy time, and the wall beside the
      one-slot call. On one card this step does not run, and says so."""
    import shutil
    import tempfile

    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch import obs as obs_lib
    from mpi_k_selection_tpu_torch.api import quantile_ranks
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
    from mpi_k_selection_tpu_torch.ops.cuda import topk as T
    from mpi_k_selection_tpu_torch.streaming import pipeline as pl
    from mpi_k_selection_tpu_torch.utils.profiling import PhaseTimer

    launches = {k: 0 for k in KERNELS}
    per_call, out = {}, {"calls": {}}

    def counted(what, fn, bits, want_launches, kind="sweep"):
        """One call with every count at 0 just before it: fails unless the
        sweep kernel of ``bits`` launched ``want_launches()`` times (or,
        for the resident calls, the histogram kernels launched), nothing
        else ran and no plain version ran."""
        for m in (H, T, S):
            m.reset_counts()
        res = fn()
        torch.cuda.synchronize()
        plain = {k: v for k, v in {**H.PLAIN_CALLS, **T.PLAIN_CALLS, **S.PLAIN_CALLS}.items() if v}
        got = {k: v for k, v in {**H.LAUNCHES, **T.LAUNCHES, **S.LAUNCHES}.items() if v}
        if kind == "sweep":
            want = want_launches()
            ok = got == {f"sweep_ingest{bits}": want} and want > 0
        else:
            ok = got.get(f"radix_histogram{bits}", 0) + got.get(f"radix_histogram_multi{bits}", 0) > 0 \
                and not any(k.startswith("sweep") for k in got)
        if not ok or plain:
            fail(f"{what}: launches {got}; plain calls {plain}")
        for k, v in got.items():
            launches[k] += v
        per_call[what] = got
        print(f"[phase10] {what}: launches {got}, no plain call")
        return res

    def check_obs(what, o, src_chunks, kbytes, timer):
        """The instrumented stream's checks; returns its summary."""
        ev = o.events.events
        obs_lib.check_stream_invariants(ev)
        passes = o.events.of_kind("stream.pass")
        chunks = o.events.of_kind("stream.chunk")
        per_pass = {}
        for c in chunks:
            per_pass[c.pass_index] = per_pass.get(c.pass_index, 0) + 1
        if set(per_pass.values()) != {src_chunks} or set(per_pass) != {e.pass_index for e in passes}:
            fail(f"{what}: chunk events a pass {per_pass}, expected {src_chunks} in each of "
                 f"{[e.pass_index for e in passes]}")
        reg = o.metrics
        by_dev = {dict(m.labels)["device"]: m.value for m in reg.metrics() if m.name == "ingest.chunks"}
        nbytes = sum(m.value for m in reg.metrics() if m.name == "ingest.bytes")
        if sum(by_dev.values()) != len(chunks) or nbytes != sum(e.keys_read for e in passes) * kbytes:
            fail(f"{what}: ingest.chunks {by_dev} / ingest.bytes {nbytes} against {len(chunks)} chunk events and "
                 f"{sum(e.keys_read for e in passes) * kbytes} key bytes read")
        pool = (reg.counter("staging_pool.hits").value, reg.counter("staging_pool.misses").value,
                reg.gauge("staging_pool.resident_bytes").value)
        if pool != (pl.STAGING_POOL.hits, pl.STAGING_POOL.misses, pl.STAGING_POOL.resident_bytes):
            fail(f"{what}: staging_pool metrics {pool} != the pool's own ({pl.STAGING_POOL.hits}, "
                 f"{pl.STAGING_POOL.misses}, {pl.STAGING_POOL.resident_bytes})")
        tracks = len(o.trace.thread_ids())
        if tracks < 2:
            fail(f"{what}: {tracks} thread track(s) in the trace, expected the producer's and the consumer's")
        phases = {k: round(v["seconds"] * 1e3, 3) for k, v in timer.as_dict().items()}
        print(f"[phase10] {what}: invariants hold; {len(passes)} passes x {src_chunks} chunk events; ingest.chunks "
              f"{by_dev}; staging_pool metrics == the pool's {pool}; {tracks} trace tracks; spans "
              f"{len(o.trace.spans)}; phases ms {phases}")
        return {"passes": len(passes), "ingest_chunks": by_dev, "ingest_bytes": nbytes, "trace_tracks": tracks,
                "spans": len(o.trace.spans), "phase_ms": phases,
                "occupancy_max": reg.histogram("inflight.occupancy").max}

    def replay(what, src, k, want, bits, **kw):
        src.passes = 0
        got, ms, busy, idle, top = counted(what, lambda: profiled_call(
            lambda: kt.kselect_streaming(src, k, pipeline_depth=2, **kw)), bits, lambda: src.passes * len(src.chunks))
        if got.tobytes() != want.tobytes():
            fail(f"{what}: {got!r} != phase 3's certified answer {want!r}")
        rec = {"ms": ms, "busy_ms": busy, "idle_share": idle, "passes": src.passes, "answer": repr(got)}
        print(f"[phase10] {what}: {got!r} == phase 3; {ms:.1f} ms; device busy "
              + ("not measured" if busy is None else f"{busy:.1f} ms, idle share {idle:.3f}"))
        out["calls"][what] = rec
        return rec

    # the int32 and float64 replay medians, bare and with telemetry
    n32, n64 = len(ints.chunks) * STREAM_CHUNK, len(f64.chunks) * F64_CHUNK
    runs = ((ints, 32, n32 // 2, certified["median32"], "int32 uniform 2^31", True),
            (f64, 64, n64 // 2, certified["median64"], "float64 normal 2^30", False))
    for src, bits, k, want, label, with_bare_slots in runs:
        replay(f"median depth=2 devices=None obs=None, {label}", src, k, want, bits)
        if with_bare_slots:
            replay(f"median depth=2 devices=2 slots on cuda:0 obs=None, {label}", src, k, want, bits,
                   devices=TWO_SLOTS)
        o, timer = obs_lib.Observability.collecting(), PhaseTimer()
        what = f"median depth=2 devices=2 slots on cuda:0 obs=on, {label}"
        rec = replay(what, src, k, want, bits, devices=TWO_SLOTS, obs=o, timer=timer)
        rec.update(check_obs(what, o, len(src.chunks), bits // 8, timer))

    # the one-shot spilled median, both knobs "auto", two slots, telemetry
    tmp = tempfile.gettempdir()
    chunks = ints.chunks[: len(ints.chunks) // 2]
    free = shutil.disk_usage(tmp).free
    while len(chunks) > 1 and free < SPILL_DISK_FACTOR * sum(c.nbytes for c in chunks):
        chunks = chunks[: len(chunks) // 2]
        out.setdefault("cut", []).append(f"free disk {free} bytes: the spilled median read {len(chunks)} chunks")
        print(f"[phase10] CUT: {out['cut'][-1]}")
    n = len(chunks) * STREAM_CHUNK
    root = tempfile.mkdtemp(prefix="chip-smoke-phase10-", dir=tmp)
    try:
        what = f"median one-shot spill=auto width_schedule=auto pack_spill=auto devices=2 slots obs=on, int32 {n}"
        o, timer = obs_lib.Observability.collecting(), PhaseTimer()
        with SpillWatch(root) as watch:
            got, ms, busy, idle, top = counted(what, lambda: profiled_call(lambda: kt.kselect_streaming(
                (c for c in chunks), n // 2, spill="auto", spill_dir=root, width_schedule="auto", pack_spill="auto",
                devices=TWO_SLOTS, obs=o, timer=timer)), 32,
                lambda: len(o.events.of_kind("stream.chunk")))  # one launch a chunk read (the pack is torch ops)
        less, leq = np_certificates(chunks, [got])[0]
        if not less < n // 2 <= leq:
            fail(f"{what}: {got!r} fails NumPy's certificate ({less}, {leq}]")
        log = watch.stores[-1].pass_log
        obs_lib.check_stream_invariants(o.events.events, spill_pass_log=log)
        events = o.events.of_kind("stream.pass")
        fields = ("keys_read", "bytes_read", "disk_bytes_read", "keys_written", "bytes_written", "disk_bytes_written")
        mine = [{"pass": e.pass_index, "read": e.read_from, **{f: getattr(e, f) for f in fields
                                                                  if getattr(e, f) is not None}} for e in events]
        if mine != log:
            fail(f"{what}: stream.pass events {mine} != pass_log {log}")
        reg = o.metrics
        sums = {name: sum(int(e.get(name) or 0) for e in log) for name in fields}
        got_sums = {name: reg.counter(f"spill.{name}").value for name in fields}
        if got_sums != sums or reg.counter("spill.passes").value != len(log):
            fail(f"{what}: spill counters {got_sums} (passes {reg.counter('spill.passes').value}) != the log's sums "
                 f"{sums} ({len(log)} entries)")
        if glob.glob(os.path.join(root, "ksel-spill-*")):
            fail(f"{what}: a spill store outlived the call: {os.listdir(root)}")
        print(f"[phase10] {what}: {got!r} passes NumPy's certificate; {ms:.1f} ms; device busy "
              + ("not measured" if busy is None else f"{busy:.1f} ms, idle share {idle:.3f}")
              + f"; {len(log)} stream.pass events == pass_log entry for entry; spill counters == the log's sums "
              f"{got_sums}")
        out["calls"][what] = {"ms": ms, "busy_ms": busy, "idle_share": idle, "answer": repr(got), "pass_log": log,
                              "spill_counters": got_sums, "peak_disk_bytes": watch.peak}
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the resident selects with telemetry, and the ledger's api.select site
    o = obs_lib.Observability.collecting()
    n30 = x30.numel()
    qranks = quantile_ranks(QS, n30)
    base = {"kselect": kt.kselect(x30, n30 // 2), "kselect_many": kt.kselect_many(x30, qranks)}
    before = obs_lib.LEDGER.snapshot()
    for what, fn in (("kselect twice", lambda: [kt.kselect(x30, n30 // 2, obs=o) for _ in range(2)]),
                     ("kselect_many p50/p90/p99/p99.9", lambda: [kt.kselect_many(x30, qranks, obs=o)])):
        what = f"{what} obs=on, int32 uniform 2^30"
        vals = counted(what, fn, 32, None, kind="resident")
        ref = base["kselect" if what.startswith("kselect twice") else "kselect_many"]
        if any(v.cpu().numpy().tobytes() != ref.cpu().numpy().tobytes() for v in vals):
            fail(f"{what}: {vals!r} != the calls without telemetry {ref!r}")
    after = obs_lib.LEDGER.snapshot()
    site = obs_lib.snapshot_delta(before, after)["sites"].get("api.select", {})
    events = o.events.of_kind("resident.select")
    whole = after["sites"]["api.select"]
    if [(e.algorithm, e.queries, e.n) for e in events] != [("radix", 1, n30)] * 2 + [("radix-many", 4, n30)] \
            or site.get("hits", 0) < 1 or site.get("compiles", 0) + site.get("hits", 0) != 3 \
            or whole["compiles"] != whole["distinct_keys"]:
        fail(f"resident selects: events {[e.as_dict() for e in events]}, api.select delta {site}, process {whole}")
    # the cost of the event and the ledger entry: best of 5 each, telemetry off and on, in turns
    from mpi_k_selection_tpu_torch.utils.timing import time_fn

    ms = {}
    for label, kw in (("off", {}), ("on", {"obs": obs_lib.Observability.collecting()})) * 2:
        for name, fn in (("kselect", lambda: kt.kselect(x30, n30 // 2, **kw)),
                         ("kselect_many", lambda: kt.kselect_many(x30, qranks, **kw))):
            secs, _ = time_fn(fn, repeats=5, device="cuda")
            ms.setdefault(f"{name} obs={label}", []).append(secs * 1e3)
    print(f"[phase10] resident selects obs=on: 3 resident.select events; api.select this phase {site}; in the "
          f"process {whole} (one compile a key); ms (off, on, off, on turns) {ms}")
    out["resident"] = {"events": [e.as_dict() for e in events], "api_select_delta": site, "api_select": whole,
                       "ms": ms}

    # one slot a card
    p = torch.cuda.device_count()
    what = f"median depth=2 devices={p} (one slot a card), int32 uniform 2^31"
    if p < 2:
        print(f"[phase10] {what}: needs two cards or more ({p} here): not run")
        out["multi_card"] = {"run": False, "cards": p}
        return launches, per_call, out
    if len(ints.chunks) % p:
        fail(f"{what}: {len(ints.chunks)} chunks do not split evenly over {p} cards")
    o = obs_lib.Observability.collecting()
    ints.passes = 0
    got, ms, busy, sweeps = counted(what, lambda: profiled_per_card(
        lambda: kt.kselect_streaming(ints, n32 // 2, pipeline_depth=2, devices=p, obs=o)), 32,
        lambda: ints.passes * len(ints.chunks))
    if got.tobytes() != certified["median32"].tobytes():
        fail(f"{what}: {got!r} != phase 3's certified answer {certified['median32']!r}")
    chunks_by = {dict(m.labels)["device"]: m.value for m in o.metrics.metrics() if m.name == "ingest.chunks"}
    each = ints.passes * len(ints.chunks) // p
    # the profiler may drop an activity record under load (seen: 255 of 256), never add one: no card may show
    # more sweep kernels than the chunks staged to it, none outside the set, and nearly all must be seen
    seen = sum(sweeps.values())
    if chunks_by != {str(i): each for i in range(p)} or not set(sweeps) <= set(range(p)) \
            or any(v > each for v in sweeps.values()) or seen < 0.95 * p * each:
        fail(f"{what}: ingest.chunks {chunks_by} and the profiler's sweep launches by card {sweeps}, expected {each} "
             f"on each of {p} cards")
    one = out["calls"]["median depth=2 devices=None obs=None, int32 uniform 2^31"]["ms"]
    print(f"[phase10] {what}: {got!r} == phase 3; {ms:.1f} ms against {one:.1f} ms on one slot; ingest.chunks "
          f"{chunks_by}; sweep kernels by card (profiler) {dict(sorted(sweeps.items()))}, {p * each - seen} of "
          f"{p * each} records not seen, none on a card its chunk was not staged to; busy ms by card "
          f"{ {i: round(b, 1) for i, b in sorted(busy.items())} }")
    out["multi_card"] = {"run": True, "cards": p, "ms": ms, "one_slot_ms": one, "ingest_chunks": chunks_by,
                         "sweep_kernels_by_card_profiler": sweeps, "busy_ms_by_card": busy, "passes": ints.passes,
                         "answer": repr(got)}
    return launches, per_call, out


FAULT_CHUNKS = 16  # phase 11: the int32 stream's first half, 2^30 keys (BASELINE's "1B int32")
FAULT_CLI_CHUNKS = 4  # phase 11's CLI run: 2^28 keys in chunks of 2^26
HARD_SEED = 3  # phase 11's hard form: FaultPlan.seeded(3, sites=("stage",), recoverable=False) holds a raise


def fault_plan(faults):
    """Phase 11's explicit plan: every streamed site and kind once. Chunk 2
    of the source raises and chunk 5 stalls 1 ms; the staging of chunk 3
    raises and of chunk 7 stalls; record 1 of the first survivor generation
    fails its write (attempt 1: generation 0 writes it at attempt 0);
    record 4 reads corrupt once (a re-read heals it); record 6 is corrupted
    on disk and record 9 truncated (persistent: a rebuild from the
    source)."""
    S = faults.FaultSpec
    return faults.FaultPlan((
        S("source", 2, "raise"), S("source", 5, "stall", arg=0.001),
        S("stage", 3, "raise"), S("stage", 7, "stall", arg=0.001),
        S("spill.write", 1, "raise", attempts=(1,)),
        S("spill.read", 4, "corrupt"), S("spill.read", 6, "corrupt_disk"), S("spill.read", 9, "truncate"),
    ))


def prometheus_lines(text: str) -> dict:
    """Prometheus text exposition as ``{series: value}``; raises on a line
    that is not a comment or ``series value``."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        series, value = line.rsplit(" ", 1)
        out[series] = float(value)
    return out


def phase_faults(chunks, device: str = "cuda", collect_budget: int | None = None):
    """Phase 11, the fault harness and the recovery policies on the spilled
    descent, on ``chunks`` (the int32 stream's first half, 16 chunks of
    2^26), each call driven with the launch counts set to 0 just before it
    and read just after (the sweep kernel once per chunk each pass read,
    failed attempts included, nothing else, no plain version), and every
    answer held against the fault-free twin's bits, which pass NumPy's
    certificate:

    - (a) the twin: ``kselect_streaming(replayable, N/2, spill=store)``
      with no injector (its answer against NumPy's certificate), its wall
      ms;
    - (b) the same call under :func:`fault_plan`: ``injector.fired`` equals
      the plan, the pass log shows a rebuilt pass read from the source, the
      ``faults.*`` counters by site and action, row 8's histogram, tee
      (``ingest.fused``) and collect kinds in the ledger, the wall ms;
    - (c) a one-shot stream with ``spill="auto"`` and an ENOSPC on the
      first survivor generation's first write: a ``degrade`` event and the
      RuntimeWarning, the pass run again without its tee, the same answer;
    - (d) the hard form, ``FaultPlan.seeded(HARD_SEED, sites=("stage",),
      recoverable=False)`` under a flight recorder rooted in a temporary
      directory: ``RetryExhaustedError(site="stage", attempts=3)``, one
      bundle with the five sections, no ``ksel-`` thread, spill store or
      other file left, the card's allocated memory back to its level;
    - (e) the ``Monitor`` over a one-shot generator of the chunks with its
      registry served by ``start_metrics_server(port=0)``: one scrape
      mid-run parses as Prometheus text, the body after the run equals the
      registry's text, and the server's threads are gone after ``close()``;
    - (f) the CLI in subprocesses: ``--streaming --spill force --chaos 7
      --check --debug-bundle`` on 2^28 keys (exit 0, the certificate true,
      the bundle's five sections) and ``monitor --buckets 8`` (8 sample
      lines).

    ``device="cpu"`` runs the same steps with the kernel's plain version
    (a rehearsal off the card at a small size: the plain calls stand in for
    the launches, and ``collect_budget`` keeps the card's pass structure:
    pass 0, pass 1, the collect)."""
    import shutil
    import tempfile
    import threading
    import urllib.request
    import warnings

    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch import faults
    from mpi_k_selection_tpu_torch import obs as obs_lib
    from mpi_k_selection_tpu_torch.monitor import start_metrics_server
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
    from mpi_k_selection_tpu_torch.ops.cuda import topk as T
    from mpi_k_selection_tpu_torch.utils.timing import Stopwatch

    on_card = device == "cuda"
    budget = {} if collect_budget is None else {"collect_budget": collect_budget}
    n = len(chunks) * chunks[0].size
    k = n // 2
    launches = {kname: 0 for kname in KERNELS}
    per_call, out = {}, {"calls": {}}

    def counted(what, fn, want_launches):
        """``fn()`` with every count at 0 just before it: fails unless the
        32-bit sweep kernel launched ``want_launches()`` times (read after
        the call), nothing else did and no plain version ran."""
        for m in (H, T, S):
            m.reset_counts()
        before = obs_lib.LEDGER.snapshot()
        sw = Stopwatch()
        with sw.timing():
            res = fn()
            if on_card:
                torch.cuda.synchronize()
        plain = {kname: v for kname, v in {**H.PLAIN_CALLS, **T.PLAIN_CALLS, **S.PLAIN_CALLS}.items() if v}
        got = {kname: v for kname, v in {**H.LAUNCHES, **T.LAUNCHES, **S.LAUNCHES}.items() if v}
        if not on_card:  # the rehearsal: the plain calls stand in for the launches
            got, plain = {"sweep_ingest32": plain.pop("sweep_ingest", 0)}, plain
        wanted = want_launches()
        if got != {"sweep_ingest32": wanted} or not wanted or plain:
            fail(f"{what}: launches {got}, expected {wanted} of sweep_ingest32; plain calls {plain}")
        sites = obs_lib.snapshot_delta(before, obs_lib.LEDGER.snapshot())["sites"]
        kinds = {s: v["compiles"] + v["hits"] for s, v in sites.items() if s.startswith("ingest.")}
        for kname, v in got.items():
            launches[kname] += v
        per_call[what] = got
        ms = sw.seconds * 1e3
        print(f"[phase11] {what}: launches {got} (by kind {kinds}), no plain call; {ms:.1f} ms")
        return res, ms, kinds

    def certified(what, got):
        if np.asarray(got).tobytes() != np.asarray(twin).tobytes():
            fail(f"{what}: {got!r} != the twin's certified median {twin!r}")

    def ksel_threads():
        return sorted(t.name for t in threading.enumerate() if t.name.startswith("ksel-"))

    def chunk_events(o):
        return lambda: len(o.events.of_kind("stream.chunk"))

    policy = faults.RetryPolicy()  # the default's bounds, the real sleeper: the card waits its backoff
    root = tempfile.mkdtemp(prefix="chip-smoke-phase11-", dir=tempfile.gettempdir())
    try:
        # (a) the fault-free twin
        what = f"(a) median spilled to a SpillStore, no faults, int32 {n}"
        o = obs_lib.Observability.collecting()
        with kt.SpillStore(root) as store:
            twin, twin_ms, twin_kinds = counted(what, lambda: kt.kselect_streaming(
                Replay(chunks), k, spill=store, device=device, obs=o, **budget), chunk_events(o))
        less, leq = np_certificates(chunks, [twin])[0]
        if not less < k <= leq:
            fail(f"{what}: {twin!r} fails NumPy's certificate ({less}, {leq}]")
        print(f"[phase11] {what}: {twin!r}, NumPy's certificate {less} < k <= {leq}")
        out["calls"]["a"] = {"ms": twin_ms, "answer": repr(twin), "kinds": twin_kinds}

        # (b) the same call under the plan that strikes every site and kind
        what = f"(b) median spilled to a SpillStore under the fault plan, int32 {n}"
        plan = fault_plan(faults)
        o = obs_lib.Observability.collecting()
        with kt.SpillStore(root) as store:
            with faults.inject(plan, obs=o) as inj:
                src = inj.wrap_chunk_source(Replay(chunks))
                got, ms, kinds = counted(what, lambda: kt.kselect_streaming(
                    src, k, spill=store, retry=policy, device=device, obs=o, **budget), chunk_events(o))
            log = list(store.pass_log)
        certified(what, got)
        fired = sorted((f["site"], f["kind"], f["index"], f["attempt"]) for f in inj.fired)
        planned = sorted((s.site, s.kind, s.index, a) for s in plan.specs for a in s.attempts)
        if fired != planned:
            fail(f"{what}: fired {fired} != the plan {planned}")
        rebuilt = [e for e in log if e["pass"] != 0 and e["read"] == "source"]
        if not rebuilt:
            fail(f"{what}: no pass after pass 0 read the source (the rebuild): {log}")
        reg = o.metrics
        counters = {(m.name, tuple(sorted(dict(m.labels).items()))): m.value for m in reg.metrics()
                    if m.name.startswith("faults.")}
        by_site = {site: sum(1 for f in inj.fired if f["site"] == site) for site in faults.FAULT_SITES}
        for site, count in by_site.items():
            if count and counters.get(("faults.injected", (("site", site),))) != count:
                fail(f"{what}: faults.injected{{site={site}}} != {count}: {counters}")
        need = {("faults.retries", (("site", "source"),)): 1, ("faults.retries", (("site", "stage"),)): 1}
        actions = {}
        for (name, labels), v in counters.items():
            if name == "faults.recovered":
                actions[dict(labels)["action"]] = actions.get(dict(labels)["action"], 0) + v
        if any(counters.get(key) != v for key, v in need.items()) or not actions.get("reread") \
                or not actions.get("rebuild") or not actions.get("retry"):
            fail(f"{what}: faults counters {counters}")
        for kind in ("ingest.histogram", "ingest.fused", "ingest.collect"):
            if not kinds.get(kind):
                fail(f"{what}: row 8's {kind} kind never launched: {kinds}")
        print(f"[phase11] {what}: {got!r} == the twin == NumPy's certificate; fired == the plan ({len(fired)}); "
              f"pass log {[(e['pass'], e['read']) for e in log]}; faults counters {counters}; {ms:.1f} ms against "
              f"the twin's {twin_ms:.1f} ms")
        out["calls"]["b"] = {"ms": ms, "twin_ms": twin_ms, "answer": repr(got), "fired": inj.fired,
                             "pass_log": log, "kinds": kinds,
                             "counters": {f"{name}{dict(labels)}": v for (name, labels), v in counters.items()}}

        # (c) spill="auto" on a one-shot stream, ENOSPC on the first survivor generation
        what = f"(c) median one-shot spill=auto, ENOSPC on generation 1, int32 {n}"
        o = obs_lib.Observability.collecting()
        plan = faults.FaultPlan((faults.FaultSpec("spill.write", 0, "enospc", attempts=(1,)),))
        with faults.inject(plan, obs=o) as inj, warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got, ms, kinds = counted(what, lambda: kt.kselect_streaming(
                (c for c in chunks), k, spill="auto", spill_dir=root, retry=policy, device=device, obs=o,
                **budget), chunk_events(o))
        certified(what, got)
        degrade = [e for e in o.events.of_kind("fault") if e.action == "degrade"]
        if len(inj.fired) != 1 or len(degrade) != 1 or not any("ENOSPC" in str(w.message) for w in caught):
            fail(f"{what}: fired {inj.fired}, degrade events {degrade}, warnings {[str(w.message) for w in caught]}")
        print(f"[phase11] {what}: {got!r} == the twin; one degrade event, the RuntimeWarning; {ms:.1f} ms")
        out["calls"]["c"] = {"ms": ms, "answer": repr(got), "kinds": kinds}

        # (d) the hard form: a stage fault on every attempt
        what = f"(d) median spill=force, FaultPlan.seeded({HARD_SEED}, sites=('stage',), recoverable=False)"
        dump = os.path.join(root, "flight")
        os.makedirs(dump)
        rec = obs_lib.FlightRecorder(dump_dir=dump)
        o = obs_lib.Observability(metrics=obs_lib.MetricsRegistry(), flight=rec)
        plan = faults.FaultPlan.seeded(HARD_SEED, sites=("stage",), recoverable=False, n_chunks=len(chunks))
        threads_before = ksel_threads()
        mem_before = torch.cuda.memory_allocated() if on_card else 0
        err = None
        S.reset_counts()
        with faults.inject(plan, obs=o) as inj:
            try:
                kt.kselect_streaming(Replay(chunks), k, spill="force", spill_dir=root, retry=policy, device=device,
                                     obs=o, **budget)
            except faults.RetryExhaustedError as e:
                err = e
        if on_card:
            torch.cuda.synchronize()
        per_call[what] = {kname: v for kname, v in S.LAUNCHES.items() if v}
        if err is None or (err.site, err.attempts) != ("stage", 3):
            fail(f"{what}: expected RetryExhaustedError(site='stage', attempts=3), got {err!r}")
        bundles = os.listdir(dump)
        if len(bundles) != 1 or rec.auto_dumps != [os.path.join(dump, bundles[0])]:
            fail(f"{what}: bundles {bundles}, recorder {rec.auto_dumps}")
        bundle = json.load(open(rec.auto_dumps[0]))
        missing = [s for s in obs_lib.flight.BUNDLE_SECTIONS if s not in bundle]
        if missing or bundle["reason"] != "retry-exhausted":
            fail(f"{what}: the bundle lacks {missing} or its reason is {bundle.get('reason')!r}")
        obs_lib.flight.drain_dumped()
        left = sorted(set(os.listdir(root)) - {"flight"})
        mem_after = torch.cuda.memory_allocated() if on_card else 0
        if ksel_threads() != threads_before or left or mem_after != mem_before:
            fail(f"{what}: left behind threads {ksel_threads()}, files {left}, allocated bytes {mem_after} "
                 f"against {mem_before}")
        print(f"[phase11] {what}: {type(err).__name__}(site={err.site!r}, attempts={err.attempts}); fired "
              f"{len(inj.fired)}; one bundle with the five sections; no thread, store or file left; allocated "
              f"{mem_after} bytes == before")
        out["calls"]["d"] = {"error": str(err), "fired": inj.fired, "bundle_events": len(bundle["events"]),
                             "allocated_bytes": mem_after}
        shutil.rmtree(dump)

        # (e) the monitor, its registry served as Prometheus text
        what = f"(e) Monitor over a one-shot generator with start_metrics_server, int32 {n}"
        o = obs_lib.Observability(metrics=obs_lib.MetricsRegistry())
        scrapes = {}

        def monitor_run():
            samples = []
            with start_metrics_server(o.metrics, port=0) as srv:
                url = f"http://127.0.0.1:{srv.port}/metrics"
                for s in kt.Monitor(window=8, emit_every=4, device=device, obs=o).run((c for c in chunks), np.int32):
                    samples.append(s)
                    if len(samples) == 1:
                        with urllib.request.urlopen(url, timeout=10) as r:
                            scrapes["mid"] = r.read().decode()
                with urllib.request.urlopen(url, timeout=10) as r:
                    scrapes["end"] = r.read().decode()
            return samples

        samples, ms, kinds = counted(what, monitor_run, lambda: len(chunks))
        mid = prometheus_lines(scrapes["mid"])
        if len(samples) != len(chunks) // 4 or mid.get("ksel_monitor_samples") != 1.0 \
                or scrapes["end"] != o.metrics.render_prometheus() or ksel_threads() != threads_before:
            fail(f"{what}: {len(samples)} samples; mid-run scrape {mid}; end scrape equal to the registry: "
                 f"{scrapes['end'] == o.metrics.render_prometheus()}; threads {ksel_threads()}")
        print(f"[phase11] {what}: {len(samples)} samples; the mid-run scrape parses ({len(mid)} series, "
              f"ksel_monitor_samples 1); the last scrape == the registry's text; the server's threads gone; "
              f"{ms:.1f} ms")
        out["calls"]["e"] = {"ms": ms, "samples": len(samples), "mid_series": len(mid)}

        # (f) the CLI in subprocesses
        bundle_path = os.path.join(root, "b.json")
        cli = [sys.executable, "-m", "mpi_k_selection_tpu_torch"]
        runs = {
            "chaos": cli + ["--streaming", "--n", str(FAULT_CLI_CHUNKS * chunks[0].size), "--chunk-elems",
                            str(chunks[0].size), "--spill", "force", "--spill-dir", root, "--chaos", "7", "--check",
                            "--debug-bundle", bundle_path, "--json", "--device", device],
            "monitor": cli + ["monitor", "--buckets", "8", "--chunk-elems", str(1 << 20), "--drift", "1000",
                              "--device", device],
        }
        for name, argv in runs.items():
            sw = Stopwatch()
            with sw.timing():
                res = subprocess.run(argv, capture_output=True, text=True, timeout=300)
            lines = res.stdout.strip().splitlines()
            if res.returncode != 0:
                fail(f"(f) CLI {name}: exit {res.returncode}: {res.stderr[-2000:]}")
            if name == "chaos":
                record = json.loads(lines[-1])
                bundle = json.load(open(bundle_path))
                if not record["extra"]["certificate_ok"] or not record["extra"]["chaos"]["fired"] \
                        or any(s not in bundle for s in obs_lib.flight.BUNDLE_SECTIONS):
                    fail(f"(f) CLI chaos: {record}")
                note = (f"answer {record['answer']}, certificate {record['extra']['rank_certificate']}, fired "
                        f"{record['extra']['chaos']['fired']}, bundle sections {sorted(bundle)}")
            else:
                samples = [ln for ln in lines if ln.startswith("multirank_p50_p90_p99")]
                if len(samples) != 8:
                    fail(f"(f) CLI monitor: {len(samples)} sample lines: {lines[:3]}")
                note = f"8 sample lines, the last: {samples[-1]}"
            print(f"[phase11] (f) CLI {name}: exit 0 in {sw.seconds:.1f} s; {note}")
            out["calls"][f"f {name}"] = {"s": sw.seconds, "note": note}
        if glob.glob(os.path.join(root, "ksel-spill-*")):
            fail(f"phase 11: a spill store outlived its call: {os.listdir(root)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, per_call, out


SERVE_WINDOW = 0.002  # phase 12: the server's coalescing window (seconds)
SERVE_CLIENTS = 8  # phase 12: HTTP client threads
SERVE_QPS_QUERIES = 16  # phase 12: exact single-rank queries a client sends at each window of the throughput run
SERVE_CLI_N = 1 << 28  # phase 12's CLI run: 2^28 int32 uniform (the CLI's seed)


def http_json(port: int, method: str, path: str, body=None):
    """One request to a local HTTP front: ``(status, parsed JSON body or
    text)``."""
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        c.request(method, path, None if body is None else json.dumps(body), {"Content-Type": "application/json"})
        r = c.getresponse()
        raw = r.read()
        kind = r.getheader("Content-Type", "")
        return r.status, json.loads(raw) if kind.startswith("application/json") else raw.decode()
    finally:
        c.close()


def quantile_ms(seconds: list, q: float) -> float:
    """The nearest-rank ``q`` quantile of ``seconds``, in ms."""
    s = sorted(seconds)
    return s[max(0, min(len(s) - 1, int(np.ceil(q * len(s))) - 1))] * 1e3


def phase_serve(x30: torch.Tensor, f64: torch.Tensor, chunks, device: str = "cuda", cli_n: int = SERVE_CLI_N,
                oracles=None):
    """Phase 12, the resident-dataset query server: one ``KSelectServer(
    window=0.002, obs=..., flight=True)`` holding ``x30`` (2^30 int32
    ``uniform``, seed 0, cloned at registration, warmed), ``f64`` (2^27
    float64 ``normal``, warmed) and ``chunks`` (the int32 stream's first
    half, 16 chunks of 2^26) as a stream dataset, served over HTTP by
    ``start_http_server(port=0)``:

    - each op alone first, with the launch counts set to 0 just before it
      and read just after (its kernels launched, no plain version called):
      the registrations (row 8's sketch part), an exact rank and
      ``kselect_many`` of 4 ranks of each array (rows 1-5), ``topk`` (row
      6, on the float64 array), a certificate, an exact stream query (row
      8), a sketch read (no launch);
    - 8 client threads over HTTP: single exact ranks, ``kselect_many`` of 4
      ranks, the p50/p90/p99/p99.9 in each tier, ``topk`` k=128 largest
      and smallest, the certificate of the median, two exact stream
      queries; every exact answer equal to NumPy's bit for bit (the
      stream's by NumPy's certificate over the host chunks), every sketch
      answer's bounds around the true value, every auto answer the exact
      one, a coalesced batch wider than 1, no build at ``serve.programs``
      on the request path after warmup;
    - the latency a tier (median, p99), the queries a second at window 0
      and 0.002, the exact single-rank request beside a direct ``kselect``,
      the warmup's build and the cached sort's time and peak memory, the
      program cache's hits and misses;
    - after ``close()`` and dropping the datasets, no ``ksel-serve-*``
      thread and the card's allocated bytes back at their level;
    - the CLI in a subprocess: ``serve --n 2^28 --warmup --port 0
      --port-file ... --quit-after 4``, its answers against ``datagen``
      data.

    ``oracles`` are phase 3's NumPy answers for the same data (``{"i32":
    {k: bytes}, "f64": {k: bytes}, "f64_tops": {largest: (values,
    indices)}}`` at phase 3's ranks); without them the phase computes them.
    ``device="cpu"`` runs the same steps at a small size with the kernels'
    plain versions (a rehearsal off the card: the plain calls stand in for
    the launches)."""
    import gc
    import tempfile
    import threading

    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch import api, config
    from mpi_k_selection_tpu_torch import obs as obs_lib
    from mpi_k_selection_tpu_torch.cli import topk_oracle
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
    from mpi_k_selection_tpu_torch.ops.cuda import topk as T
    from mpi_k_selection_tpu_torch.serve import KSelectServer, start_http_server
    from mpi_k_selection_tpu_torch.serve.registry import DatasetRegistry
    from mpi_k_selection_tpu_torch.utils import datagen
    from mpi_k_selection_tpu_torch.utils.interop import tensor_to_numpy
    from mpi_k_selection_tpu_torch.utils.timing import Stopwatch

    on_card = device == "cuda"
    launches = {kname: 0 for kname in KERNELS}
    per_call, out = {}, {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def reset():
        for m in (H, T, S):
            m.reset_counts()

    def used():
        """The kernels launched since the reset (the plain calls off the
        card), and the plain calls that must not have happened on it."""
        got = {kname: v for kname, v in {**H.LAUNCHES, **T.LAUNCHES, **S.LAUNCHES}.items() if v}
        plain = {kname: v for kname, v in {**H.PLAIN_CALLS, **T.PLAIN_CALLS, **S.PLAIN_CALLS}.items() if v}
        return (got, plain) if on_card else (plain, {})

    def counted(what, fn, want=True):
        """``fn()`` with every count at 0 just before it: fails if a plain
        version ran on the card, or if ``want`` and nothing launched."""
        reset()
        sw = Stopwatch()
        with sw.timing():
            res = fn()
            sync()
        got, plain = used()
        if plain or (want and not got) or (not want and got):
            fail(f"{what}: launches {got}, plain calls {plain}")
        for kname, v in got.items():
            if kname in launches:
                launches[kname] += v
        per_call[what] = got
        print(f"[phase12] {what}: launches {got}, no plain call; {sw.seconds * 1e3:.1f} ms")
        return res, sw.seconds

    def serve_threads():
        return sorted(t.name for t in threading.enumerate() if t.name.startswith("ksel-serve"))

    n32, n64 = x30.numel(), f64.numel()
    ns = sum(c.size for c in chunks)
    # NumPy's answers (phase 3's, or from host copies): the ranks every client asks for
    ranks = {"i32": [1, 250, n32 // 2, n32] + api.quantile_ranks(QS, n32),
             "f64": [1, 250, n64 // 2, n64] + api.quantile_ranks(QS, n64)}
    sw = Stopwatch()
    with sw.timing():
        if oracles is None:
            f64h = tensor_to_numpy(f64)
            oracles = {"i32": oracle(tensor_to_numpy(x30), ranks["i32"]), "f64": oracle(f64h, ranks["f64"]),
                       "f64_tops": {largest: topk_oracle(f64h, TOPK, largest) for largest in (True, False)}}
            del f64h
    want = {"i32": oracles["i32"], "f64": oracles["f64"]}
    tops = oracles["f64_tops"]
    median32 = np.frombuffer(want["i32"][n32 // 2], np.int32)[0]
    print(f"[phase12] NumPy oracles of {len(ranks['i32'])} + {len(ranks['f64'])} ranks and 2 top-{TOPK} of the "
          f"float64 array: {sw.seconds:.1f} s")

    threads_before = serve_threads()
    gc.collect()
    sync()
    mem_before = torch.cuda.memory_allocated() if on_card else 0
    o = obs_lib.Observability.collecting(flight=True)
    srv = KSelectServer(window=SERVE_WINDOW, obs=o, flight=True)
    zero = None
    try:
        # registrations: each one's sketch counts its data with row 8's sketch part
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reg32_s = counted("register int32 2^30 (clone, sketch)",
                          lambda: srv.add_dataset("i32", x30, device=device))[1]
        warm32_s = counted("warmup int32 2^30 (cached sort, walk of one rank)",
                           lambda: srv.registry.warmup(srv.registry.get("i32")))[1]
        warm_peak = torch.cuda.max_memory_allocated() - mem_before if on_card else 0
        reg64_s = counted("register float64 2^27 with warmup",
                          lambda: srv.add_dataset("f64", f64, device=device, warmup=True))[1]
        regs_s = counted(f"register the int32 stream ({len(chunks)} chunks) with warmup",
                         lambda: srv.add_dataset("st", source=Replay(chunks), device=device, warmup=True,
                                                 pipeline_depth=2))[1]
        ds32 = srv.registry.get("i32")
        if ds32.data.data_ptr() == x30.data_ptr() or srv.registry.programs.misses != 5:
            fail(f"phase 12: the dataset was not cloned, or warmup built {srv.registry.programs.misses} programs")
        # the cached sort again, alone: its time and peak memory above the data
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if on_card else 0
        sws = Stopwatch()
        with sws.timing():
            s = DatasetRegistry._build_sorted(ds32)
            sync()
        sort_peak = torch.cuda.max_memory_allocated() - base if on_card else 0
        del s
        del ds32
        zero = obs_lib.LEDGER.snapshot()
        out["registration"] = {"i32_s": reg32_s, "i32_warmup_s": warm32_s, "i32_warmup_peak_bytes": warm_peak,
                               "f64_with_warmup_s": reg64_s, "stream_with_warmup_s": regs_s,
                               "sort_s": sws.seconds, "sort_peak_bytes": sort_peak}
        print(f"[phase12] registration: int32 {reg32_s:.3f} s, its warmup {warm32_s:.3f} s (peak {warm_peak} bytes "
              f"above the data before it); float64 with warmup {reg64_s:.3f} s; the stream with warmup "
              f"{regs_s:.3f} s; the cached sort of 2^30 int32 alone {sws.seconds * 1e3:.1f} ms, peak "
              f"{sort_peak} bytes above the data")

        with start_http_server(srv, port=0) as h:
            port = h.port

            def q(body):
                status, reply = http_json(port, "POST", "/v1/query", body)
                if status != 200:
                    fail(f"phase 12: {body} -> {status} {reply}")
                return reply

            def values(reply):
                return [a["value"] for a in reply["answers"]]

            def check_exact(name, reply, dtype):
                for a in reply["answers"]:
                    if np.asarray(a["value"], dtype).tobytes() != want[name][a["k"]] or not a["exact"]:
                        fail(f"phase 12: {name} k={a['k']}: {a} != NumPy's")

            # each op alone, its launches counted
            k_mid = n32 // 2
            r, _ = counted("exact rank int32", lambda: q({"dataset": "i32", "op": "kselect", "k": k_mid,
                                                           "tier": "exact"}))
            check_exact("i32", r, np.int32)
            r, _ = counted("kselect_many 4 ranks int32", lambda: q({"dataset": "i32", "op": "kselect",
                                                                     "ks": ranks["i32"][:4], "tier": "exact"}))
            check_exact("i32", r, np.int32)
            r, _ = counted("quantiles exact float64", lambda: q({"dataset": "f64", "op": "quantiles",
                                                                 "qs": list(QS), "tier": "exact"}))
            check_exact("f64", r, np.float64)
            r, _ = counted("exact rank float64", lambda: q({"dataset": "f64", "op": "kselect", "k": 250,
                                                             "tier": "exact"}))
            check_exact("f64", r, np.float64)
            r, _ = counted(f"topk k={TOPK} float64", lambda: q({"dataset": "f64", "op": "topk", "k": TOPK}))
            if np.asarray(r["indices"]).tolist() != tops[True][1].tolist():
                fail("phase 12: topk's indices != NumPy's")
            r, _ = counted("rank certificate int32 (torch compares)", lambda: q(
                {"dataset": "i32", "op": "rank_certificate", "value": int(median32)}), want=False)
            if not r["less"] < k_mid <= r["leq"]:
                fail(f"phase 12: the certificate of the median {r}")
            r, stream_s = counted("exact stream median", lambda: q({"dataset": "st", "op": "kselect",
                                                                     "k": ns // 2, "tier": "exact"}))
            less, leq = np_certificates(chunks, [r["answers"][0]["value"]])[0]
            if not less < ns // 2 <= leq:
                fail(f"phase 12: the stream median {r} fails NumPy's certificate ({less}, {leq}]")
            counted("sketch quantiles int32 (the request thread)", lambda: q(
                {"dataset": "i32", "op": "quantiles", "qs": list(QS), "tier": "sketch"}), want=False)
            rows = {"radix_histogram32", "radix_histogram64", "radix_histogram_multi32", "radix_histogram_multi64",
                    "sweep_ingest32", "sweep_ingest64"}
            seen = {kname for got in per_call.values() for kname in got}
            if on_card and (not rows <= seen or not seen & {"match_counts32", "match_counts64"}
                            or not seen & {"tau_counts32", "tau_counts64"}):
                fail(f"phase 12: the serve path launched {sorted(seen)}; rows 1-6 and 8 must all launch")

            # 8 clients at once over HTTP
            lat = {"sketch": [], "exact": []}
            answers, errors = [], []
            lock = threading.Lock()
            barrier = threading.Barrier(SERVE_CLIENTS)

            def client(i):
                def send(body):
                    sw = Stopwatch()
                    with sw.timing():
                        reply = q(body)
                    tier = reply["answers"][0]["tier"] if "answers" in reply else "exact"
                    with lock:
                        lat[tier].append(sw.seconds)
                        answers.append((body, reply))
                    return reply

                try:
                    barrier.wait(timeout=60)
                    r32, r64 = ranks["i32"], ranks["f64"]
                    send({"dataset": "i32", "op": "kselect", "k": r32[i % len(r32)], "tier": "exact"})
                    send({"dataset": "f64", "op": "kselect", "k": r64[(i + 3) % len(r64)], "tier": "exact"})
                    send({"dataset": "i32", "op": "kselect", "ks": r32[:4], "tier": "exact"})
                    for tier in ("sketch", "exact", "auto"):
                        send({"dataset": "i32", "op": "quantiles", "qs": list(QS), "tier": tier})
                        send({"dataset": "f64", "op": "quantiles", "qs": list(QS), "tier": tier})
                    send({"dataset": "f64", "op": "topk", "k": TOPK, "largest": i % 2 == 0})
                    send({"dataset": "i32", "op": "rank_certificate", "value": int(median32)})
                    if i < 2:  # two exact stream queries
                        send({"dataset": "st", "op": "quantiles", "qs": [0.5, 0.99][i:i + 1], "tier": "exact"})
                except BaseException as e:  # raised below, on the main thread
                    errors.append(e)

            reset()
            swc = Stopwatch()
            with swc.timing():
                clients = [threading.Thread(target=client, args=(i,), name=f"phase12-client-{i}")
                           for i in range(SERVE_CLIENTS)]
                for t in clients:
                    t.start()
                for t in clients:
                    t.join(timeout=600)
            if errors or any(t.is_alive() for t in clients):
                fail(f"phase 12: the clients failed: {errors}")
            got, plain = used()
            if plain or not got:
                fail(f"phase 12: 8 clients: launches {got}, plain calls {plain}")
            for kname, v in got.items():
                if kname in launches:
                    launches[kname] += v
            per_call[f"{SERVE_CLIENTS} HTTP clients"] = got
            # every answer against NumPy
            exact_by_q = {}
            stream_values = []
            for body, reply in answers:
                name = body["dataset"]
                if body["op"] == "topk":
                    v, idx = tops[body.get("largest", True)]
                    if reply["indices"] != idx.tolist() or np.asarray(reply["values"], np.float64).tobytes() \
                            != v.tobytes():
                        fail(f"phase 12: topk {body} != NumPy's")
                elif body["op"] == "rank_certificate":
                    if not reply["less"] < k_mid <= reply["leq"]:
                        fail(f"phase 12: certificate {reply}")
                elif name == "st":
                    stream_values += [(a["k"], a["value"]) for a in reply["answers"]]
                else:
                    dtype = np.int32 if name == "i32" else np.float64
                    for a in reply["answers"]:
                        truth = want[name][a["k"]]
                        if a["tier"] == "exact":
                            if np.asarray(a["value"], dtype).tobytes() != truth:
                                fail(f"phase 12: {name} {a} != NumPy's")
                            exact_by_q[(name, a["k"])] = a["value"]
                        else:
                            lo, hi = a["rank_bounds"]
                            v_lo, v_hi = a["value_bounds"]
                            tv = np.frombuffer(truth, dtype)[0]
                            if not (lo < a["k"] <= hi and v_lo <= tv <= v_hi):
                                fail(f"phase 12: sketch answer {a} does not bracket {tv!r}")
            for body, reply in answers:
                if body.get("tier") == "auto":
                    for a in reply["answers"]:
                        if a["value"] != exact_by_q.get((body["dataset"], a["k"]), a["value"]) or not a["exact"]:
                            fail(f"phase 12: auto {a} != the exact answer")
            certs = np_certificates(chunks, [v for _, v in stream_values])
            for (k, v), (less, leq) in zip(stream_values, certs):
                if not less < k <= leq:
                    fail(f"phase 12: stream k={k} {v} fails NumPy's certificate ({less}, {leq}]")
            widths = [e.width for e in o.events.of_kind("serve.batch")]
            if max(widths) < 2 or o.metrics.histogram("serve.batch_width").max < 2:
                fail(f"phase 12: no coalescing: batch widths {widths}")
            lat_ms = {t: {"n": len(v), "median_ms": quantile_ms(v, 0.5), "p99_ms": quantile_ms(v, 0.99)}
                      for t, v in lat.items()}
            print(f"[phase12] {SERVE_CLIENTS} clients, {len(answers)} requests in {swc.seconds:.3f} s: every exact "
                  f"answer NumPy's, {len(stream_values)} stream answers certified, sketch bounds bracket the truth, "
                  f"auto == exact; batch widths up to {max(widths)}; latency {lat_ms}")
            out["clients"] = {"requests": len(answers), "s": swc.seconds, "latency": lat_ms,
                              "max_batch_width": max(widths), "launches": got}

            # queries a second at window 0 and 0.002: the same registry behind a second front at window 0
            qps = {}
            for window in (0.0, SERVE_WINDOW):
                view = srv if window == SERVE_WINDOW else KSelectServer(window=0.0, registry=srv.registry)
                try:
                    with start_http_server(view, port=0) as hv:
                        def burst(i, hv=hv):
                            for j in range(SERVE_QPS_QUERIES):
                                k = ranks["i32"][(i + j) % len(ranks["i32"])]
                                st, reply = http_json(hv.port, "POST", "/v1/query",
                                                      {"dataset": "i32", "op": "kselect", "k": k, "tier": "exact"})
                                if st != 200 or np.asarray(reply["answers"][0]["value"], np.int32).tobytes() \
                                        != want["i32"][k]:
                                    errors.append((k, st, reply))

                        swq = Stopwatch()
                        with swq.timing():
                            ts = [threading.Thread(target=burst, args=(i,)) for i in range(SERVE_CLIENTS)]
                            for t in ts:
                                t.start()
                            for t in ts:
                                t.join(timeout=600)
                finally:
                    if view is not srv:
                        view.close()
                if errors:
                    fail(f"phase 12: throughput run at window {window}: {errors[:3]}")
                qps[str(window)] = SERVE_CLIENTS * SERVE_QPS_QUERIES / swq.seconds
            print(f"[phase12] exact single-rank queries a second over HTTP, {SERVE_CLIENTS} clients x "
                  f"{SERVE_QPS_QUERIES}: {qps}")
            out["qps"] = qps

            # the exact single-rank request beside a direct kselect of the same rank
            times = {"direct kselect": [], "server.kselect (in process)": [], "HTTP request": []}
            for _ in range(5):
                for label, fn in (("direct kselect", lambda: kt.kselect(x30, k_mid)),
                                  ("server.kselect (in process)", lambda: srv.kselect("i32", k_mid, tier="exact")),
                                  ("HTTP request", lambda: q({"dataset": "i32", "op": "kselect", "k": k_mid,
                                                              "tier": "exact"}))):
                    sw1 = Stopwatch()
                    with sw1.timing():
                        fn()
                        sync()
                    times[label].append(sw1.seconds)
            single = {label: quantile_ms(v, 0.5) for label, v in times.items()}
            print(f"[phase12] one exact rank (k=N/2) of 2^30 int32, median of 5: {single} ms")
            out["single_rank_ms"] = single

        book = obs_lib.snapshot_delta(zero, obs_lib.LEDGER.snapshot())["sites"].get("serve.programs", {})
        if book.get("compiles", 0) != 0 or not book.get("hits"):
            fail(f"phase 12: the request path built programs after warmup: {book}")
        cache = {"hits": srv.registry.programs.hits, "misses": srv.registry.programs.misses}
        print(f"[phase12] serve.programs on the request path: {book.get('compiles', 0)} builds, {book['hits']} hits; "
              f"the program cache: {cache}")
        out["programs"] = {"request_path": book, "cache": cache}
    finally:
        for name in srv.registry.list_datasets():
            srv.drop_dataset(name["dataset"])
        srv.close()
    del srv, o
    gc.collect()
    sync()
    mem_after = torch.cuda.memory_allocated() if on_card else 0
    if serve_threads() != threads_before or mem_after != mem_before:
        fail(f"phase 12: left behind threads {serve_threads()}, allocated {mem_after} bytes against {mem_before}")
    print(f"[phase12] after close and drop: no ksel-serve thread, allocated {mem_after} bytes == before")

    # the CLI in a subprocess, with the blocks this process's allocator still
    # caches (the warmup's sort peaked near 40 GB) given back to the card
    if on_card:
        torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip-smoke-phase12-", dir=tempfile.gettempdir())
    port_file = os.path.join(root, "port")
    argv = [sys.executable, "-m", "mpi_k_selection_tpu_torch", "serve", "--n", str(cli_n), "--warmup", "--port", "0",
            "--port-file", port_file, "--quit-after", "4", "--device", device]
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        swl = Stopwatch()
        with swl.timing():
            for _ in range(6000):
                if proc.poll() is not None or (os.path.exists(port_file) and open(port_file).read()):
                    break
                threading.Event().wait(0.05)
            if proc.poll() is not None:
                fail(f"phase 12: the CLI exited {proc.returncode}: {proc.stderr.read()[-2000:]}")
            port = int(open(port_file).read())
            xc = datagen.generate(cli_n, pattern="uniform", seed=config.DEFAULT_SEED, dtype=np.int32)
            ks = [1, cli_n // 2] + api.quantile_ranks(QS, cli_n)
            wc = oracle(xc, ks)
            replies = [http_json(port, "GET", "/healthz"),
                       http_json(port, "POST", "/v1/query", {"dataset": "default", "op": "kselect", "ks": ks[:2],
                                                             "tier": "exact"}),
                       http_json(port, "POST", "/v1/query", {"dataset": "default", "op": "quantiles", "qs": list(QS),
                                                             "tier": "auto"}),
                       http_json(port, "GET", "/v1/datasets")]
            stdout, stderr = proc.communicate(timeout=120)
        if proc.returncode != 0 or any(st != 200 for st, _ in replies):
            fail(f"phase 12: CLI exit {proc.returncode}, replies {replies}: {stderr[-2000:]}")
        got = [a for _, r in replies[1:3] for a in r["answers"]]
        if [np.asarray(a["value"], np.int32).tobytes() for a in got] != [wc[k] for k in ks]:
            fail(f"phase 12: the CLI's answers {got} != NumPy's over datagen's data")
        print(f"[phase12] CLI serve --n {cli_n} --warmup --quit-after 4: exit 0 in {swl.seconds:.1f} s, "
              f"{len(got)} answers NumPy's; {stdout.strip().splitlines()[0][:120]}")
        out["cli"] = {"s": swl.seconds, "datasets": replies[3][1]}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    return launches, per_call, out


DIST_WORLD = 4  # ranks of the distributed phase, all on cuda:0 (one card: gloo)
DIST_REPS = 3  # timed runs of each distributed path (the median run's counts reported)
DIST_N64 = 1 << 30  # BASELINE.md's "Multi-chip distributed median: N=1B int64"
DIST_CGM = ((16_000_000, 8_000_000), (100_000_000, 150))  # BASELINE's CGM config; the reference's own
DIST_TOPK_N = 1 << 26
# the kernels each distributed path must launch on every rank (CGM runs
# torch.sort and torch.searchsorted: no kernel of the port)
DIST_LAUNCH_KEYS = ("radix_histogram32", "radix_histogram64", "radix_histogram_multi32", "radix_histogram_multi64",
                    "match_counts32", "match_counts64", "tau_counts32", "tau_counts64")
DIST_PATHS = {  # label: kernels it must launch (the values lie below 2^27, so every 64-bit key shares its top
    # 37 bits: both rungs of the ladder overflow and all 16 passes run, no collect; at 32 bits the median of
    # 10^8 collects after 5 passes, about 4096 keys under the 20-bit prefix, gathered from every rank)
    "median int64 uniform 2^30": ("radix_histogram64",),
    "quantiles K=4 int64 uniform 2^30": ("radix_histogram64", "radix_histogram_multi64"),
    "median int32 uniform 10^8": ("radix_histogram32", "match_counts32"),
    "cgm int32 uniform 16M k=N/2": (),
    "cgm int32 uniform 10^8 k=150": (),
    f"topk k={TOPK} float32 normal 2^26": ("radix_histogram32", "tau_counts32"),
}
# distributed_sketch at the default 16 bits, each timed as the paths above:
# the 10^8 int32, and the 2^30 int64 (its values lie below 2^27, so every
# key of a rank's 2^28-key shard falls in one of the 2^16 counters)
DIST_SKETCHES = {"sketch int32 uniform 10^8": ("int32 uniform 10^8", DIST_REPS),
                 "sketch int64 uniform 2^30": ("int64 uniform 2^30", DIST_REPS)}


def dist_rank(mesh, files):
    """One rank of phase 6 (spawned by ``run_ranks``): memory-map the global
    arrays, place this rank's shards (timed), then drive each distributed
    path twice, a barrier before each: the first run with the launch counts
    set to 0 just before it and read just after, the second timed with CUDA
    events on this rank. Rank 0 returns every rank's counts, gathered."""
    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch import api
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.parallel import shard_1d
    from mpi_k_selection_tpu_torch.utils.interop import tensor_to_numpy

    data = {name: np.load(path, mmap_mode="r") for name, path in files.items()}

    def timed(fn):
        mesh.barrier()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    placed = {}
    for name in data:
        sentinel = "min" if name.startswith("float32") else "max"  # the top-k's losers
        placed[name], ms = timed(lambda: shard_1d(data[name], mesh, sentinel=sentinel))
        placed[name + " ms"] = ms
    x64, n64 = placed["int64 uniform 2^30"], DIST_N64
    calls = {
        "median int64 uniform 2^30": lambda: kt.distributed_radix_select(x64, n64 // 2, mesh=mesh),
        "quantiles K=4 int64 uniform 2^30":
            lambda: kt.distributed_radix_select_many(x64, api.quantile_ranks(QS, n64), mesh=mesh),
        "median int32 uniform 10^8":
            lambda: kt.distributed_radix_select(placed["int32 uniform 10^8"], DIST_CGM[1][0] // 2, mesh=mesh),
        "cgm int32 uniform 16M k=N/2":
            lambda: kt.distributed_cgm_select(placed["int32 uniform 16M"], DIST_CGM[0][1], mesh=mesh,
                                              return_rounds=True),
        "cgm int32 uniform 10^8 k=150":
            lambda: kt.distributed_cgm_select(placed["int32 uniform 10^8"], DIST_CGM[1][1], mesh=mesh,
                                              return_rounds=True),
        f"topk k={TOPK} float32 normal 2^26":
            lambda: kt.distributed_topk(placed["float32 normal 2^26"], TOPK, mesh=mesh),
    }
    out = {"device": str(mesh.device), "backend": mesh.backend, "world": mesh.size,
           "place_ms": {k[:-3]: v for k, v in placed.items() if k.endswith(" ms")}, "paths": {}}
    # one pass's collective with no kernel between: the all_reduce of a
    # 16-bucket int64 histogram on the card, 50 in a row after a barrier
    # (host clock around each call: the staging copies included; the
    # mesh's own count: the gloo call alone)
    from mpi_k_selection_tpu_torch.utils.timing import Stopwatch

    probe = {}
    for where in ("cuda", "cpu"):  # a host tensor: gloo alone, no copy and no wait on the card
        hist = torch.ones(16, dtype=torch.int64, device=mesh.device if where == "cuda" else "cpu")
        mesh.barrier()
        mesh.reset_stats()
        calls_clock = Stopwatch()
        for _ in range(50):
            with calls_clock.timing():
                hist = mesh.all_reduce(hist) // mesh.size
                if where == "cuda":
                    torch.cuda.synchronize()
        probe[where] = (calls_clock.seconds / 50 * 1e3, mesh.collective_seconds() / 50 * 1e3)
    out["allreduce_probe_ms"] = probe
    for label, fn in calls.items():
        H.reset_counts()
        first, _ = timed(fn)  # the counted run
        counts = [H.LAUNCHES[k] for k in DIST_LAUNCH_KEYS] + [sum(H.PLAIN_CALLS.values())]
        runs = []
        for _ in range(DIST_REPS):
            mesh.reset_stats()
            second, ms = timed(fn)
            runs.append([ms, float(mesh.collectives), mesh.collective_seconds() * 1e3])
        runs.sort()
        stats = runs[len(runs) // 2] + [runs[0][0], runs[-1][0]]  # the median run's; the fastest and slowest ms
        per_rank = mesh.all_gather(torch.tensor(counts + stats, dtype=torch.float64))
        rounds = None
        if isinstance(first, tuple) and isinstance(first[1], int):  # cgm: (value, rounds)
            (first, rounds), (second, _) = first, second
        if isinstance(first, tuple):  # topk: (values, indices)
            first = [tensor_to_numpy(t) for t in first]
            second = [tensor_to_numpy(t) for t in second]
        else:
            first, second = tensor_to_numpy(first.reshape(-1)), tensor_to_numpy(second.reshape(-1))
        out["paths"][label] = {"answer": first, "again": second, "rounds": rounds, "per_rank": per_rank.numpy()}
    out["sketches"] = dist_sketches(mesh, placed, timed)
    if mesh.rank == 0:
        out["kernel_checks"] = dist_kernel_checks(placed)
    mesh.barrier()
    return out


def dist_sketches(mesh, placed, timed) -> dict:
    """``distributed_sketch`` of each of :data:`DIST_SKETCHES` on this rank:
    a run with the launch counts at 0 just before it and read just after,
    timed (CUDA events after a barrier), then ``reps`` more timed runs that
    must give the same sketch. Returns rank 0's sketch and every rank's
    launches, plain calls, sketch digest and times, gathered."""
    import hashlib

    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S

    def digest(sk):  # the keys as int64 bit patterns
        h = hashlib.blake2b(sk.hists[-1].tobytes(), digest_size=7).digest()
        keys = np.array([sk._min_key, sk._max_key], np.uint64).view(np.int64).tolist()
        return [sk.n, *keys, int.from_bytes(h, "little")]

    out = {}
    for label, (name, reps) in DIST_SKETCHES.items():
        H.reset_counts()
        S.reset_counts()
        mesh.reset_stats()
        sk, ms = timed(lambda: kt.distributed_sketch(placed[name], mesh=mesh))
        counts = [S.LAUNCHES["sweep_ingest32"], S.LAUNCHES["sweep_ingest64"], sum(H.LAUNCHES.values()),
                  sum(H.PLAIN_CALLS.values()) + sum(S.PLAIN_CALLS.values())]
        runs = [[ms, float(mesh.collectives), mesh.collective_seconds() * 1e3]]
        for _ in range(reps):
            mesh.reset_stats()
            again, ms = timed(lambda: kt.distributed_sketch(placed[name], mesh=mesh))
            if again != sk:
                raise RuntimeError(f"{label}: a second run gave another sketch")
            runs.append([ms, float(mesh.collectives), mesh.collective_seconds() * 1e3])
        runs.sort()
        stats = runs[len(runs) // 2] + [runs[0][0], runs[-1][0]]
        ints = mesh.all_gather(torch.tensor(counts + digest(sk), dtype=torch.int64))
        times = mesh.all_gather(torch.tensor(stats, dtype=torch.float64))
        out[label] = {"deep": sk.hists[-1], "n": sk.n, "min": int(sk._min_key), "max": int(sk._max_key),
                      "per_rank": ints.numpy(), "times": times.numpy()}
    return out


def dist_kernel_checks(placed) -> dict:
    """Each kernel the distributed paths launch, on rank 0's shards (the
    shapes those paths give it: 2^28 int64, 2.5e7 int32, 2^24 float32
    words), held exactly against its plain version on the same tensor.
    Returns ``{kernel: max_abs_err}``."""
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
    from mpi_k_selection_tpu_torch.ops.radix import cutover_passes
    from mpi_k_selection_tpu_torch.utils import dtypes as dt

    err = {}

    def exact(name, kernel, plain, **kw):
        d = (kernel(**kw) - plain(**kw)).abs().max().item()
        err[name] = max(err.get(name, 0), d)

    for label, bits, key_op, key_xor in (("int64 uniform 2^30", 64, "xor", 1 << 63),
                                         ("int32 uniform 10^8", 32, "xor", 1 << 31),
                                         ("float32 normal 2^26", 32, "float", 0)):
        shard = placed[label]
        w = shard.block.view(torch.int32 if bits == 32 else torch.int64)
        n = w.numel()
        keys = dt.keys_from_raw(w[[n // 3, n // 2, n - 1]], key_op, key_xor)
        kw = dict(words=w, radix_bits=4, key_op=key_op, key_xor=key_xor)
        name = f"radix_histogram{bits}"
        exact(name, H.radix_histogram, H.radix_histogram_plain, shift=bits - 4, **kw)
        exact(name, H.radix_histogram, H.radix_histogram_plain, shift=bits - 12,
              prefix=dt.shift_right_logical(keys[:1], bits - 8, bits).contiguous(), **kw)
        if bits == 64:  # the quantiles' passes: K prefixes of keys in the data
            exact("radix_histogram_multi64", H.radix_histogram_multi, H.radix_histogram_multi_plain, shift=bits - 12,
                  prefixes=dt.shift_right_logical(keys, bits - 8, bits).contiguous(), **kw)
        elif key_op == "xor":  # the median's collect at its cutover width
            res = 4 * cutover_passes(shard.n, bits, 4, 8192)
            exact("match_counts32", H.match_counts, H.match_counts_plain, words=w, resolved_bits=res,
                  prefixes=dt.shift_right_logical(keys[1:2], bits - res, bits).contiguous(),
                  key_op=key_op, key_xor=key_xor)
        else:  # the top-k's threshold count
            for largest in (True, False):
                exact("tau_counts32", H.tau_counts, H.tau_counts_plain, words=w, tau=keys[1:2].clone(),
                      largest=largest, key_op=key_op, key_xor=key_xor)
        if key_op == "xor":  # distributed_sketch: the sketch part on the shard's real keys
            n_valid = min(n, shard.n - shard.rank * n)
            kw = dict(key_op=key_op, key_xor=key_xor, sketch_bits=SKETCH_BITS)
            got, want = S.sweep_ingest(w, n_valid, **kw)[4], S.sweep_ingest_plain(w, n_valid, **kw)[4]
            err[f"sweep_ingest{bits}"] = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    torch.cuda.synchronize()
    return err


def bincount_ranks(x: np.ndarray, ks) -> list:
    """NumPy's k-th smallest of non-negative integers for each k: the
    running count of each value (``np.bincount``) searched for k."""
    cum = np.cumsum(np.bincount(x))
    return [int(np.searchsorted(cum, k)) for k in ks]


def phase_distributed():
    """Phase 6: the distributed paths on ``DIST_WORLD`` ranks sharing one
    card over gloo, each answer against a NumPy oracle; then the native
    ``mpi`` backend and the resident single-device median as yardsticks."""
    import math
    import shutil
    import tempfile

    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch.cli import topk_oracle
    from mpi_k_selection_tpu_torch.parallel.mesh import choose_backend
    from mpi_k_selection_tpu_torch.parallel.multihost import run_ranks
    from mpi_k_selection_tpu_torch.parallel.sketch import SEGMENT as SKETCH_SEGMENT
    from mpi_k_selection_tpu_torch.utils import datagen
    from mpi_k_selection_tpu_torch.utils.timing import cuda_ms

    backend = choose_backend(DIST_WORLD, "cuda")
    where = (f"{DIST_WORLD} ranks sharing one {torch.cuda.get_device_name(0)} over {backend}"
             if backend == "gloo" else f"{DIST_WORLD} ranks, one card each, over {backend}")
    print(f"[dist] {where}")
    tmp = tempfile.mkdtemp(prefix="kselect-dist-")
    try:
        arrays = {
            "int64 uniform 2^30": datagen.generate(DIST_N64, pattern="uniform", seed=0, dtype=np.int64),
            "int32 uniform 16M": datagen.generate(DIST_CGM[0][0], pattern="uniform", seed=0),
            "int32 uniform 10^8": datagen.generate(DIST_CGM[1][0], pattern="uniform", seed=0),
            "float32 normal 2^26": datagen.generate(DIST_TOPK_N, pattern="normal", seed=0, dtype=np.float32),
        }
        files = {}
        for name, a in arrays.items():
            files[name] = f"{tmp}/{name.replace(' ', '_').replace('^', '')}.npy"
            np.save(files[name], a)
        x64, i16, i8, f32 = arrays.values()
        qranks = [max(1, min(DIST_N64, math.ceil(q * DIST_N64))) for q in QS]
        want = {
            "median int64 uniform 2^30": bincount_ranks(x64, [DIST_N64 // 2]),
            "quantiles K=4 int64 uniform 2^30": bincount_ranks(x64, qranks),
            "median int32 uniform 10^8": bincount_ranks(i8, [DIST_CGM[1][0] // 2]),
            "cgm int32 uniform 16M k=N/2": [int(np.partition(i16, DIST_CGM[0][1] - 1)[DIST_CGM[0][1] - 1])],
            "cgm int32 uniform 10^8 k=150": [int(np.partition(i8, DIST_CGM[1][1] - 1)[DIST_CGM[1][1] - 1])],
            f"topk k={TOPK} float32 normal 2^26": topk_oracle(f32, TOPK),
        }
        out = run_ranks(dist_rank, DIST_WORLD, files, device="cuda", timeout=600)
    finally:
        shutil.rmtree(tmp)
    if out["world"] != DIST_WORLD or out["backend"] != backend or out["device"] != "cuda:0":
        fail(f"distributed phase ran {out['world']} ranks over {out['backend']} on {out['device']}")
    rows, summary = [], {"where": where, "place_ms_rank0": out["place_ms"]}
    for label, r in out["paths"].items():
        ok = True
        if label.startswith("topk"):
            got = r["answer"]
            ok = got[0].tobytes() == want[label][0].tobytes() and np.array_equal(got[1], want[label][1])
            ok = ok and all(a.tobytes() == b.tobytes() for a, b in zip(got, r["again"]))
        else:
            ok = r["answer"].tolist() == want[label] and r["again"].tobytes() == r["answer"].tobytes()
        if not ok:
            fail(f"distributed {label}: {r['answer']!r} (again {r['again']!r}) != NumPy {want[label]!r}")
        pr = r["per_rank"]
        nk = len(DIST_LAUNCH_KEYS)
        launches = [{k: int(v) for k, v in zip(DIST_LAUNCH_KEYS, row[:nk]) if v} for row in pr]
        plain = [int(row[nk]) for row in pr]
        missing = [(rank, k) for rank, row in enumerate(launches) for k in DIST_PATHS[label] if not row.get(k)]
        if missing or any(plain):
            fail(f"distributed {label}: kernels not launched {missing}, plain calls {plain}")
        ms, coll, coll_ms, fastest, slowest = (float(pr[0][nk + 1 + i]) for i in range(5))
        print(f"[dist] {label}: exact vs NumPy; {ms:.3f} ms on rank 0 (CUDA events, after a barrier; median of "
              f"{DIST_REPS}, {fastest:.3f}-{slowest:.3f})"
              + ("" if r["rounds"] is None else f"; {r['rounds']} CGM rounds")
              + f"; {int(coll)} collectives, {coll_ms:.3f} ms in them on rank 0")
        for rank, row in enumerate(launches):
            print(f"[dist]   rank {rank}: launches {row}; {int(pr[rank][nk + 2])} collectives, "
                  f"{pr[rank][nk + 3]:.3f} ms in them; {pr[rank][nk + 1]:.3f} ms")
        rows.append({"what": f"distributed {label}", "ms": ms, "ms_range": [fastest, slowest],
                     "rounds": r["rounds"], "collectives": int(coll),
                     "collective_ms": coll_ms, "launches_per_rank": launches,
                     "ms_per_rank": [float(row[nk + 1]) for row in pr]})
    summary["paths"] = rows
    # distributed_sketch: every rank's sketch the same, rank 0's equal to
    # NumPy's sketch of the whole array bit for bit
    summary["sketches"] = []
    for label, arr in (("sketch int32 uniform 10^8", i8), ("sketch int64 uniform 2^30", x64)):
        r = out["sketches"][label]
        deep, n, kmin, kmax = np_sketch(np_chunk_sketches(np.array_split(arr, 16)))
        if not (np.array_equal(r["deep"], deep) and (r["n"], r["min"], r["max"]) == (n, kmin, kmax)):
            fail(f"distributed {label}: rank 0's sketch != NumPy's (n {r['n']} vs {n})")
        pr, times = r["per_rank"], r["times"]
        if any(row[4:].tolist() != pr[0][4:].tolist() for row in pr):
            fail(f"distributed {label}: the ranks' sketches differ: {pr[:, 4:].tolist()}")
        bits = 32 if "int32" in label else 64
        # one launch a segment of a rank's real keys (its pads are never counted)
        per = -(-arr.size // len(pr))
        valid = [max(0, min(arr.size, (r + 1) * per) - r * per) for r in range(len(pr))]
        expect = [-(-v // SKETCH_SEGMENT) for v in valid]
        if [int(row[0 if bits == 32 else 1]) for row in pr] != expect or any(row[2] or row[3] for row in pr):
            fail(f"distributed {label}: per-rank launches (sweep32, sweep64, other kernels, plain) "
                 f"{pr[:, :4].tolist()}; sweep_ingest{bits} must launch {expect} times (once a segment of "
                 f"{valid} real keys)")
        ms, coll, coll_ms, fastest, slowest = (float(v) for v in times[0])
        print(f"[dist] {label}: == NumPy's sketch bit for bit on every rank; {ms:.3f} ms on rank 0 (CUDA events, "
              f"after a barrier; median of {DIST_SKETCHES[label][1] + 1} runs, "
              f"{fastest:.3f}-{slowest:.3f}); {int(coll)} collectives, {coll_ms:.3f} ms in them; launches of "
              f"sweep_ingest{bits} a rank {pr[:, 0 if bits == 32 else 1].tolist()}")
        summary["sketches"].append({"what": f"distributed {label}", "ms": ms, "ms_range": [fastest, slowest],
                                    "runs": DIST_SKETCHES[label][1] + 1, "collectives": int(coll),
                                    "collective_ms": coll_ms, "ms_per_rank": times[:, 0].tolist(),
                                    "sweep_launches_per_rank": pr[:, 0 if bits == 32 else 1].tolist()})
    checks = out["kernel_checks"]
    print(f"[check] distributed shards (rank 0) through each kernel vs plain: max_abs_err {checks}")
    if any(checks.values()):
        fail(f"a kernel != plain at a distributed shard's shape: {checks}")
    summary["kernel_checks"] = checks
    print(f"[dist] shard placement on rank 0 (memory map to cuda:0): {out['place_ms']}")
    probe = out["allreduce_probe_ms"]
    print(f"[dist] one 16-bucket int64 all_reduce with no kernel between, rank 0: on cuda:0 "
          f"{probe['cuda'][0]:.3f} ms a call ({probe['cuda'][1]:.3f} ms of it in gloo, the rest the staging "
          f"copies); of a host tensor {probe['cpu'][0]:.3f} ms a call")
    summary["allreduce_probe_ms"] = {w: {"call": c, "gloo": g} for w, (c, g) in probe.items()}

    # the native mpi backend: the reference's CGM over 4 forked host ranks,
    # in a process of its own (it forks; this one holds CUDA and threads)
    n8, k8 = DIST_CGM[1]
    res = subprocess.run(
        [sys.executable, "-m", "mpi_k_selection_tpu_torch", "--backend", "mpi", "--num-procs", str(DIST_WORLD),
         "--n", str(n8), "--k", str(k8), "--verify", "--json"],
        capture_output=True, text=True, timeout=600,
    )
    if res.returncode != 0:
        fail(f"the mpi backend: rc {res.returncode}: {res.stderr[-2000:]}")
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    cuda_cgm = out["paths"]["cgm int32 uniform 10^8 k=150"]
    if rec["answer"] != want["cgm int32 uniform 10^8 k=150"][0] or rec["answer"] != int(cuda_cgm["answer"][0]):
        fail(f"the mpi backend answered {rec['answer']}, NumPy {want['cgm int32 uniform 10^8 k=150']}, "
             f"the cuda backend's CGM {cuda_cgm['answer']}")
    print(f"[dist] mpi backend (native, {DIST_WORLD} forked host ranks) 10^8 int32 k=150: {rec['answer']} "
          f"== NumPy == cuda backend's CGM; {rec['rounds']} rounds ({cuda_cgm['rounds']} on the card's ranks: "
          f"the native runtime keeps the reference's coarseness c); {rec['seconds'] * 1e3:.1f} ms (host clock)")
    summary["mpi_backend"] = {"answer": rec["answer"], "rounds": rec["rounds"], "ms": rec["seconds"] * 1e3}

    # the yardstick: the same 2^30 int64 whole on the card, one process
    xd = torch.from_numpy(x64).cuda()
    del arrays, x64
    got = int(kt.median(xd))
    if got != want["median int64 uniform 2^30"][0]:
        fail(f"resident median of the 2^30 int64: {got} != NumPy {want['median int64 uniform 2^30']}")
    ms = cuda_ms(lambda: kt.median(xd), iters=3)
    print(f"[dist] yardstick: resident median of the same 2^30 int64 on one process: {ms:.3f} ms (exact)")
    summary["resident_median_ms"] = ms
    del xd
    torch.cuda.empty_cache()
    return summary


def kernel_device_ms(fn, name: str, reps: int = 10):
    """Device milliseconds per launch of the kernels whose name holds
    ``name`` over ``reps`` calls of ``fn`` (torch.profiler), or None when
    three profiles in a row saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile that recorded no device event is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and name in e.key]
        count = sum(e.count for e in evs)
        if count:
            return sum(e.self_device_time_total for e in evs) / 1e3 / count
    return None


def sweep_kinds(bits: int, chunk: np.ndarray):
    """(label, sweep_ingest parts) of each launch kind the streamed paths
    issue, on one chunk of the stream, with the prefixes its own quantiles
    give: a first pass (the top digit, no prefix); a pass under one prefix
    (the median's top 8 bits) and under the 4 distinct 16-bit prefixes of
    the p50/p90/p99/p99.9 keys (the quantiles); the collect of one sparse
    spec (the median's top 24 bits) and of the 4 quantile keys' specs; a
    certificate (the median's key); and the sketch alone at the sketches'
    default 16 bits (16-bit counters in shared memory)."""
    keys = host_keys(chunk)
    n = keys.size
    ranks = [n // 2] + [max(0, int(np.ceil(q * n)) - 1) for q in QS]
    part = np.partition(keys, ranks)
    med = int(part[ranks[0]])
    qk = [int(part[r]) for r in ranks[1:]]
    q16 = sorted({k >> (bits - 16) for k in qk})
    return [
        ("hist, no prefix (pass 0)", dict(hist_prefixes=[0], shift=bits - 8, radix_bits=8)),
        ("hist, 1 prefix", dict(hist_prefixes=[med >> (bits - 8)], shift=bits - 16, radix_bits=8)),
        (f"hist, {len(q16)} distinct prefixes", dict(hist_prefixes=q16, shift=bits - 24, radix_bits=8)),
        ("collect, 1 sparse spec", dict(collect=[(bits - 24, med >> (bits - 24))])),
        ("collect, 4 specs", dict(collect=[(bits - 24, k >> (bits - 24)) for k in qk])),
        ("certificate", dict(vkey=med)),
        ("sketch, 16 bits", dict(sketch_bits=SKETCH_BITS)),
    ]


def tee_kinds(bits: int, chunk: np.ndarray):
    """(label, sweep_ingest parts) of the spill passes' histogram + tee
    launch on one chunk of a stream: the histogram of the 8 bits below the
    prefixes the tee takes whole, for the median's 8-bit prefix (a spill
    pass of the median) and for survivor shares of about 1%, 17% and 50%
    (the one prefix of 8, 12 or 16 bits, or the union of the largest 8-bit
    prefixes, whose share is nearest; none that repeats an earlier kind);
    pass 0's every-key tee beside the prefix-free first pass; and the union
    of the 4 quantile keys' 16-bit prefixes (the spilled quantiles K=4),
    alone and with a parked rank's spec of another width (the largest
    key's 12-bit prefix)."""
    keys = host_keys(chunk)
    n = keys.size
    ranks = [n // 2] + [max(0, int(np.ceil(q * n)) - 1) for q in QS]
    part = np.partition(keys, ranks)
    med = int(part[ranks[0]])
    q16 = sorted({int(part[r]) >> (bits - 16) for r in ranks[1:]})
    top = int(keys.max())

    def launch(width, prefixes):
        return dict(hist_prefixes=list(prefixes), shift=bits - width - 8, radix_bits=8,
                    tee=[(bits - width, p) for p in prefixes])

    cands = []  # (share, width, prefixes)
    for width in (8, 12, 16):
        counts = np.bincount((keys >> (bits - width)).astype(np.int64), minlength=1 << width)
        cands += [(int(counts[v]) / n, width, [int(v)]) for v in np.flatnonzero(counts)]
        if width == 8:
            big = np.argsort(-counts, kind="stable")
            cands += [(int(counts[big[:k]].sum()) / n, 8, sorted(int(v) for v in big[:k])) for k in range(2, 9)]
    kinds = [("hist 1 prefix + tee 1 spec (spill pass)", launch(8, [med >> (bits - 8)]))]
    for share in TEE_SHARES:
        got, width, prefixes = min(cands, key=lambda c: (abs(c[0] - share), c[1], c[2]))
        parts = launch(width, prefixes)
        if all(parts != k for _, k in kinds):
            what = f"{len(prefixes)} {width}-bit prefixes" if len(prefixes) > 1 else f"a {width}-bit prefix"
            kinds.append((f"hist under {what} + its tee, {got:.1%} of keys", parts))
    kinds.append(("hist, no prefix + the every-key tee (pass 0)",
                  dict(hist_prefixes=[0], shift=bits - 8, radix_bits=8, tee=[(bits, 0)])))
    k4 = dict(hist_prefixes=q16, shift=bits - 24, radix_bits=8, tee=[(bits - 16, q) for q in q16])
    kinds.append((f"hist under {len(q16)} 16-bit prefixes + their tee (spilled quantiles)", k4))
    kinds.append((f"hist under {len(q16)} 16-bit prefixes + their tee + a parked 12-bit spec",
                  dict(k4, tee=k4["tee"] + [(bits - 12, top >> (bits - 12))])))
    return kinds


def sweep_kind_rows(row, bits: int, w: torch.Tensor, kinds, key_op: str, key_xor: int, library_hist=False) -> dict:
    """Phase 4 for the sweep kernel at each launch kind of ``kinds``
    (:func:`sweep_kinds`: (label, parts)) on the words ``w`` on the card:
    held exactly against the plain version first, then the kernel's own
    device time (torch.profiler) and the whole ``sweep_ingest`` call (CUDA
    events), each beside its share of the bound. The bound counts the read,
    every returned survivor buffer as written bytes (L words each: the
    survivors, then zeros) and the counters; the old bound, beside it,
    counted the survivors only. A launch with a sketch part must count
    every word of the bucket (its counts sum to L); it is also timed as
    the plain version and beside ``torch.bincount`` of the top key bits (of
    the 16-bit digit, for a histogram of 16-bit keys) and
    ``torch.aminmax`` of the keys, held equal first; so is a tee launch
    (beside ``torch.bincount`` + ``torch.masked_select``) and, with
    ``library_hist``, a histogram launch (beside ``torch.bincount``)."""
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
    from mpi_k_selection_tpu_torch.utils.timing import cuda_ms

    n, wb = w.numel(), bits // 8
    out = {}
    for label, parts in kinds:
        kw = dict(key_op=key_op, key_xor=key_xor, **parts)
        got = S.sweep_ingest(w, n, **kw)
        err = sweep_err(got, S.sweep_ingest_plain(w, n, **kw), f"sweep_ingest{bits} {label}")
        survivors = sum(int(c) for _, c in got[1]) + (int(got[2][1]) if got[2] is not None else 0)
        n_surv = len(got[1]) + (got[2] is not None)  # the collect buffers and the tee's
        sketch_bits = parts.get("sketch_bits", 0)
        counters = 4 * ((1 << sketch_bits if sketch_bits else 0)
                        + len(parts.get("hist_prefixes", ())) * (1 << parts.get("radix_bits", 1)))
        b, by = bound(n * wb + n_surv * n * wb + counters, n)
        old_b, _ = bound(n * wb + survivors * wb, n)
        if sketch_bits and int((got[0][0] if sketch_bits == 1 else got[4][0]).sum()) != n:
            fail(f"sweep_ingest{bits} {label}: the counts do not sum to the bucket's {n} words")
        kms = kernel_device_ms(lambda: S.sweep_ingest(w, n, **kw), "sweep_ingest_kernel")
        ms = cuda_ms(lambda: S.sweep_ingest(w, n, **kw))
        alone = "not measured" if kms is None else f"{kms:.4f} ms ({b / kms:.0%}; {old_b / kms:.0%} of the old)"
        row(f"sweep_ingest{bits} {label}, a {n}-word chunk", ms, b, by,
            f"   call {b / ms:.0%} of bound; old bound {old_b:.4f} ms; kernel alone {alone}; "
            f"{survivors} survivors; max_abs_err {err}")
        out[label] = {"kernel_ms": kms, "call_ms": ms, "bound_ms": b, "old_bound_ms": old_b,
                      "survivors": survivors, "max_abs_err": err}
        if sketch_bits:
            out[label]["plain_ms"] = cuda_ms(lambda: S.sweep_ingest_plain(w, n, **kw), iters=3, warmup=1)
            row(f"sweep_ingest_plain {label}, a {n}-word chunk", out[label]["plain_ms"], b, by)
            out[label]["library_ms"] = library_sketch_ms(w, got, bits, key_op, key_xor, parts)
            what = "the 16-bit digit" if sketch_bits == 1 else f"the top {sketch_bits} key bits"
            row(f"torch.bincount of {what} + torch.aminmax, {n} words", out[label]["library_ms"], b, by)
        elif parts.get("tee"):
            out[label]["plain_ms"] = cuda_ms(lambda: S.sweep_ingest_plain(w, n, **kw), iters=3, warmup=1)
            row(f"sweep_ingest_plain {label}, a {n}-word chunk", out[label]["plain_ms"], b, by)
            out[label]["library_ms"] = library_tee_ms(w, got, bits, key_op, key_xor, parts)
            row(f"torch.bincount + torch.masked_select of the tee's mask, {n} words", out[label]["library_ms"], b, by)
        elif parts.get("hist_prefixes") and library_hist:
            out[label]["plain_ms"] = cuda_ms(lambda: S.sweep_ingest_plain(w, n, **kw), iters=3, warmup=1)
            row(f"sweep_ingest_plain {label}, a {n}-word chunk", out[label]["plain_ms"], b, by)
            out[label]["library_ms"] = library_hist_ms(w, got, bits, key_op, key_xor, parts)
            row(f"torch.bincount of the digits under the prefixes, {n} words", out[label]["library_ms"], b, by)
        del got
        torch.cuda.empty_cache()
    return out


def library_tee_ms(w: torch.Tensor, got, bits: int, key_op: str, key_xor: int, parts) -> float:
    """The sweep kernel's tee launch (a histogram under the prefixes a
    spill pass tees and the tee union, a later spill pass's launch) as
    library calls on the same words: ``torch.bincount`` of (prefix row,
    digit) over the keys under any of the prefixes (the rest in one spare
    bin) and ``torch.masked_select`` of the keys under the union's mask,
    held equal to the kernel's output ``got`` first; the bin indices and
    the mask are made untimed. CUDA-event milliseconds of the two calls."""
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
    from mpi_k_selection_tpu_torch.utils import dtypes as dt
    from mpi_k_selection_tpu_torch.utils.timing import cuda_ms

    keys = dt.keys_from_raw(w, key_op, key_xor)
    shift, width, prefixes = parts["shift"], parts["radix_bits"], parts["hist_prefixes"]
    distinct = sorted(set(prefixes))
    above = dt.shift_right_logical(keys, shift + width, bits).long()  # non-negative: a logical shift
    table = torch.tensor(distinct, dtype=torch.int64, device=w.device)
    row_of = torch.searchsorted(table, above).clamp(max=len(distinct) - 1)
    hit = table[row_of] == above
    digit = (dt.shift_right_logical(keys, shift, bits) & ((1 << width) - 1)).long()
    index = torch.where(hit, row_of * (1 << width) + digit, len(distinct) << width)
    tmask = torch.zeros_like(hit)
    for s, p in parts["tee"]:
        tmask |= S._spec_match(keys, s, p, bits)
    del above, row_of, hit, digit

    def fn():
        return torch.bincount(index, minlength=(len(distinct) << width) + 1), torch.masked_select(keys, tmask)

    counts, surv = fn()
    counts = counts[: len(distinct) << width].view(len(distinct), 1 << width).to(torch.int32)
    buf, cnt = got[2]
    if not (all(torch.equal(counts[distinct.index(p)], got[0][i]) for i, p in enumerate(prefixes))
            and torch.equal(surv, buf[: int(cnt)])):
        fail(f"sweep_ingest{bits} {parts}: library calls != kernel")
    ms = cuda_ms(fn)
    del keys, index, tmask, counts, surv
    return ms


def library_hist_ms(w: torch.Tensor, got, bits: int, key_op: str, key_xor: int, parts) -> float:
    """The sweep kernel's histogram launch as one library call on the same
    words: ``torch.bincount`` of (prefix row, digit) over the keys under
    any of the launch's prefixes (the rest in one spare bin), held equal
    to the kernel's counts ``got[0]`` first; the bin indices are made
    untimed. CUDA-event milliseconds of the call."""
    from mpi_k_selection_tpu_torch.utils import dtypes as dt
    from mpi_k_selection_tpu_torch.utils.timing import cuda_ms

    keys = dt.keys_from_raw(w, key_op, key_xor)
    shift, width, prefixes = parts["shift"], parts["radix_bits"], parts["hist_prefixes"]
    distinct = sorted(set(prefixes))
    above = dt.shift_right_logical(keys, shift + width, bits).long()  # non-negative: a logical shift
    table = torch.tensor(distinct, dtype=torch.int64, device=w.device)
    row_of = torch.searchsorted(table, above).clamp(max=len(distinct) - 1)
    hit = table[row_of] == above
    digit = (dt.shift_right_logical(keys, shift, bits) & ((1 << width) - 1)).long()
    index = torch.where(hit, row_of * (1 << width) + digit, len(distinct) << width)
    del keys, above, row_of, hit, digit

    def fn():
        return torch.bincount(index, minlength=(len(distinct) << width) + 1)

    counts = fn()[: len(distinct) << width].view(len(distinct), 1 << width).to(torch.int32)
    if not all(torch.equal(counts[distinct.index(p)], got[0][i]) for i, p in enumerate(prefixes)):
        fail(f"sweep_ingest{bits} {parts}: library call != kernel")
    ms = cuda_ms(fn)
    del index, counts
    return ms


def library_sketch_ms(w: torch.Tensor, got, bits: int, key_op: str, key_xor: int, parts) -> float:
    """The sweep kernel's sketch launch as library calls on the same words:
    ``torch.bincount`` of the top ``sketch_bits`` key bits (of the 16-bit
    digit, when the launch counts 16-bit keys in its histogram part and
    takes a 1-bit sketch for the extremes) and ``torch.aminmax`` of the
    keys in unsigned order (biased signed), held equal to the kernel's
    output ``got`` (counts, key min, key max) first; the keys are made
    untimed. CUDA-event milliseconds of the two calls."""
    from mpi_k_selection_tpu_torch.utils import dtypes as dt
    from mpi_k_selection_tpu_torch.utils.timing import cuda_ms

    keys = dt.keys_from_raw(w, key_op, key_xor)
    width = parts["radix_bits"] if parts["sketch_bits"] == 1 else parts["sketch_bits"]
    shift = parts["shift"] if parts["sketch_bits"] == 1 else bits - width
    top = (dt.shift_right_logical(keys, shift, bits) & ((1 << width) - 1)).long()
    biased = dt.order_bias(keys, bits)

    def fn():
        return torch.bincount(top, minlength=1 << width), torch.aminmax(biased)

    counts, (lo, hi) = fn()
    deep, kmin, kmax = got[4]
    if parts["sketch_bits"] == 1:
        deep = got[0][0]
    if not (torch.equal(counts.to(torch.int32), deep) and int(dt.order_bias(lo, bits)) == int(kmin)
            and int(dt.order_bias(hi, bits)) == int(kmax)):
        fail(f"sweep_ingest{bits} {parts}: library calls != kernel")
    ms = cuda_ms(fn)
    del keys, top, biased
    return ms


ANALYSIS_DATASET = 1 << 26  # phase 13: the sanitized server's int32 dataset
ANALYSIS_CLIENTS, ANALYSIS_RANKS = 8, 16  # phase 13: client threads x exact ranks each


def phase_analysis(x30: torch.Tensor, chunks, want_i32=None, device: str = "cuda"):
    """Phase 13, the analyzer and the 16-bit repair, all on ``device``:

    - the median and quantiles K=4 of ``x30`` (2^30 int32 uniform) at
      ``radix_bits=16`` beside the default 4-bit calls: CUDA-event ms, the
      passes and the launches, every answer NumPy's (``want_i32``: phase
      3's oracle, made here when None); the 16-bit route's launch kinds (the
      top digit, and a digit under K=4 prefixes) as the sweep kernel alone
      (torch.profiler) and the whole wrapper call, beside the bound and
      ``torch.bincount`` of the same digits;
    - the analyzer over the port's tree (no contracts): 0 unsuppressed
      findings and 0 stale suppressions, with its seconds;
    - the contracts' CUDA halves (KSC101-105) on small tensors: each
      verdict, the launch-trail lengths and the host-read census;
    - the lock-order sanitizer around a ``KSelectServer(window=0.002)``
      session (8 clients x 16 exact ranks on the first 2^26 keys of
      ``x30``, every answer NumPy's) and around a two-slot streamed median
      of ``chunks`` (NumPy's certificate): the observed package edges, 0
      cycles, no direction conflict with the static lock graph
      (``check_consistency``), the edges the static graph holds too, the
      session's queries a second with the sanitizer on and off, and a
      flight bundle whose ``lock_order`` is the observed graph.

    Returns (launches, per_call, notes)."""
    import pathlib
    import threading

    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch import api
    from mpi_k_selection_tpu_torch.analysis import (
        LockOrderSanitizer,
        build_concurrency_report,
        run_analysis,
        run_contracts,
    )
    from mpi_k_selection_tpu_torch.analysis import contracts as C
    from mpi_k_selection_tpu_torch.obs import Observability
    from mpi_k_selection_tpu_torch.obs.flight import build_bundle
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
    from mpi_k_selection_tpu_torch.ops.cuda import topk as T
    from mpi_k_selection_tpu_torch.ops.radix import resolve_cutover
    from mpi_k_selection_tpu_torch.serve import KSelectServer
    from mpi_k_selection_tpu_torch.utils.interop import tensor_to_numpy
    from mpi_k_selection_tpu_torch.utils.timing import Stopwatch, cuda_ms

    notes = {}
    launches = {kn: 0 for kn in KERNELS}
    per_call = {}
    on_card = torch.device(device).type == "cuda"

    def reset():
        for mod in (H, S, T):
            mod.reset_counts()

    def used():
        got = {k: v for k, v in {**H.LAUNCHES, **T.LAUNCHES, **S.LAUNCHES}.items() if v}
        plain = {k: v for k, v in {**H.PLAIN_CALLS, **T.PLAIN_CALLS, **S.PLAIN_CALLS}.items() if v}
        return got, plain

    # -- the 16-bit repair on the 2^30 int32 array --------------------------
    n = x30.numel()
    ranks = [n // 2] + api.quantile_ranks(QS, n)
    if want_i32 is None:
        want_i32 = oracle(tensor_to_numpy(x30), ranks)
    calls = {
        "median": lambda rb: kt.median(x30, radix_bits=rb),
        "quantiles K=4": lambda rb: kt.quantiles(x30, QS, radix_bits=rb),
    }
    rows16 = {}
    for label, fn in calls.items():
        for rb in (4, 16):
            what = f"{label} int32 uniform 2^30, radix_bits={rb}"
            reset()
            got = tensor_to_numpy(fn(rb).reshape(-1))
            kn, plain = used()
            ks = ranks[:1] if label == "median" else ranks[1:]
            if got.tobytes() != b"".join(want_i32[k] for k in ks):
                fail(f"phase 13: {what}: {got} != NumPy's")
            if on_card and (plain or not kn or (rb == 16 and not any(k.startswith("sweep_ingest") for k in kn))):
                fail(f"phase 13: {what}: launches {kn}, plain calls {plain}")
            for k, v in kn.items():
                launches[k] += v
            per_call[what] = kn
            ms = cuda_ms(lambda: fn(rb), iters=5, warmup=1)
            ncut = resolve_cutover("auto", n, 32, rb, 8192)
            rows16[what] = {"ms": ms, "passes": 32 // rb, "cutover_passes": ncut, "launches": kn}
            print(f"[phase13] {what}: {ms:.3f} ms; {32 // rb} passes (cutover after {ncut}); launches {kn}; NumPy's")
    notes["radix16"] = rows16

    w = x30.reshape(-1)
    kinds = {}
    top = dict(shift=16, radix_bits=16)
    hist = H.radix_histogram(w, **top)
    digits = ((w >> 16) & 0xFFFF).long()
    lib = lambda: torch.bincount(digits, minlength=1 << 16)  # noqa: E731
    if not torch.equal(lib(), hist):
        fail("phase 13: the 16-bit top digit != torch.bincount")
    kinds["top digit, no prefix"] = (lambda: H.radix_histogram(w, **top), lib)
    keys = w
    picks = [int(v) for v in (keys[[7, n // 3, 2 * n // 3, n - 1]] >> 16) & 0xFFFF]
    low = dict(shift=0, radix_bits=16)
    pre = torch.tensor(picks, dtype=torch.int32, device=w.device)
    hist4 = H.radix_histogram_multi(w, prefixes=pre, **low)
    above = ((w >> 16) & 0xFFFF).long()
    table = torch.tensor(sorted(set(picks)), dtype=torch.int64, device=w.device)
    row = torch.searchsorted(table, above).clamp(max=table.numel() - 1)
    index = torch.where(table[row] == above, row * (1 << 16) + (w & 0xFFFF).long(), table.numel() << 16)
    del above, row
    lib4 = lambda: torch.bincount(index, minlength=(table.numel() << 16) + 1)  # noqa: E731
    counts = lib4()[: table.numel() << 16].view(-1, 1 << 16)
    if not all(torch.equal(counts[sorted(set(picks)).index(p)], hist4[i]) for i, p in enumerate(picks)):
        fail("phase 13: the 16-bit digit under 4 prefixes != torch.bincount")
    kinds["digit under K=4 prefixes"] = (lambda: H.radix_histogram_multi(w, prefixes=pre, **low), lib4)
    b, by = bound(n * 4 + 4 * (1 << 16), n)
    for label, (fn, lfn) in kinds.items():
        kms = kernel_device_ms(fn, "sweep_ingest_kernel", reps=5)
        ms = cuda_ms(fn, iters=5, warmup=1)
        lms = cuda_ms(lfn, iters=3, warmup=1)
        alone = "not measured" if kms is None else f"{kms:.4f} ms ({b / kms:.0%} of bound)"
        print(f"[phase13] 16-bit route, {label}, 2^30 int32: kernel alone {alone}; call {ms:.4f} ms; bound "
              f"{b:.4f} ms ({by}); torch.bincount {lms:.4f} ms")
        kinds[label] = {"kernel_ms": kms, "call_ms": ms, "bound_ms": b, "bound_by": by, "bincount_ms": lms}
    notes["radix16_kinds"] = kinds
    del digits, index, hist, hist4, counts
    torch.cuda.empty_cache()

    # -- the analyzer over the port's tree, on a machine without JAX ------------
    pkg = pathlib.Path(kt.__file__).resolve().parent
    sw = Stopwatch()
    with sw.timing():
        report = run_analysis([pkg], root=pkg.parent, contracts=False)
    if report.unsuppressed or report.dead_suppressions:
        fail(f"phase 13: analyzer: {[f.render() for f in report.unsuppressed]} stale {report.dead_suppressions}")
    notes["analyzer"] = {"files": len(report.files), "findings": 0, "suppressed": len(report.findings),
                         "stale": 0, "seconds": sw.seconds, "checks": report.checks_run}
    print(f"[phase13] analyzer over {len(report.files)} files of the port: 0 findings ({len(report.findings)} "
          f"suppressed), 0 stale suppressions, {sw.seconds:.2f} s")

    # -- the contracts' CUDA halves -----------------------------------------------
    sw = Stopwatch()
    reset()
    with sw.timing():
        verdicts = run_contracts(device)
    bad = {cid: [f.message for f in fs] for cid, fs in verdicts.items() if fs}
    if bad:
        fail(f"phase 13: contracts on {device}: {bad}")
    kn, plain = used()
    if on_card and plain:
        fail(f"phase 13: the contracts called plain versions on the card: {plain}")
    for k, v in kn.items():
        launches[k] += v
    per_call["contracts KSC101-105 on the card"] = kn
    notes["contracts"] = {"verdicts": {cid: "pass" for cid in verdicts}, "seconds": sw.seconds,
                          "details": {cid: C.DETAILS.get(cid) for cid in verdicts}, "launches": kn}
    print(f"[phase13] contracts KSC101-105 on {device}: all pass in {sw.seconds:.2f} s; trail lengths "
          f"{C.DETAILS['KSC103']['trail_lengths']}; launches {kn}")

    # -- the lock-order sanitizer around a server session and a two-slot median ----
    x26 = x30.reshape(-1)[:ANALYSIS_DATASET].clone()
    n26 = x26.numel()
    ks26 = [1 + (i * 7919 * 131) % n26 for i in range(ANALYSIS_CLIENTS * ANALYSIS_RANKS)]
    want26 = oracle(tensor_to_numpy(x26), ks26)

    def session(obs=None):
        srv = KSelectServer(window=SERVE_WINDOW, obs=obs)
        errors = []
        try:
            srv.add_dataset("x", x26, device=device)
            srv.kselect("x", 1, tier="exact")  # builds the dataset's programs before the clock

            def client(i):
                try:
                    for j in range(ANALYSIS_RANKS):
                        k = ks26[i * ANALYSIS_RANKS + j]
                        a = srv.kselect("x", k, tier="exact")
                        if np.asarray(a.value, np.int32).tobytes() != want26[k]:
                            errors.append((k, a.value))
                except BaseException as e:  # raised below, on the main thread
                    errors.append(e)

            sw = Stopwatch()
            with sw.timing():
                ts = [threading.Thread(target=client, args=(i,)) for i in range(ANALYSIS_CLIENTS)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(timeout=600)
        finally:
            srv.close()
        if errors or any(t.is_alive() for t in ts):
            fail(f"phase 13: server session: {errors[:3]}")
        return ANALYSIS_CLIENTS * ANALYSIS_RANKS / sw.seconds

    qps_off = session()
    obs = Observability.collecting(flight=True)
    k_mid = sum(c.size for c in chunks) // 2
    with LockOrderSanitizer() as san:
        san.patch_package_locks()
        qps_on = session(obs)
        reset()
        slots = (device, device) if on_card else 2  # two slots of one card
        v = kt.kselect_streaming(chunks, k_mid, devices=slots, device=device, pipeline_depth=2, obs=obs)
        kn, plain = used()
    less, leq = np_certificates(chunks, [v])[0]
    if not less < k_mid <= leq or (on_card and plain):
        fail(f"phase 13: sanitized two-slot median {v!r}: NumPy certificate ({less}, {leq}], plain {plain}")
    for k, c in kn.items():
        launches[k] += c
    per_call["sanitized two-slot streamed median"] = kn
    cycles = san.find_cycles(package_only=True)
    static = build_concurrency_report([pkg], root=pkg.parent)["lock_graph"]
    conflicts = san.check_consistency(static)
    edges = san.package_edges()
    site_to_key = {nd["site"]: key for key, nd in static["nodes"].items()}
    site_to_key.update({key: key for key in static["nodes"]})
    static_edges = {(e["src"], e["dst"]) for e in static["edges"]}
    joined = [(a, b) for a, b, _ in edges if a in site_to_key and b in site_to_key]
    in_static = [(a, b) for a, b in joined if (site_to_key[a], site_to_key[b]) in static_edges]
    if cycles or conflicts:
        fail(f"phase 13: lock order: cycles {cycles}, conflicts {conflicts}")
    bundle = build_bundle(obs, reason="phase 13")
    if not bundle.get("lock_order") or bundle["lock_order"]["package_edges"] != san.to_dict()["package_edges"]:
        fail("phase 13: the flight bundle does not carry the observed lock order")
    notes["lock_order"] = {
        "labels": len(san.labels), "threads": len(san.threads_seen), "package_edges": [list(e) for e in edges],
        "cycles": 0, "conflicts": 0, "edges_joined_to_static_nodes": len(joined),
        "edges_in_static_graph": len(in_static), "static_nodes": len(static["nodes"]),
        "static_edges": len(static_edges), "qps_sanitizer_off": qps_off, "qps_sanitizer_on": qps_on,
        "median": repr(v), "bundle_lock_order_edges": len(bundle["lock_order"]["edges"]),
    }
    print(f"[phase13] lock-order sanitizer: {len(edges)} package edges over {len(san.threads_seen)} threads, 0 "
          f"cycles, 0 conflicts with the static graph ({len(static['nodes'])} nodes, {len(static_edges)} edges; "
          f"{len(joined)} observed edges join its nodes, {len(in_static)} are its edges); server session "
          f"{qps_off:.1f} queries/s off, {qps_on:.1f} on; two-slot median {v!r} certified; bundle lock_order "
          f"has {len(bundle['lock_order']['edges'])} edges")
    del x26
    torch.cuda.empty_cache()
    return launches, per_call, notes


def generation_digests(root: str) -> dict:
    """``{gen dir/record file: blake2b digest}`` of every generation file of
    the store at ``root``, read on 8 threads (hashlib releases the GIL)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    paths = sorted(glob.glob(os.path.join(root, "gen-*", "*")))

    def digest(path):
        with open(path, "rb") as f:
            return hashlib.blake2b(f.read(), digest_size=16).hexdigest()

    with ThreadPoolExecutor(8) as pool:
        return {os.path.relpath(p, root): d for p, d in zip(paths, pool.map(digest, paths))}


def phase_ingest_pool(chunks, device: str = "cuda"):
    """Phase 14, the pooled host data plane and spill decode (this slice's
    paths), on ``chunks`` (the int32 stream's first half), at each
    ``ingest_workers`` of :data:`POOL_WIDTHS`, each call driven with the
    launch counts set to 0 just before it and read just after:

    - the one-shot spilled median (a generator of the chunks, ``spill=`` a
      store of the script's that keeps every generation, ``pack_spill=
      "auto"``);
    - ``streaming_rank_certificate`` of that answer from the packed store
      (its generation 0, the later ones dropped once hashed; decoded on
      the pool at width > 1).

    Each call runs under the profiler with a PhaseTimer: wall ms, the
    device's idle share, ``pass_host_ms`` (the certificate's record work),
    ``HOST_COPY``, ``ingest_hidden_frac``, ``encode_hidden_frac``, the
    phases and the peak device memory. Fails unless the sweep kernel alone
    launched (at least once a pass; once a record for the certificate), no
    plain version ran, the widths' answers and certificates are the same
    bits and NumPy's certificate, every generation file is byte-identical
    across the widths, and no ``ksel-ingest-*`` thread or staged chunk is
    left."""
    import shutil
    import tempfile
    import threading

    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
    from mpi_k_selection_tpu_torch.ops.cuda import topk as T
    from mpi_k_selection_tpu_torch.streaming import pipeline as pl
    from mpi_k_selection_tpu_torch.streaming import spill as sp
    from mpi_k_selection_tpu_torch.utils.profiling import PhaseTimer

    on_card = device == "cuda"
    n = len(chunks) * chunks[0].size
    k = n // 2
    launches = {"sweep_ingest32": 0, "sweep_ingest64": 0}
    per_call, out = {}, {"calls": {}, "widths": list(POOL_WIDTHS)}
    root = tempfile.mkdtemp(prefix="chip-smoke-pool-root-", dir=tempfile.gettempdir())
    answers, certs, digests = {}, {}, {}
    staged = pl.live_staged_keys()  # chunks earlier phases staged by hand and still hold

    def counted(what, fn, passes_fn, exact=None):
        """One call with every count at 0 just before it; fails unless the
        int32 sweep kernel launched (at least once a pass ``passes_fn()``
        counts, or ``exact`` times) and nothing else ran."""
        for m in (H, T, S):
            m.reset_counts()
        pl.HOST_COPY.reset()
        if on_card:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        res = profiled_call(fn) if on_card else (fn(), None, None, None, [])
        peak = torch.cuda.max_memory_allocated() - base if on_card else None
        got = S.LAUNCHES["sweep_ingest32"] if on_card else S.PLAIN_CALLS["sweep_ingest"]
        passes = passes_fn()
        others = {kn: v for kn, v in {**H.LAUNCHES, **T.LAUNCHES, "sweep_ingest64": S.LAUNCHES["sweep_ingest64"]}.items()
                  if v}
        plain = {kn: v for kn, v in {**H.PLAIN_CALLS, **T.PLAIN_CALLS, **S.PLAIN_CALLS}.items() if v}
        if (got != exact if exact is not None else got < max(1, passes)) or others or (on_card and plain):
            fail(f"{what}: {got} launches of sweep_ingest32 over {passes} passes (want {exact or 'one a pass'}); "
                 f"other kernels {others}; plain calls {plain}")
        if on_card:
            launches["sweep_ingest32"] += got
            per_call[what] = {"sweep_ingest32": got}
        return (*res, peak, got)

    try:
        for w in POOL_WIDTHS:
            store = kt.SpillStore(root)
            store.drop_generation = lambda gen: None  # every generation stays, to be compared across widths
            timer = PhaseTimer()
            what = f"streaming median one-shot spill=store pack_spill=auto ingest_workers={w}, int32 uniform {n}"
            got, ms, busy, idle, top, peak, nl = counted(what, lambda: kt.kselect_streaming(
                (c for c in chunks), k, spill=store, pack_spill="auto", ingest_workers=w, timer=timer,
                device=device), lambda: len(store.pass_log))
            answers[w] = got
            digests[w] = generation_digests(store.root)
            for idx in sorted(store.generations)[1:]:  # the store keeps generation 0, as a caller's store does
                kt.SpillStore.drop_generation(store, store.generations[idx])
            rec = {"ms": ms, "busy_ms": busy, "idle_share": idle, "answer": repr(got), "launches": nl,
                   "pass_host_ms": list(store.pass_host_ms), "host_copy_s": pl.HOST_COPY.seconds,
                   "host_copy_count": pl.HOST_COPY.count, "ingest_hidden_frac": pl.ingest_hidden_frac(timer),
                   "encode_hidden_frac": pl.encode_hidden_frac(timer), "phases": timer.as_dict(),
                   "peak_device_bytes": peak, "generation0_bytes": store.generations[0].nbytes}
            out["calls"][what] = rec
            print(f"[pool] {what}: {got!r}; {'not measured' if ms is None else f'{ms:.1f} ms'}; idle share "
                  + ("not measured" if idle is None else f"{idle:.3f}")
                  + f"; host copy {rec['host_copy_s'] * 1e3:.1f} ms in {rec['host_copy_count']} copies; "
                  f"ingest_hidden_frac {rec['ingest_hidden_frac']}, encode_hidden_frac {rec['encode_hidden_frac']}; "
                  f"peak device memory {peak if peak is None else f'{peak / 2**20:.1f} MiB'}")
            for h in store.pass_host_ms:
                print(f"[pool]   pass {h['pass']}: host ms " + ", ".join(
                    f"{key[:-3]} {h[key]:.1f}" for key in ("prepare_ms", "write_ms", "read_ms")))
            print(f"[pool]   phases (summed over threads): " + ", ".join(
                f"{name} {d['seconds'] * 1e3:.1f} ms ({d['calls']}x)" for name, d in sorted(timer.as_dict().items())))
            timer = PhaseTimer()
            marks = {name: sw.seconds for name, sw in sp.HOST_TIMES.items()}
            what = f"streaming_rank_certificate(packed store) ingest_workers={w}, int32 uniform {n}"
            records = len(store.generations[0].records)
            cert, ms, busy, idle, top, peak, nl = counted(what, lambda: kt.streaming_rank_certificate(
                store, got, ingest_workers=w, timer=timer, device=device), lambda: 1, exact=records)
            certs[w] = tuple(cert)
            host = {f"{name}_ms": (sw.seconds - marks[name]) * 1e3 for name, sw in sp.HOST_TIMES.items()}
            out["calls"][what] = {"ms": ms, "busy_ms": busy, "idle_share": idle, "certificate": list(cert),
                                  "launches": nl, "host_ms": host, "host_copy_s": pl.HOST_COPY.seconds,
                                  "host_copy_count": pl.HOST_COPY.count,
                                  "ingest_hidden_frac": pl.ingest_hidden_frac(timer),
                                  "encode_hidden_frac": pl.encode_hidden_frac(timer), "phases": timer.as_dict(),
                                  "peak_device_bytes": peak}
            print(f"[pool] {what}: {cert}; {'not measured' if ms is None else f'{ms:.1f} ms'}; idle share "
                  + ("not measured" if idle is None else f"{idle:.3f}")
                  + f"; host ms {({kk: round(v, 1) for kk, v in host.items()})}; host copy "
                  f"{pl.HOST_COPY.seconds * 1e3:.1f} ms in {pl.HOST_COPY.count} copies; ingest_hidden_frac "
                  f"{out['calls'][what]['ingest_hidden_frac']}, encode_hidden_frac "
                  f"{out['calls'][what]['encode_hidden_frac']}")
            store.close()
            left = [t.name for t in threading.enumerate() if t.name.startswith(pl.INGEST_THREAD_PREFIX)]
            if left or pl.live_staged_keys() != staged:
                fail(f"ingest_workers={w}: threads {left} and {pl.live_staged_keys() - staged} staged chunks left")
        first, last = POOL_WIDTHS[0], POOL_WIDTHS[-1]
        if answers[first].tobytes() != answers[last].tobytes() or certs[first] != certs[last]:
            fail(f"ingest_workers {first} and {last}: answers {answers[first]!r} / {answers[last]!r}, "
                 f"certificates {certs[first]} / {certs[last]}")
        want = np_certificates(chunks, [answers[first]])[0]
        if certs[first] != want or not want[0] < k <= want[1]:
            fail(f"the pooled phase's certificate {certs[first]} != NumPy's {want} (k = {k})")
        if not digests[first] or digests[first] != digests[last]:
            diff = sorted(set(digests[first].items()) ^ set(digests[last].items()))[:4]
            fail(f"generation files differ across ingest_workers {first} and {last}: {diff}")
        out["generation_files"] = len(digests[first])
        out["numpy_certificate"] = list(want)
        print(f"[pool] answers and certificates the same bits at ingest_workers {list(POOL_WIDTHS)}, NumPy's "
              f"certificate {want}; {len(digests[first])} generation files byte-identical across the widths")
        if glob.glob(os.path.join(root, "ksel-spill-*")):
            fail(f"a spill store outlived phase 14: {os.listdir(root)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, per_call, out


EARLY_BUDGETS = (8192, 4096)  # phase 15: the cutover's default budget, and tests/test_radix.py's
EARLY_REPS = 10  # phase 15: interleaved timed calls of each configuration
EARLY_CONFIGS = (  # phase 15: label, radix_select options
    *((f"early {b}", {"early_exit_budget": b}) for b in EARLY_BUDGETS),
    ("cutover auto", {}),
    ("cutover None", {"cutover": None}),
)


def prefix_counts(x: torch.Tensor, ans: torch.Tensor, radix_bits: int = 4) -> list:
    """For p = 1 .. passes - 1, the keys of ``x`` sharing the answer's top
    ``p * radix_bits`` key bits: plain torch compares on ``x``'s device."""
    from mpi_k_selection_tpu_torch.utils import dtypes as dt

    keys = dt.to_sortable_bits(x.reshape(-1))
    a = dt.to_sortable_bits(ans.reshape(1))
    carrier, total = keys.element_size() * 8, dt.key_bits(x.dtype)
    out = []
    for p in range(1, total // radix_bits):
        s = total - p * radix_bits
        out.append(int((dt.shift_right_logical(keys, s, carrier) == dt.shift_right_logical(a, s, carrier)).sum()))
    return out


def predicted_early(counts: list, budget: int) -> tuple[int, int]:
    """(passes, collects) of the early exit from :func:`prefix_counts`: the
    least p >= 1 whose count fits ``budget`` and one collect, else every
    pass and none (tests/test_torch_early_exit.py:predicted, NumPy's rule)."""
    for p, c in enumerate(counts, 1):
        if c <= budget:
            return p, 1
    return len(counts) + 1, 0


def phase_early_exit(data, oracles, device: str = "cuda"):
    """Phase 15, ``early_exit_budget`` (this slice's path) beside the
    cutover on phase 3's resident arrays: the median and k in {1, n} of
    2^30 int32 ``uniform``, the medians of 2^27 float64 ``normal``, 2^26
    float32 ``normal`` and 2^27 int32 ``equal`` (one hot bin: the
    population never fits), each at the budgets of :data:`EARLY_BUDGETS`
    and under ``cutover="auto"`` and ``cutover=None``.

    Each call runs once with the launch counts set to 0 just before it and
    read just after, and the host syncs it makes counted
    (``torch.cuda.set_sync_debug_mode("warn")``: the upload of k, and one a
    population read); its answer must be phase 3's NumPy oracle bit for
    bit, no plain version may run, and an early call's passes and collects
    must be those :func:`predicted_early` finds in the data. Then every
    configuration is timed warm with CUDA events, :data:`EARLY_REPS`
    calls each, interleaved; the medians' peak device memory above the
    data is read, and the 2^30 int32 and equal medians are profiled."""
    import statistics
    import warnings

    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
    from mpi_k_selection_tpu_torch.ops.cuda import topk as T
    from mpi_k_selection_tpu_torch.utils.interop import tensor_to_numpy

    on_card = torch.device(device).type == "cuda"
    x30 = data["int32 uniform 2^30"]
    n30 = x30.numel()
    cases = (  # label, array, ranks, oracle bytes by rank
        ("int32 uniform 2^30", x30, (n30 // 2, 1, n30), oracles["i32"]),
        ("float64 normal 2^27", data["float64 normal 2^27"], None, oracles["f64"]),
        ("float32 normal 2^26", data["float32 normal 2^26"], None, oracles["f32"]),
        ("int32 equal 2^27", data["int32 equal 2^27"], None, oracles["i32_equal"]),
    )
    books = (H, S, T)
    launches = {"radix_histogram32": 0, "radix_histogram64": 0, "match_counts32": 0, "match_counts64": 0}
    per_call, out = {}, {"calls": [], "profiles": []}

    def call(x, k, kw):
        return kt.median(x, **kw) if k == x.numel() // 2 else kt.kselect(x, k, **kw)

    def counted(what, x, k, kw):
        """One call with every count at 0 just before it: its answer, its
        (passes, collects) (the kernels' launches on the card, the plain
        versions' calls on the CPU) and its host syncs."""
        bits = 8 * x.element_size()
        for book in books:
            book.reset_counts()
        if on_card:
            torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if on_card:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                ans = call(x, k, kw)
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode("default")
        if on_card:
            torch.cuda.synchronize()
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        got = {kn: v for book in books for kn, v in book.LAUNCHES.items()}
        if on_card:
            pc = (got[f"radix_histogram{bits}"], got[f"match_counts{bits}"])
        else:
            pc = (H.PLAIN_CALLS["radix_histogram"], H.PLAIN_CALLS["match_counts"])
        plain = {kn: v for book in books for kn, v in book.PLAIN_CALLS.items() if v}
        if on_card and plain:
            fail(f"phase 15: {what}: plain calls {plain}")
        per_call[what] = {kn: v for kn, v in got.items() if v}
        for kn, v in per_call[what].items():
            if kn not in launches:
                fail(f"phase 15: {what} launched {kn}")
            launches[kn] += v
        return ans, pc, syncs

    def timed(fn):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1)

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    medians = {}
    for label, x, ranks, want in cases:
        n = x.numel()
        for k in ranks or (n // 2,):
            what = f"{'median' if k == n // 2 else f'kselect k={k}'}, {label}"
            counts = None
            results = {}
            for cname, kw in EARLY_CONFIGS:
                ans, (passes, collects), syncs = counted(f"{what}, {cname}", x, k, kw)
                if tensor_to_numpy(ans.reshape(1)).tobytes() != want[k]:
                    fail(f"phase 15: {what}, {cname}: {ans!r} != the NumPy oracle")
                row = {"what": what, "config": cname, "passes": passes, "collects": collects, "host_syncs": syncs}
                if "early_exit_budget" in kw:
                    if counts is None:
                        counts = prefix_counts(x, ans)
                    want_pc = predicted_early(counts, kw["early_exit_budget"])
                    if (passes, collects) != want_pc:
                        fail(f"phase 15: {what}, {cname}: {passes} passes and {collects} collects, the data "
                             f"predicts {want_pc} (prefix counts {counts})")
                    row["predicted"] = list(want_pc)
                results[cname] = row
            print(f"[phase15] {what}: == NumPy under every configuration; population by resolved digits {counts}")
            if not on_card:
                out["calls"] += list(results.values())
                continue
            for cname, kw in EARLY_CONFIGS:  # warm
                call(x, k, kw)
            ms = {cname: [] for cname, _ in EARLY_CONFIGS}
            for _ in range(EARLY_REPS):
                for cname, kw in EARLY_CONFIGS:
                    ms[cname].append(timed(lambda: call(x, k, kw)))
            for cname, kw in EARLY_CONFIGS:
                row = results[cname]
                row.update(ms_median=statistics.median(ms[cname]), ms_min=min(ms[cname]), ms_max=max(ms[cname]))
                if k == n // 2:
                    row["extra_peak_bytes"] = peak(lambda: call(x, k, kw))
                print(f"[phase15] {what}, {cname:<12}: {row['ms_median']:9.4f} ms median of {EARLY_REPS} "
                      f"({row['ms_min']:.4f}-{row['ms_max']:.4f}); {row['passes']} passes, {row['collects']} "
                      f"collects, {row['host_syncs']} host syncs"
                      + (f", peak {row['extra_peak_bytes'] / 2**20:.1f} MiB above the data"
                         if "extra_peak_bytes" in row else ""))
                out["calls"].append(row)
            if k == n // 2:
                medians[label] = (x, results)
    if on_card:
        if not any(r["host_syncs"] for r in out["calls"]):
            print("[phase15] the sync debug mode reported no host sync: host reads not measured")
            for r in out["calls"]:
                r["host_syncs"] = None
        for label in ("int32 uniform 2^30", "int32 equal 2^27"):
            x, results = medians[label]
            for cname in (f"early {EARLY_BUDGETS[0]}", "cutover auto", "cutover None"):
                kw = dict(EARLY_CONFIGS)[cname]
                prof = phase_profile(lambda: kt.median(x, **kw), f"phase 15 median {label}, {cname}",
                                     results[cname]["ms_median"])
                if prof is not None:
                    results[cname]["idle_share"] = prof["idle_share"]
                    out["profiles"].append(prof)
    print(f"[phase15] launches {launches}; plain calls 0 on each call")
    if on_card and not all(launches.values()):
        fail(f"phase 15: a kernel of the path never launched: {launches}")
    return launches, per_call, out


def main_phase13(smi: str) -> int:
    """``python3 chip_smoke.py --phase13``: phase 13 alone (the build, the
    2^30 int32 array of phase 3, the int32 stream's first half, then
    phase 13)."""
    from mpi_k_selection_tpu_torch.utils import datagen
    from mpi_k_selection_tpu_torch.utils.interop import tensor_from_numpy
    from mpi_k_selection_tpu_torch.utils.timing import Stopwatch

    phase_build()
    x30 = tensor_from_numpy(datagen.generate(1 << 30, pattern="uniform", seed=0, dtype=np.int32), "cuda")
    chunks = make_chunks(FAULT_CHUNKS, STREAM_CHUNK, "uniform", np.int32)
    clock = Stopwatch()
    with clock.timing():
        launches, _, notes = phase_analysis(x30, chunks)
    notes["seconds"] = clock.seconds  # NumPy's oracle of the 2^30 array included (the full run reuses phase 3's)
    print(f"[phase13] {clock.seconds:.1f} s")
    print(json.dumps({"phase13": notes, "launches": launches}, default=str))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


def main_phase10(smi: str) -> int:
    """``python3 chip_smoke.py --phase10``: phase 10 alone (the build, the
    streams, their answers certified by NumPy as phase 3 certifies them,
    then phase 10): the measurement for a host of several cards."""
    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch.utils import datagen

    phase_build()
    ints = Replay(make_chunks(STREAM_CHUNKS, STREAM_CHUNK, "uniform", np.int32))
    f64 = Replay(make_chunks(F64_CHUNKS, F64_CHUNK, "normal", np.float64))
    certified = {}
    for src, key, n in ((ints, "median32", STREAM_CHUNKS * STREAM_CHUNK), (f64, "median64", F64_CHUNKS * F64_CHUNK)):
        v = kt.kselect_streaming(src, n // 2)
        less, leq = np_certificates(src.chunks, [v])[0]
        if not less < n // 2 <= leq:
            fail(f"{key}: {v!r} fails NumPy's certificate ({less}, {leq}]")
        certified[key] = v
        print(f"[phase10] {key}: {v!r}, NumPy certificate {less} < k <= {leq}")
    x30 = torch.from_numpy(datagen.generate(1 << 30, pattern="uniform", seed=0, dtype=np.int32)).to("cuda")
    _, _, notes = phase_multidevice_obs(ints, f64, certified, x30)
    print(json.dumps({"phase10": notes}, default=str))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


def main_phase11(smi: str) -> int:
    """``python3 chip_smoke.py --phase11``: phase 11 alone (the build, the
    int32 stream's first half, then phase 11)."""
    phase_build()
    chunks = make_chunks(FAULT_CHUNKS, STREAM_CHUNK, "uniform", np.int32)
    launches, _, notes = phase_faults(chunks)
    print(json.dumps({"phase11": notes, "launches": launches}, default=str))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


def main_phase12(smi: str) -> int:
    """``python3 chip_smoke.py --phase12``: phase 12 alone (the build, the
    2^30 int32 and 2^27 float64 arrays of phase 3, the int32 stream's first
    half, then phase 12)."""
    from mpi_k_selection_tpu_torch.utils import datagen
    from mpi_k_selection_tpu_torch.utils.interop import tensor_from_numpy

    phase_build()
    x30 = tensor_from_numpy(datagen.generate(1 << 30, pattern="uniform", seed=0, dtype=np.int32), "cuda")
    f64 = tensor_from_numpy(datagen.generate(1 << 27, pattern="normal", seed=0, dtype=np.float64), "cuda")
    chunks = make_chunks(FAULT_CHUNKS, STREAM_CHUNK, "uniform", np.int32)
    launches, _, notes = phase_serve(x30, f64, chunks)
    print(json.dumps({"phase12": notes, "launches": launches}, default=str))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


def main_phase14(smi: str) -> int:
    """``python3 chip_smoke.py --phase14``: phase 14 alone (the build, the
    int32 stream's first half, then phase 14)."""
    from mpi_k_selection_tpu_torch.utils.timing import Stopwatch

    phase_build()
    chunks = make_chunks(FAULT_CHUNKS, STREAM_CHUNK, "uniform", np.int32)
    clock = Stopwatch()
    with clock.timing():
        launches, _, notes = phase_ingest_pool(chunks)
    notes["seconds"] = clock.seconds
    print(f"[phase14] {clock.seconds:.1f} s")
    print(json.dumps({"phase14": notes, "launches": launches}, default=str))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


def main_phase15(smi: str) -> int:
    """``python3 chip_smoke.py --phase15``: phase 15 alone (the build, the
    resident arrays of phase 3 it reads and their NumPy oracles, then
    phase 15)."""
    from mpi_k_selection_tpu_torch.utils import datagen
    from mpi_k_selection_tpu_torch.utils.interop import tensor_from_numpy
    from mpi_k_selection_tpu_torch.utils.timing import Stopwatch

    phase_build()
    data, oracles = {}, {}
    for label, key, n, pattern, dtype, ks in (
        ("int32 uniform 2^30", "i32", 1 << 30, "uniform", np.int32, (1, 1 << 29, 1 << 30)),
        ("float64 normal 2^27", "f64", 1 << 27, "normal", np.float64, (1 << 26,)),
        ("float32 normal 2^26", "f32", 1 << 26, "normal", np.float32, (1 << 25,)),
        ("int32 equal 2^27", "i32_equal", 1 << 27, "equal", np.int32, (1 << 26,)),
    ):
        x = datagen.generate(n, pattern=pattern, seed=0, dtype=dtype)
        oracles[key] = oracle(x, list(ks))
        data[label] = tensor_from_numpy(x, "cuda")
        del x
    clock = Stopwatch()
    with clock.timing():
        launches, _, notes = phase_early_exit(data, oracles)
    notes["seconds"] = clock.seconds
    print(f"[phase15] {clock.seconds:.1f} s")
    print(json.dumps({"phase15": notes, "launches": launches}, default=str))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")
    import mpi_k_selection_tpu_torch as kt  # fails here, before any output, outside the repo
    from mpi_k_selection_tpu_torch.utils.timing import Deadline, Stopwatch

    torch.cuda.init()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name} x {torch.cuda.device_count()}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"nvidia-smi: {smi}")
    if sys.argv[1:] == ["--phase10"]:
        return main_phase10(smi)
    if sys.argv[1:] == ["--phase11"]:
        return main_phase11(smi)
    if sys.argv[1:] == ["--phase12"]:
        return main_phase12(smi)
    if sys.argv[1:] == ["--phase13"]:
        return main_phase13(smi)
    if sys.argv[1:] == ["--phase14"]:
        return main_phase14(smi)
    if sys.argv[1:] == ["--phase15"]:
        return main_phase15(smi)

    gen = torch.Generator(device="cuda").manual_seed(0)
    budget = Deadline.after(BUDGET_S)
    clock = {}

    def lap(label):  # seconds since the build started, at the end of each phase
        clock[label] = round(BUDGET_S - budget.remaining(), 1)
        print(f"[clock] {label}: {clock[label]} s of the {BUDGET_S} s budget")

    phase_build()
    lap("phase 1")
    check_err = phase_kernels_vs_plain(gen)
    lap("phase 2")
    data, launches, per_call, notes, oracles = phase_main_path(gen)
    lap("phase 3, resident paths")
    rows, kern, library = phase_timing(data)
    lap("phase 4, resident timings")

    def ms_of(what):
        return next(r["ms"] for r in rows if r["what"] == what)

    x30 = data["int32 uniform 2^30"]
    del data["batched float32 adversarial"], data["batched bfloat16 adversarial"]
    ints, f64, stream_launches, stream_per_call, stream_notes, certified = phase_streaming()
    lap("phase 3, streamed paths")
    launches.update(stream_launches)
    per_call.update(stream_per_call)
    notes.update(stream_notes)
    srows, skern, slibrary, stream_ms, resident_fault, sweep_kinds_ms = phase_streaming_timing(ints, f64)
    lap("phase 4, streamed timings")
    notes["sweep_kinds"] = sweep_kinds_ms
    rows += srows
    kern.update(skern)
    library.update(slibrary)
    for kname, e in check_err.items():  # phase 2's exhaustive checks join the kernels' errors
        kern[kname] = (*kern[kname][:4], max(kern[kname][4], e))
    profiles = [
        phase_profile(lambda: kt.median(x30), "median int32 uniform 2^30", ms_of("median int32 uniform 2^30")),
        phase_profile(lambda: kt.median(data["float64 normal 2^27"]), "median float64 normal 2^27",
                      ms_of("median float64 normal 2^27")),
        phase_profile(lambda: kt.quantiles(x30, QS), "quantiles K=4 int32 uniform 2^30",
                      ms_of("quantiles K=4 int32 uniform 2^30")),
        phase_profile(lambda: kt.topk(data["float32 normal 2^26"], TOPK), f"topk k={TOPK} float32 normal 2^26",
                      ms_of(f"topk k={TOPK} float32 normal 2^26")),
        phase_profile(lambda: kt.batched_topk(data["batched float32 normal"], 8),
                      f"batched_topk k=8 float32 ({BATCH}, {WIDTH})",
                      ms_of("batched_topk float32 k=8 (values and indices)")),
        phase_profile(lambda: kt.kselect_streaming(ints, len(ints.chunks) * STREAM_CHUNK // 2),
                      "streaming median depth=2, int32 uniform 2^31",
                      stream_ms["streaming median depth=2, int32 uniform 2^31"], reps=1),
    ]
    lap("phase 5")
    notes["resident_fault"] = resident_fault
    # phase 7: the ingest pool, the sketches and the monitor on the streams
    p7_launches, p7_per_call, notes["phase7"] = phase_sketch_staging(ints, f64, certified)
    for kname, v in p7_launches.items():
        launches[kname] += v
    per_call.update(p7_per_call)
    lap("phase 7")
    # phase 8: the spill descent on the int32 stream
    p8_launches, p8_per_call, notes["phase8"] = phase_spill(ints, f64, certified)
    for kname, v in p8_launches.items():
        launches[kname] += v
    per_call.update(p8_per_call)
    lap("phase 8")
    # phase 9: the width schedule and packed spill records
    p9_launches, p9_per_call, notes["phase9"] = phase_width_pack(ints, f64, certified, notes["phase8"])
    for kname, v in p9_launches.items():
        launches[kname] += v
    per_call.update(p9_per_call)
    lap("phase 9")
    # phase 10: multi-device staging and the telemetry
    p10_launches, p10_per_call, notes["phase10"] = phase_multidevice_obs(ints, f64, certified, x30)
    for kname, v in p10_launches.items():
        launches[kname] += v
    per_call.update(p10_per_call)
    lap("phase 10")
    # phase 11: the fault harness and the recovery policies on the spilled descent
    p11_launches, p11_per_call, notes["phase11"] = phase_faults(ints.chunks[:FAULT_CHUNKS])
    for kname, v in p11_launches.items():
        launches[kname] += v
    per_call.update(p11_per_call)
    lap("phase 11")
    # phase 12: the resident-dataset query server
    p12_launches, p12_per_call, notes["phase12"] = phase_serve(x30, data["float64 normal 2^27"],
                                                               ints.chunks[:FAULT_CHUNKS], oracles=oracles)
    for kname, v in p12_launches.items():
        launches[kname] += v
    per_call.update(p12_per_call)
    lap("phase 12")
    # phase 13: the analyzer, its contracts on the card, the lock-order sanitizer and 16-bit digits
    p13_clock = Stopwatch()
    with p13_clock.timing():
        p13_launches, p13_per_call, notes["phase13"] = phase_analysis(x30, ints.chunks[:FAULT_CHUNKS], oracles["i32"])
    notes["phase13"]["seconds"] = p13_clock.seconds
    print(f"[phase13] {p13_clock.seconds:.1f} s")
    for kname, v in p13_launches.items():
        launches[kname] += v
    per_call.update(p13_per_call)
    lap("phase 13")
    # phase 14: the pooled host data plane and spill decode, W = 1 beside W = 4
    p14_clock = Stopwatch()
    with p14_clock.timing():
        p14_launches, p14_per_call, notes["phase14"] = phase_ingest_pool(ints.chunks[:FAULT_CHUNKS])
    notes["phase14"]["seconds"] = p14_clock.seconds
    print(f"[phase14] {p14_clock.seconds:.1f} s")
    for kname, v in p14_launches.items():
        launches[kname] += v
    per_call.update(p14_per_call)
    lap("phase 14")
    # phase 15: early_exit_budget beside the cutover on phase 3's resident arrays
    p15_clock = Stopwatch()
    with p15_clock.timing():
        p15_launches, p15_per_call, notes["phase15"] = phase_early_exit(data, oracles)
    notes["phase15"]["seconds"] = p15_clock.seconds
    print(f"[phase15] {p15_clock.seconds:.1f} s")
    for kname, v in p15_launches.items():
        launches[kname] += v
    per_call.update(p15_per_call)
    lap("phase 15")
    # phase 6: the host chunks and the resident data go first (the ranks
    # need the card's memory and the host's for the 8 GiB array)
    del ints, f64, data, x30
    torch.cuda.empty_cache()
    notes["distributed"] = phase_distributed()
    lap("phase 6")
    notes["clock_s"] = clock
    for srow in notes["distributed"]["sketches"]:  # rank 0's launches of distributed_sketch
        kname = "sweep_ingest32" if "int32" in srow["what"] else "sweep_ingest64"
        launches[kname] += srow["sweep_launches_per_rank"][0]
        per_call[srow["what"] + ", rank 0"] = {kname: srow["sweep_launches_per_rank"][0]}
    for kname, e in notes["distributed"]["kernel_checks"].items():  # the shards' checks join the kernels' errors
        kern[kname] = (*kern[kname][:4], max(kern[kname][4], e))

    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        ms, pms, b, by, err = kern[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "bound_ms": b, "bound_by": by, "library_ms": library.get(kname),
        })
    print(json.dumps({"timings": rows, "profiles": profiles, "launches_per_call": per_call, **notes}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
