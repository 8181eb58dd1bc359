"""Torch contract checks (KSC101-KSC105): the counterparts of the JAX
package's jaxpr contracts (``mpi_k_selection_tpu/analysis/jaxpr_checks.py``
and its KSC105 in ``analysis/placement.py``).

The JAX package traces its programs abstractly. PyTorch runs eagerly, so
these checks RUN the port's public kernels on small tensors and read what
they did: the result dtypes, the counters' dtypes, the launch trail (the
sequence of kernel launches, ops/cuda/books.py), and the host reads.
Each check takes the device it runs on: the CPU half runs in the tier-1
tests on the plain versions; the CUDA half runs the same checks on the
kernels (``chip_smoke.py`` phase 13 and the ``gpu`` tests).

- **KSC101 dtype preservation**: ``radix_select``, ``radix_select_many``,
  ``sort_select`` and ``topk`` return their input dtype, over all 12
  dtypes (and the block top-k over its two).
- **KSC102 counter width**: the per-row and per-chunk counts of the
  kernels are int32 and the resident histograms int64; a bucket of 2^31
  words or more is refused; the descent's running sums are int64
  (``ops/radix.py:row_cumsum``; the port has no ``select_count_dtype``);
  the staged per-chunk counts are int32 and their host merge int64;
  ``validate_width_schedule`` refuses widths above 20 and
  ``resolve_width_schedule("auto", ...)`` never emits one above 16.
- **KSC103 launch-trail stability**: the launch trail replaces the jaxpr
  trail. It is identical for each streamed program at two adjacent pow2
  staging buckets, for the resident select and its many-rank walk at
  adjacent n inside one cutover regime, and across the width schedule's
  shifts 16/8/0.
- **KSC104 host-transfer census**: a staged chunk's consume (dispatch,
  then finish) reads to the host no more than its program's declared
  budget (:data:`HOST_READ_BUDGETS`), the same at two buckets; on a card
  the profiler's device-to-host copies and host syncs are counted too. A
  program with no budget, or a budget with no program, is a finding.
- **KSC105 placement agreement**: every static crossing site of the
  placement pass is sanctioned; every ``DISPATCH_CALLS`` name has a live
  site; the recorded ``device_slot`` streams on devices {1, 2} x spill
  {off, force} follow the round robin (chunk j on slot ``j % p``; the
  recorded slot names the device, its first slot), and a replay of the
  spilled generation re-stages each chunk onto its slot with a
  bit-identical sketch. On the CPU the two slots are ``cpu:0`` and
  ``cpu:1`` (recorded 0, 1, 0, 1); on one card, two slots of ``cuda:0``
  (recorded 0 throughout).

:data:`DETAILS` keeps, per check, what the last run measured (trail
lengths, read counts), for ``chip_smoke.py`` to print.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from mpi_k_selection_tpu_torch.analysis.core import Finding

CONTRACT_CHECKS: list["ContractCheck"] = []

#: What each check's last run measured, by check id.
DETAILS: dict[str, dict] = {}

_HERE = "mpi_k_selection_tpu_torch/analysis/contracts.py"


@dataclasses.dataclass
class ContractCheck:
    id: str
    title: str
    rationale: str
    fn: Callable[..., list]

    def run(self, device="cpu") -> list[Finding]:
        try:
            return self.fn(device)
        except Exception as e:  # a crash is a finding, not a pass
            return [Finding(self.id, "<contract-engine>", 0, f"contract check crashed: {type(e).__name__}: {e}")]


def contract(id: str, title: str, rationale: str):
    def deco(fn):
        CONTRACT_CHECKS.append(ContractCheck(id, title, rationale, fn))
        return fn

    return deco


def run_contracts(device="cpu", select=None) -> dict:
    """``{check id: findings}`` of every contract check on ``device``."""
    return {c.id: c.run(device) for c in CONTRACT_CHECKS if select is None or c.id in select}


ALL_DTYPES = (
    "int8", "uint8", "int16", "uint16", "int32", "uint32",
    "int64", "uint64", "float16", "bfloat16", "float32", "float64",
)

# two adjacent pow2 staging buckets (streaming/pipeline.py pads a chunk to
# its pow2 ceiling): the per-chunk programs at both must agree
BUCKETS = (1 << 12, 1 << 13)


def _values(name: str, n: int, seed: int = 0):
    """Seeded values of dtype ``name`` as a NumPy array."""
    import numpy as np

    from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype

    rng = np.random.default_rng(seed)
    dt = numpy_dtype(name)
    if name[0] in "iu":
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, size=n, dtype=dt, endpoint=True)
    return (rng.standard_normal(n) * 1e3).astype(dt)


def _tensor(name: str, n: int, device, seed: int = 0):
    from mpi_k_selection_tpu_torch.utils.interop import tensor_from_numpy

    return tensor_from_numpy(_values(name, n, seed), device)


def _finding(check: str, message: str, path: str = _HERE) -> Finding:
    return Finding(check, path, 0, message)


# ---------------------------------------------------------------------------
# KSC101


@contract(
    "KSC101",
    "selections return their input dtype",
    "A selection answers with an element of its input, so its dtype is the "
    "input's. A silent widening (an int64 key view leaking out) or narrowing "
    "is caught at the API boundary, on every dtype the port selects over.",
)
def check_dtype_preservation(device="cpu") -> list:
    import torch

    from mpi_k_selection_tpu_torch.ops.radix import radix_select, radix_select_many
    from mpi_k_selection_tpu_torch.ops.sort import sort_select
    from mpi_k_selection_tpu_torch.ops.topk import topk

    findings = []
    n = 4096
    for name in ALL_DTYPES:
        x = _tensor(name, n, device)
        outs = {
            "radix_select": radix_select(x, n // 2, cutover=1, cutover_budget=64),
            "radix_select_many": radix_select_many(x, [1, n // 2, n], cutover=1, cutover_budget=64),
            "sort_select": sort_select(x, n // 2),
            "topk": topk(x, 8, method="threshold", device=device)[0],
        }
        for what, out in outs.items():
            if out.dtype != x.dtype:
                findings.append(_finding("KSC101", f"{what} on {name} returned {out.dtype}"))
    for name in ("float32", "bfloat16"):
        x = _tensor(name, 64 * 4096, device).reshape(64, 4096)
        v = topk(x, 8, method="block", device=device)[0]
        if v.dtype != x.dtype:
            findings.append(_finding("KSC101", f"topk(method='block') on {name} returned {v.dtype}"))
    DETAILS["KSC101"] = {"dtypes": len(ALL_DTYPES), "device": str(torch.device(device))}
    return findings


# ---------------------------------------------------------------------------
# KSC102


def _stage(x, device):
    """``x`` (a 1-D tensor on ``device``) as one staged bucket."""
    import torch

    from mpi_k_selection_tpu_torch.streaming.pipeline import stage_chunk

    return stage_chunk(x, x.dtype, torch.device(device))


@contract(
    "KSC102",
    "counter widths: int32 per launch, int64 where counts accumulate",
    "A kernel counts a bucket of fewer than 2^31 words in int32; every sum "
    "that can pass 2^31 (a resident histogram, the descent's running sums, "
    "the host merge of a stream's chunks) is int64, and the wider buckets "
    "and digits that would overflow a counter are refused loudly.",
)
def check_counter_width(device="cpu") -> list:
    import numpy as np
    import torch

    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.ops.cuda.sweep_ingest import MAX_BITS, sweep_ingest
    from mpi_k_selection_tpu_torch.ops.radix import _Descent, row_cumsum
    from mpi_k_selection_tpu_torch.streaming.chunked import resolve_width_schedule, validate_width_schedule
    from mpi_k_selection_tpu_torch.streaming.executor import (
        CountLessLeqConsumer,
        FusedIngestConsumer,
        SketchFoldConsumer,
        StreamExecutor,
    )
    from mpi_k_selection_tpu_torch.streaming.sketch import RadixSketch

    findings = []

    def want(what, got, dtype):
        if got != dtype:
            findings.append(_finding("KSC102", f"{what} counts in {got}, expected {dtype}"))

    n = 1 << 14
    for bits, wdt in ((32, torch.int32), (64, torch.int64)):
        w = _tensor("int32" if bits == 32 else "int64", n, device)
        p = torch.zeros(1, dtype=wdt, device=w.device)
        ps = torch.arange(4, dtype=wdt, device=w.device)
        want(f"radix_histogram{bits}", H.radix_histogram(w, shift=bits - 4, radix_bits=4).dtype, torch.int64)
        want(f"radix_histogram{bits} (16-bit digit)", H.radix_histogram(w, shift=bits - 32, radix_bits=16,
                                                                         prefix=p).dtype, torch.int64)
        want(f"radix_histogram_multi{bits}", H.radix_histogram_multi(w, shift=bits - 8, radix_bits=4,
                                                                     prefixes=ps).dtype, torch.int64)
        want(f"match_counts{bits}", H.match_counts(w, resolved_bits=4, prefixes=ps).dtype, torch.int32)
        want(f"tau_counts{bits}", H.tau_counts(w, tau=p).dtype, torch.int32)
        hist, collect, tee, cert, sketch = sweep_ingest(
            w, n, shift=bits - 8, radix_bits=4, hist_prefixes=[0, 1], collect=[(bits - 4, 0)], tee=[(bits - 4, 1)],
            vkey=7, sketch_bits=8,
        )
        want(f"sweep_ingest{bits} hist", hist.dtype, torch.int32)
        want(f"sweep_ingest{bits} collect count", collect[0][1].dtype, torch.int32)
        want(f"sweep_ingest{bits} tee count", tee[1].dtype, torch.int32)
        want(f"sweep_ingest{bits} certificate", cert[0].dtype, torch.int32)
        want(f"sweep_ingest{bits} sketch", sketch[0].dtype, torch.int32)
    # a bucket of 2^31 words or more is refused before any launch
    try:
        sweep_ingest(torch.empty(1 << 31, dtype=torch.int32, device="meta"), 0, hist_prefixes=[0])
        findings.append(_finding("KSC102", "a bucket of 2^31 words was accepted (int32 counts overflow)"))
    except ValueError:
        pass
    # the descent's running sums are int64
    x = _tensor("int32", n, device)
    prep = _Descent(x)  # ksel: noqa[KSL003] -- a counter-width probe of the port's descent (no f64 shell exists)
    _, kk, count = prep.one_pass(0, None, torch.tensor([n // 2], dtype=torch.int64, device=x.device))
    want("the descent's rebased rank", kk.dtype, torch.int64)
    want("the descent's bucket population", count.dtype, torch.int64)
    want("row_cumsum", row_cumsum(torch.ones((2, 3), dtype=torch.int32, device=x.device)).dtype, torch.int64)
    # the staged per-chunk counts are int32; the host merge int64
    keys = _stage(x, device)
    fused = FusedIngestConsumer(total_bits=32, hist=(28, 4, [None]))
    handle = fused.dispatch(keys)
    want("a staged chunk's histogram", handle[2].dtype, torch.int32)
    fused.finish(handle)
    want("the host merge", str(fused.hists[None].dtype), "int64")
    cert = CountLessLeqConsumer(7)
    lt, _ = cert.dispatch(keys)
    want("a staged chunk's certificate", lt.dtype, torch.int32)
    sketch = RadixSketch(np.int32, device=device)
    ex = StreamExecutor([SketchFoldConsumer(sketch)])
    ex.push(keys)
    ex.drain()
    want("the sketch's host pyramid", str(np.asarray(sketch.hists[-1]).dtype), "int64")
    # digit widths: at most MAX_BITS by hand, at most 16 under "auto"
    try:
        validate_width_schedule((MAX_BITS + 1,))
        findings.append(_finding("KSC102", f"validate_width_schedule accepted a {MAX_BITS + 1}-bit digit"))
    except ValueError:
        pass
    validate_width_schedule((MAX_BITS,))
    widest = 0
    for total in (8, 16, 32, 64):
        for rb in (1, 2, 4, 8, 16):
            if total % rb == 0:
                widest = max(widest, *resolve_width_schedule("auto", total, rb))
    if widest > 16:
        findings.append(_finding("KSC102", f'resolve_width_schedule("auto") emitted a {widest}-bit digit'))
    DETAILS["KSC102"] = {"widest_auto_digit": widest}
    return findings


# ---------------------------------------------------------------------------
# KSC103


def _consume(programs, x, device):
    """Each program's launch trail over one staged bucket of ``x``:
    ``{name: [launches]}``."""
    from mpi_k_selection_tpu_torch.ops.cuda.books import launch_trail
    from mpi_k_selection_tpu_torch.streaming.executor import StreamExecutor

    out = {}
    for name, make in programs.items():
        keys = _stage(x, device)
        ex = StreamExecutor([make()])
        with launch_trail() as trail:
            ex.push(keys)
            ex.drain()
        out[name] = list(trail)
    return out


def streamed_programs(bits: int = 32) -> dict:
    """The streamed passes' per-chunk programs, by name (each a consumer
    factory): a first pass, one and four prefixes, a one-spec collect, a
    spill-pass tee, the certificate and the sketch fold."""
    import numpy as np

    from mpi_k_selection_tpu_torch.streaming.executor import (
        CountLessLeqConsumer,
        FusedIngestConsumer,
        SketchFoldConsumer,
    )
    from mpi_k_selection_tpu_torch.streaming.sketch import RadixSketch

    class _Sink:  # a tee's writer: records land here
        def append(self, *args, **kwargs):
            pass

    return {
        "histogram": lambda: FusedIngestConsumer(total_bits=bits, hist=(bits - 8, 8, [None])),
        "histogram-multi": lambda: FusedIngestConsumer(total_bits=bits, hist=(bits - 16, 8, [0, 1, 2, 3])),
        "collect": lambda: FusedIngestConsumer(total_bits=bits, collect_specs=[(8, 0)]),
        "fused": lambda: FusedIngestConsumer(total_bits=bits, hist=(bits - 16, 8, [0]), tee_specs=[(8, 0)],
                                             writer=_Sink(), orig_dtype=np.dtype(np.int32)),
        "certificate": lambda: CountLessLeqConsumer(7),
        "sketch": lambda: SketchFoldConsumer(RadixSketch(np.int32, device="cpu")),
    }


@contract(
    "KSC103",
    "the launch trail is stable across batch sizes and digit shifts",
    "PyTorch compiles nothing per shape, but a Python branch that depends on "
    "n changes which kernels run: the same program at nearby sizes must "
    "launch the same sequence, or a bucket, a resident size or a pass of "
    "the width schedule takes a different, unmeasured route.",
)
def check_launch_trail(device="cpu") -> list:
    import torch

    from mpi_k_selection_tpu_torch.ops.cuda.books import launch_trail
    from mpi_k_selection_tpu_torch.ops.radix import radix_select, radix_select_many, resolve_cutover
    from mpi_k_selection_tpu_torch.streaming.executor import FusedIngestConsumer

    findings = []
    lengths = {}
    # the streamed programs at two adjacent buckets
    programs = streamed_programs()
    trails = [_consume(programs, _tensor("int32", b, device, seed=b), device) for b in BUCKETS]
    for name in programs:
        a, b = trails[0][name], trails[1][name]
        lengths[name] = len(a)
        if a != b or not a:
            findings.append(_finding("KSC103", f"streamed {name}: trail {a} at {BUCKETS[0]} words, {b} at {BUCKETS[1]}"))
    # the resident walks at adjacent n inside one cutover regime
    ns = ((1 << 20) + 4096, (1 << 20) + 8192)
    if len({resolve_cutover("auto", n, 32, 4, 8192) for n in ns}) != 1:
        findings.append(_finding("KSC103", f"n={ns} straddle a cutover regime"))
    for what, fn in (("radix_select", lambda x: radix_select(x, x.numel() // 2)),
                     ("radix_select_many", lambda x: radix_select_many(x, [1, x.numel() // 2, x.numel()]))):
        got = []
        for n in ns:
            x = _tensor("int32", n, device, seed=1)
            with launch_trail() as trail:
                fn(x)
            got.append(list(trail))
        lengths[what] = len(got[0])
        if got[0] != got[1]:
            findings.append(_finding("KSC103", f"{what}: trail {got[0]} at n={ns[0]}, {got[1]} at n={ns[1]}"))
    # the width schedule's passes at shifts 16, 8 and 0 (16, 8 and 8 bits)
    x = _tensor("int32", BUCKETS[0], device, seed=2)
    shifts = {
        16: lambda: FusedIngestConsumer(total_bits=32, hist=(16, 16, [None])),
        8: lambda: FusedIngestConsumer(total_bits=32, hist=(8, 8, [3])),
        0: lambda: FusedIngestConsumer(total_bits=32, hist=(0, 8, [5])),
    }
    by_shift = _consume(shifts, x, device)
    if len({tuple(t) for t in by_shift.values()}) != 1:
        findings.append(_finding("KSC103", f"width-schedule passes launch differently by shift: {by_shift}"))
    lengths["width-schedule"] = len(by_shift[16])
    DETAILS["KSC103"] = {"trail_lengths": lengths, "buckets": list(BUCKETS), "resident_n": list(ns),
                         "device": str(torch.device(device))}
    return findings


# ---------------------------------------------------------------------------
# KSC104

#: Host reads each streamed program makes a bucket (all at its finish, none
#: at its dispatch): a histogram reads its counts; a collect its count and
#: then its survivors; a tee the same; the certificate its two counts; the
#: sketch its counts and its extremes. On a card the finish also waits for
#: the bundle's event once (a sync, counted apart).
HOST_READ_BUDGETS = {
    "histogram": 1,
    "histogram-multi": 1,
    "collect": 2,
    "fused": 3,
    "certificate": 2,
    "sketch": 2,
}

_READ_METHODS = frozenset({"cpu", "item", "__int__", "__float__", "__bool__"})


def _host_reads(fn):
    """Run ``fn()`` and count its host reads: ``.cpu()``, ``.item()``,
    ``int()``/``float()``/``bool()`` of a tensor and ``.to(<cpu>)``."""
    from torch.overrides import TorchFunctionMode

    count = [0]

    class _Census(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = getattr(func, "__name__", "")
            if name in _READ_METHODS:
                count[0] += 1
            elif name == "to":
                target = kwargs.get("device", args[1] if len(args) > 1 else None)
                if str(target).startswith("cpu"):
                    count[0] += 1
            return func(*args, **kwargs)

    with _Census():
        fn()
    return count[0]


def _profile_transfers(fn):
    """``(device-to-host copies, host syncs)`` that ``fn()`` makes on the
    card, from torch.profiler, or ``(None, None)`` when three profiles in a
    row recorded none of the card's activity (no launch of the sweep
    kernel: the profiler can miss a window's device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()]
        if any("sweep_ingest_kernel" in n for n in names):
            copies = sum("Memcpy DtoH" in n for n in names)
            syncs = sum(n in ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize") for n in names)
            return copies, syncs
    return None, None


@contract(
    "KSC104",
    "a staged chunk's consume stays inside its host-read budget",
    "A streamed pass reads each bucket's results to the host once, when the "
    "in-flight window pops. A read at dispatch, a per-survivor read or a "
    "read that grows with the bucket serializes the pipeline; every program "
    "declares its reads, and the census holds it to them at two buckets.",
)
def check_host_transfer_census(device="cpu") -> list:
    import torch

    from mpi_k_selection_tpu_torch.streaming.executor import StreamExecutor

    findings = []
    programs = streamed_programs()
    for name in sorted(set(programs) - set(HOST_READ_BUDGETS)):
        findings.append(_finding("KSC104", f"streamed program {name} has no host-read budget"))
    for name in sorted(set(HOST_READ_BUDGETS) - set(programs)):
        findings.append(_finding("KSC104", f"budget row {name} names no streamed program"))
    on_card = torch.device(device).type == "cuda"
    census = {}
    for name, make in sorted(programs.items()):
        if name not in HOST_READ_BUDGETS:
            continue
        rows = []
        for b in BUCKETS:
            x = _tensor("int32", b, device, seed=b)
            keys = _stage(x, device)
            consumer = make()
            handle = []
            at_dispatch = _host_reads(lambda: handle.append(consumer.dispatch(keys)))
            at_finish = _host_reads(lambda: consumer.finish(handle[0]))
            keys.release()
            row = {"dispatch": at_dispatch, "finish": at_finish}
            if on_card:
                def consume():
                    ex = StreamExecutor([make()])
                    ex.push(_stage(x, device))
                    ex.drain()

                consume()  # warm: the first launch builds the kernel
                row["dtoh"], row["syncs"] = _profile_transfers(consume)
            rows.append(row)
        census[name] = rows
        budget = HOST_READ_BUDGETS[name]
        for b, row in zip(BUCKETS, rows):
            if row["dispatch"]:
                findings.append(_finding("KSC104", f"{name} at {b} words reads {row['dispatch']} times at dispatch"))
            if row["finish"] > budget:
                findings.append(_finding("KSC104", f"{name} at {b} words reads {row['finish']} times, budget {budget}"))
            if on_card and row["dtoh"] is not None and row["dtoh"] > budget:
                findings.append(_finding("KSC104", f"{name} at {b} words: {row['dtoh']} DtoH copies, budget {budget}"))
        measured = [r for r in rows if r.get("dtoh", 0) is not None]
        if len(measured) < len(rows):  # compare what both buckets measured
            rows = [{k: r[k] for k in ("dispatch", "finish")} for r in rows]
        if rows[0] != rows[1]:
            findings.append(_finding("KSC104", f"{name}: census {rows[0]} at {BUCKETS[0]} words, {rows[1]} at {BUCKETS[1]}"))
    DETAILS["KSC104"] = {"census": census, "budgets": dict(HOST_READ_BUDGETS)}
    return findings


# ---------------------------------------------------------------------------
# KSC105


def _slot_stream_findings(devices, force_spill: bool, device) -> list:
    """One small staged sketch pass over ``devices`` slots: the recorded
    ``device_slot`` stream against the round-robin prediction; with
    ``force_spill`` also a replay of the spilled generation, which must
    re-stage every chunk onto its recorded slot and fold the same sketch."""
    import tempfile

    import numpy as np

    from mpi_k_selection_tpu_torch.obs import Observability
    from mpi_k_selection_tpu_torch.streaming.pipeline import resolve_stream_devices
    from mpi_k_selection_tpu_torch.streaming.sketch import RadixSketch
    from mpi_k_selection_tpu_torch.streaming.spill import SpillStore

    devs = resolve_stream_devices(devices, device)
    p = len(devs)
    # a chunk's recorded slot names its device: the first slot holding it,
    # which is chunk_index % p for distinct devices (two slots of one card
    # both record slot 0, as the staging's device_slot is defined)
    predict = [devs.index(devs[j % p]) for j in range(p)]
    label = f"devices={p} spill={'force' if force_spill else 'off'}"
    findings = []
    rng = np.random.default_rng(7)
    chunks = [rng.integers(0, 1 << 31, 1024, dtype=np.int64).astype(np.int32) for _ in range(4)]

    def run(source, store=None):
        obs = Observability.collecting()
        sk = RadixSketch(np.int32, device=device)
        sk.update_stream(source, pipeline_depth=2, devices=devices, spill=store, obs=obs)
        return sk, obs.events.of_kind("stream.chunk")

    # the store's ksel-spill-* dir sits in a directory of its own, out of
    # the shared temp dir that a test suite's leak check globs
    with tempfile.TemporaryDirectory(prefix="kselect-contracts-") as root:
        store = SpillStore(root) if force_spill else None
        try:
            sk, evs = run(chunks, store)
            if len(evs) != len(chunks):
                findings.append(_finding("KSC105", f"{label}: {len(evs)} stream.chunk events for {len(chunks)} chunks"))
            for ev in evs:
                if ev.device_slot != predict[ev.chunk_index % p]:
                    findings.append(_finding(
                        "KSC105", f"{label}: chunk {ev.chunk_index} recorded slot {ev.device_slot}, round-robin "
                                  f"predicts {predict[ev.chunk_index % p]}"))
            if force_spill:
                sk2, evs2 = run(store)
                if [e.device_slot for e in evs2] != [e.device_slot for e in evs]:
                    findings.append(_finding("KSC105", f"{label}: the replay re-dealt the slots "
                                                       f"{[e.device_slot for e in evs2]}"))
                if sk2 != sk:
                    findings.append(_finding("KSC105", f"{label}: the replay's sketch is not the teeing pass's"))
        finally:
            if store is not None:
                store.close()
    return findings


@contract(
    "KSC105",
    "the static placement census agrees with the recorded slots",
    "The placement pass says where crossings and dispatches happen; the "
    "runtime records each staged chunk's slot. Every static crossing must "
    "be sanctioned, every dispatch name must be live, and the recorded slot "
    "streams on devices {1, 2} x spill {off, force} must follow the "
    "round-robin rule, with a replay landing on the recorded slots.",
)
def check_placement_agreement(device="cpu") -> list:
    import torch

    from mpi_k_selection_tpu_torch import resource_protocols as rp
    from mpi_k_selection_tpu_torch.analysis.placement import static_census

    findings = []
    crossings, dispatch_names = static_census()
    for rel, sites in sorted(crossings.items()):
        for site in sites:
            if not site["sanctioned"]:
                findings.append(Finding("KSC105", rel, site["line"],
                                        f"static census: `{site['call']}` crossing at an unsanctioned site"))
    for rel in sorted(set(rp.SANCTIONED_TRANSFER_SITES) - set(crossings)):
        findings.append(_finding("KSC105", f"SANCTIONED_TRANSFER_SITES lists {rel}, which has no crossing site",
                                 "mpi_k_selection_tpu_torch/resource_protocols.py"))
    for name in sorted(rp.DISPATCH_CALLS - dispatch_names):
        findings.append(_finding("KSC105", f"DISPATCH_CALLS registers `{name}` but no site uses it",
                                 "mpi_k_selection_tpu_torch/resource_protocols.py"))
    dev = torch.device(device)
    two = 2 if dev.type == "cpu" else (dev, dev)  # two slots of one card
    for devices in (1, two):
        for force_spill in (False, True):
            findings.extend(_slot_stream_findings(devices, force_spill, device))
    DETAILS["KSC105"] = {
        "crossing_modules": len(crossings),
        "crossing_sites": sum(len(s) for s in crossings.values()),
        "dispatch_names": sorted(dispatch_names & rp.DISPATCH_CALLS),
    }
    return findings
