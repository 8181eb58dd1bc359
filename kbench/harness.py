"""One run of one cell: set-up, the measured window, the check, the result.

``main`` is the command (``kbench/run.py``). :func:`run_cell` is the run
itself; the tests and ``control.py`` drive it directly, on the CPU at a small
size or with the control or a fault put in the port's place.

A query is one call of the cell's op, ended by its answer being ready: the
loop is closed, with one caller that waits for each answer before it sends
the next. Its latency runs from the call's start to the answer's readiness,
read by CUDA events on the stream (the device's clock); the window's rate is
every query over the window's length by the host clock.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import traceback
from dataclasses import dataclass, field

from kbench import clock, gen, manifest, stats
from kbench import trace as tr

FORBIDDEN = ("jax", "jaxlib", "flax", "mpi_k_selection_tpu")  # compared with whole top-level module names
GIB = float(1 << 30)
# a traced run profiles a window of at most this long: the trace of a longer
# one (over a million events for the fastest cell) takes too long to read
TRACE_WINDOW_S = 10.0
PORT_BOOKS_PREFIX = "mpi_k_selection_tpu_torch.ops.cuda."


def forbidden_modules() -> list[str]:
    """The forbidden top-level names that ``sys.modules`` holds."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def launch_books() -> dict:
    """The port's kernel launch counts so far (every ``LAUNCHES`` book of
    its ``ops.cuda`` modules that this process imported)."""
    out: dict = {}
    for name, mod in list(sys.modules.items()):
        book = getattr(mod, "LAUNCHES", None) if name.startswith(PORT_BOOKS_PREFIX) else None
        if isinstance(book, dict):
            out.update(book)
    return out


class Timer:
    """A query's latency in ms: CUDA events on the current stream on a card,
    the host clock elsewhere (the CPU is for the tests only)."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self.a.record()
        else:
            self.t = clock.now()

    def stop(self) -> float:
        """Wait for the answer; its latency in ms."""
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            return self.a.elapsed_time(self.b)
        return (clock.now() - self.t) * 1e3


@dataclass
class Window:
    """What the measured window did: queries, their latencies, the failures
    and the kept answers ``(i, query, output)``."""

    seconds: float = 0.0
    latencies_ms: list = field(default_factory=list)
    failed: int = 0
    kept: list = field(default_factory=list)


def run_window(call, inputs, plan, seconds: float, timer: Timer, keep_all: bool, sample: int, seed: int) -> Window:
    """Queries back to back until ``seconds`` have passed. The answers kept
    for the check are all of them, or a uniform sample of ``sample`` drawn
    by the seed (reservoir sampling), held as the port returned them."""
    w = Window()
    rng = gen.host_rng(seed, 3)
    i = 0
    t0 = clock.now()
    deadline = t0 + seconds
    while True:
        q = plan.query(i)
        timer.start()
        try:
            out = call(inputs, q)
        except Exception:  # a query that raises has failed; the loop goes on, its traceback goes to stderr
            if not w.failed:
                traceback.print_exc()
            w.failed += 1
            out = None
        w.latencies_ms.append(timer.stop())
        if out is not None:
            if keep_all or len(w.kept) < sample:
                w.kept.append((i, q, out))
            else:
                j = int(rng.integers(0, i + 1))
                if j < sample:
                    w.kept[j] = (i, q, out)
        i += 1
        if clock.now() >= deadline:
            break
    w.seconds = clock.now() - t0
    return w


def check(cell: manifest.Cell, inputs: dict, w: Window) -> tuple[bool, int, dict]:
    """The comparison that decides ``correct``: every kept answer against the
    plain reference, computed after the window. Returns ``(correct, failed
    queries, {number: (value, limit)})``."""
    ref_mod = cell.reference
    ref = ref_mod.Ref(inputs, cell.config, cell.params, cell.config["dtype"])
    sums = dict.fromkeys(ref_mod.LIMITS, 0)
    wrong = 0
    for _, q, out in w.kept:
        numbers = ref_mod.compare(out, ref.answer(q))
        for name, v in numbers.items():
            sums[name] += v
        wrong += any(numbers.values())
    checks = {"failed_queries": (w.failed, 0)}
    checks.update({name: (sums[name], limit) for name, limit in ref_mod.LIMITS.items()})
    checks["checked_answers"] = (len(w.kept), None)
    correct = bool(w.kept) and all(v <= lim for v, lim in checks.values() if lim is not None)
    return correct, w.failed + wrong, checks


def read_layers(cell: manifest.Cell, view: tr.View) -> dict:
    """Every per-layer metric of the cell that its reader finds; a reader
    whose kernel counts disagree with the launch books reports nothing."""
    out = {}
    for m in cell.per_layer:
        try:
            value = cell.metric_reader(m["name"]).read(view)
        except tr.CountMismatch as e:
            print(f"kbench: {m['name']} not reported: {e}", file=sys.stderr)
            continue
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def traced_window(cell, call, inputs, plan, seconds, timer, sample, seed, on_card) -> tuple[Window, tr.View]:
    """The window under ``torch.profiler``, marked ``trace.WINDOW``, with the
    port's launch books read before and after it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    books0 = launch_books()
    with profile(activities=acts) as prof:
        with record_function(tr.WINDOW):
            w = run_window(call, inputs, plan, seconds, timer, cell.op.KEEP_ALL, sample, seed)
    books = {k: v - books0.get(k, 0) for k, v in launch_books().items()}
    fd, path = tempfile.mkstemp(suffix=".json", prefix="kbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = tr.load_chrome(path)
    finally:
        os.remove(path)
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    return w, tr.View(events, len(w.latencies_ms), books, kind, cell.config, cell.params,
                      cell.op.least_bytes(cell.config, cell.params))


def run_cell(cell: manifest.Cell, seed: int, seconds: float, traced: bool = False, device="cuda",
             t_start: float | None = None, call_factory=None) -> dict:
    """One run of ``cell``; the result's fields, ``checks`` last.

    ``call_factory(inputs)`` returns what answers a query in the port's place
    (the control, or a fault for the tests); the port's own call by default."""
    import torch

    t_start = clock.now() if t_start is None else t_start
    on_card = torch.device(device).type == "cuda"
    op, params = cell.op, cell.params
    inputs = op.make_inputs(cell.config, params, seed, device)
    plan = op.Plan(cell.config, params, seed)
    call = op.call if call_factory is None else call_factory(inputs)
    expect = params.get("expect_algorithm")
    if expect is not None and call_factory is None:
        leg = op.dispatch(inputs, plan.warm()[0])
        if leg != expect:
            raise RuntimeError(f"{cell.name}: the port takes {leg!r}, the cell is {expect!r}")
    timer = Timer(device)
    for q in plan.warm():  # every shape the window uses, through the window's own timing
        timer.start()
        call(inputs, q)
        timer.stop()
    setup_s = clock.now() - t_start
    setup_peak = 0
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    sample = int(params.get("check_calls", 0))
    view = None
    if traced:
        w, view = traced_window(cell, call, inputs, plan, min(seconds, TRACE_WINDOW_S), timer, sample, seed, on_card)
    else:
        w = run_window(call, inputs, plan, seconds, timer, op.KEEP_ALL, sample, seed)
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    n = len(w.latencies_ms)
    print(f"kbench: {cell.name} seed {seed}: set-up {setup_s:.3f} s, {n} queries in {w.seconds:.3f} s, "
          f"{len(w.kept)} kept", file=sys.stderr)

    if traced:
        metrics = read_layers(cell, view)
    else:
        metrics = {"queries_per_s": stats.rate(n, w.seconds), "latency_p95_ms": stats.nearest_rank(w.latencies_ms, 0.95),
                   "setup_s": setup_s}
        if on_card:
            metrics["peak_mem_gib"] = window_peak / GIB
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in metrics.items() if k in units}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": max(setup_peak, window_peak)}
    if view is not None:
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
    correct, failed, checks = check(cell, inputs, w)
    result = {"correct": correct, "attempted": n, "failed": failed, "metrics": metrics, "device": dev}
    if view is not None:
        result["breakdown"] = view.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reads it, None where it
    cannot."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=20, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="kbench/run.py", description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def emit(result: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    stderr; the result as the last line of stdout."""
    for name, c in result["checks"].items():
        limit = "none (counted)" if c["limit"] is None else c["limit"]
        print(f"check {name} {c['value']} limit {limit}", file=sys.stderr)
    print(f"check correct {str(result['correct']).lower()}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = clock.now() if t_start is None else t_start
    args = parse(argv)
    man = manifest.load()
    entry = manifest.workload(man, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"kbench: {args.workload} needs {entry['chips']} CUDA device(s); this machine has {have}",
              file=sys.stderr)
        return 2
    cell = manifest.Cell(man, args.workload)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    except tr.ShareOver100 as e:
        print(f"kbench: {e}", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"kbench: the run loaded {found}; the benchmark measures the port alone", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = power_limit()
    emit(result)
    return 0
