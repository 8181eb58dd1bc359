"""The port's WindowedSketch, DecayedWindowedSketch and Monitor against
the JAX package's, field by field.

The same seeded numpy chunks go to both packages; the port's buckets count
through the sweep kernel's plain version (``device="cpu"``). Windows are
compared bucket for bucket and query for query (pyramids, counts and
extremes exactly), samples as their ``as_dict()`` records (values as bit
patterns), the ring against a from-scratch merge, and the decayed window's
fixed-point weights exactly. Sources include one-shot generators, and an
abandoned sample generator must leave no ``ksel-`` thread (the conftest
leak fixture). The ``gpu`` test collects where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_monitor.py -m gpu
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import mpi_k_selection_tpu_torch as kt
from mpi_k_selection_tpu_torch.monitor import (
    DECAY_SHIFT,
    DecayedSketch,
    DecayedWindowedSketch,
    WindowedSketch,
    decay_weight,
    q_label,
)
from mpi_k_selection_tpu_torch.monitor.monitor import MONITOR_THREAD_PREFIX, start_metrics_server
from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
from mpi_k_selection_tpu_torch.streaming import pipeline as pl
from mpi_k_selection_tpu_torch.streaming.sketch import RadixSketch
from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype
from test_torch_sketch import same
from test_torch_streaming import bits, stream

torch.set_num_threads(1)


def drifting(n_chunks, elems=600, step=500, seed=7):
    """int32 chunks whose values drift upward chunk by chunk."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 1000, size=elems) + i * step).astype(np.int32) for i in range(n_chunks)]


def records(samples) -> list:
    """Samples as comparable records: ``as_dict()`` with the values as bit
    patterns."""
    out = []
    for s in samples:
        d = s.as_dict()
        dtype = np.asarray(s.values[0]).dtype
        d["values"] = np.asarray(s.values, dtype).tobytes()
        d["value_bounds"] = np.asarray(s.value_bounds, dtype).tobytes()
        out.append((d, s.format_line()))
    return out


@pytest.mark.parametrize("window", [1, 2, 3, 8])
def test_windowed_ring_matches_jax_and_scratch(window, rng):
    """Every advance of a 3x-wrap run, every query window: the port's ring
    equals the JAX ring, bucket for bucket and query for query, and a
    from-scratch merge of its live buckets."""
    from mpi_k_selection_tpu.monitor import WindowedSketch as JaxWindowed

    mine = WindowedSketch(np.int32, window=window, device="cpu")
    ref = JaxWindowed(np.int32, window=window)
    for _ in range(3 * window + 2):
        c = rng.integers(-(2**31), 2**31 - 1, size=int(rng.integers(1, 400)), dtype=np.int32)
        mine.update(c)
        ref.update(c)
        assert (mine.epoch, mine.n_live) == (ref.epoch, ref.n_live)
        for a, b in zip(mine.live_buckets(), ref.live_buckets()):
            same(a, b)
        for qw in [None, *range(1, window + 1)]:
            got = mine.query(qw)
            same(got, ref.query(qw))
            w = mine._resolve_window(qw)
            scratch = RadixSketch(np.int32, device="cpu")
            for b in mine.live_buckets()[-w:]:
                scratch.fold_scaled(b, 1)
            assert got == scratch
        mine.advance()
        ref.advance()
    with pytest.raises(ValueError, match="query window"):
        mine.query(window + 1)
    with pytest.raises(ValueError, match="window must be >= 1"):
        WindowedSketch(np.int32, window=0)


@pytest.mark.parametrize("name", ["int8", "bfloat16", "float32", "uint64", "float64"])
def test_windowed_dtypes_and_update_value_match_jax(name):
    """Other dtypes (NaNs and +-0.0 included), chunks and single values
    (``update_value``) into the same ring."""
    from mpi_k_selection_tpu.monitor import WindowedSketch as JaxWindowed

    geo = dict(radix_bits=4, levels=2) if name == "int8" else {}
    chunks = stream(name, seed=3)
    mine = WindowedSketch(numpy_dtype(name), window=3, device="cpu", **geo)
    ref = JaxWindowed(numpy_dtype(name), window=3, **geo)
    for c in chunks:
        for w in (mine, ref):
            w.update(c)
            if c.size:
                w.update_value(c[0])
            w.advance()
    same(mine.query(), ref.query())
    dtype = numpy_dtype(name)
    assert bits(mine.quantiles([0.5, 0.9]), dtype) == bits(ref.quantiles([0.5, 0.9]), dtype)


def test_decay_weights_and_decayed_window_match_jax(rng):
    """``decay_weight`` equals the JAX one (and its errors); the decayed
    window's query equals the JAX one at every advance and the weighted
    fold of its live buckets in any order; ``decay=1.0`` is the undecayed
    window scaled by ``2^DECAY_SHIFT``."""
    from mpi_k_selection_tpu.monitor import DecayedWindowedSketch as JaxDecayed
    from mpi_k_selection_tpu.monitor import decay_weight as jax_weight

    for decay in (1.0, 0.9, 0.5, 1e-3):
        for age in (0, 1, 7, 40):
            assert decay_weight(decay, age) == jax_weight(decay, age)
    for bad in (0.0, 1.5, -1.0):
        with pytest.raises(ValueError, match="decay must be in"):
            decay_weight(bad, 1)
    with pytest.raises(ValueError, match="age must be >= 0"):
        decay_weight(0.5, -1)
    mine = DecayedWindowedSketch(np.int32, window=4, decay=0.5, device="cpu")
    ref = JaxDecayed(np.int32, window=4, decay=0.5)
    flat = WindowedSketch(np.int32, window=4, device="cpu")
    unit = DecayedWindowedSketch(np.int32, window=4, decay=1.0, device="cpu")
    for _ in range(9):
        c = rng.integers(0, 10**6, size=int(rng.integers(50, 300)), dtype=np.int32)
        for w in (mine, ref, flat, unit):
            w.update(c)
        got = mine.query()
        assert isinstance(got, DecayedSketch) and got.scale == 1 << DECAY_SHIFT
        same(got, ref.query())
        for qw in (1, 2):
            same(mine.query(qw), ref.query(qw))
        shuffled = DecayedSketch(np.int32, decay=0.5, device="cpu")
        ages = list(enumerate(reversed(mine.live_buckets())))
        for age, b in reversed(ages):
            shuffled.fold_bucket(b, age)
        assert shuffled == got
        scaled = flat.query()
        assert unit.query().n == scaled.n << DECAY_SHIFT
        assert all(np.array_equal(a, b << DECAY_SHIFT) for a, b in zip(unit.query().hists, scaled.hists))
        for w in (mine, ref, flat, unit):
            w.advance()
    with pytest.raises(ValueError, match="decay must be in"):
        DecayedWindowedSketch(np.int32, window=2, decay=0.0)


@pytest.mark.parametrize("decay", [None, 0.5])
def test_monitor_samples_match_jax(decay):
    """Samples of a list source, a one-shot generator and a callable, at
    depth 0 and 2 and widths 1 and 4, equal the JAX monitor's field by
    field (``emit_every`` 2, a partial last bucket)."""
    from mpi_k_selection_tpu.monitor import Monitor as JaxMonitor

    chunks = drifting(9)
    kw = dict(window=3, emit_every=2, decay=decay, qs=(0.5, 0.9, 0.99, 0.999))
    want = records(JaxMonitor(**kw).run(list(chunks), np.int32))
    assert len(want) == 5 and want[-1][0]["chunks"] == 9
    for depth in (0, 2):
        for workers in (1, 4):
            mon = kt.Monitor(pipeline_depth=depth, ingest_workers=workers, device="cpu", **kw)
            assert records(mon.run(list(chunks))) == want
            assert records(mon.run((c for c in chunks), np.int32)) == want  # one-shot
            assert records(mon.run(lambda: iter(chunks), np.int32)) == want


def test_monitor_emit_every_max_samples_and_validation():
    from mpi_k_selection_tpu.monitor import Monitor as JaxMonitor

    chunks = drifting(10, elems=256)
    samples = list(kt.Monitor(window=4, emit_every=2, device="cpu").run(chunks, np.int32))
    assert len(samples) == 5 and samples[0].n == 512 and samples[-1].n == 4 * 512
    capped = list(kt.Monitor(window=4, emit_every=2, device="cpu").run(chunks, np.int32, max_samples=2))
    assert records(capped) == records(JaxMonitor(window=4, emit_every=2).run(chunks, np.int32, max_samples=2))
    assert kt.Monitor(window=2, device="cpu").sample() is None
    with pytest.raises(TypeError, match="pass dtype="):
        next(kt.Monitor(window=2, device="cpu").run(iter(chunks)))
    with pytest.raises(ValueError, match="emit_every"):
        kt.Monitor(emit_every=0)
    with pytest.raises(ValueError, match="at least one quantile"):
        kt.Monitor(qs=())
    from mpi_k_selection_tpu_torch import obs as obs_lib

    for knob, value in (("devices", 2), ("obs", obs_lib.Observability.collecting())):
        got = kt.Monitor(window=4, emit_every=2, device="cpu", **{knob: value}).run(chunks, np.int32, max_samples=2)
        assert records(got) == records(JaxMonitor(window=4, emit_every=2).run(chunks, np.int32, max_samples=2))
    with pytest.raises(TypeError, match="fused.*no counterpart"):
        kt.Monitor(fused=None)
    said = []
    for cls in (kt.Monitor, JaxMonitor):  # retry: the JAX package's own plain TypeError
        with pytest.raises(TypeError) as ei:
            cls(retry=None)
        said.append(str(ei.value))
    assert said[0] == said[1] == "Monitor.__init__() got an unexpected keyword argument 'retry'"
    with pytest.raises(TypeError, match="requires one dtype per stream"):
        list(kt.Monitor(window=2, device="cpu").run([chunks[0], chunks[1].astype(np.int64)]))
    assert [q_label(q) for q in (0.5, 0.99, 0.999)] == ["p50", "p99", "p99_9"]
    assert MONITOR_THREAD_PREFIX.startswith("ksel-")


@pytest.mark.parametrize("workers", [1, 4])
def test_monitor_abandoned_generator_cleans_up(workers):
    """Breaking out of the sample stream tears the staging down: no
    ``ksel-`` thread outlives it and the one-shot source is read no
    further than the pipeline had pulled."""
    chunks = drifting(40, elems=256)
    pulled = []

    def one_shot():
        for c in chunks:
            pulled.append(1)
            yield c

    gen = kt.Monitor(window=4, pipeline_depth=2, ingest_workers=workers, device="cpu").run(one_shot(), np.int32)
    first = next(gen)
    assert first.chunks == 1
    gen.close()
    assert len(pulled) < len(chunks)
    assert not [t.name for t in threading.enumerate() if t.name.startswith(("ksel-pipeline", "ksel-ingest"))]


# --- the Prometheus exposition and the CLI's monitor ---------------------------


def _get(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.headers["Content-Type"], r.read().decode()


def _monitor_threads() -> list:
    return [t.name for t in threading.enumerate() if t.name.startswith(MONITOR_THREAD_PREFIX)]


def test_metrics_server_serves_the_registry_and_closes():
    """``GET /metrics`` is the registry's own Prometheus text, live, on
    ``ksel-monitor-*`` threads that ``close()`` joins; ``/healthz`` answers
    and any other path is a 404, as the JAX package's server does."""
    import json
    import urllib.error

    from mpi_k_selection_tpu.monitor import start_metrics_server as jax_start
    from mpi_k_selection_tpu.obs import MetricsRegistry as JaxRegistry

    from mpi_k_selection_tpu_torch import obs as obs_lib

    regs = []
    for make in (obs_lib.MetricsRegistry, JaxRegistry):
        reg = make()
        reg.gauge("monitor.window_n").set(42)
        reg.counter("monitor.samples").inc(3)
        reg.gauge("monitor.quantile", labels={"q": "p99"}).set(1.5)
        regs.append(reg)
    bodies = []
    for start, reg in ((start_metrics_server, regs[0]), (jax_start, regs[1])):
        with start(reg) as srv:
            url = f"http://127.0.0.1:{srv.port}"
            status, ctype, body = _get(url + "/metrics")
            assert status == 200 and ctype.startswith("text/plain; version=0.0.4") and body == reg.render_prometheus()
            reg.gauge("monitor.window_n").set(43)
            assert "ksel_monitor_window_n 43" in _get(url + "/metrics")[2]  # rendered live
            assert json.loads(_get(url + "/healthz")[2]) == {"status": "ok"}
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(url + "/nope")
            assert ei.value.code == 404
            bodies.append(body)
        assert _monitor_threads() == []
    assert bodies[0] == bodies[1]
    srv = start_metrics_server(regs[0])
    assert srv.port > 0 and _monitor_threads()
    srv.close()
    assert _monitor_threads() == []


def test_monitor_run_scraped_mid_run(rng):
    """A scrape between two samples parses as Prometheus text and carries
    the first sample's gauges; after the run the body equals the
    registry's own text."""
    from mpi_k_selection_tpu_torch import obs as obs_lib

    o = obs_lib.Observability(metrics=obs_lib.MetricsRegistry())
    chunks = drifting(6, elems=2048)
    with start_metrics_server(o.metrics) as srv:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        gen = kt.Monitor(window=4, emit_every=2, obs=o, device="cpu").run(iter(chunks), np.int32)
        first = next(gen)
        mid = _get(url)[2]
        samples = [first, *gen]
        lines = [ln for ln in mid.splitlines() if ln and not ln.startswith("#")]
        assert lines and all(len(ln.split(" ")) == 2 for ln in lines)
        assert {ln.split(" ")[0] for ln in lines} >= {'ksel_monitor_quantile{q="p50"}', "ksel_monitor_window_n"}
        assert "ksel_monitor_samples 1" in lines
        assert _get(url)[2] == o.metrics.render_prometheus()
    assert len(samples) == 3 and _monitor_threads() == []


MONITOR_ARGV = ["monitor", "--buckets", "3", "--window", "4", "--chunk-elems", "1024", "--drift", "50", "--seed", "9"]


@pytest.mark.parametrize("extra", [
    ["--json"],
    ["--json", "--decay", "0.5", "--emit-every", "2", "--quantiles", "0.5,0.95"],
    ["--json", "--dtype", "float32", "--gen", "normal"],
    [],
])
def test_cli_monitor_samples_match_the_jax_cli(extra, capsys):
    """``python -m mpi_k_selection_tpu_torch monitor`` prints the JAX CLI's
    sample lines for the same seed: JSON records equal field for field,
    and the human-readable lines equal."""
    from mpi_k_selection_tpu.cli import main as jax_main

    from mpi_k_selection_tpu_torch import cli

    assert cli.main(MONITOR_ARGV + extra + ["--device", "cpu"]) == 0
    mine = capsys.readouterr().out.splitlines()
    assert jax_main(MONITOR_ARGV + extra) == 0
    theirs = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(("{", "multirank"))]
    assert len(mine) == 3 and mine == theirs


def test_cli_monitor_metrics_port_and_validation(tmp_path, capsys):
    """``--metrics-json`` writes the registry, ``--prometheus-port 0``
    serves it on a free port for the run (written to ``--port-file``) and
    closes it; bad knobs exit with the JAX CLI's messages."""
    import json

    from mpi_k_selection_tpu_torch import cli

    mpath, ppath = tmp_path / "mon.json", tmp_path / "port"
    argv = MONITOR_ARGV + ["--device", "cpu", "--metrics-json", str(mpath), "--prometheus-port", "0",
                           "--port-file", str(ppath)]
    assert cli.main(argv) == 0
    assert len(capsys.readouterr().out.splitlines()) == 3 and int(ppath.read_text()) > 0
    saved = json.loads(mpath.read_text())
    assert saved["monitor.samples"]["value"] == 3 and any(k.startswith("monitor.quantile") for k in saved)
    assert _monitor_threads() == []
    for bad, match in ((["--chunk-elems", "0"], "chunk-elems"), (["--quantiles", "0.5,zap"], "quantiles"),
                       (["--decay", "7.5"], "decay")):
        with pytest.raises(SystemExit, match=match):
            cli.main(["monitor", "--buckets", "1", "--device", "cpu", *bad])


# --- on the card ----------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("decay", [None, 0.5])
def test_monitor_on_card_matches_cpu(decay):
    """The monitor on the card (the sweep kernel's sketch part, one launch
    a chunk, widths 1 and 4) gives the CPU monitor's samples, with no
    plain call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card: python -m pytest --noconftest tests/test_torch_*.py -m gpu")
    rng = np.random.default_rng(5)
    chunks = [rng.integers(0, 10**8, size=200_000).astype(np.int32) for _ in range(8)]
    kw = dict(window=3, emit_every=2, decay=decay)
    want = records(kt.Monitor(device="cpu", **kw).run(chunks))
    for workers in (1, 4):
        S.reset_counts()
        got = records(kt.Monitor(ingest_workers=workers, **kw).run(iter(chunks), np.int32))
        assert got == want
        assert S.LAUNCHES["sweep_ingest32"] == len(chunks) and not S.PLAIN_CALLS["sweep_ingest"]
    assert pl.STAGING_POOL.live_bytes == 0
