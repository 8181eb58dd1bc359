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
from mpi_k_selection_tpu_torch.monitor.monitor import MONITOR_THREAD_PREFIX
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
    for knob, why in (("retry", "item 4"), ("fused", "no counterpart")):
        with pytest.raises(TypeError, match=f"{knob}.*{why}"):
            kt.Monitor(**{knob: None})
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
