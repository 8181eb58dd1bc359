"""The port's multi-device staging (``devices=`` on the streamed entry
points, streaming/pipeline.py) against the JAX package, bit for bit.

The JAX package's contract (tests/test_multidevice_ingest.py): answers
are the same bits for ``devices`` in {None, 1, 2, 8} x ``pipeline_depth``
in {0, 2}, on heterogeneous, ragged and empty chunks, with a tiny collect
budget, for the certificate and the sketch, because the host int64 folds
drain in chunk order. On the CPU the port's slots are indexed CPU devices
(``cpu:0`` .. ``cpu:7``, the stand-in for the JAX tests' eight host
devices): chunks stay CPU tensors, and the slot each lands on is the one
the producer recorded. The spill records name that slot, so the
generations equal the JAX package's file for file at p = 2. The ``gpu``
tests stage two slots on ``cuda:0`` and, with two cards or more, one slot
a card:

    python -m pytest --noconftest tests/test_torch_*.py -m gpu
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch

import mpi_k_selection_tpu_torch as kt
from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
from mpi_k_selection_tpu_torch.streaming import pipeline as pl
from test_torch_spill import generation_files, spill_dirs
from test_torch_streaming import cuda_device  # noqa: F401 (a fixture)

torch.set_num_threads(1)

GRID = (None, 1, 2, 8)
CPU = dict(device="cpu")


def _chunks(x, nchunks):
    return [np.ascontiguousarray(c) for c in np.array_split(x, nchunks)]


def _ints(rng, n, dtype=np.int32):
    return rng.integers(-(2**31), 2**31, size=n, dtype=np.int64).astype(dtype)


def _seq(x, ks):
    return [np.sort(x, kind="stable")[k - 1] for k in ks]


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.mark.parametrize("depth", [0, 2])
def test_grid_bit_identical_heterogeneous_chunks(depth, rng):
    """Ragged chunk sizes over the devices grid: the port equals the JAX
    package's depth-0 oracle and NumPy at every slot count."""
    from mpi_k_selection_tpu.streaming import streaming_kselect_many as ref_many

    x = _ints(rng, (1 << 14) + 311)
    chunks = _chunks(x, 7)
    ks = [1, 137, x.size // 2, x.size]
    want = ref_many(chunks, ks, pipeline_depth=0, devices=1)
    assert want == _seq(x, ks)
    for devices in GRID:
        assert kt.kselect_streaming_many(chunks, ks, pipeline_depth=depth, devices=devices, **CPU) == want, devices


def test_grid_ragged_final_and_empty_chunks(rng):
    """A short last chunk, and empty chunks that must not advance the round
    robin: the answers and each chunk's slot (``j % p`` over the non-empty
    chunks) follow the JAX package's."""
    from mpi_k_selection_tpu import obs as jobs
    from mpi_k_selection_tpu.streaming import streaming_kselect as ref_select

    from mpi_k_selection_tpu_torch import obs as obs_lib

    x = _ints(rng, 5 * 1000 + 537)
    ragged = [x[i * 1000:(i + 1) * 1000] for i in range(5)] + [x[5000:]]
    want = _seq(x, [x.size // 2])[0]
    empty = [x[:1000], np.empty(0, np.int32), x[1000:2048], np.empty(0, np.int32), x[2048:]]
    for devices in GRID:
        assert kt.kselect_streaming(ragged, x.size // 2, pipeline_depth=2, devices=devices, **CPU) == want
        o, jo = obs_lib.Observability.collecting(), jobs.Observability.collecting()
        got = kt.kselect_streaming(empty, 19, pipeline_depth=2, devices=devices, obs=o, **CPU)
        assert got == ref_select(empty, 19, pipeline_depth=2, devices=devices, obs=jo) == _seq(x, [19])[0]
        slots = [(c.pass_index, c.chunk_index, c.device_slot) for c in o.events.of_kind("stream.chunk")]
        assert slots == [(c.pass_index, c.chunk_index, c.device_slot) for c in jo.events.of_kind("stream.chunk")]
        p = 1 if devices in (None, 1) else devices
        assert [s for _, j, s in slots if _ == 0] == [None if devices is None else j % p for j in range(3)]


@pytest.mark.parametrize("dtype", [np.int64, np.float64, np.uint16])
def test_grid_other_widths(dtype, rng):
    """64-bit keys (the JAX package counts them on its devices only under
    x64) and widened 16-bit keys over the devices grid."""
    from mpi_k_selection_tpu.streaming import streaming_kselect as ref_select
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    x = rng.integers(-(2**62), 2**62, size=1 << 13, dtype=np.int64).astype(dtype)
    k = x.size // 2
    with enable_x64():
        want = ref_select(_chunks(x, 8), k, pipeline_depth=2, devices=2)
    assert want.tobytes() == np.asarray(_seq(x, [k])[0]).tobytes()
    for devices in GRID:
        got = kt.kselect_streaming(_chunks(x, 8), k, pipeline_depth=2, devices=devices, **CPU)
        assert np.asarray(got).tobytes() == want.tobytes(), devices


def test_grid_tiny_budget_multi_prefix_and_collect(rng):
    """A 64-survivor budget drives deep shared passes and the collect
    through several slots; every slot count answers as the depth-0 path
    and the JAX package."""
    from mpi_k_selection_tpu.streaming import streaming_kselect_many as ref_many

    x = _ints(rng, 1 << 14)
    chunks = _chunks(x, 9)
    ks = [7, x.size // 4, x.size // 2, x.size - 3]
    want = ref_many(chunks, ks, collect_budget=64, pipeline_depth=2, devices=8)
    assert kt.kselect_streaming_many(chunks, ks, collect_budget=64, pipeline_depth=0, **CPU) == want
    for devices in GRID:
        got = kt.kselect_streaming_many(chunks, ks, collect_budget=64, pipeline_depth=2, devices=devices, **CPU)
        assert got == want, devices


def test_certificate_grid_matches_sync(rng):
    from mpi_k_selection_tpu.streaming import streaming_rank_certificate as ref_cert

    x = _ints(rng, 1 << 13)
    chunks = _chunks(x, 8)
    v = int(np.sort(x)[x.size // 2])
    want = tuple(int(c) for c in ref_cert(chunks, v, pipeline_depth=0))
    for devices in GRID:
        for depth in (0, 2):
            assert kt.streaming_rank_certificate(chunks, v, pipeline_depth=depth, devices=devices, **CPU) == want


def test_sketch_and_quantiles_devices_bit_identical(rng):
    """``RadixSketch.update_stream`` and ``StreamingQuantiles`` over the
    slots equal the sketch of ``update`` chunk by chunk and the JAX
    package's (counts, n and extremes); ``devices`` survives ``merge``
    and is checked at construction."""
    from mpi_k_selection_tpu import StreamingQuantiles as JaxQuantiles
    from mpi_k_selection_tpu.streaming import RadixSketch as JaxSketch

    x = _ints(rng, (1 << 13) + 77)
    chunks = _chunks(x, 7)
    want = kt.RadixSketch(np.int32, device="cpu")
    for c in chunks:
        want.update(c)
    jax_sk = JaxSketch(np.int32).update_stream(chunks, pipeline_depth=2, devices=2)
    assert [h.tolist() for h in want.hists] == [h.tolist() for h in jax_sk.hists]
    for devices in GRID:
        for depth in (0, 2):
            got = kt.RadixSketch(np.int32, device="cpu").update_stream(chunks, pipeline_depth=depth, devices=devices)
            assert got == want, (devices, depth)
    t = kt.StreamingQuantiles(np.int32, devices=2, **CPU).update_stream(chunks)
    assert t.sketch == want and t.merge(kt.StreamingQuantiles(np.int32, **CPU)).devices == 2
    qs = [0.5, 0.99]
    jt = JaxQuantiles(np.int32, devices=2).update_stream(chunks)
    assert t.refine_quantiles(qs, chunks) == jt.refine_quantiles(qs, chunks)
    for bad in (0, True):
        with pytest.raises(ValueError, match="devices"):
            kt.StreamingQuantiles(np.int32, devices=bad, **CPU)
        with pytest.raises(ValueError, match="devices"):
            JaxQuantiles(np.int32, devices=bad)


def test_spill_generations_match_jax_at_two_slots(rng, tmp_path):
    """At p = 2 every record names its chunk's slot: the pass-0 tee and the
    later generations equal the JAX package's file for file, the pass logs
    entry for entry, and a replay of the store re-stages each record onto
    the slot it names."""
    from mpi_k_selection_tpu import obs as jobs
    from mpi_k_selection_tpu.streaming import streaming_kselect_many as ref_many
    from mpi_k_selection_tpu.streaming.spill import SpillStore as JaxStore

    from mpi_k_selection_tpu_torch import obs as obs_lib

    x = _ints(rng, 6000)
    chunks = _chunks(x, 6)
    ks = [1, x.size // 2]
    out = {}
    for pkg, store_cls, run in (("jax", JaxStore, ref_many), ("port", kt.SpillStore, kt.kselect_streaming_many)):
        with store_cls(str(tmp_path / pkg)) as store:
            store.drop_generation = lambda gen: None  # every generation stays on disk
            kw = {} if pkg == "jax" else CPU
            ans = run(chunks, ks, radix_bits=4, collect_budget=64, pipeline_depth=2, devices=2, spill=store, **kw)
            slots = sorted({r.device_slot for g in store.generations.values() for r in g.records})
            o = (jobs if pkg == "jax" else obs_lib).Observability.collecting()
            gen0 = store.generations[min(store.generations)]
            again = run(gen0.as_source(), ks, radix_bits=4, collect_budget=64, pipeline_depth=2, devices=2,
                        spill="off", obs=o, **kw)
            replay = [c.device_slot for c in o.events.of_kind("stream.chunk")]
            out[pkg] = (ans, again, list(store.pass_log), generation_files(store), slots, replay)
    assert out["port"][:2] == out["jax"][:2] and out["port"][0] == _seq(x, ks)
    assert out["port"][2] == out["jax"][2]
    assert out["port"][3] == out["jax"][3]
    assert out["port"][4] == [0, 1] and out["port"][5] == out["jax"][5]
    assert not spill_dirs(tmp_path / "port")


def test_round_robin_places_chunks_on_successive_slots(rng):
    """The producer stages chunk j onto slot ``j % p`` and records it; a CPU
    slot's tensor stays a CPU tensor (``cpu:1`` reports ``cpu``), which is
    why the slot is recorded and never read back from the tensor."""
    devs = pl.resolve_stream_devices(8, "cpu")
    assert devs == tuple(torch.device("cpu", i) for i in range(8))
    chunks = _chunks(_ints(rng, 10 * 1024), 10)
    pipe = pl.ChunkPipeline(lambda: iter(chunks), depth=2, cursor=pl.SlotCursor(devs[0], devs, True), window=8)
    seen = []
    try:
        for keys, _ in pipe:
            assert keys.staged and keys.data.device == torch.device("cpu")
            seen.append((keys.device_slot, keys.tee_slot))
            keys.release()
    finally:
        pipe.close()
    assert seen == [(i % 8, i % 8) for i in range(10)]
    # two slots on one device: the second names the first's index, the tee its own
    two = (torch.device("cpu", 3), torch.device("cpu", 3))
    cur = pl.SlotCursor(two[0], two, True)
    assert [(p["device_slot"], p["tee_slot"]) for p in (cur.place(chunks[0]) for _ in range(3))] == [
        (0, 0), (0, 1), (0, 0)]


def test_resolve_stream_devices_knob():
    """The knob's forms and errors, with the JAX package's messages."""
    from mpi_k_selection_tpu.streaming import pipeline as jpl
    from mpi_k_selection_tpu.streaming import streaming_kselect as ref_select

    assert pl.resolve_stream_devices(None) == (None,) == jpl.resolve_stream_devices(None)
    assert pl.resolve_stream_devices(2, "cpu") == (torch.device("cpu", 0), torch.device("cpu", 1))
    assert pl.resolve_stream_devices(["cpu:5", torch.device("cpu", 2)]) == (
        torch.device("cpu", 5), torch.device("cpu", 2))
    for bad in (0, -1, True, 1.5, "all", [], ["x"], [3]):
        with pytest.raises(ValueError) as mine:
            pl.resolve_stream_devices(bad, "cpu")
        with pytest.raises(ValueError) as theirs:
            jpl.resolve_stream_devices(bad)
        if not isinstance(bad, (list, float, str)):
            assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="devices"):
        kt.kselect_streaming([np.arange(4, dtype=np.int32)], 1, devices=-2, **CPU)
    with pytest.raises(ValueError, match="devices"):
        ref_select([np.arange(4, dtype=np.int32)], 1, devices=-2)
    if not torch.cuda.is_available():  # a card that is not there is an error, never a fallback
        with pytest.raises(ValueError, match="no CUDA card"):
            kt.kselect_streaming([np.arange(4, dtype=np.int32)], 1, devices=["cuda:0"])
    with pytest.raises(ValueError, match="disagree"):
        kt.kselect_streaming([np.arange(4, dtype=np.int32)], 1, devices=["cpu:0"], device="cuda")
    with pytest.raises(ValueError, match="disagree"):
        kt.kselect_streaming([np.arange(4, dtype=np.int32)], 1, devices=["cpu:0", "cpu:1"], device="cpu:4")
    assert pl.resolve_ingest("cpu:1", ["cpu:0", "cpu:1"])[0] == torch.device("cpu", 0)


def test_depth_zero_stays_synchronous(rng):
    """``devices`` with ``pipeline_depth=0`` starts no thread and stages no
    chunk to a slot: the synchronous path, whatever the slots."""
    from mpi_k_selection_tpu_torch import obs as obs_lib

    x = _ints(rng, 1 << 10)
    before = {t.ident for t in threading.enumerate()}
    o = obs_lib.Observability.collecting()
    assert kt.kselect_streaming(_chunks(x, 4), 17, pipeline_depth=0, devices=8, obs=o, **CPU) == _seq(x, [17])[0]
    assert not [t for t in threading.enumerate()
                if t.ident not in before and t.name.startswith(pl.THREAD_NAME_PREFIX)]
    assert all(not c.staged and c.device_slot is None for c in o.events.of_kind("stream.chunk"))


def test_drifting_and_failing_sources_join_the_producer(rng):
    """A source that changes between passes fails the replay check, and one
    that raises mid-stream re-raises, with chunks in flight on several
    slots; no producer thread is left (the conftest leak check too)."""
    calls = [0]

    def drifting():
        calls[0] += 1
        r = np.random.default_rng(calls[0])
        for _ in range(8):
            yield r.integers(-(2**31), 2**31, size=1 << 11, dtype=np.int64).astype(np.int32)

    with pytest.raises(RuntimeError, match="not replay-stable"):
        kt.kselect_streaming(drifting, 1 << 12, collect_budget=4, pipeline_depth=3, devices=8, **CPU)
    x = _ints(rng, 2048)

    def failing():
        yield x[:1024]
        yield x[1024:]
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        kt.kselect_streaming(failing, 5, pipeline_depth=2, devices=8, **CPU)
    assert not [t for t in threading.enumerate() if t.name.startswith(pl.THREAD_NAME_PREFIX)]
    assert pl.STAGING_POOL.live_bytes == 0


def test_staging_pool_metrics_mirror_counters_exactly(rng):
    """``collect_runtime`` snapshots the pool's own ints, and a descent
    with metrics mirrors the module pool right after the call."""
    from mpi_k_selection_tpu_torch.obs import MetricsRegistry, Observability
    from mpi_k_selection_tpu_torch.obs.metrics import collect_runtime

    pool = pl.StagingPool()  # a miss would pin memory, which needs a card: buffers handed in
    for nbytes in (4000, 4000, 8000):
        pool.release(torch.empty(nbytes, dtype=torch.uint8), "cpu")
    b, c = pool.acquire(4000, "cpu"), pool.acquire(8000, "cpu")  # hits
    reg = MetricsRegistry()
    collect_runtime(reg, staging_pool=pool)
    assert reg.counter("staging_pool.hits").value == pool.hits == 2
    assert reg.counter("staging_pool.misses").value == pool.misses == 0
    assert reg.gauge("staging_pool.resident_bytes").value == pool.resident_bytes == 4000
    pool.release(b, "cpu")
    pool.release(c, "cpu")
    collect_runtime(reg, staging_pool=pool)
    assert reg.gauge("staging_pool.resident_bytes").value == pool.resident_bytes == 16000
    chunks = [rng.integers(0, 2**31 - 1, size=1500, dtype=np.int32) for _ in range(4)]
    o = Observability(metrics=MetricsRegistry())
    kt.kselect_streaming(chunks, 3000, pipeline_depth=2, devices=2, obs=o, **CPU)
    assert o.metrics.counter("staging_pool.hits").value == pl.STAGING_POOL.hits
    assert o.metrics.counter("staging_pool.misses").value == pl.STAGING_POOL.misses


def test_cli_streaming_devices_flag(capsys):
    """``--streaming --devices N`` caps the ingest set and records it; the
    answer is the single-slot run's and passes the certificate."""
    from mpi_k_selection_tpu_torch import cli

    args = ["--streaming", "--n", "60000", "--chunk-elems", "9973", "--verify", "--check", "--json",
            "--pipeline-depth", "2", "--device", "cpu"]
    assert cli.main(args + ["--devices", "2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["n_devices"] == 2 and rec["extra"]["ingest_devices"] == 2
    assert rec["extra"]["exact_match"] is True and rec["extra"]["certificate_ok"] is True
    assert cli.main(args) == 0
    rec1 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec1["n_devices"] == 1 and rec1["extra"]["ingest_devices"] == 1
    assert rec1["answer"] == rec["answer"]


def _card_grid(chunks, ks, devices, **kw):
    S.reset_counts()
    got = kt.kselect_streaming_many(chunks, ks, collect_budget=64, pipeline_depth=2, devices=devices, **kw)
    return got, dict(S.LAUNCHES), S.PLAIN_CALLS["sweep_ingest"]


@pytest.mark.gpu
def test_two_slots_on_one_card(cuda_device, rng):  # noqa: F811
    """Two slots on ``cuda:0`` (a window of two bundles): the answers, the
    certificate and the sketch equal the CPU's, every chunk through the
    sweep kernel and none through its plain version."""
    x = _ints(rng, 1 << 20)
    chunks = _chunks(x, 16)
    ks = [1, x.size // 3, x.size // 2, x.size]
    want = kt.kselect_streaming_many(chunks, ks, collect_budget=64, pipeline_depth=0, **CPU)
    got, launches, plain = _card_grid(chunks, ks, ("cuda:0", "cuda:0"))
    assert got == want and launches["sweep_ingest32"] > 0 and plain == 0
    v = np.asarray(want[2])
    assert kt.streaming_rank_certificate(chunks, v, devices=("cuda:0", "cuda:0")) == \
        kt.streaming_rank_certificate(chunks, v, **CPU)
    assert kt.RadixSketch(np.int32).update_stream(chunks, devices=("cuda:0", "cuda:0")) == \
        kt.RadixSketch(np.int32, device="cpu").update_stream(chunks)


@pytest.mark.gpu
def test_launches_on_every_card(cuda_device, rng):  # noqa: F811
    """With two cards or more, ``devices=device_count()`` stages chunk j on
    card ``j % p`` and the sweep kernel runs there: each card's staged
    bytes rise and fall in the ledger, and the answers equal one card's."""
    from mpi_k_selection_tpu_torch.obs import LEDGER

    p = torch.cuda.device_count()
    if p < 2:
        pytest.skip("needs two cards or more")
    x = _ints(rng, 1 << 20)
    chunks = _chunks(x, 4 * p)
    ks = [1, x.size // 2]
    want = kt.kselect_streaming_many(chunks, ks, collect_budget=64, pipeline_depth=2)
    before = LEDGER.snapshot()["device_bytes_peak"]
    got, launches, plain = _card_grid(chunks, ks, p)
    assert got == want and plain == 0
    peaks = LEDGER.snapshot()["device_bytes_peak"]
    for i in range(p):
        assert peaks.get(f"staging/cuda:{i}", 0) > 0 or before.get(f"staging/cuda:{i}", 0) > 0
        assert LEDGER.device_bytes("staging").get(("staging", f"cuda:{i}"), 0) == 0
