"""The port's pooled host data plane and pooled spill decode against the
JAX package's (``tests/test_ingest_pool.py``), bit for bit.

``ingest_workers`` > 1 splits a pipelined pass into one puller (source
order, dtype checks, slots and fault indices fixed in pull order), a pool
of ``ksel-ingest-*`` workers (staging, the v1 tee's prepare) and a reorder
sequencer (chunks to the consumer and tee records to disk in chunk order);
under ``pack_spill="auto"`` the digit tee's host half runs on a
``ksel-ingest-tee-*`` pool, and ``SpillGeneration.iter_chunks(workers=)``
decodes records on ``ksel-ingest-decode-*`` threads. So answers,
certificates, sketches, monitor samples and spill generations are the same
bits at every width and in both packages. Every store is rooted in the
test's ``tmp_path``, every run is on ``device="cpu"``, and no
``ksel-ingest-*`` thread may be left afterwards.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import mpi_k_selection_tpu_torch as kt
from mpi_k_selection_tpu_torch.errors import SpillRecordError
from mpi_k_selection_tpu_torch.streaming import pipeline as pl
from mpi_k_selection_tpu_torch.streaming import spill as sp
from mpi_k_selection_tpu_torch.streaming.spill import SpillStore
from mpi_k_selection_tpu_torch.utils.profiling import PhaseTimer
from test_torch_faults import _fault_stream
from test_torch_monitor import records
from test_torch_sketch import same
from test_torch_spill import generation_files, jax_generation, jax_store, spill_dirs
from test_torch_streaming import bits, key_oracle, stream

torch.set_num_threads(1)

WIDTHS = (1, 2, 4, "auto")


def _chunks(x, nchunks):
    return [np.ascontiguousarray(c) for c in np.array_split(x, nchunks)]


def _ingest_threads() -> list:
    return [t.name for t in threading.enumerate() if t.name.startswith(pl.INGEST_THREAD_PREFIX)]


def _port_store(root, keep_all=True):
    store = SpillStore(str(root))
    if keep_all:
        store.drop_generation = lambda gen: None
    return store


def _jax_many(chunks, ks, store=None, **kw):
    from mpi_k_selection_tpu.streaming import streaming_kselect_many as ref_many
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    with enable_x64():
        got = ref_many(chunks, ks, **({} if store is None else dict(spill=store)), **kw)
    return [np.asarray(g).item() for g in got]


# -- the knob ---------------------------------------------------------------


def test_resolve_ingest_workers_contract():
    """None -> 1, ``"auto"`` -> min(4, cores), ints in [1, 64]; bools,
    floats and strings refused with the JAX package's messages; the phase
    names are the JAX package's."""
    from mpi_k_selection_tpu.streaming import pipeline as ref

    assert pl.resolve_ingest_workers(None) == 1
    auto = pl.resolve_ingest_workers("auto")
    assert auto == min(pl.INGEST_WORKERS_AUTO_CAP, os.cpu_count() or 1) == ref.resolve_ingest_workers("auto")
    assert pl.resolve_ingest_workers(np.int64(3)) == 3
    assert pl.resolve_ingest_workers(pl.MAX_INGEST_WORKERS) == pl.MAX_INGEST_WORKERS
    for junk in (0, pl.MAX_INGEST_WORKERS + 1, True, False, 2.0, "three"):
        with pytest.raises(ValueError, match="ingest_workers") as mine:
            pl.resolve_ingest_workers(junk)
        with pytest.raises(ValueError) as theirs:
            ref.resolve_ingest_workers(junk)
        assert str(mine.value) == str(theirs.value)
    assert (pl.INGEST_PHASES, pl.STALL_PHASE, pl.SEQ_WAIT_PHASE, pl.INGEST_THREAD_PREFIX) == (
        ref.INGEST_PHASES, ref.STALL_PHASE, ref.SEQ_WAIT_PHASE, ref.INGEST_THREAD_PREFIX)
    with pytest.raises(ValueError, match="ingest_workers"):
        kt.kselect_streaming([np.arange(8, dtype=np.int32)], 2, ingest_workers=0, device="cpu")


# -- bit equality across the widths ----------------------------------------


@pytest.mark.parametrize("pack_spill", ["off", "auto"])
def test_pool_bit_equality_grid(pack_spill, rng, tmp_path):
    """workers {1, 2, 4, "auto"} x depth {1, 2} x spill {off, force}: the
    answers of every leg equal NumPy's and the JAX package's at 4 workers,
    and with spill on every generation (kept on disk) is file for file
    the one of 1 worker and of the JAX package."""
    n = 1 << 13
    x = rng.integers(-(2**31), 2**31, size=n, dtype=np.int64).astype(np.int32)
    ks = [1, 1337, n // 2, n]
    want = key_oracle(x, ks)
    chunks = _chunks(x, 8)
    kw = dict(collect_budget=256, radix_bits=4, pack_spill=pack_spill)
    theirs = jax_store(tmp_path / "jax")
    theirs.drop_generation = lambda gen: None
    assert bits(_jax_many(chunks, ks, theirs, pipeline_depth=2, ingest_workers=4, **kw), x.dtype) == want
    ref_files = generation_files(theirs)
    theirs.close()
    assert len({f.split(os.sep)[0] for f in ref_files}) >= 2
    for depth in (1, 2):
        for spill in ("off", "force"):
            for workers in WIDTHS:
                root = tmp_path / f"{depth}-{spill}-{workers}"
                store = _port_store(root) if spill == "force" else "off"
                got = kt.kselect_streaming_many(chunks, ks, pipeline_depth=depth, ingest_workers=workers,
                                                spill=store, device="cpu", **kw)
                assert bits(got, x.dtype) == want, (depth, spill, workers)
                if spill == "force":
                    assert generation_files(store) == ref_files, (depth, workers)
                    store.close()
                assert not spill_dirs(root)
    assert not _ingest_threads()


@pytest.mark.parametrize("name", ["uint64", "float64", "int8", "bfloat16"])
def test_pool_other_dtypes(name, tmp_path):
    """64-bit and sub-32-bit streams (ties, NaNs, +-0.0) through a 4-wide
    pool, spilled or not: the answers of 1 worker, NumPy's and the JAX
    package's at 4 workers."""
    chunks = stream(name, seed=3, sizes=(700, 1, 0, 333, 512, 90))
    x = np.concatenate(chunks)
    ks = [7, x.size // 2, x.size]
    want = key_oracle(x, ks)
    assert bits(_jax_many(chunks, ks, spill="force", collect_budget=64, radix_bits=4, ingest_workers=4,
                          spill_dir=str(tmp_path)), x.dtype) == want
    for spill in ("off", "force"):
        for workers in (1, 4):
            got = kt.kselect_streaming_many(chunks, ks, spill=spill, collect_budget=64, radix_bits=4,
                                            ingest_workers=workers, spill_dir=str(tmp_path), device="cpu")
            assert bits(got, x.dtype) == want, (spill, workers)
    assert not spill_dirs(tmp_path) and not _ingest_threads()


def test_one_shot_source_under_pool(rng, tmp_path):
    """A one-shot generator through a 4-wide pool: the puller is its one
    reader, so it is read once, as at 1 worker (a second read would
    raise), and the answer is the JAX package's."""
    n = 1 << 13
    x = rng.integers(0, 1 << 62, size=n, dtype=np.int64).astype(np.uint64)
    pulls = []

    def gen():
        for c in _chunks(x, 8):
            pulls.append(threading.current_thread().name)
            yield c

    got = kt.kselect_streaming(gen(), 999, spill="force", collect_budget=128, ingest_workers=4,
                               spill_dir=str(tmp_path), device="cpu")
    assert bits([got], x.dtype) == key_oracle(x, [999])
    assert len(pulls) == 8 and len(set(pulls)) == 1 and pulls[0].startswith(pl.THREAD_NAME_PREFIX)
    theirs = _jax_many(iter(_chunks(x, 8)), [999], spill="force", collect_budget=128, ingest_workers=4,
                       spill_dir=str(tmp_path))
    assert bits(theirs, x.dtype) == bits([got], x.dtype)
    assert not spill_dirs(tmp_path) and not _ingest_threads()


def test_drifting_source_raises_with_workers_in_flight(rng, tmp_path):
    """A source whose dtype drifts at chunk 3 while workers are staging:
    the puller raises the JAX package's TypeError after the chunks before
    it, every thread is joined and no staged chunk is left booked."""
    from mpi_k_selection_tpu.streaming import streaming_kselect as ref_kselect

    good = rng.integers(-1000, 1000, size=4096, dtype=np.int64).astype(np.int32)
    chunks = _chunks(good, 6)
    chunks[3] = chunks[3].astype(np.float32)
    said = []
    staged = pl.live_staged_keys()  # other tests may hold staged chunks of their own
    for depth in (1, 2):
        with pytest.raises(TypeError, match="requires one dtype per stream") as mine:
            kt.kselect_streaming(chunks, 17, spill="force", collect_budget=64, ingest_workers=4,
                                 pipeline_depth=depth, spill_dir=str(tmp_path), device="cpu")
        said.append(str(mine.value))
        assert not _ingest_threads() and pl.live_staged_keys() == staged
    with pytest.raises(TypeError) as theirs:
        ref_kselect(chunks, 17, spill="force", collect_budget=64, ingest_workers=4, spill_dir=str(tmp_path))
    assert said == [str(theirs.value)] * 2
    assert not spill_dirs(tmp_path) and not _ingest_threads()


# -- the sequencer under skewed work ----------------------------------------


def test_sequencer_orders_spill_under_slow_worker(rng, tmp_path, monkeypatch):
    """Chunk 0 is 50x the others and its tee prepare sleeps, so at 4
    workers the later chunks finish first and wait for their turn: the
    records still land in pull order, and every generation equals, file
    for file, the one of 1 worker and the JAX package's at 4 workers."""
    big = rng.integers(-(2**31), 2**31, size=100_000, dtype=np.int64)
    small = [rng.integers(-(2**31), 2**31, size=2048, dtype=np.int64) for _ in range(7)]
    chunks = [c.astype(np.int32) for c in (big, *small)]
    x = np.concatenate(chunks)
    k = x.size // 2
    prepare = sp.SpillWriter.prepare

    def slow_first(self, keys, orig_dtype):
        if keys.size == big.size:
            time.sleep(0.2)
        return prepare(self, keys, orig_dtype)

    monkeypatch.setattr(sp.SpillWriter, "prepare", slow_first)
    files = {}
    for workers in (1, 4):
        timer = PhaseTimer()
        store = _port_store(tmp_path / f"w{workers}")
        got = kt.kselect_streaming(chunks, k, spill=store, collect_budget=64, radix_bits=4, ingest_workers=workers,
                                   timer=timer, device="cpu")
        assert bits([got], x.dtype) == key_oracle(x, [k])
        gen0 = store.generations[min(store.generations)]
        assert [r.chunk_index for r in gen0.records] == list(range(len(chunks)))
        assert [r.n_valid for r in gen0.records] == [c.size for c in chunks]
        files[workers] = generation_files(store)
        store.close()
        if workers > 1:  # the fast chunks waited for chunk 0's turn
            # one prepare a chunk on the pass-0 tee, and on the survivor tees after it
            assert timer.phases[pl.SEQ_WAIT_PHASE] > 0.1 and timer.counts["pipeline.pack"] > len(chunks)
        else:
            assert pl.SEQ_WAIT_PHASE not in timer.phases and "pipeline.pack" not in timer.phases
    theirs = jax_store(tmp_path / "jax")
    theirs.drop_generation = lambda gen: None
    _jax_many(chunks, [k], theirs, collect_budget=64, radix_bits=4, ingest_workers=4)
    assert files[1] == files[4] == generation_files(theirs)
    theirs.close()
    assert not _ingest_threads()


def test_digit_tee_pool_writes_in_chunk_order(rng, tmp_path, monkeypatch):
    """Under ``pack_spill="auto"`` the pass-0 tee's host half runs on the
    ``ksel-ingest-tee-*`` pool: with chunk 0's job slowed the records
    still land in chunk order, file for file the ones of 1 worker and of
    the JAX package; a write that fails (ENOSPC) reaches the caller as
    the typed error, with the pool joined and the store removed."""
    import errno

    from mpi_k_selection_tpu_torch.errors import SpillCapacityError

    chunks = [rng.integers(0, 1 << 30, size=m, dtype=np.int64).astype(np.int32) for m in (6000, 900, 1500, 700, 2000)]
    x = np.concatenate(chunks)
    k = x.size // 3
    segments = sp.digit_segments_from
    tee_threads = []

    def slow_first(counts, payload, digit_bits, total_bits):
        tee_threads.append(threading.current_thread().name)
        if int(counts.sum()) == chunks[0].size:
            time.sleep(0.2)
        return segments(counts, payload, digit_bits, total_bits)

    monkeypatch.setattr(sp, "digit_segments_from", slow_first)
    files = {}
    for workers in (1, 4):
        tee_threads.clear()
        store = _port_store(tmp_path / f"w{workers}")
        got = kt.kselect_streaming(chunks, k, spill=store, pack_spill="auto", collect_budget=64, radix_bits=4,
                                   ingest_workers=workers, device="cpu")
        assert bits([got], x.dtype) == key_oracle(x, [k])
        files[workers] = generation_files(store)
        store.close()
        prefix = pl.INGEST_THREAD_PREFIX + "-tee-"
        assert len(tee_threads) == len(chunks)
        assert all(t.startswith(prefix) for t in tee_threads) == (workers > 1)
    theirs = jax_store(tmp_path / "jax")
    theirs.drop_generation = lambda gen: None
    _jax_many(chunks, [k], theirs, pack_spill="auto", collect_budget=64, radix_bits=4, ingest_workers=4)
    assert files[1] == files[4] == generation_files(theirs)
    theirs.close()
    append = sp.SpillWriter.append_prepared

    def full_disk(self, prep, device_slot=None):
        if self.pack_digit_bits is not None and self._count == 2:
            raise OSError(errno.ENOSPC, "No space left on device")
        return append(self, prep, device_slot)

    monkeypatch.setattr(sp.SpillWriter, "append_prepared", full_disk)
    with pytest.raises(SpillCapacityError, match="teeing generation 0"):
        kt.kselect_streaming(iter(chunks), k, spill="auto", pack_spill="auto", ingest_workers=4,
                             spill_dir=str(tmp_path / "full"), device="cpu")
    assert not spill_dirs(tmp_path / "full") and not _ingest_threads()


def test_seeded_chaos_matches_jax_at_four_workers(tmp_path):
    """A seeded plan (a stalled pull, a staging raise retried in place, a
    stalled staging) at 4 workers on two slots with the spill store: the
    answer of a clean run, and ``injector.fired`` and the FaultEvent
    stream entry for entry the JAX package's under the same plan. Fault
    indices are fixed in pull order, so which attempt fails does not
    depend on the pool's scheduling; only the order in which two workers'
    firings land may differ, so the logs are compared sorted."""
    from mpi_k_selection_tpu import faults as jf
    from mpi_k_selection_tpu import obs as jobs
    from mpi_k_selection_tpu.streaming import streaming_kselect as ref_kselect
    from mpi_k_selection_tpu_torch import faults as f
    from mpi_k_selection_tpu_torch import obs as obs_lib

    rng = np.random.default_rng(23)
    chunks = [rng.integers(-(2**31), 2**31 - 1, m, np.int64).astype(np.int32) for m in (5000, 4096, 2048, 3000)]
    x = np.concatenate(chunks)
    k = x.size // 2
    out = []
    for fm, om, call in ((f, obs_lib, lambda *a, **kw: kt.kselect_streaming(*a, device="cpu", **kw)),
                         (jf, jobs, ref_kselect)):
        o = om.Observability.collecting()
        root = tmp_path / fm.__name__
        root.mkdir()
        plan = fm.FaultPlan.seeded(23, n_chunks=len(chunks), faults=4)
        policy = fm.RetryPolicy(sleeper=fm.VirtualSleeper())
        with fm.inject(plan, sleeper=fm.VirtualSleeper(), obs=o) as inj:
            got = call(inj.wrap_chunk_source(lambda: iter(chunks)), k, spill="force", devices=2, retry=policy,
                       radix_bits=4, collect_budget=64, ingest_workers=4, spill_dir=str(root), obs=o)
        order = lambda d: json.dumps(d, sort_keys=True, default=str)  # noqa: E731
        out.append((int(got), sorted(inj.fired, key=order), sorted(_fault_stream(o), key=order)))
        assert not spill_dirs(root)
    assert out[0][0] == int(np.sort(x, kind="stable")[k - 1])
    assert out[0] == out[1]
    assert {e["site"] for e in out[0][1]} == {"source", "stage"}
    assert not _ingest_threads()


# -- the pooled spill decode --------------------------------------------------


@pytest.mark.parametrize("mmap", [False, True], ids=["read", "mmap"])
def test_pooled_decode_matches_serial(mmap, tmp_path, rng, monkeypatch):
    """``iter_chunks(workers=4)`` decodes on ``ksel-ingest-decode-*``
    threads and yields the serial read's chunks in record order, whole and
    pruned by a segment filter (records left empty skipped as serially),
    on the heap and mmap routes; the JAX package's pooled read of the same
    files yields the same keys; a consumer that stops midway, or a store
    source through the descent, leaves no thread."""
    from mpi_k_selection_tpu.streaming.spill import SpillStore as JaxStore

    keys = rng.integers(0, 1 << 63, size=30_000, dtype=np.int64).astype(np.uint64)
    store = SpillStore(str(tmp_path / "port"))
    w = store.new_generation(pack_digit_bits=8)
    for part in np.array_split(np.sort(keys), 7):  # each record a narrow key range: a filter empties some
        w.append(part, np.uint64)
    v1 = store.new_generation()
    for part in np.array_split(keys, 5):
        v1.append(part, np.uint64)
    gen, gen_v1 = w.commit(), v1.commit()
    top = int(keys[0] >> np.uint64(60))
    theirs = JaxStore(str(tmp_path / "jax"))
    jgen = jax_generation(theirs, gen)
    read, readers = sp._read_record, []

    def reading(*a, **kw):
        readers.append(threading.current_thread().name)
        if len(readers) == 1:
            time.sleep(0.05)  # the other threads decode meanwhile
        return read(*a, **kw)

    monkeypatch.setattr(sp, "_read_record", reading)
    for g, specs in ((gen, None), (gen, ((4, top),)), (gen_v1, None)):
        serial = list(g.iter_chunks(mmap=mmap, filter_specs=specs))
        readers.clear()
        pooled = list(g.iter_chunks(mmap=mmap, filter_specs=specs, workers=4))
        assert len(readers) == len(g.records)
        assert all(n.startswith(pl.INGEST_THREAD_PREFIX + "-decode-") for n in readers) and len(set(readers)) > 1
        assert [c.chunk_index for c in pooled] == [c.chunk_index for c in serial]
        assert 0 < len(pooled) < len(g.records) if specs else len(pooled) == len(g.records)
        for s, p in zip(serial, pooled):
            assert s.keys.tobytes() == p.keys.tobytes() and s.device_slot == p.device_slot
        if g is gen:
            ref = list(jgen.iter_chunks(mmap=mmap, filter_specs=specs, workers=4))
            assert [c.keys.tobytes() for c in ref] == [c.keys.tobytes() for c in pooled]
    it = gen.iter_chunks(mmap=mmap, workers=3)
    next(it)
    it.close()  # abandoned midway
    assert not _ingest_threads()
    src = gen.as_source(workers=4)
    assert src.keywords["workers"] == 4 and gen.as_source() == gen.iter_chunks
    x = keys
    for workers in (1, 4):
        got = kt.kselect_streaming_many(store, [1, x.size // 2], ingest_workers=workers, device="cpu",
                                        pipeline_depth=workers % 3)
        assert bits(got, x.dtype) == key_oracle(x, [1, x.size // 2])
        cert = kt.streaming_rank_certificate(store, got[1], ingest_workers=workers, device="cpu")
        assert cert[0] < x.size // 2 <= cert[1]
    store.close()
    theirs.close()
    assert not _ingest_threads()


def test_pooled_decode_raises_corruption_in_order(tmp_path, rng):
    """A corrupt record raises SpillRecordError at its own turn, after the
    records before it, through the pool as serially, and the decode
    threads are joined on the raise; the descent's recovery ladder reads a
    store's corrupt generation again and rebuilds the answer."""
    keys = rng.integers(0, 1 << 62, size=8192, dtype=np.int64).astype(np.uint64)
    store = SpillStore(str(tmp_path))
    w = store.new_generation(pack_digit_bits=8)
    for part in np.array_split(keys, 4):
        w.append(part, np.uint64)
    gen = w.commit()
    rec = gen.records[2]
    data = bytearray(open(rec.path, "rb").read())
    data[-2] ^= 0xFF  # a byte inside the last segment's payload
    with open(rec.path, "wb") as f:
        f.write(data)
    for workers in (1, 4):
        got = []
        with pytest.raises(SpillRecordError, match="checksum"):
            for c in gen.iter_chunks(workers=workers):
                got.append(c.chunk_index)
        assert got == [0, 1]
        assert not _ingest_threads()
    with pytest.raises(SpillRecordError):
        kt.kselect_streaming(store, 5, ingest_workers=4, device="cpu")
    store.close()
    assert not _ingest_threads()


# -- every entry point that takes the knob ------------------------------------


def test_entry_points_bit_identical_across_widths(tmp_path):
    """``RadixSketch.update_stream`` (with a packed tee), ``refine``,
    ``StreamingQuantiles``, the certificate and the ``Monitor`` at widths
    1, 2, 4 and ``"auto"`` and depths 0 and 2: the sketches, the tee's
    generation file for file, answers and samples held against the JAX
    package's (its sketch tee at 4 workers) and NumPy's."""
    from mpi_k_selection_tpu import StreamingQuantiles as JaxQuantiles
    from mpi_k_selection_tpu.monitor import Monitor as JaxMonitor
    from mpi_k_selection_tpu.streaming.sketch import RadixSketch as JaxSketch

    chunks = stream("int32", seed=11, sizes=(900, 0, 1, 500, 700, 300, 64))
    x = np.concatenate(chunks)
    qs = [0.1, 0.5, 0.99]
    ref = JaxSketch(np.int32)
    theirs = jax_store(tmp_path / "jax")
    ref.update_stream(chunks, spill=theirs, pack_spill="auto", ingest_workers=4)
    ref_files = generation_files(theirs)
    theirs.close()
    want_q = bits(JaxQuantiles(np.int32).update_stream(chunks).refine_quantiles(qs, chunks), np.int32)
    want_m = records(JaxMonitor(window=3, emit_every=2).run(list(chunks), np.int32))
    k = x.size // 2
    vk = np.sort(x)[k - 1]
    for depth in (0, 2):
        for workers in WIDTHS:
            store = _port_store(tmp_path / f"{depth}-{workers}", keep_all=False)
            sk = kt.RadixSketch(np.int32, device="cpu").update_stream(
                chunks, pipeline_depth=depth, ingest_workers=workers, spill=store, pack_spill="auto")
            same(sk, ref)
            got = sk.refine(store, k, pipeline_depth=depth, ingest_workers=workers)
            assert bits([got], x.dtype) == key_oracle(x, [k])
            assert generation_files(store) == ref_files, (depth, workers)  # the sketch tee's generation 0
            store.close()
            tq = kt.StreamingQuantiles(np.int32, pipeline_depth=depth, ingest_workers=workers, device="cpu")
            assert bits(tq.update_stream(chunks).refine_quantiles(qs, chunks), np.int32) == want_q
            mon = kt.Monitor(window=3, emit_every=2, pipeline_depth=depth, ingest_workers=workers, device="cpu")
            assert records(mon.run(iter(chunks), np.int32)) == want_m
            assert kt.streaming_rank_certificate(chunks, vk, pipeline_depth=depth, ingest_workers=workers,
                                                 device="cpu") == (int(np.count_nonzero(x < vk)),
                                                                   int(np.count_nonzero(x <= vk)))
    assert not _ingest_threads() and not glob.glob(str(tmp_path / "*" / "ksel-spill-*"))


# -- observability -------------------------------------------------------------


def test_seq_wait_accounting_and_hidden_fracs(rng, tmp_path):
    """``pipeline.seq_wait`` is a phase of the pooled plane only and not
    ingest work; ``ingest_hidden_frac`` and ``encode_hidden_frac`` equal
    the JAX functions on the same phase sums (clamped, None without
    work), ``collect_hidden_frac`` on the same window occupancies, and a
    pooled pass records the puller's, the workers' and the consumer's
    phases."""
    from mpi_k_selection_tpu.streaming import pipeline as ref

    assert pl.SEQ_WAIT_PHASE not in pl.INGEST_PHASES
    assert {"pipeline.encode", "pipeline.pack", "pipeline.stage"} <= set(pl.INGEST_PHASES)

    class _T:
        def __init__(self, phases):
            self.phases = phases

    cases = [{}, {p: 1.0 for p in pl.INGEST_PHASES}, {pl.STALL_PHASE: 100.0, "pipeline.encode": 1.0},
             {"pipeline.produce": 2.0, pl.STALL_PHASE: 0.5}, {"pipeline.stage": 3.0, "pipeline.pack": 1.0,
                                                             pl.STALL_PHASE: 1.0, pl.SEQ_WAIT_PHASE: 9.0}]
    cases += [{p: float(v) for p, v in zip((*pl.INGEST_PHASES, pl.STALL_PHASE), rng.random(6) * 3)} for _ in range(8)]
    for phases in cases:
        for mine, theirs in ((pl.ingest_hidden_frac, ref.ingest_hidden_frac),
                             (pl.encode_hidden_frac, ref.encode_hidden_frac)):
            assert mine(_T(phases)) == theirs(_T(phases)), phases
    assert pl.encode_hidden_frac(_T({})) is None and pl.ingest_hidden_frac(_T({})) is None
    assert pl.encode_hidden_frac(_T({p: 1.0 for p in pl.INGEST_PHASES})) == 1.0
    assert pl.encode_hidden_frac(_T({"pipeline.encode": 1.0, pl.STALL_PHASE: 100.0})) == 0.0
    from mpi_k_selection_tpu.streaming.executor import collect_hidden_frac as ref_collect

    from mpi_k_selection_tpu_torch.streaming import collect_hidden_frac

    class _Occ:
        def __init__(self, count, mean):
            self.count, self.mean = count, mean

    for occ, window in ((None, 2), (_Occ(0, None), 4), (_Occ(5, 1.0), 1), (_Occ(5, 1.5), 2), (_Occ(9, 3.5), 4),
                        (_Occ(3, 9.0), 2)):
        assert collect_hidden_frac(occ, window) == ref_collect(occ, window)
    chunks = _chunks(rng.integers(0, 1 << 20, size=1 << 14).astype(np.int32), 8)
    for workers in (1, 4):
        timer = PhaseTimer()
        kt.kselect_streaming(chunks, 100, spill="force", ingest_workers=workers, timer=timer,
                             spill_dir=str(tmp_path), device="cpu")
        names = set(timer.phases)
        assert {"pipeline.produce", "pipeline.encode", "pipeline.stage", "pipeline.spill", pl.STALL_PHASE} <= names
        assert ({pl.SEQ_WAIT_PHASE, "pipeline.pack"} <= names) == (workers > 1)
        assert 0.0 <= pl.ingest_hidden_frac(timer) <= 1.0 and 0.0 <= pl.encode_hidden_frac(timer) <= 1.0
    assert not spill_dirs(tmp_path) and not _ingest_threads()


def test_cli_records_ingest_hidden_frac_like_the_jax_cli(tmp_path, capsys):
    """``--streaming --profile`` (and ``--metrics-json``) records
    ``ingest_hidden_frac`` beside ``pipeline_phases`` and prints it, as
    the JAX CLI does on the same chunks, at 1 and 4 workers."""
    from mpi_k_selection_tpu.cli import main as jax_main

    from mpi_k_selection_tpu_torch import cli

    base = ["--streaming", "--n", "40000", "--chunk-elems", "8192", "--pipeline-depth", "2", "--spill", "force",
            "--spill-dir", str(tmp_path)]
    for workers in ("1", "4"):
        recs = []
        for main, extra in ((cli.main, ["--device", "cpu"]), (jax_main, [])):
            assert main(base + ["--ingest-workers", workers, "--profile", "--json", *extra]) == 0
            recs.append(json.loads([ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")][-1]))
        mine, theirs = recs
        assert mine["answer"] == theirs["answer"]
        for rec in recs:
            assert 0.0 <= rec["extra"]["ingest_hidden_frac"] <= 1.0
            assert rec["extra"]["ingest_hidden_frac"] == round(rec["extra"]["ingest_hidden_frac"], 4)
        assert (pl.SEQ_WAIT_PHASE in mine["extra"]["pipeline_phases"]) == (workers == "4")
        assert cli.main(base + ["--ingest-workers", workers, "--profile", "--device", "cpu"]) == 0
        assert "ingest_hidden_frac" in capsys.readouterr().out
    metrics = tmp_path / "m.json"
    assert cli.main(base + ["--ingest-workers", "4", "--metrics-json", str(metrics), "--json", "--device", "cpu"]) == 0
    rec = json.loads([ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")][-1])
    assert 0.0 <= rec["extra"]["ingest_hidden_frac"] <= 1.0
    assert not spill_dirs(tmp_path) and not _ingest_threads()
