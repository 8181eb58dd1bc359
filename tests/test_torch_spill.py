"""The port's survivor spill store (``streaming/spill.py``) and spill
descent against the JAX package, bit for bit.

The same seeded numpy chunks go to both packages: answers in every spill
mode, the pass logs entry by entry, and the generations themselves, file
for file, read across packages in both directions. Corrupt, truncated and
missing records raise the typed error, the re-read/rebuild ladder and the
ENOSPC rung answer as the JAX package's do, and caller-owned stores keep
their generation 0 for the sketch-then-refine flow.

Stores are rooted in each test's ``tmp_path`` (``spill_dir=``), and each
test checks that its root holds no ``ksel-spill-*`` directory after the
call; only the lifecycle tests of the default root (success, consumer
raise, producer raise, bad k) use the temp dir, under the conftest's own
leak check. The JAX package is imported inside the tests, so the ``gpu``
tests also collect where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_*.py -m gpu
"""

from __future__ import annotations

import errno
import glob
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import mpi_k_selection_tpu_torch as kt
from mpi_k_selection_tpu_torch.errors import SpillCapacityError, SpillError, SpillRecordError
from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
from mpi_k_selection_tpu_torch.streaming import chunked
from mpi_k_selection_tpu_torch.streaming import spill as sp
from mpi_k_selection_tpu_torch.streaming.sketch import LATER_KNOBS, RadixSketch
from mpi_k_selection_tpu_torch.streaming.spill import SpillStore
from mpi_k_selection_tpu_torch.utils import dtypes as dt
from test_torch_streaming import (  # noqa: F401 (a fixture)
    DTYPES, N_TEE_CASES, bits, cuda_device, key_oracle, stream, tee_cases,
)

NARROW = dict(radix_bits=4, collect_budget=64)  # several passes, so several generations


def spill_dirs(root) -> list:
    return glob.glob(os.path.join(str(root), sp.SPILL_DIR_PREFIX + "*"))


def seq_keys(x, ks):
    """The reference's ``backends/seq.py`` sort-then-index oracle, run on
    the sortable keys, as raw bytes of the k-th values."""
    from mpi_k_selection_tpu.backends import seq

    keys = dt.np_to_sortable_bits(x)
    picked = np.array([seq.kselect_sort(keys, k) for k in ks], keys.dtype)
    return dt.np_from_sortable_bits(picked, x.dtype).tobytes()


def jax_store(root):
    from mpi_k_selection_tpu.streaming.spill import SpillStore as JaxStore

    return JaxStore(str(root))


def port_generation(store, jax_gen):
    """A JAX generation's records as a generation of the port's ``store``
    (the same files)."""
    recs = tuple(sp.SpillRecord(
        path=r.path, chunk_index=r.chunk_index, n_valid=r.n_valid, bucket=r.bucket, device_slot=r.device_slot,
        key_dtype=r.key_dtype, orig_dtype=r.orig_dtype, crc32=r.crc32, nbytes=r.nbytes, version=r.version,
        segments=r.segments,
    ) for r in jax_gen.records)
    gen = sp.SpillGeneration(store, jax_gen.index, jax_gen.path, recs)
    store._register(gen)
    store._counter = max(store._counter, gen.index + 1)
    return gen


def jax_generation(store, port_gen):
    """The port's generation as a generation of a JAX ``store``."""
    from mpi_k_selection_tpu.streaming import spill as jsp

    recs = tuple(jsp.SpillRecord(
        path=r.path, chunk_index=r.chunk_index, n_valid=r.n_valid, bucket=r.bucket, device_slot=r.device_slot,
        key_dtype=r.key_dtype, orig_dtype=r.orig_dtype, crc32=r.crc32, nbytes=r.nbytes, version=r.version,
        segments=r.segments,
    ) for r in port_gen.records)
    gen = jsp.SpillGeneration(store, port_gen.index, port_gen.path, recs)
    store.generations[gen.index] = gen
    store._counter = max(store._counter, gen.index + 1)
    return gen


def generation_files(store) -> dict:
    """``{gen dir/record file: bytes}`` of every generation on disk."""
    out = {}
    for path in sorted(glob.glob(os.path.join(store.root, "gen-*", "*"))):
        with open(path, "rb") as f:
            out[os.path.relpath(path, store.root)] = f.read()
    return out


def test_prefix_errors_and_knobs_match_jax(tmp_path):
    """The spill dir prefix is the JAX registry's (so the conftest leak
    check covers the port's stores); the error classes nest as the JAX
    package's; ``spill`` and ``pack_spill`` are ported (the format-v2
    constants are the JAX package's), and so are ``devices``, ``obs`` and
    ``timer``: a sketch tee with each equals the JAX package's records
    file for file, while ``retry``, a knob of the descent only, raises the
    JAX package's own plain TypeError on the sketch tee."""
    from mpi_k_selection_tpu import errors as jerr
    from mpi_k_selection_tpu.resource_protocols import SPILL_DIR_PREFIX
    from mpi_k_selection_tpu.streaming import spill as jsp

    assert sp.SPILL_DIR_PREFIX == SPILL_DIR_PREFIX
    assert sp.SPILL_MODES == jsp.SPILL_MODES
    assert (sp._MAGIC, sp._VERSION, sp._VERSION_PACKED, sp._HEADER.format) == (
        jsp._MAGIC, jsp._VERSION, jsp._VERSION_PACKED, jsp._HEADER.format)
    assert (sp.PACK_SPILL_MODES, sp._SEG_COUNT.format, sp._SEG_ENTRY.format, sp.GEN0_SEGMENT_BITS) == (
        jsp.PACK_SPILL_MODES, jsp._SEG_COUNT.format, jsp._SEG_ENTRY.format, jsp.GEN0_SEGMENT_BITS)
    assert chunked.DEFAULT_SPILL == "auto"
    for mine, theirs in ((SpillError, jerr.SpillError), (SpillRecordError, jerr.SpillRecordError),
                         (SpillCapacityError, jerr.SpillCapacityError)):
        assert mine.__name__ == theirs.__name__
        assert [c.__name__ for c in mine.__mro__] == [c.__name__ for c in theirs.__mro__]
    assert not {"spill", "pack_spill", "width_schedule", "retry"} & set(LATER_KNOBS)
    a = [np.arange(3, dtype=np.int32)]
    with SpillStore(str(tmp_path)) as store:
        RadixSketch(np.int32, device="cpu").update_stream(a, spill=store, pack_spill="auto")
        assert store.latest_generation().keys == 3
    from mpi_k_selection_tpu.streaming.sketch import RadixSketch as JaxSketch

    from mpi_k_selection_tpu_torch import obs as obs_lib
    from mpi_k_selection_tpu_torch.utils.profiling import PhaseTimer

    two = a + [np.arange(-4, 0, dtype=np.int32)]
    with jax_store(tmp_path / "jax") as js:
        JaxSketch(np.int32).update_stream(two, spill=js, devices=2)
        want = generation_files(js)
    for knob, value in (("devices", 2), ("obs", obs_lib.Observability.collecting()), ("timer", PhaseTimer())):
        with SpillStore(str(tmp_path / knob)) as store:
            RadixSketch(np.int32, device="cpu").update_stream(two, spill=store, **{"devices": 2, knob: value})
            assert generation_files(store) == want
    said = []
    for sketch in (RadixSketch(np.int32, device="cpu"), JaxSketch(np.int32)):
        with pytest.raises(TypeError) as ei:
            sketch.update_stream(a, retry=None)
        said.append(str(ei.value))
    assert said[0] == said[1] == "RadixSketch.update_stream() got an unexpected keyword argument 'retry'"
    with pytest.raises(TypeError, match="SpillStore"):
        RadixSketch(np.int32, device="cpu").update_stream(a, spill="force")
    for bad in ("always", True):
        with pytest.raises(ValueError, match="spill must be one of"):
            kt.kselect_streaming(a, 1, spill=bad, device="cpu")
    s = SpillStore(str(tmp_path))
    s.close()
    with pytest.raises(SpillError, match="closed"):
        sp.validate_spill_mode(s)
    assert not spill_dirs(tmp_path)


@pytest.mark.parametrize("name", DTYPES)
def test_spill_modes_match_jax_and_seq(name, tmp_path):
    """Every spill mode at depth 0 and 2, with the default knobs and with
    4-bit digits and a 64-survivor budget, over list chunks and (spill on)
    a one-shot generator: the same bits as NumPy's key order,
    ``backends/seq.py`` and the JAX package in the same modes."""
    from mpi_k_selection_tpu.streaming import streaming_kselect_many as ref_many
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    chunks = stream(name, seed=3)
    x = np.concatenate(chunks)
    n = x.size
    ks = [1, n // 3, n // 2, n]
    want = key_oracle(x, ks)
    assert seq_keys(x, ks) == want
    with enable_x64():
        for spill in ("off", "force"):
            assert bits(ref_many(chunks, ks, spill=spill, spill_dir=str(tmp_path), **NARROW), x.dtype) == want
    for depth in (0, 2):
        for spill in ("off", "auto", "force"):
            for kw in ({}, NARROW):
                got = kt.kselect_streaming_many(chunks, ks, pipeline_depth=depth, spill=spill,
                                                spill_dir=str(tmp_path), device="cpu", **kw)
                assert bits(got, x.dtype) == want, (depth, spill, kw)
            if spill != "off":
                got = kt.kselect_streaming_many((c for c in chunks), ks, pipeline_depth=depth, spill=spill,
                                                spill_dir=str(tmp_path), device="cpu", **NARROW)
                assert bits(got, x.dtype) == want, (depth, spill, "one-shot")
    assert not spill_dirs(tmp_path)


def _spilled(pkg, chunks, ks, root, depth, keep_all=False, **kw):
    """A descent of ``pkg`` ("port" or "jax") into a caller-owned store:
    ``(answers, store)``; ``keep_all`` keeps every generation on disk."""
    if pkg == "port":
        store = SpillStore(str(root))
        if keep_all:
            store.drop_generation = lambda gen: None
        return kt.kselect_streaming_many(chunks, ks, spill=store, pipeline_depth=depth, device="cpu", **kw), store
    from mpi_k_selection_tpu.streaming import streaming_kselect_many as ref_many
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    store = jax_store(root)
    if keep_all:
        store.drop_generation = lambda gen: None
    with enable_x64():
        return ref_many(chunks, ks, spill=store, pipeline_depth=depth, **kw), store


@pytest.mark.parametrize("name", ["int8", "uint16", "int32", "float32", "int64", "float64"])
@pytest.mark.parametrize("depth", [0, 2])
def test_pass_log_and_generations_match_jax(name, depth, tmp_path):
    """Into caller-owned stores, on the same input: the pass log entry by
    entry, and every generation (kept on disk) file for file, byte for
    byte; afterwards each store holds generation 0 alone."""
    chunks = stream(name, seed=5, sizes=(900, 0, 1, 500, 700))
    x = np.concatenate(chunks)
    ks = [2, x.size // 2]
    got, mine = _spilled("port", chunks, ks, tmp_path / "port", depth, keep_all=True, **NARROW)
    want, theirs = _spilled("jax", chunks, ks, tmp_path / "jax", depth, keep_all=True, **NARROW)
    assert bits(got, x.dtype) == bits(want, x.dtype) == key_oracle(x, ks)
    assert len(mine.pass_log) >= 3 and mine.pass_log == theirs.pass_log
    files = generation_files(mine)
    written = [e for e in mine.pass_log if "keys_written" in e]  # a generation a histogram pass
    assert len({f.split(os.sep)[0] for f in files}) == len(written) >= 2
    assert files == generation_files(theirs)
    mine.close()
    theirs.close()
    _, mine = _spilled("port", chunks, ks, tmp_path / "port", depth, **NARROW)
    assert list(mine.generations) == [0] and mine.latest_generation().keys == x.size
    mine.close()
    assert not spill_dirs(tmp_path / "port")


@pytest.mark.parametrize("name", ["uint8", "int32", "bfloat16", "uint64"])
def test_each_package_reads_the_others_generation(name, tmp_path):
    """Generation 0 written by one package is a source of the other: its
    chunks hold the same keys, and a descent and a certificate over it
    answer as over the stream. (The port reads bfloat16 records back
    through their ``<V2`` dtype tag; the JAX package's own reader does not,
    and its ladder then rebuilds from the source.)"""
    from mpi_k_selection_tpu.streaming import streaming_kselect as ref_select
    from mpi_k_selection_tpu.streaming import streaming_rank_certificate as ref_cert
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    chunks = stream(name, seed=7, sizes=(600, 0, 400))
    x = np.concatenate(chunks)
    k = x.size // 2
    want = key_oracle(x, [k])
    mine = SpillStore(str(tmp_path / "port"))
    theirs = jax_store(tmp_path / "jax")
    kt.kselect_streaming(chunks, k, spill=mine, device="cpu", **NARROW)
    with enable_x64():
        ref_select(chunks, k, spill=theirs, **NARROW)
    host = [dt.np_to_sortable_bits(c) for c in chunks if c.size]
    # the port reads the JAX generation
    reader = SpillStore(str(tmp_path / "port"))
    gen = port_generation(reader, theirs.latest_generation())
    assert [c.keys.tobytes() for c in gen.iter_chunks()] == [h.tobytes() for h in host]
    assert bits([kt.kselect_streaming(reader, k, device="cpu", **NARROW)], x.dtype) == want
    less, leq = kt.streaming_rank_certificate(reader, np.frombuffer(want, x.dtype)[0], device="cpu")
    assert less < k <= leq
    # the JAX package reads the port's generation
    jreader = jax_store(tmp_path / "jax")
    jgen = jax_generation(jreader, mine.latest_generation())
    if name != "bfloat16":
        assert [c.keys.tobytes() for c in jgen.iter_chunks()] == [h.tobytes() for h in host]
        with enable_x64():
            assert bits([ref_select(jreader, k, **NARROW)], x.dtype) == want
            assert tuple(int(c) for c in ref_cert(jreader, np.frombuffer(want, x.dtype)[0])) == (less, leq)
    else:
        from mpi_k_selection_tpu.errors import SpillRecordError as JaxRecordError

        with pytest.raises(JaxRecordError, match="header does not match"):
            list(jgen.iter_chunks())
    for s in (mine, theirs, reader, jreader):
        s.close()
    assert not spill_dirs(tmp_path / "port") and not spill_dirs(tmp_path / "jax")


def test_port_refuses_a_packed_generation(tmp_path):
    """A JAX ``pack_spill="auto"`` generation (format v2), once refused, is
    now read: its keys are the JAX package's own read of it, whole and
    pruned, and descents over it (replayed, spill-forced, packed) answer
    as over the stream."""
    from mpi_k_selection_tpu.streaming import streaming_kselect as ref_select

    chunks = stream("int32", seed=9, sizes=(4000, 4000))
    x = np.concatenate(chunks)
    theirs = jax_store(tmp_path)
    ref_select(chunks, 100, spill=theirs, pack_spill="auto", **NARROW)
    jgen = theirs.latest_generation()
    assert any(r.version == 2 for r in jgen.records)
    reader = SpillStore(str(tmp_path))
    gen = port_generation(reader, jgen)
    assert gen.packed and gen.nbytes == jgen.nbytes < gen.logical_nbytes
    for specs in (None, ((8, 0x80),), ((4, 0x8), (12, 0x7FF))):
        assert [c.keys.tobytes() for c in gen.iter_chunks(filter_specs=specs)] == [
            c.keys.tobytes() for c in jgen.iter_chunks(filter_specs=specs)]
        assert (gen.read_keys(specs), gen.read_nbytes(specs)) == (jgen.read_keys(specs), jgen.read_nbytes(specs))
    want = key_oracle(x, [100])
    for kw in ({}, {"spill": "force", "spill_dir": str(tmp_path)}, {"pack_spill": "auto", "width_schedule": "auto"}):
        assert bits([kt.kselect_streaming(reader, 100, device="cpu", **NARROW, **kw)], x.dtype) == want, kw
    theirs.close()
    reader.close()
    assert not spill_dirs(tmp_path)


def test_one_shot_sources_match_jax(tmp_path):
    """A one-shot generator answers under ``auto`` and ``force`` (and its
    source is read once); under ``off`` both packages refuse it with the
    same message; a source that changes between reads fails the replay
    check under ``off`` and answers its first snapshot under ``force``, in
    both packages."""
    from mpi_k_selection_tpu.streaming import streaming_kselect as ref_select

    chunks = stream("int32", seed=11, sizes=(3000, 2000, 3192))
    x = np.concatenate(chunks)
    k = x.size // 2
    calls = []

    def once():
        calls.append(1)
        return iter(chunks)

    got = kt.kselect_streaming(once, k, spill="force", spill_dir=str(tmp_path), device="cpu", **NARROW)
    assert bits([got], x.dtype) == key_oracle(x, [k]) and len(calls) == 1
    kt.kselect_streaming(once, k, spill="off", device="cpu", **NARROW)
    assert len(calls) > 2  # the replay path reads it once a pass
    msg = "let the spill store serve the later passes"
    for select in (lambda s, k, **kw: kt.kselect_streaming(s, k, device="cpu", **kw), ref_select):
        with pytest.raises(TypeError, match=msg):
            select((c for c in chunks), k, spill="off")

    def drifting():
        drifting.n += 1
        r = np.random.default_rng(drifting.n)
        return iter([r.integers(-(2**31), 2**31, size=4096, dtype=np.int64).astype(np.int32)])

    first = np.random.default_rng(1).integers(-(2**31), 2**31, size=4096, dtype=np.int64).astype(np.int32)
    for select in (lambda s, **kw: kt.kselect_streaming(s, 2048, device="cpu", **kw),
                   lambda s, **kw: ref_select(s, 2048, **kw)):
        drifting.n = 0
        with pytest.raises(RuntimeError, match="replay-stable"):
            select(drifting, spill="off", collect_budget=64)
        drifting.n = 0
        got = select(drifting, spill="force", spill_dir=str(tmp_path), collect_budget=64)
        assert drifting.n == 1 and bits([got], np.int32) == key_oracle(first, [2048])
    assert not spill_dirs(tmp_path)


def _corrupt_first_record(gen, how):
    rec = gen.records[0]
    if how == "missing":
        os.unlink(rec.path)
        return
    with open(rec.path, "rb") as f:
        data = bytearray(f.read())
    if how == "truncated":
        data = data[:-7]
    else:
        data[-3] ^= 0xFF  # one payload byte
    with open(rec.path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("how, match", [("corrupt", "checksum"), ("truncated", "truncated"),
                                        ("missing", "unreadable")])
def test_damaged_records_raise_before_a_key_is_counted(how, match, tmp_path):
    """A damaged record of a store's only generation: reading it raises
    SpillRecordError (no chunk of it reaches a consumer), and so do a
    descent and a certificate over the store (the ladder has nothing else
    to rebuild from), as in the JAX package."""
    from mpi_k_selection_tpu.errors import SpillRecordError as JaxRecordError
    from mpi_k_selection_tpu.streaming import streaming_kselect as ref_select

    chunks = stream("int32", seed=13, sizes=(1000, 1000, 1000))
    store = SpillStore(str(tmp_path))
    kt.kselect_streaming(chunks, 7, spill=store, device="cpu", **NARROW)
    gen = store.latest_generation()
    _corrupt_first_record(gen, how)
    with pytest.raises(SpillRecordError, match=match):
        next(gen.iter_chunks())
    S.reset_counts()
    with pytest.raises(SpillRecordError, match=match):
        kt.kselect_streaming(store, 7, device="cpu", **NARROW)
    with pytest.raises(SpillRecordError, match=match):
        kt.streaming_rank_certificate(store, 0, device="cpu")
    assert S.PLAIN_CALLS["sweep_ingest"] == 0  # the damaged record comes first: nothing was counted
    jreader = jax_store(tmp_path)
    jax_generation(jreader, gen)
    with pytest.raises(JaxRecordError, match=match):
        ref_select(jreader, 7, **NARROW)
    store.close()
    jreader.close()
    assert not spill_dirs(tmp_path)


@pytest.mark.parametrize("failures", ["once", "persistent"])
@pytest.mark.parametrize("one_shot", [False, True])
def test_recovery_ladder_matches_jax(failures, one_shot, tmp_path, monkeypatch):
    """Records of generation 1 fail validation: once (read again, then
    they serve), or on every read (the pass is rebuilt from the replayable
    source, or a one-shot run's generation 0). The answer stays exact,
    and the pass log (what each pass read) equals the JAX package's under
    the same failures."""
    from mpi_k_selection_tpu import errors as jerr
    from mpi_k_selection_tpu.streaming import spill as jsp
    from mpi_k_selection_tpu.streaming import streaming_kselect as ref_select

    chunks = stream("float32", seed=15, sizes=(2000, 1500, 2500))
    x = np.concatenate(chunks)
    k = x.size // 3
    logs = []
    for pkg, mod, err, select in (
        ("port", sp, SpillRecordError, lambda s, st: kt.kselect_streaming(s, k, spill=st, device="cpu", **NARROW)),
        ("jax", jsp, jerr.SpillRecordError, lambda s, st: ref_select(s, k, spill=st, **NARROW)),
    ):
        real = mod._read_record
        seen = {"reads": 0}

        def flaky(rec, *a, _real=real, _err=err, _seen=seen, **kw):
            if os.sep + "gen-0001" + os.sep in rec.path:
                _seen["reads"] += 1
                if failures == "persistent" or _seen["reads"] == 1:
                    raise _err(f"spill record {rec.path}: checksum mismatch (corrupt payload)")
            return _real(rec, *a, **kw)

        monkeypatch.setattr(mod, "_read_record", flaky)
        store = SpillStore(str(tmp_path / pkg)) if pkg == "port" else jax_store(tmp_path / pkg)
        got = select((c for c in chunks) if one_shot else chunks, store)
        assert bits([got], x.dtype) == key_oracle(x, [k]), pkg
        logs.append([{key: e[key] for key in ("pass", "read", "keys_read")} for e in store.pass_log])
        store.close()
    assert logs[0] == logs[1]
    reads = [e["read"] for e in logs[0]]
    assert reads[0] == "source" and reads[1] == "spill"
    assert reads[2] == ("spill" if failures == "once" or one_shot else "source")


def test_enospc_degrades_auto_and_raises_otherwise(tmp_path, monkeypatch):
    """ENOSPC while teeing generation 1 degrades ``auto`` (a one-shot
    source) to replaying generation 0, with a RuntimeWarning and the same
    answer; it raises SpillCapacityError under ``force`` and a caller's
    store, and while teeing generation 0 in every mode, as in the JAX
    package; no store is left behind."""
    from mpi_k_selection_tpu import errors as jerr
    from mpi_k_selection_tpu.streaming import spill as jsp
    from mpi_k_selection_tpu.streaming import streaming_kselect as ref_select

    chunks = stream("int64", seed=17, sizes=(1500, 1500))
    x = np.concatenate(chunks)
    k = x.size // 2
    want = key_oracle(x, [k])
    for mod, cap, select in (
        (sp, SpillCapacityError, lambda s, **kw: kt.kselect_streaming(s, k, device="cpu", **NARROW, **kw)),
        (jsp, jerr.SpillCapacityError, lambda s, **kw: ref_select(s, k, **NARROW, **kw)),
    ):
        real = mod.SpillWriter.append_prepared

        def full(self, prep, device_slot=None, _real=real):
            if self.index >= full.from_gen:
                raise OSError(errno.ENOSPC, "No space left on device")
            return _real(self, prep, device_slot=device_slot)

        monkeypatch.setattr(mod.SpillWriter, "append_prepared", full)
        full.from_gen = 1
        with pytest.warns(RuntimeWarning, match="ENOSPC"):
            got = select((c for c in chunks), spill_dir=str(tmp_path))
        assert bits([got], x.dtype) == want
        with pytest.raises(cap, match="explicitly"):
            select(chunks, spill="force", spill_dir=str(tmp_path))
        full.from_gen = 0
        with pytest.raises(cap, match="generation 0"):
            select((c for c in chunks), spill_dir=str(tmp_path))
        monkeypatch.undo()
    assert not spill_dirs(tmp_path)


def test_caller_store_keeps_generation_0(tmp_path):
    """A caller-owned store keeps its pass-0 generation alone: it serves
    the rank certificate (equal to NumPy's), a second descent of another
    rank and a spill-forced descent, never re-reading the stream."""
    chunks = stream("uint32", seed=19, sizes=(3000, 3000, 2192))
    x = np.concatenate(chunks)
    k = x.size // 2
    with SpillStore(str(tmp_path)) as store:
        got = kt.kselect_streaming(iter(chunks), k, spill=store, device="cpu", **NARROW)
        assert bits([got], x.dtype) == key_oracle(x, [k])
        assert list(store.generations) == [0]
        gen0 = store.latest_generation()
        assert gen0.keys == x.size and gen0.nbytes == x.nbytes
        keys = dt.np_to_sortable_bits(x)
        vkey = dt.np_to_sortable_bits(np.asarray([got]))[0]
        assert kt.streaming_rank_certificate(store, got, device="cpu") == (
            int((keys < vkey).sum()), int((keys <= vkey).sum()))
        for spill in ("auto", "force", "off"):
            assert bits([kt.kselect_streaming(store, 17, spill=spill, spill_dir=str(tmp_path), device="cpu",
                                              **NARROW)], x.dtype) == key_oracle(x, [17])
        assert store.latest_generation() is gen0 and list(store.generations) == [0]
    assert not spill_dirs(tmp_path)


@pytest.mark.parametrize("name", ["int16", "float32", "float64"])
def test_sketch_tee_then_refine(name, tmp_path):
    """``RadixSketch.update_stream(one_shot, spill=store)`` then
    ``refine``/``refine_many`` from the store (repeatable: generation 0
    survives), and ``StreamingQuantiles``' spill flow: the answers of the
    JAX package's flows and NumPy's, bit for bit; the tee is the JAX
    package's generation byte for byte."""
    from mpi_k_selection_tpu.api import StreamingQuantiles as JaxTracker
    from mpi_k_selection_tpu.api import quantile_ranks
    from mpi_k_selection_tpu.streaming.sketch import RadixSketch as JaxSketch
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    chunks = stream(name, seed=21, sizes=(1500, 0, 1700, 900))
    x = np.concatenate(chunks)
    ks = [1, x.size // 2, x.size]
    with SpillStore(str(tmp_path / "port")) as store:
        sk = RadixSketch(x.dtype, device="cpu").update_stream(iter(chunks), pipeline_depth=2, spill=store)
        assert sk.n == x.size
        for _ in range(2):
            assert bits([sk.refine(store, k, collect_budget=16) for k in ks], x.dtype) == key_oracle(x, ks)
        assert bits(sk.refine_many(store, ks, collect_budget=16), x.dtype) == key_oracle(x, ks)
        assert list(store.generations) == [0]
        with jax_store(tmp_path / "jax") as theirs, enable_x64():
            JaxSketch(x.dtype).update_stream(iter(chunks), pipeline_depth=2, spill=theirs)
            assert generation_files(store) == generation_files(theirs)
    qs = [0.1, 0.5, 0.99]
    want = key_oracle(x, quantile_ranks(qs, x.size))
    with SpillStore(str(tmp_path / "port")) as store:
        t = kt.StreamingQuantiles(x.dtype, device="cpu").update_stream(iter(chunks), spill=store)
        assert bits(t.refine_quantiles(qs, store), x.dtype) == want
    with jax_store(tmp_path / "jax") as theirs, enable_x64():
        t = JaxTracker(x.dtype).update_stream(iter(chunks), spill=theirs)
        assert bits(t.refine_quantiles(qs, theirs), x.dtype) == want
    assert not spill_dirs(tmp_path / "port") and not spill_dirs(tmp_path / "jax")


def test_store_api_lifecycle(tmp_path):
    """The store and writer surface: an empty store, a commit, a write
    after it, reading, dropping, an abort (idempotent), close (idempotent),
    as the JAX package's."""
    store = SpillStore(str(tmp_path))
    with pytest.raises(SpillError, match="no committed generation"):
        store.latest_generation()
    w = store.new_generation()
    w.append(np.arange(8, dtype=np.uint32), np.int32, device_slot=None)
    gen = w.commit()
    with pytest.raises(SpillError, match="committed/aborted"):
        w.append(np.arange(8, dtype=np.uint32), np.int32)
    assert store.latest_generation() is gen
    assert gen.keys == 8 and gen.nbytes == gen.logical_nbytes == gen.read_nbytes(((4, 0),)) == 32
    [chunk] = list(gen.iter_chunks())
    [mapped] = list(gen.iter_chunks(mmap=True))
    assert chunk.device_slot is None and chunk.orig_dtype == np.dtype(np.int32) and chunk.bucket == 8
    np.testing.assert_array_equal(chunk.keys, np.arange(8, dtype=np.uint32))
    np.testing.assert_array_equal(mapped.keys, chunk.keys)
    w2 = store.new_generation()
    w2.append(np.arange(3, dtype=np.uint64), np.float64, device_slot=0)
    path = w2.path
    assert os.listdir(path)
    w2.abort()
    w2.abort()
    assert not os.path.exists(path)
    store.drop_generation(gen)
    with pytest.raises(SpillError, match="dropped"):
        list(gen.iter_chunks())
    store.close()
    store.close()
    with pytest.raises(SpillError, match="closed"):
        store.new_generation()
    assert not spill_dirs(tmp_path)


def test_bad_source_leaves_no_store(tmp_path):
    """A source of an unsupported type is refused after the store is made:
    the store is removed all the same (the JAX package leaves its
    directory behind here)."""
    for spill in ("force", "auto"):
        with pytest.raises(TypeError, match="unsupported chunk source type 'int'"):
            kt.kselect_streaming(5, 1, spill=spill, spill_dir=str(tmp_path), device="cpu")
    assert not spill_dirs(tmp_path)


# -- the default root, under the conftest's own leak check -------------------


def _temp_spill_dirs():
    return set(spill_dirs(tempfile.gettempdir()))


def test_internal_store_removed_on_success():
    before = _temp_spill_dirs()
    chunks = stream("int32", seed=23, sizes=(2000, 2000))
    x = np.concatenate(chunks)
    assert bits([kt.kselect_streaming(iter(chunks), 9, device="cpu", **NARROW)], x.dtype) == key_oracle(x, [9])
    assert bits([kt.kselect_streaming(chunks, 9, spill="force", device="cpu", **NARROW)], x.dtype) == key_oracle(
        x, [9])
    assert _temp_spill_dirs() == before


def test_internal_store_removed_on_consumer_raise():
    """A dtype that drifts mid-stream, with the producer thread running:
    the error reaches the caller and the internal store is gone."""
    before = _temp_spill_dirs()
    chunks = stream("int32", seed=25, sizes=(2000, 2000))
    bad = chunks + [chunks[0][:64].astype(np.float32)]
    with pytest.raises(TypeError, match="stream dtype"):
        kt.kselect_streaming(bad, 9, spill="force", pipeline_depth=2, device="cpu")
    with pytest.raises(TypeError, match="stream dtype"):
        kt.kselect_streaming(iter(bad), 9, pipeline_depth=2, device="cpu")
    assert _temp_spill_dirs() == before


def test_internal_store_removed_on_producer_raise():
    """A source that raises mid-stream on the producer thread."""
    before = _temp_spill_dirs()

    def failing():
        yield np.arange(100, dtype=np.int32)
        raise OSError("disk gone")

    for depth in (0, 2):
        with pytest.raises(OSError, match="disk gone"):
            kt.kselect_streaming(failing(), 5, pipeline_depth=depth, device="cpu")
    assert _temp_spill_dirs() == before


def test_internal_store_removed_on_bad_k():
    before = _temp_spill_dirs()
    chunks = stream("int32", seed=27, sizes=(1000, 1000))
    with pytest.raises(ValueError, match="out of range"):
        kt.kselect_streaming(iter(chunks), 2001, device="cpu")
    assert _temp_spill_dirs() == before


def test_cli_spill_flags(tmp_path, capsys):
    """``--spill force --spill-dir --check --verify`` on the streamed mode:
    exact, the certificate read from the spilled generation 0, and the
    store's root left empty."""
    from mpi_k_selection_tpu_torch import cli

    rc = cli.main([
        "--streaming", "--n", "40000", "--chunk-elems", "8192", "--spill", "force", "--spill-dir", str(tmp_path),
        "--check", "--verify", "--json", "--device", "cpu",
    ])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["extra"]["spill"] == "force"
    assert rec["extra"]["exact_match"] is True and rec["extra"]["certificate_ok"] is True
    assert os.path.isdir(tmp_path) and not spill_dirs(tmp_path)
    rc = cli.main(["--n", "30000", "--dtype", "float16", "--gen", "normal", "--check", "--json", "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out)
    assert rc == 0 and rec["extra"]["certificate_ok"] is True
    with pytest.raises(SystemExit, match="--check applies to k-th"):
        cli.main(["--topk", "4", "--check", "--device", "cpu"])


# -- on the card -------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["int16", "uint32", "bfloat16", "float32", "int64", "float64"])
def test_spill_descent_on_card(cuda_device, name, tmp_path):
    """The spill grid with the sweep kernel on the card: the same bits as
    NumPy at depth 0 and 2, the kernel launched (a pass after the first
    runs its histogram and tee parts in one launch a chunk) and no plain
    call, and the generations those launches write equal, file for file,
    to the ones the plain version writes on the CPU."""
    chunks = stream(name, seed=29, sizes=(70000, 1, 0, 33000))
    x = np.concatenate(chunks)
    ks = [1, x.size // 2, x.size]
    want = key_oracle(x, ks)
    bits_ = dt.key_bits(x.dtype)
    kname = "sweep_ingest64" if bits_ == 64 else "sweep_ingest32"
    for depth in (0, 2):
        for spill in ("auto", "force"):
            S.reset_counts()
            got = kt.kselect_streaming_many(iter(chunks), ks, pipeline_depth=depth, spill=spill,
                                            spill_dir=str(tmp_path), device=cuda_device, **NARROW)
            assert bits(got, x.dtype) == want
            assert S.LAUNCHES[kname] > 0 and S.PLAIN_CALLS["sweep_ingest"] == 0
        files = []
        for device in (cuda_device, "cpu"):
            store = SpillStore(str(tmp_path))
            store.drop_generation = lambda gen: None
            kt.kselect_streaming_many(chunks, ks, pipeline_depth=depth, spill=store, device=device, **NARROW)
            files.append(generation_files(store))
            store.close()
        assert len(files[0]) > 3 and files[0] == files[1]
    assert not spill_dirs(tmp_path)


@pytest.mark.gpu
@pytest.mark.parametrize("bits_", [32, 64])
def test_tee_launch_matches_plain_on_card(cuda_device, bits_):
    """Row 8's tee launch kind (a histogram of one prefix and a one-spec
    tee), as a later spill pass issues it, against the plain version:
    counts and the survivor buffer, exactly."""
    gen = torch.Generator(device="cuda").manual_seed(bits_)
    n = (1 << 20) + 77
    w = torch.randint(-(1 << 62), 1 << 62, (n,), dtype=torch.int64, device="cuda", generator=gen)
    w = w.to(torch.int32) if bits_ == 32 else w
    key = dt.keys_from_raw(w[:1], "xor", 1 << (bits_ - 1))
    p8 = (int(key) & ((1 << bits_) - 1)) >> (bits_ - 8)
    kw = dict(key_op="xor", key_xor=1 << (bits_ - 1), hist_prefixes=[p8], shift=bits_ - 16, radix_bits=8,
              tee=[(bits_ - 8, p8)])
    got = S.sweep_ingest(w, n - 5, **kw)
    want = S.sweep_ingest_plain(w.cpu(), n - 5, **kw)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[2][0].cpu(), want[2][0]) and int(got[2][1]) == int(want[2][1]) > 0


# (L, n_valid, offset) of each edge shape: the bucket is words[offset:offset + L]
TEE_EDGES = {
    "more tiles than resident blocks (the look-back)": ((1 << 22) + 3, (1 << 22) - 5, 0),
    "a base not 16-byte aligned": ((1 << 20) + 1, (1 << 20) - 9, 1),
    "n_valid inside the last tile": ((1 << 20) + 77, (1 << 20) + 40, 0),
    "a bucket below one tile": (5000, 4990, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("bits_", [32, 64])
@pytest.mark.parametrize("case", range(N_TEE_CASES))
@pytest.mark.parametrize("edge", list(TEE_EDGES))
def test_tee_kinds_match_plain_on_card(cuda_device, bits_, case, edge):
    """Row 8's histogram + tee launch at each shape of ``tee_cases`` (the
    tee's survivor shares, a union of teed prefixes with a parked spec,
    pass 0's every-key tee) and each edge shape, pads of random bits
    present, against the plain version on the same words: every output
    exactly, the tee buffer to its last word."""
    L, n_valid, off = TEE_EDGES[edge]
    rng = np.random.default_rng(1000 * bits_ + case)
    label, keys, parts = tee_cases(bits_, L, rng)[case]
    raw = keys ^ keys.dtype.type(1 << (bits_ - 1))
    raw[n_valid:] = rng.integers(0, 1 << bits_, size=L - n_valid, dtype=np.uint64).astype(raw.dtype)
    words = np.zeros(L + off, raw.dtype)
    words[off:] = raw
    w = torch.from_numpy(words.view(np.int32 if bits_ == 32 else np.int64)).to(cuda_device)[off:]
    kw = dict(key_op="xor", key_xor=1 << (bits_ - 1), **parts)
    S.reset_counts()
    got = S.sweep_ingest(w, n_valid, **kw)
    assert S.LAUNCHES[f"sweep_ingest{bits_}"] == 1 and S.PLAIN_CALLS["sweep_ingest"] == 0
    want = S.sweep_ingest_plain(w, n_valid, **kw)
    assert torch.equal(got[0], want[0]), label
    assert torch.equal(got[2][0], want[2][0]) and int(got[2][1]) == int(want[2][1]), label

