"""The port's spill record format v2 (``pack_spill="auto"``,
``streaming/spill.py``) against the JAX package's, byte for byte.

The pack's fast paths (whole-byte widths, the grouping by a stable sort of
small segment indices, the card's digit grouping) against the JAX
package's ``_pack_low_bits``, ``_unpack_low_bits`` and ``_pack_payload``;
the JAX package's own v2 cases (round-trip fuzz, the digit tee's pruning
and its price, the v1 fallback, corrupt directory and segment, truncated
record, a packed descent over v1 generations); generations written by a
descent file for file with the JAX package's, with ``drop_generation``
stubbed so every generation stays on disk; and each package reading the
other's packed generations, whole and pruned. Stores root in each test's
``tmp_path``, which holds no ``ksel-spill-*`` afterwards.

    python -m pytest --noconftest tests/test_torch_*.py -m gpu
"""

from __future__ import annotations

import errno
import os

import numpy as np
import pytest
import torch

import mpi_k_selection_tpu_torch as kt
from mpi_k_selection_tpu_torch.errors import SpillCapacityError, SpillRecordError
from mpi_k_selection_tpu_torch.streaming import spill as sp
from mpi_k_selection_tpu_torch.streaming.spill import SpillStore
from mpi_k_selection_tpu_torch.utils import dtypes as dt
from test_torch_spill import (NARROW, _spilled, generation_files, jax_generation, jax_store, port_generation,
                              spill_dirs)
from test_torch_streaming import bits, cuda_device, key_oracle, stream  # noqa: F401 (a fixture)

PACKED = dict(pack_spill="auto", **NARROW)


def random_values(rng, n: int, width: int) -> np.ndarray:
    v = rng.integers(0, 1 << 63, size=n, dtype=np.int64).astype(np.uint64)
    if width == 64:
        return v | (rng.integers(0, 2, size=n).astype(np.uint64) << np.uint64(63))
    return v & np.uint64((1 << width) - 1)


def random_population(rng, total_bits: int, n_specs: int, max_per_spec: int):
    """Keys under a random union of ``(resolved, prefix)`` specs of mixed
    depths, shuffled (the JAX package's ``_random_packed_population``)."""
    specs = set()
    while len(specs) < n_specs:
        r = int(rng.integers(0, total_bits))
        specs.add((r, int(rng.integers(0, 1 << r)) if r else 0))
    parts = []
    for r, p in sorted(specs):
        low = random_values(rng, int(rng.integers(0, max_per_spec)), total_bits - r)
        parts.append(low | np.uint64(p << (total_bits - r)) if r else low)
    keys = np.concatenate(parts)
    return keys[rng.permutation(keys.shape[0])], tuple(sorted(specs))


def tail_of(segments) -> tuple:
    """The v2 tail (directory and payloads) and layout of ``segments``."""
    prep = sp.prepared_record(lambda: None, 1 << 40, np.uint64, np.uint64, segments)
    return b"".join(bytes(p.data) for p in prep.parts), prep.segments


@pytest.mark.parametrize("width", range(1, 65))
def test_bit_pack_matches_jax_at_every_width(width):
    """``_pack_low_bits`` (whole bytes: big-endian low bytes; else a bit
    expansion) and ``_unpack_low_bits`` (whole bytes: overlapping
    big-endian windows) against the JAX package's, across its 2^16-value
    slice boundary, both ways."""
    from mpi_k_selection_tpu.streaming import spill as jsp

    rng = np.random.default_rng(width)
    for n in (0, 1, 7, 8, 9, 1000, (1 << 16) + 3):
        v = random_values(rng, n, width)
        packed = sp._pack_low_bits(v, width)
        assert packed.tobytes() == jsp._pack_low_bits(v, width).tobytes()
        np.testing.assert_array_equal(sp._unpack_low_bits(packed, n, width), v)
        np.testing.assert_array_equal(jsp._unpack_low_bits(packed, n, width), v)
        if width % 8 == 0 and width <= 32:  # a narrower carrier takes the same bytes
            assert sp._pack_low_bits(v.astype(np.uint32), width).tobytes() == packed.tobytes()


@pytest.mark.parametrize("total_bits", [8, 16, 32, 64])
def test_pack_payload_matches_jax(total_bits):
    """Segment grouping for mixed-depth unions (the deepest spec first),
    one-depth unions (a stable sort of small segment indices) and one spec
    (no sort): the JAX package's tail and layout, byte for byte; a key
    under no spec raises its SpillError."""
    from mpi_k_selection_tpu.streaming import spill as jsp

    rng = np.random.default_rng(total_bits)
    kdt = np.dtype(f"uint{total_bits}")
    for trial in range(40):
        if trial % 2:
            keys, specs = random_population(rng, total_bits, int(rng.integers(1, 7)), 400)
        else:  # one depth
            r = int(rng.integers(1, total_bits))
            ps = sorted({int(p) for p in rng.integers(0, 1 << r, size=int(rng.integers(1, 9)))})
            specs = tuple((r, p) for p in ps)
            parts = [random_values(rng, int(rng.integers(0, 300)), total_bits - r) | np.uint64(p << (total_bits - r))
                     for p in ps]
            keys = np.concatenate(parts)
            keys = keys[rng.permutation(keys.shape[0])]
        keys = keys.astype(kdt)
        tail, _, layout = jsp._pack_payload(keys, specs, total_bits)
        assert tail_of(sp._pack_payload(keys, specs, total_bits)) == (tail.tobytes(), layout), specs
    keys = np.arange(100, dtype=kdt)
    with pytest.raises(sp.SpillError, match="match no"):
        sp._pack_payload(keys, ((total_bits - 1, 0),), total_bits)
    with pytest.raises(sp.SpillError, match="match no"):
        sp._pack_payload(keys, ((total_bits - 1, 0), (total_bits - 1, 3)), total_bits)


@pytest.mark.parametrize("total_bits", [8, 16, 32, 64])
def test_digit_grouping_on_host_and_device_matches_jax(total_bits):
    """A digit-segmented record's segments, from the host's radix-sort
    grouping and from :func:`spill.pack_digits` (torch on the CPU here,
    the card's code), equal the JAX writer's ``np.unique``-derived specs
    packed by its ``_pack_payload``."""
    from mpi_k_selection_tpu.streaming import spill as jsp

    rng = np.random.default_rng(total_bits + 1)
    kdt = np.dtype(f"uint{total_bits}")
    digit = min(8, total_bits - 1)
    for n, skew in ((1, 0), (5000, 0), (5000, 3), (70000, 6)):
        keys = (random_values(rng, n, total_bits) >> np.uint64(skew)).astype(kdt)
        tops = np.unique(keys.astype(np.uint64) >> np.uint64(total_bits - digit))
        tail, _, layout = jsp._pack_payload(keys, tuple((digit, int(t)) for t in tops), total_bits)
        assert tail_of(sp._digit_segments(keys, digit)) == (tail.tobytes(), layout)
        if (total_bits - digit) % 8 == 0:
            carrier = torch.from_numpy(keys.view(f"int{total_bits}") if total_bits >= 32
                                       else keys.astype(np.int32))
            counts, payload = sp.pack_digits(carrier, digit, total_bits)
            segs = sp.digit_segments_from(counts.numpy(), payload.numpy(), digit, total_bits)
            assert tail_of(segs) == (tail.tobytes(), layout)


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("mmap", [False, True])
def test_packed_roundtrip_fuzz(key_dtype, mmap, tmp_path):
    """The JAX package's round-trip fuzz: random mixed-depth unions pack
    and replay key for key on the read and mmap routes, the physical
    record never exceeds the logical one, and a filtered read returns
    exactly the keys of every segment a kept spec matches (a superset of
    the keys under the kept specs); the JAX package reads the same file
    to the same keys."""
    from mpi_k_selection_tpu.streaming.spill import _segment_matches

    rng = np.random.default_rng(int(mmap) + 8 * np.dtype(key_dtype).itemsize)
    total_bits = np.dtype(key_dtype).itemsize * 8
    for trial in range(8):
        keys, specs = random_population(rng, total_bits, int(rng.integers(1, 7)), 800)
        keys = keys.astype(key_dtype)
        store = SpillStore(str(tmp_path))
        w = store.new_generation(pack_specs=specs, total_bits=total_bits)
        w.append(keys, np.float64 if total_bits == 64 else np.int32)
        gen = w.commit()
        [rec] = gen.records
        assert rec.nbytes <= keys.nbytes
        got = np.concatenate([c.keys for c in gen.iter_chunks(mmap=mmap)] or [np.empty(0, key_dtype)])
        np.testing.assert_array_equal(np.sort(got), np.sort(keys))
        keep = specs[: max(1, len(specs) // 2)]
        u = keys.astype(np.uint64)
        assigned = np.zeros(u.shape[0], bool)
        expect = np.zeros(u.shape[0], bool)
        direct = np.zeros(u.shape[0], bool)
        for r, p in sorted(specs, key=lambda s: (-s[0], s[1])):
            seg = ~assigned
            if r:
                seg &= (u >> np.uint64(total_bits - r)) == np.uint64(p)
            assigned |= seg
            if _segment_matches(r, p, keep):
                expect |= seg
        for r, p in keep:
            direct |= (u >> np.uint64(total_bits - r)) == np.uint64(p) if r else np.ones_like(direct)
        got_f = np.concatenate([c.keys for c in gen.iter_chunks(mmap=mmap, filter_specs=keep)]
                               or [np.empty(0, key_dtype)])
        np.testing.assert_array_equal(np.sort(got_f), np.sort(keys[expect]))
        assert not np.any(direct & ~expect)
        assert gen.read_keys(keep) == int(expect.sum())
        jgen = jax_generation(jax_store(tmp_path / "j"), gen)
        assert [c.keys.tobytes() for c in jgen.iter_chunks(filter_specs=keep)] == [
            c.keys.tobytes() for c in gen.iter_chunks(filter_specs=keep)]
        assert jgen.read_nbytes(keep) == gen.read_nbytes(keep)
        jgen.store.close()
        store.close()
    assert not spill_dirs(tmp_path)


def test_packed_digit_tee_prunes_and_prices(tmp_path):
    """The digit-segmented tee: a filtered replay returns exactly the keys
    under the filter, and ``read_nbytes`` / ``read_keys`` price the pruned
    read from the layout, below the whole generation; the JAX package's
    writer makes the same files."""
    rng = np.random.default_rng(41)
    keys = rng.integers(0, 1 << 63, size=20_000, dtype=np.int64).astype(np.uint64)
    gens = []
    for store in (SpillStore(str(tmp_path / "port")), jax_store(tmp_path / "jax")):
        w = store.new_generation(pack_digit_bits=8)
        for part in np.array_split(keys, 4):
            w.append(part, np.uint64)
        gens.append(w.commit())
    gen = gens[0]
    assert gen.packed and gen.nbytes < gen.logical_nbytes
    assert generation_files(gen.store) == generation_files(gens[1].store)
    specs = ((4, 0x7),)
    mask = (keys >> np.uint64(60)) == np.uint64(0x7)
    got = np.concatenate([c.keys for c in gen.iter_chunks(filter_specs=specs)])
    np.testing.assert_array_equal(np.sort(got), np.sort(keys[mask]))
    assert gen.read_keys(specs) == int(mask.sum())
    assert gen.read_nbytes(specs) == gens[1].read_nbytes(specs) < gen.nbytes
    assert gen.read_nbytes(None) == gen.nbytes and gen.read_keys(None) == keys.shape[0]
    for g in gens:
        g.store.close()
    assert not spill_dirs(tmp_path / "port")


def test_packed_tiny_record_falls_back_to_v1(tmp_path):
    """Records the directory would dominate, and a resolved-0 pack (no bit
    saved), stay format v1; mixed v1/v2 generations replay."""
    store = SpillStore(str(tmp_path))
    w = store.new_generation(pack_digit_bits=8)
    big = np.arange(4096, dtype=np.uint64) * np.uint64(1 << 50)
    tiny = np.asarray([1, 2], np.uint64)
    w.append(big, np.uint64)
    w.append(tiny, np.uint64)
    gen = w.commit()
    assert [rec.version for rec in gen.records] == [2, 1]
    assert all(r.nbytes <= r.logical_nbytes for r in gen.records)
    got = np.concatenate([c.keys for c in gen.iter_chunks()])
    np.testing.assert_array_equal(np.sort(got), np.sort(np.concatenate([big, tiny])))
    w2 = store.new_generation(pack_specs=((0, 0),), total_bits=64)
    w2.append(big, np.uint64)
    assert w2.commit().records[0].version == 1
    store.close()
    assert not spill_dirs(tmp_path)


def packed_store(tmp_path, name):
    keys = np.random.default_rng(43).integers(0, 1 << 63, size=4096, dtype=np.int64).astype(np.uint64)
    store = SpillStore(str(tmp_path / name))
    w = store.new_generation(pack_digit_bits=8)
    w.append(keys, np.uint64)
    gen = w.commit()
    assert gen.records[0].version == 2
    return keys, store, gen


def rewrite(path, edit):
    with open(path, "rb") as f:
        data = bytearray(f.read())
    with open(path, "wb") as f:
        f.write(edit(data))


@pytest.mark.parametrize("mmap", [False, True])
def test_packed_corrupt_directory_raises_typed(mmap, tmp_path):
    """A directory byte flipped: a whole read raises SpillRecordError, in
    both packages."""
    from mpi_k_selection_tpu.errors import SpillRecordError as JaxRecordError

    _, store, gen = packed_store(tmp_path, f"dir{mmap}")

    def flip(data):
        data[128 + 12] ^= 0xFF  # a directory entry byte (the header is 64 bytes)
        return data

    rewrite(gen.records[0].path, flip)
    with pytest.raises(SpillRecordError, match="corrupt segment directory"):
        list(gen.iter_chunks(mmap=mmap))
    jgen = jax_generation(jax_store(tmp_path / "j"), gen)
    with pytest.raises(JaxRecordError, match="corrupt segment directory"):
        list(jgen.iter_chunks(mmap=mmap))
    jgen.store.close()
    store.close()


@pytest.mark.parametrize("mmap", [False, True])
def test_packed_corrupt_segment_raises_typed(mmap, tmp_path):
    """A byte of the last segment flipped: a whole read raises; a pruned
    read that skips that segment serves (each segment has its own CRC),
    one that takes it raises."""
    keys, store, gen = packed_store(tmp_path, f"seg{mmap}")

    def flip(data):
        data[-2] ^= 0xFF
        return data

    rewrite(gen.records[0].path, flip)
    with pytest.raises(SpillRecordError, match="corrupt segment resolved="):
        list(gen.iter_chunks(mmap=mmap))
    tops = np.sort(np.unique(keys >> np.uint64(56)))
    good, bad = int(tops[0]), int(tops[-1])
    got = np.concatenate([c.keys for c in gen.iter_chunks(mmap=mmap, filter_specs=((8, good),))])
    np.testing.assert_array_equal(np.sort(got), np.sort(keys[(keys >> np.uint64(56)) == np.uint64(good)]))
    with pytest.raises(SpillRecordError, match="checksum"):
        list(gen.iter_chunks(mmap=mmap, filter_specs=((8, bad),)))
    store.close()


@pytest.mark.parametrize("mmap", [False, True])
def test_packed_truncated_raises_typed(mmap, tmp_path):
    """A record cut short by 9 bytes raises SpillRecordError."""
    _, store, gen = packed_store(tmp_path, f"trunc{mmap}")
    rewrite(gen.records[0].path, lambda data: data[:-9])
    with pytest.raises(SpillRecordError, match="truncated|implies"):
        list(gen.iter_chunks(mmap=mmap))
    with pytest.raises(SpillRecordError, match="truncated|implies"):  # without the generation's index
        list(port_generation(SpillStore(str(tmp_path / "r")), gen).iter_chunks(mmap=mmap))
    store.close()


def test_packed_descent_reads_v1_generations(tmp_path):
    """A store teed in format v1 serves a descent that asks for
    ``pack_spill="auto"`` (the reader keys on each record's version), and
    its survivor generations are then packed."""
    chunks = stream("int32", seed=45, sizes=(1500, 1200, 1396))
    x = np.concatenate(chunks)
    want = key_oracle(x, [77])
    with SpillStore(str(tmp_path)) as store:
        assert bits([kt.kselect_streaming(iter(chunks), 77, spill=store, device="cpu", **NARROW)], x.dtype) == want
        assert not store.latest_generation().packed
        store.pass_log.clear()
        assert bits([kt.kselect_streaming(store, 77, spill=store, device="cpu", **PACKED)], x.dtype) == want
        assert any(e["disk_bytes_written"] < e["bytes_written"] for e in store.pass_log if "keys_written" in e)
    assert not spill_dirs(tmp_path)


@pytest.mark.parametrize("name", ["int8", "uint16", "int32", "float32", "int64", "float64"])
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("ws", ["auto", "off"])
def test_packed_generations_match_jax_file_for_file(name, depth, ws, tmp_path):
    """Packed descents into caller-owned stores, every generation kept: the
    pass logs entry for entry (physical bytes below logical ones) and the
    generations file for file, byte for byte (the pass-0 records grouped
    by the port's torch digit pack, the later ones by its host pack)."""
    chunks = stream(name, seed=47, sizes=(900, 0, 1, 500, 700))
    x = np.concatenate(chunks)
    ks = [2, x.size // 2]
    got, mine = _spilled("port", chunks, ks, tmp_path / "port", depth, keep_all=True, width_schedule=ws, **PACKED)
    want, theirs = _spilled("jax", chunks, ks, tmp_path / "jax", depth, keep_all=True, width_schedule=ws, **PACKED)
    assert bits(got, x.dtype) == bits(want, x.dtype) == key_oracle(x, ks)
    assert mine.pass_log and mine.pass_log == theirs.pass_log  # "auto" resolves 8- and 16-bit keys in one pass
    assert any(r.packed for g in mine.generations.values() for r in g.records)
    assert all(e["disk_bytes_written"] <= e["bytes_written"] for e in mine.pass_log if "keys_written" in e)
    assert generation_files(mine) == generation_files(theirs)
    mine.close()
    theirs.close()
    assert not spill_dirs(tmp_path / "port")


@pytest.mark.parametrize("name", ["uint8", "int16", "int32", "bfloat16", "uint64", "float64"])
def test_each_package_reads_the_others_packed_generations(name, tmp_path):
    """Every generation of a packed descent, written by one package, is
    read by the other, whole and pruned to the next pass's specs, with the
    generation's segment index and without it (the on-disk directory):
    the same keys; a descent and a certificate over the other's store
    answer as over the stream. (The JAX package does not read its own
    bfloat16 tag back; the port maps it.)"""
    from mpi_k_selection_tpu.streaming import streaming_kselect as ref_select
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    chunks = stream(name, seed=49, sizes=(600, 0, 400, 900))
    x = np.concatenate(chunks)
    k = x.size // 2
    want = key_oracle(x, [k])
    _, mine = _spilled("port", chunks, [k], tmp_path / "port", 2, keep_all=True, **PACKED)
    _, theirs = _spilled("jax", chunks, [k], tmp_path / "jax", 2, keep_all=True, **PACKED)
    top = int(dt.np_to_sortable_bits(np.frombuffer(want, x.dtype))[0]) >> (dt.key_bits(x.dtype) - 4)
    readers = []
    for idx in sorted(mine.generations) if name != "bfloat16" else [0]:  # the JAX descent rebuilds past gen 0
        pg, jg = mine.generations[idx], theirs.generations[idx]
        for specs in (None, ((4, top),)):
            ref = [c.keys.tobytes() for c in pg.iter_chunks(filter_specs=specs)]
            r = SpillStore(str(tmp_path / "port"))
            readers.append(r)
            assert [c.keys.tobytes() for c in port_generation(r, jg).iter_chunks(filter_specs=specs)] == ref
            plain = sp.SpillGeneration(r, 99, jg.path, tuple(
                sp.SpillRecord(**{**rec.__dict__, "segments": None}) for rec in port_generation(r, jg).records))
            assert [c.keys.tobytes() for c in plain.iter_chunks(filter_specs=specs)] == ref
            if name != "bfloat16":
                js = jax_store(tmp_path / "jax")
                readers.append(js)
                assert [c.keys.tobytes() for c in jax_generation(js, pg).iter_chunks(filter_specs=specs)] == ref
    reader = SpillStore(str(tmp_path / "port"))
    port_generation(reader, theirs.generations[0])
    assert bits([kt.kselect_streaming(reader, k, device="cpu", **PACKED)], x.dtype) == want
    less, leq = kt.streaming_rank_certificate(reader, np.frombuffer(want, x.dtype)[0], device="cpu")
    assert less < k <= leq
    if name != "bfloat16":
        jreader = jax_store(tmp_path / "jax")
        jax_generation(jreader, mine.generations[0])
        with enable_x64():
            assert bits([ref_select(jreader, k, **PACKED)], x.dtype) == want
        jreader.close()
    for s in (mine, theirs, reader, *readers):
        s.close()
    assert not spill_dirs(tmp_path / "port") and not spill_dirs(tmp_path / "jax")


@pytest.mark.parametrize("failures", ["once", "persistent"])
def test_recovery_ladder_on_packed_generations(failures, tmp_path, monkeypatch):
    """Records of a packed generation 1 fail validation once (read again)
    or always (the pass is rebuilt from the one-shot run's packed
    generation 0): NumPy's answer, and the JAX package's pass log (reads,
    keys, logical and physical bytes) under the same failures."""
    from mpi_k_selection_tpu import errors as jerr
    from mpi_k_selection_tpu.streaming import spill as jsp
    from mpi_k_selection_tpu.streaming import streaming_kselect as ref_select

    chunks = stream("float32", seed=51, sizes=(2000, 1500, 2500))
    x = np.concatenate(chunks)
    k = x.size // 3
    logs = []
    for pkg, mod, err, select in (
        ("port", sp, SpillRecordError, lambda s, st: kt.kselect_streaming(s, k, spill=st, device="cpu", **PACKED)),
        ("jax", jsp, jerr.SpillRecordError, lambda s, st: ref_select(s, k, spill=st, **PACKED)),
    ):
        real = mod._read_record
        seen = {"reads": 0}

        def flaky(rec, *a, _real=real, _err=err, _seen=seen, **kw):
            if os.sep + "gen-0001" + os.sep in rec.path:
                _seen["reads"] += 1
                if failures == "persistent" or _seen["reads"] == 1:
                    raise _err(f"spill record {rec.path}: checksum mismatch (corrupt segment)")
            return _real(rec, *a, **kw)

        monkeypatch.setattr(mod, "_read_record", flaky)
        store = SpillStore(str(tmp_path / pkg)) if pkg == "port" else jax_store(tmp_path / pkg)
        assert bits([select((c for c in chunks), store)], x.dtype) == key_oracle(x, [k]), pkg
        logs.append(store.pass_log)
        store.close()
    assert logs[0] == logs[1]
    assert [e["read"] for e in logs[0]][:3] == ["source", "spill", "spill"]


def test_enospc_on_packed_generations(tmp_path, monkeypatch):
    """ENOSPC while teeing a packed generation 1 degrades ``auto`` with a
    RuntimeWarning and the same answer, raises SpillCapacityError under
    ``force``, and while teeing generation 0 (the card's digit pack) in
    every mode; no store is left behind."""
    chunks = stream("int64", seed=53, sizes=(1500, 1500))
    x = np.concatenate(chunks)
    k = x.size // 2
    real = sp.SpillWriter.append_prepared

    def full(self, prep, device_slot=None):
        if self.index >= full.from_gen:
            raise OSError(errno.ENOSPC, "No space left on device")
        return real(self, prep, device_slot=device_slot)

    monkeypatch.setattr(sp.SpillWriter, "append_prepared", full)
    full.from_gen = 1
    with pytest.warns(RuntimeWarning, match="ENOSPC"):
        got = kt.kselect_streaming((c for c in chunks), k, spill_dir=str(tmp_path), device="cpu", **PACKED)
    assert bits([got], x.dtype) == key_oracle(x, [k])
    with pytest.raises(SpillCapacityError, match="explicitly"):
        kt.kselect_streaming(chunks, k, spill="force", spill_dir=str(tmp_path), device="cpu", **PACKED)
    full.from_gen = 0
    for depth in (0, 2):
        with pytest.raises(SpillCapacityError, match="generation 0"):
            kt.kselect_streaming((c for c in chunks), k, spill_dir=str(tmp_path), pipeline_depth=depth, device="cpu",
                                 **PACKED)
    assert not spill_dirs(tmp_path)


@pytest.mark.parametrize("name", ["int16", "float32", "float64"])
def test_sketch_tee_packed_matches_jax(name, tmp_path):
    """``RadixSketch.update_stream(one_shot, spill=store,
    pack_spill="auto")`` writes the JAX sketch tee's packed generation
    byte for byte, at depth 2 and 0, and ``refine`` from it prunes its
    first pass to the sketch bucket's segments: NumPy's answers, and
    fewer keys read than the generation holds."""
    from mpi_k_selection_tpu.streaming.sketch import RadixSketch as JaxSketch
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    chunks = stream(name, seed=55, sizes=(3000, 0, 1700, 900))
    x = np.concatenate(chunks)
    ks = [1, x.size // 2, x.size]
    for depth in (2, 0):
        with SpillStore(str(tmp_path / "port")) as store, jax_store(tmp_path / "jax") as theirs:
            sk = kt.RadixSketch(x.dtype, device="cpu").update_stream(iter(chunks), pipeline_depth=depth, spill=store,
                                                                     pack_spill="auto")
            with enable_x64():
                JaxSketch(x.dtype).update_stream(iter(chunks), pipeline_depth=depth, spill=theirs, pack_spill="auto")
            assert store.latest_generation().packed and generation_files(store) == generation_files(theirs)
            assert bits(sk.refine_many(store, ks, spill=store, collect_budget=16), x.dtype) == key_oracle(x, ks)
            if dt.key_bits(x.dtype) > 16:  # a 16-bit key is resolved by the sketch alone
                assert store.pass_log[0]["keys_read"] < x.size
    assert not spill_dirs(tmp_path / "port")


# -- on the card -------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("total_bits", [16, 32, 64])
def test_pack_digits_on_card_matches_host(cuda_device, total_bits):
    """:func:`spill.pack_digits` on the card gives the host grouping's
    segments, byte for byte, at a chunk of 2^22 keys."""
    rng = np.random.default_rng(total_bits)
    kdt = np.dtype(f"uint{total_bits}")
    keys = (random_values(rng, 1 << 22, total_bits) >> np.uint64(3)).astype(kdt)
    carrier = torch.from_numpy(keys.view(f"int{total_bits}") if total_bits >= 32 else keys.astype(np.int32)).cuda()
    counts, payload = sp.pack_digits(carrier, 8, total_bits)
    segs = sp.digit_segments_from(counts.cpu().numpy(), payload.cpu().numpy(), 8, total_bits)
    assert tail_of(segs) == tail_of(sp._digit_segments(keys, 8))
