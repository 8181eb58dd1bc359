"""The port's RadixSketch, StreamingQuantiles, distributed_sketch and
dcn_merge_sketch against the JAX package's and NumPy, bit for bit.

The same seeded numpy chunks (every dtype, NaNs of both signs, +-0.0,
+-inf and integer extremes included) go to both packages: the JAX sketch
counts on the host, the port's through the sweep kernel's plain version
(``device="cpu"``), at pipeline depth 0 and 2 and ingest widths 1, 2 and
4. Pyramids, counts and extremes are compared exactly, answers as bit
patterns. ``distributed_sketch`` runs at world 2 and 4 over gloo on the
CPU (one spawn per world, every case in it) against the JAX package's
on ``make_mesh(P)`` of its 8-device virtual mesh. The JAX package is
imported inside the tests, so the ``gpu`` tests also collect where only
PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_*.py -m gpu
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import mpi_k_selection_tpu_torch as kt
from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
from mpi_k_selection_tpu_torch.parallel import multihost
from mpi_k_selection_tpu_torch.parallel import sketch as psk
from mpi_k_selection_tpu_torch.streaming import executor as ex
from mpi_k_selection_tpu_torch.streaming import pipeline as pl
from mpi_k_selection_tpu_torch.streaming.sketch import RadixSketch
from mpi_k_selection_tpu_torch.utils import dtypes as dt
from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype, tensor_from_numpy
from test_torch_streaming import DTYPES, bits, key_oracle, stream

torch.set_num_threads(1)

WORLDS = (2, 4)
DIST_DTYPES = ("int32", "float32", "bfloat16", "uint8", "int64", "float64")
DIST_N = 3001  # a multiple of neither world: the last shards carry sentinels
SPAWN_TIMEOUT_S = 120


def geometry(name) -> dict:
    """The sketch shape of a dtype: the default 4 x 4 where it fits (16
    bits resolve a 16-bit key whole), 4 x 2 for 8-bit keys."""
    return dict(radix_bits=4, levels=2) if dt.key_bits(name) == 8 else {}


def wide(name) -> bool:
    return dt.key_bits(name) == 64


def jax_sketch(name, chunks, **kw):
    from mpi_k_selection_tpu.streaming.sketch import RadixSketch as JaxSketch

    sk = JaxSketch(numpy_dtype(name), **kw)
    for c in chunks:
        sk.update(c)
    return sk


def same(port, ref) -> None:
    """Pyramid, count, extremes and shape equal, exactly."""
    assert port.dtype == ref.dtype and (port.radix_bits, port.levels) == (ref.radix_bits, ref.levels)
    assert port.n == ref.n
    assert all(np.array_equal(a, b) for a, b in zip(port.hists, ref.hists))
    for a, b in ((port._min_key, ref._min_key), (port._max_key, ref._max_key)):
        assert (a is None and b is None) or (int(a) == int(b) and a.dtype == b.dtype)


def queries(sk, n) -> list:
    """Every query method at ranks across the stream, as comparable bytes
    and ints."""
    out = [sk.max_bucket_population()]
    for k in sorted({1, 2, n // 3, n // 2, n - 1, n}):
        lo, hi, vlo, vhi, pinned = sk.describe(k)
        pin = sk.pin(k)
        out += [sk.rank_bounds(k), sk.rank_error_bound(k), bits(sk.value_bounds(k), sk.dtype),
                bits([sk.query(k)], sk.dtype), (lo, hi), bits([vlo, vhi], sk.dtype),
                None if pinned is None else bits([pinned], sk.dtype), None if pin is None else bits([pin], sk.dtype),
                sk.walk(k)]
    out.append(bits(sk.quantiles([0.0, 0.5, 0.9, 0.99, 1.0]), sk.dtype))
    out.append(bits([sk.quantile(0.25)], sk.dtype))
    return out


@pytest.mark.parametrize("name", DTYPES)
def test_sketch_matches_jax_on_every_dtype(name):
    """``update`` (numpy chunks and CPU tensors) and ``update_stream`` at
    depth 0 and 2, ingest widths 1, 2 and 4, against the JAX sketch's
    ``update``: pyramid, n and extremes, and every query method."""
    chunks = stream(name, seed=7)
    geo = geometry(name)
    ref = jax_sketch(name, chunks, **geo)
    port = RadixSketch(numpy_dtype(name), device="cpu", **geo)
    for i, c in enumerate(chunks):
        port.update(tensor_from_numpy(c, "cpu") if i % 2 else c)
    same(port, ref)
    assert queries(port, ref.n) == queries(ref, ref.n)
    for depth in (0, 2):
        for workers in (1, 2, 4):
            streamed = RadixSketch(numpy_dtype(name), device="cpu", **geo)
            streamed.update_stream(chunks, pipeline_depth=depth, ingest_workers=workers)
            same(streamed, ref)
            assert streamed == port


def skewed(case: str, sizes=(3001, 1, 0, 999)) -> list:
    """Seeded chunks of skewed data, every key in one bucket of the deepest
    level: int64 below 2^27 (``distributed_sketch``'s 2^30 int64 shape,
    its keys all under one 16-bit prefix) and int16 / bfloat16 chunks of
    one value."""
    rng = np.random.default_rng(23)
    if case == "int64 below 2^27":
        return [rng.integers(0, 1 << 27, size=s, dtype=np.int64) for s in sizes]
    dtype = numpy_dtype(case.split()[0])
    one = np.array([-1234.0 if dtype == np.int16 else 1.5], np.float32)
    value = one.astype(np.int16) if dtype == np.int16 else (one.view(np.uint32) >> 16).astype(np.uint16).view(dtype)
    return [np.repeat(value, s) for s in sizes]


SKEWED = ("int64 below 2^27", "int16 all equal", "bfloat16 all equal")


@pytest.mark.parametrize("case", SKEWED)
def test_sketch_of_skewed_data_matches_jax(case):
    """Data whose every key falls in one counter of the deepest level (the
    sweep kernel's hottest case: one 16-bit counter takes every key, the
    16-bit dtypes through the histogram part) sketches as the JAX
    package's ``update`` does: ``update`` and ``update_stream`` at depth 0
    and 2, pyramid, n, extremes and every query."""
    chunks = skewed(case)
    name = str(chunks[0].dtype)
    ref = jax_sketch(name, chunks)
    assert np.count_nonzero(ref.hists[-1]) == 1 and ref.hists[-1].max() == ref.n  # one hot counter
    port = RadixSketch(chunks[0].dtype, device="cpu")
    for c in chunks:
        port.update(c)
    same(port, ref)
    assert queries(port, ref.n) == queries(ref, ref.n)
    for depth in (0, 2):
        streamed = RadixSketch(chunks[0].dtype, device="cpu").update_stream(chunks, pipeline_depth=depth)
        same(streamed, ref)


@pytest.mark.parametrize("sketch_bits", [15, 16])
def test_plain_sketch_part_matches_jax_sweep_kernel_on_one_hot_keys(sketch_bits):
    """The sketch part at 15 and 16 bits on one-hot keys and pads (a 2^12
    bucket: every valid key in one counter, the pads in counter 0), the
    port's plain version against ``sweep_ingest_core`` in interpret mode."""
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.pallas import sweep_ingest as si

    bucket, n_valid = 1 << 12, (1 << 12) - 100
    keys = np.full(bucket, 0xFFFF0000 | 1234, np.uint32)  # the last counter at 16 bits
    keys[n_valid:] = 0
    none = np.zeros(0, np.uint32)
    ref = si.sweep_ingest_core(
        jnp.asarray(keys), np.int32(n_valid), jnp.asarray(none), jnp.asarray(none), jnp.asarray(none),
        jnp.asarray(none), jnp.asarray(none), np.uint32(0), sketch_bits=sketch_bits, block_rows=8, interpret=True,
    )
    deep = np.asarray(ref[4][0])
    assert deep[-1] == n_valid and deep[0] == bucket - n_valid  # the reference against the counts first
    words = torch.from_numpy(keys.view(np.int32) ^ np.int32(-(1 << 31)))
    S.reset_counts()
    _, _, _, _, (got, kmin, kmax) = S.sweep_ingest(words, n_valid, key_op="xor", key_xor=1 << 31,
                                                   sketch_bits=sketch_bits)
    assert S.PLAIN_CALLS["sweep_ingest"] == 1
    np.testing.assert_array_equal(got.numpy(), deep)
    assert int(kmin) & 0xFFFFFFFF == int(ref[4][1]) & 0xFFFFFFFF == int(kmax) & 0xFFFFFFFF


@pytest.mark.parametrize("name", ["float32", "float64", "bfloat16"])
def test_sketch_extremes_order_nan_and_signed_zero_like_jax(name):
    """Extremes in key space: ``-nan`` below ``-inf``, ``-0.0`` below
    ``+0.0``, ``+nan`` on top, as the JAX sketch orders them; chunks of one
    special value each."""
    dtype = numpy_dtype(name)
    u = {2: np.uint16, 4: np.uint32, 8: np.uint64}[dtype.itemsize]
    nan = {"float32": (0x7FC00000, 0xFFC00000), "float64": (0x7FF8000000000000, 0xFFF8000000000000),
           "bfloat16": (0x7FC0, 0xFFC0)}[name]
    for specials in ([-0.0, 0.0], [0.0, -0.0], ["-nan", 1.0], [2.0, "+nan"], ["+nan", "-nan"]):
        chunks = []
        for v in specials:
            if isinstance(v, str):
                chunks.append(np.array([nan[v == "-nan"]], u).view(dtype))
            else:
                chunks.append(np.array([v], np.float32).astype(dtype))
        ref = jax_sketch(name, chunks)
        port = RadixSketch(dtype, device="cpu").update_stream(chunks, ingest_workers=2)
        same(port, ref)


def test_merge_copy_fold_scaled_and_update_value_like_jax(rng):
    """``merge`` in every order and tree shape (the same bits), ``copy``
    independent, ``fold_scaled`` against the JAX one at weights 0, 1 and
    3, ``update_value`` the same as ``update([v])`` and as the JAX one,
    and the empty sketch an identity."""
    from mpi_k_selection_tpu.streaming.sketch import RadixSketch as JaxSketch

    x = rng.integers(-(2**31), 2**31, size=3000, dtype=np.int64).astype(np.int32)
    parts = [RadixSketch(np.int32, device="cpu").update(c) for c in np.array_split(x, 3)]
    a, b, c = parts
    whole = RadixSketch(np.int32, device="cpu").update(x)
    assert a.merge(b).merge(c) == a.merge(b.merge(c)) == c.merge(a).merge(b) == a + b + c == whole
    assert a != whole
    empty = RadixSketch(np.int32, device="cpu")
    assert a.merge(empty) == a == empty.merge(a)
    with pytest.raises(ValueError, match="empty sketch"):
        empty.rank_bounds(1)
    cp = a.copy()
    cp.update_value(np.int32(5))
    assert cp != a and cp.n == a.n + 1
    refs = [JaxSketch(np.int32).update(p) for p in np.array_split(x, 3)]
    for weight in (0, 1, 3):
        mine, theirs = a.copy(), refs[0].merge(JaxSketch(np.int32))
        mine.fold_scaled(b, weight).fold_scaled(c, weight)
        theirs.fold_scaled(refs[1], weight).fold_scaled(refs[2], weight)
        same(mine, theirs)
    with pytest.raises(ValueError, match="weight must be >= 0"):
        a.copy().fold_scaled(b, -1)
    big = a.copy()
    big.n = (1 << 63) - 100  # the next fold of 1000 keys at any weight > 0 would wrap
    with pytest.raises(OverflowError, match="overflow the int64 accumulator"):
        big.fold_scaled(b, 1 << 20)
    vals = [np.float32(v) for v in (1.5, -0.0, 0.0, np.inf, np.nan, -3.25)]
    one = RadixSketch(np.float32, device="cpu")
    ref = JaxSketch(np.float32)
    for v in vals:
        one.update_value(v)
        ref.update_value(v)
    same(one, ref)
    assert one == RadixSketch(np.float32, device="cpu").update(np.array(vals, np.float32))


def test_errors_match_jax():
    """The resolution cap, incompatible merges, dtype checks and
    ``check_stream``, with the JAX package's messages; ``pack_spill`` is
    taken by ``update_stream`` and both width knobs by
    ``StreamingQuantiles``, as the JAX package takes them; ``devices``,
    ``obs`` and ``timer`` are taken too and give the JAX package's
    sketch, while the JAX knobs the port does not take (yet) say why."""
    from mpi_k_selection_tpu.streaming.sketch import RadixSketch as JaxSketch

    for cls in (RadixSketch, JaxSketch):
        with pytest.raises(ValueError, match="fixed-size"):
            cls(np.int32, radix_bits=8, levels=4)
        with pytest.raises(ValueError, match="exceeds 16"):
            cls(np.int16, radix_bits=8, levels=3)
        with pytest.raises(ValueError, match="must be >= 1"):
            cls(np.int32, radix_bits=0)
        with pytest.raises(TypeError, match="unsupported dtype"):
            cls(np.bool_)
        with pytest.raises(ValueError, match="incompatible"):
            cls(np.int32).merge(cls(np.float32))
        with pytest.raises(TypeError):
            cls(np.int32).merge(object())
        with pytest.raises(TypeError, match="chunk dtype int64 != sketch dtype int32"):
            cls(np.int32).update(np.arange(3))
        with pytest.raises(TypeError, match="stream dtype float32 != sketch dtype int32"):
            cls(np.int32).check_stream(np.float32, 4)
        with pytest.raises(ValueError, match="must divide the 16 key bits left"):
            cls(np.int32).check_stream(np.int32, 5)
    RadixSketch(np.int32).check_stream(torch.int32, 8)
    for cls in (RadixSketch, JaxSketch):  # a schedule moves the divisibility check to the schedule
        cls(np.int32).check_stream(np.int32, 5, width_schedule="auto")
    from mpi_k_selection_tpu_torch import obs as obs_lib
    from mpi_k_selection_tpu_torch.utils.profiling import PhaseTimer

    three = [np.arange(3, dtype=np.int32), np.arange(-5, 0, dtype=np.int32)]
    want = JaxSketch(np.int32).update_stream(three, devices=2)
    for knob, value in (("devices", 2), ("obs", obs_lib.Observability.collecting()), ("timer", PhaseTimer())):
        got = RadixSketch(np.int32, device="cpu").update_stream(three, **{knob: value})
        assert [h.tolist() for h in got.hists] == [h.tolist() for h in want.hists] and got.n == want.n == 8
    for knob, why in (("fused", "no counterpart"), ("deferred", "no counterpart")):
        with pytest.raises(TypeError, match=f"{knob}.*{why}"):
            RadixSketch(np.int32, device="cpu").update_stream([np.arange(3, dtype=np.int32)], **{knob: None})
    # retry is the JAX package's knob of the descent only: the sketch raises its plain TypeError
    said = []
    for make in (lambda: RadixSketch(np.int32, device="cpu"), lambda: JaxSketch(np.int32)):
        with pytest.raises(TypeError) as ei:
            make().update_stream([np.arange(3, dtype=np.int32)], retry=None)
        said.append(str(ei.value))
    assert said[0] == said[1] == "RadixSketch.update_stream() got an unexpected keyword argument 'retry'"
    with pytest.raises(TypeError, match="unexpected keyword argument 'width_schedule'$"):  # as the JAX package's
        RadixSketch(np.int32, device="cpu").update_stream([np.arange(3, dtype=np.int32)], width_schedule="auto")
    for pack in (None, "off", "auto"):
        assert RadixSketch(np.int32, device="cpu").update_stream([np.arange(3, dtype=np.int32)], pack_spill=pack).n == 3
    with pytest.raises(ValueError, match="pack_spill must be one of"):
        RadixSketch(np.int32, device="cpu").update_stream([np.arange(3, dtype=np.int32)], pack_spill="on")
    for knob in ("deferred", "fused", "retry"):
        with pytest.raises(TypeError, match=knob):
            kt.StreamingQuantiles(np.int32, **{knob: None})
    from mpi_k_selection_tpu import api as japi

    said = []
    for cls in (kt.StreamingQuantiles, japi.StreamingQuantiles):
        with pytest.raises(TypeError) as ei:
            cls(np.int32, retry=None)
        said.append(str(ei.value))
    assert said[0] == said[1] == "StreamingQuantiles.__init__() got an unexpected keyword argument 'retry'"
    for knob in ("devices", "obs"):
        assert getattr(kt.StreamingQuantiles(np.int32, device="cpu", **{knob: None}), knob) is None
    t = kt.StreamingQuantiles(np.int32, width_schedule=(16, 8, 8), pack_spill="auto")
    assert (t.width_schedule, t.pack_spill) == ((16, 8, 8), "auto")
    with pytest.raises(ValueError, match="outside \\[1, 20\\]"):
        kt.StreamingQuantiles(np.int32, width_schedule=(32,))
    with pytest.raises(TypeError, match="unexpected keyword argument 'bogus'$"):
        RadixSketch(np.int32).update_stream([], bogus=1)
    with pytest.raises(ValueError, match="ingest_workers"):
        kt.StreamingQuantiles(np.int32, ingest_workers=0)
    with pytest.raises(TypeError, match="one-shot"):
        RadixSketch(np.int32, device="cpu").update_stream(iter([np.arange(3, dtype=np.int32)]))


@pytest.mark.parametrize("name", ["int8", "uint16", "bfloat16", "int32", "float32", "int64", "float64"])
def test_refine_matches_jax_and_numpy(name):
    """``refine`` and ``refine_many`` (a sketch-seeded descent) equal the
    JAX sketch's and NumPy's answers at widths 1 and 4, and read the
    stream fewer times than the unseeded descent; a radix width that
    divides only the bits below the sketch works."""
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    chunks = stream(name, seed=11, sizes=(2000, 1, 0, 999))
    x = np.concatenate(chunks)
    n = x.size
    ks = [1, n // 3, n // 2, n]
    want = key_oracle(x, ks)
    geo = geometry(name)
    ref = jax_sketch(name, chunks, **geo)
    with enable_x64():
        assert bits([ref.refine(chunks, k, spill="off", collect_budget=16) for k in ks], x.dtype) == want
    port = RadixSketch(x.dtype, device="cpu", **geo).update_stream(chunks)
    reads = []

    def counted():
        reads.append(1)
        return iter(chunks)

    for workers in (1, 4):
        assert bits(port.refine_many(chunks, ks, collect_budget=16, ingest_workers=workers), x.dtype) == want
    assert bits([port.refine(chunks, ks[2], collect_budget=16)], x.dtype) == key_oracle(x, ks[2:3])
    port.refine_many(counted, ks, collect_budget=16)
    seeded = len(reads)
    reads.clear()
    kt.kselect_streaming_many(counted, ks, radix_bits=4, collect_budget=16, device="cpu")
    assert seeded < len(reads)
    if dt.key_bits(name) == 32:
        assert bits([port.refine(chunks, ks[1], radix_bits=8, collect_budget=16)], x.dtype) == key_oracle(x, ks[1:2])


def test_streaming_quantiles_matches_jax(rng):
    """``update`` + ``merge`` of two trackers, ``update_stream`` at widths 1
    and 4, ``quantiles`` and ``refine_quantiles`` against the JAX
    tracker and NumPy."""
    from mpi_k_selection_tpu import StreamingQuantiles as JaxQuantiles

    x = rng.integers(0, 10**8, size=1 << 13, dtype=np.int64).astype(np.int32)
    chunks = np.array_split(x, 8)
    qs = [0.5, 0.9, 0.99, 0.999]
    t1 = kt.StreamingQuantiles(np.int32, device="cpu").update(chunks[0]).update(chunks[1])
    t2 = kt.StreamingQuantiles(np.int32, device="cpu", ingest_workers=4).update_stream(chunks[2:])
    t = t1.merge(t2)
    ref = JaxQuantiles(np.int32)
    for c in chunks:
        ref.update(c)
    same(t.sketch, ref.sketch)
    assert t.n == x.size and t.ingest_workers is None
    assert bits(t.quantiles(qs), np.int32) == bits(ref.quantiles(qs), np.int32)
    s = np.sort(x)
    want = [s[k - 1] for k in kt.api.quantile_ranks(qs, x.size)]
    assert bits(t.refine_quantiles(qs, chunks), np.int32) == bits(want, np.int32)
    assert bits(ref.refine_quantiles(qs, chunks), np.int32) == bits(want, np.int32)
    one = kt.StreamingQuantiles(np.int32, device="cpu", pipeline_depth=0).update_stream(chunks)
    assert one.sketch == t.sketch


# --- distributed_sketch and dcn_merge_sketch over gloo ------------------------


def dist_input(name: str, n: int = DIST_N, seed: int = 0) -> np.ndarray:
    """Seeded values with ties; floats with NaNs of both signs and +-0.0."""
    chunks = stream(name, seed=seed, sizes=(n,))
    return chunks[0]


def rank_cases(mesh):
    """Every distributed case on this rank: ``{case: (deep, n, min, max)}``
    for each dtype's ``distributed_sketch``, a placed shard's, a 3 x 4
    geometry's, and a ``dcn_merge_sketch`` of each rank's own sketch."""
    torch.set_num_threads(2)

    def flat(sk):
        return (sk.hists[-1], sk.n, sk._min_key, sk._max_key, [h.sum() for h in sk.hists])

    out = {}
    for name in DIST_DTYPES:
        x = dist_input(name)
        out[name] = flat(kt.distributed_sketch(x, mesh=mesh, **geometry(name)))
    x = dist_input("int32")
    out["shard"] = flat(kt.distributed_sketch(kt.parallel.shard_1d(x, mesh), mesh=mesh))
    out["3x4"] = flat(kt.distributed_sketch(x, mesh=mesh, radix_bits=3, levels=4))
    out["tiny"] = flat(kt.distributed_sketch(x[:1], mesh=mesh))  # one rank holds the only key
    out["one-hot int64"] = flat(kt.distributed_sketch(np.concatenate(skewed("int64 below 2^27")), mesh=mesh))
    local = RadixSketch(np.int32, device="cpu")
    if mesh.rank != 1:  # rank 1 saw nothing: its extremes must not count
        local.update(x[mesh.rank::mesh.size])
    mesh.reset_stats()
    out["dcn"] = flat(psk.dcn_merge_sketch(local, mesh=mesh))
    out["dcn_collectives"] = mesh.collectives
    out["payload"] = psk._split_u32(psk._pack_sketch_payload(local))
    return out


@pytest.fixture(scope="module")
def port():
    return {w: multihost.run_ranks(rank_cases, w, device="cpu", timeout=SPAWN_TIMEOUT_S) for w in WORLDS}


def jax_distributed(name, x, world, **kw):
    import jax.numpy as jnp

    from mpi_k_selection_tpu.parallel import distributed_sketch, make_mesh
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    if wide(name):
        with enable_x64():
            return distributed_sketch(jnp.asarray(x), mesh=make_mesh(world), **kw)
    return distributed_sketch(jnp.asarray(x), mesh=make_mesh(world), **kw)


def same_flat(got, ref) -> None:
    deep, n, kmin, kmax, sums = got
    assert np.array_equal(deep, ref.hists[-1]) and n == ref.n
    assert int(kmin) == int(ref._min_key) and int(kmax) == int(ref._max_key)
    assert sums == [h.sum() for h in ref.hists]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", DIST_DTYPES)
def test_distributed_sketch_matches_jax(port, world, name):
    """Each rank's sketch equals the JAX package's ``distributed_sketch`` on
    ``make_mesh(P)`` and a host sketch of the whole array, bit for bit
    (the sentinel pads of the last shards never counted)."""
    x = dist_input(name)
    ref = jax_distributed(name, x, world, **geometry(name))
    same(RadixSketch(x.dtype, device="cpu", **geometry(name)).update(x), ref)
    same_flat(port[world][name], ref)


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_sketch_shards_geometry_and_dcn_merge(port, world):
    """A placed shard sketches as the global array does; a 3 x 4 geometry
    and a one-key array match JAX; ``dcn_merge_sketch`` of each rank's
    own sketch (rank 1 empty) is their merge, in one ``all_gather``."""
    x = dist_input("int32")
    out = port[world]
    same_flat(out["shard"], jax_distributed("int32", x, world))
    same_flat(out["3x4"], jax_distributed("int32", x, world, radix_bits=3, levels=4))
    same_flat(out["tiny"], RadixSketch(np.int32, device="cpu").update(x[:1]))
    merged = RadixSketch(np.int32, device="cpu")
    for r in range(world):
        if r != 1:
            merged.update(x[r::world])
    same_flat(out["dcn"], merged)
    assert out["dcn_collectives"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_sketch_of_one_hot_int64_matches_jax(port, world):
    """``distributed_sketch`` of int64 below 2^27 (every key of every shard
    in one counter of the deepest level) equals the JAX package's on
    ``make_mesh(P)``, bit for bit."""
    x = np.concatenate(skewed("int64 below 2^27"))
    same_flat(port[world]["one-hot int64"], jax_distributed("int64", x, world))


def test_dcn_payloads_cross_decode_between_packages(port, rng):
    """The wire format is the JAX package's byte for byte: a payload packed
    by either package decodes with the other's unpacker to the same
    sketch, empty processes included; one process is the identity."""
    from mpi_k_selection_tpu.parallel import sketch as jsk
    from mpi_k_selection_tpu.streaming.sketch import RadixSketch as JaxSketch

    for name in ("int32", "float64", "uint16"):
        x = dist_input(name, 2000, seed=5)
        parts = np.array_split(x, 3)
        mine = [RadixSketch(x.dtype, device="cpu").update(p) for p in parts] + [RadixSketch(x.dtype)]
        theirs = [JaxSketch(x.dtype).update(p) for p in parts] + [JaxSketch(x.dtype)]
        rows_mine = np.stack([psk._split_u32(psk._pack_sketch_payload(s)) for s in mine])
        rows_theirs = np.stack([jsk._split_u32(jsk._pack_sketch_payload(s)) for s in theirs])
        assert rows_mine.dtype == rows_theirs.dtype == np.uint32
        assert rows_mine.tobytes() == rows_theirs.tobytes()
        same(psk._unpack_gathered_payloads(rows_theirs, mine[0]), jsk._unpack_gathered_payloads(rows_mine, theirs[0]))
    x = dist_input("int32")
    local = RadixSketch(np.int32, device="cpu").update(x[0::2])
    assert port[2]["payload"].tobytes() == jsk._split_u32(jsk._pack_sketch_payload(JaxSketch(np.int32).update(x[0::2]))).tobytes()
    assert psk.dcn_merge_sketch(local) is local


def test_distributed_sketch_refuses_one_rank():
    with pytest.raises(ValueError, match="needs >= 2"):
        kt.distributed_sketch(np.arange(10, dtype=np.int32), mesh=kt.make_mesh(device="cpu"))


# --- on the card ----------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["int8", "int16", "bfloat16", "uint32", "float32", "int64", "float64"])
def test_sketch_consumer_on_card_matches_plain(name):
    """The sketch consumer's one launch per chunk on the card equals its
    plain version (the deep level and extremes, every dtype route: the
    histogram part for sub-32-bit keys), through ``update_stream`` at
    widths 1 and 4 and ``update`` of a CUDA tensor, with no plain call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card: python -m pytest --noconftest tests/test_torch_*.py -m gpu")
    chunks = stream(name, seed=13, sizes=(300_000, 1, 0, 123_457))
    geo = geometry(name)
    cpu = RadixSketch(chunks[0].dtype, device="cpu", **geo).update_stream(chunks)
    for workers in (1, 4):
        S.reset_counts()
        card = RadixSketch(chunks[0].dtype, **geo).update_stream(chunks, ingest_workers=workers)
        assert card == cpu
        assert sum(S.LAUNCHES.values()) == 3 and not S.PLAIN_CALLS["sweep_ingest"]
    S.reset_counts()
    one = RadixSketch(chunks[0].dtype, **geo)
    for c in chunks:
        one.update(tensor_from_numpy(c, "cuda"))
    assert one == cpu and sum(S.LAUNCHES.values()) == 3 and not S.PLAIN_CALLS["sweep_ingest"]
    keys = pl.stage_chunk(tensor_from_numpy(chunks[0], "cuda"), dt.torch_dtype(name), torch.device("cuda"))
    consumer = ex.SketchFoldConsumer(RadixSketch(chunks[0].dtype, **geo))
    consumer.finish(consumer.dispatch(keys))
    assert consumer.sketch == RadixSketch(chunks[0].dtype, device="cpu", **geo).update(chunks[0])
    keys.release()
