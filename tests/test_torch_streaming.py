"""The port's streamed selection (``kselect_streaming``,
``kselect_streaming_many``, ``streaming_rank_certificate``) and its sweep
kernel against the JAX package and NumPy, bit for bit.

The same seeded numpy chunks go to both packages. The JAX sweep kernel
runs in interpret mode on 2^12 and 2^14 buckets with a small tile height
(a multi-step grid); its 64-bit counterpart is the XLA fusion tier
(``fused_ingest_core``). Counts are integers, buffers are compared byte for
byte and answers as bit patterns: no tolerance anywhere. The JAX package
is imported inside the tests that use it, so the ``gpu`` tests also
collect where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_*.py -m gpu
"""

import json
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import mpi_k_selection_tpu_torch as kt
from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
from mpi_k_selection_tpu_torch.streaming import executor as ex
from mpi_k_selection_tpu_torch.streaming import pipeline as pl
from mpi_k_selection_tpu_torch.utils import datagen
from mpi_k_selection_tpu_torch.utils import dtypes as dt
from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype, tensor_from_numpy

# one intra-op thread: in a parallel test run each worker's torch thread pool
# oversubscribes the cores, and small CPU ops stall on its barriers
torch.set_num_threads(1)

DTYPES = (
    "int8", "uint8", "int16", "uint16", "int32", "uint32",
    "int64", "uint64", "float16", "bfloat16", "float32", "float64",
)
SIZES = (700, 1, 0, 333)  # a ragged last chunk and an empty one
_NAN = {  # (+nan, -nan) bit patterns
    "float16": (0x7E00, 0xFE00), "bfloat16": (0x7FC0, 0xFFC0),
    "float32": (0x7FC00000, 0xFFC00000), "float64": (0x7FF8000000000000, 0xFFF8000000000000),
}
_UNSIGNED = {2: np.uint16, 4: np.uint32, 8: np.uint64}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs a CUDA device; on the card: "
            "python -m pytest --noconftest tests/test_torch_*.py -m gpu"
        )
    return torch.device("cuda")


def stream(name, seed=0, sizes=SIZES):
    """Seeded chunks of ``name`` with ties; floats also hold +-0.0, +-inf
    and NaNs of both signs, integers their extremes."""
    rng = np.random.default_rng(seed)
    n = sum(sizes)
    dtype = numpy_dtype(name)
    if name in _NAN:
        f = (np.round(rng.standard_normal(n) * 4) / 4).astype(np.float32)
        if name == "bfloat16":
            x = (f.view(np.uint32) >> 16).astype(np.uint16).view(dtype)
        else:
            x = f.astype(dtype)
        u = x.view(_UNSIGNED[x.dtype.itemsize])
        pos = rng.choice(n, size=12, replace=False)
        x[pos[:2]] = 0.0
        x[pos[2:4]] = -0.0
        x[pos[4]], x[pos[5]] = np.inf, -np.inf
        u[pos[6:9]] = _NAN[name][0]
        u[pos[9:12]] = _NAN[name][1]
    else:
        info = np.iinfo(dtype)
        pool = rng.integers(info.min, info.max, size=40, dtype=dtype, endpoint=True)
        x = rng.choice(np.concatenate([pool, np.array([info.min, info.max], dtype)]), size=n)
    return np.split(x, np.cumsum(sizes)[:-1])


def key_oracle(x, ks):
    """The k-th smallest of ``x`` in key order for each k, as raw bytes."""
    keys = np.sort(dt.np_to_sortable_bits(x))
    return dt.np_from_sortable_bits(keys[np.asarray(ks) - 1], x.dtype).tobytes()


def bits(vals, dtype):
    return np.array(vals, dtype=dtype).tobytes()


def _spec_arrays(specs, kdt):
    return np.array([s for s, _ in specs], kdt), np.array([p for _, p in specs], kdt)


def _assert_parts_equal(got, want_hist, want_collect, want_tee, want_cert, want_sketch):
    hist, collect, tee, cert, sketch = got
    np.testing.assert_array_equal(hist.numpy(), np.asarray(want_hist))
    for (buf, cnt), (wbuf, wcnt) in zip(collect + (tee,), tuple(want_collect) + (want_tee,)):
        assert buf.numpy().tobytes() == np.asarray(wbuf).tobytes()  # the whole buffer, zeros after
        assert int(cnt) == int(wcnt)
    assert (int(cert[0]), int(cert[1])) == tuple(int(c) for c in want_cert)
    np.testing.assert_array_equal(sketch[0].numpy(), np.asarray(want_sketch[0]))
    width = sketch[1].element_size() * 8
    for got_k, want_k in zip(sketch[1:], want_sketch[1:]):
        assert int(got_k) & ((1 << width) - 1) == int(want_k)


def _flat(out):
    """The tensors of a sweep_ingest result, in order (parts that are off
    leave a None marker)."""
    flat = []
    for part in out:
        for t in part if isinstance(part, tuple) else (part,):
            flat.extend(t if isinstance(t, tuple) else (t,))
    return flat


def _raw_words(keys, key_op):
    """Raw words whose keys under ``key_op`` are ``keys`` (unsigned)."""
    if key_op == "none":
        return keys
    if key_op == "xor":
        return keys ^ keys.dtype.type(1 << (keys.dtype.itemsize * 8 - 1))
    fdt = np.float32 if keys.dtype.itemsize == 4 else np.float64
    return dt.np_from_sortable_bits(keys, fdt).view(keys.dtype)


def _port_sweep(keys, n_valid, key_op, rng, **parts):
    """The plain version on the raw words of ``keys``, its pads filled with
    garbage (pads count as key 0 whatever their bits)."""
    raw = _raw_words(keys, key_op).copy()
    raw[n_valid:] = rng.integers(0, 1 << 32, size=raw.size - n_valid).astype(raw.dtype)
    words = torch.from_numpy(raw.view(np.int32 if raw.itemsize == 4 else np.int64))
    key_xor = 1 << (raw.itemsize * 8 - 1) if key_op == "xor" else 0
    S.reset_counts()
    got = S.sweep_ingest(words, n_valid, key_op=key_op, key_xor=key_xor, **parts)
    assert S.PLAIN_CALLS["sweep_ingest"] == 1 and not any(S.LAUNCHES.values())
    return got


@pytest.mark.parametrize("bucket", [1 << 12, 1 << 14])
def test_plain_matches_jax_sweep_kernel(bucket):
    """Every part at once against ``sweep_ingest_core`` in interpret mode,
    8-row tiles (a 4- and a 16-step grid), pads present: a sparse spec
    (~1/256 survive), a spec matching every key (0 resolved bits, shift
    32), a 16-bit spec, a two-spec tee union, a repeated histogram prefix."""
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.pallas import sweep_ingest as si

    rng = np.random.default_rng(bucket)
    n_valid = bucket - 37
    keys = rng.integers(0, 1 << 32, size=bucket, dtype=np.uint32)
    keys[n_valid:] = 0  # the JAX staging contract: pads are key 0
    u = [int(v) for v in keys]
    prefixes = [u[0] >> 24, u[3] >> 24, u[0] >> 24]
    collect = [(24, u[0] >> 24), (32, 0), (16, u[5] >> 16)]
    tee = [(16, u[5] >> 16), (24, u[9] >> 24)]
    vkey = u[100]
    cs, cp = _spec_arrays(collect, np.uint32)
    ts, tp = _spec_arrays(tee, np.uint32)
    ref = si.sweep_ingest_core(
        jnp.asarray(keys), np.int32(n_valid), jnp.asarray(np.array(prefixes, np.uint32)),
        jnp.asarray(cs), jnp.asarray(cp), jnp.asarray(ts), jnp.asarray(tp), np.uint32(vkey),
        shift=16, radix_bits=8, hist_mode="multi", n_collect=3, n_tee=2, cert=True,
        sketch_bits=12, block_rows=8, interpret=True,
    )
    valid = keys[:n_valid]
    assert int(ref[3][0]) == np.count_nonzero(valid < vkey)  # the reference against numpy first
    assert ref[2][0][: int(ref[2][1])].tolist() == valid[
        ((valid >> 16) == tee[0][1]) | ((valid >> 8) >> 16 == tee[1][1])
    ].tolist()
    for key_op in ("none", "xor", "float"):
        got = _port_sweep(
            keys, n_valid, key_op, rng, shift=16, radix_bits=8, hist_prefixes=prefixes,
            collect=collect, tee=tee, vkey=vkey, sketch_bits=12,
        )
        _assert_parts_equal(got, *ref)


def test_plain_matches_jax_sweep_kernel_on_hot_bins():
    """The stream's own data (values in [1, 10^8]: the top digit takes a few
    values, each key repeats) in a 2^14 bucket, against
    ``sweep_ingest_core`` in interpret mode: K=4 histogram prefixes with a
    repeat, 4 collect specs (one that no key holds), a tee union and the
    certificate."""
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.pallas import sweep_ingest as si

    rng = np.random.default_rng(7)
    bucket, n_valid = 1 << 14, (1 << 14) - 300
    vals = rng.integers(1, 10**8, size=bucket, endpoint=True).astype(np.int32)
    keys = vals.view(np.uint32) ^ np.uint32(1 << 31)
    keys[n_valid:] = 0  # the JAX staging contract: pads are key 0
    u = [int(v) for v in keys[:64]]
    prefixes = [u[0] >> 24, u[1] >> 24, u[2] >> 24, u[0] >> 24]
    collect = [(8, u[3] >> 8), (8, u[4] >> 8), (16, u[5] >> 16), (8, (1 << 24) - 1)]
    tee = [(16, u[6] >> 16), (8, u[7] >> 8)]
    cs, cp = _spec_arrays(collect, np.uint32)
    ts, tp = _spec_arrays(tee, np.uint32)
    ref = si.sweep_ingest_core(
        jnp.asarray(keys), np.int32(n_valid), jnp.asarray(np.array(prefixes, np.uint32)),
        jnp.asarray(cs), jnp.asarray(cp), jnp.asarray(ts), jnp.asarray(tp), np.uint32(u[8]),
        shift=16, radix_bits=8, hist_mode="multi", n_collect=4, n_tee=2, cert=True,
        sketch_bits=0, block_rows=8, interpret=True,
    )
    assert int(ref[1][3][1]) == 0 and int(ref[1][0][1]) > 0  # the absent spec, a present one
    assert np.count_nonzero(np.asarray(ref[0])) <= 4 * 256 and np.asarray(ref[0])[0].sum() > n_valid // 8
    raw = keys.view(np.int32) ^ np.int32(-(1 << 31))
    raw[n_valid:] = rng.integers(-(1 << 31), 1 << 31, size=bucket - n_valid).astype(np.int32)  # pads: any bits
    S.reset_counts()
    hist, got_collect, got_tee, cert, sketch = S.sweep_ingest(
        torch.from_numpy(raw), n_valid, key_op="xor", key_xor=1 << 31, shift=16, radix_bits=8,
        hist_prefixes=prefixes, collect=collect, tee=tee, vkey=u[8],
    )
    assert S.PLAIN_CALLS["sweep_ingest"] == 1 and sketch is None
    np.testing.assert_array_equal(hist.numpy(), np.asarray(ref[0]))
    for (buf, cnt), (wbuf, wcnt) in zip(got_collect + (got_tee,), tuple(ref[1]) + (ref[2],)):
        assert buf.numpy().view(np.uint32).tobytes() == np.asarray(wbuf).tobytes()
        assert int(cnt) == int(wcnt)
    assert (int(cert[0]), int(cert[1])) == (int(ref[3][0]), int(ref[3][1]))


_PLAN_CASES = {  # label: (sweep_plan keywords, route)
    "first pass": (dict(nd=1, shift=-8, radix_bits=8), S.ORDER_FREE),
    "4 prefixes, exact table": (dict(nd=4, shift=-16, radix_bits=8), S.ORDER_FREE),
    "4 prefixes, hashed table": (dict(nd=4, shift=-24, radix_bits=8), S.ORDER_FREE),
    "64 prefixes, by value": (dict(nd=64, shift=-24, radix_bits=8), S.ORDER_FREE),
    "65 prefixes, a device array": (dict(nd=65, shift=-24, radix_bits=8), S.ORDER_FREE),
    "2048 prefixes, 12-bit digit": (dict(nd=2048, shift=-36, radix_bits=12), S.ORDER_FREE),
    "certificate": (dict(nd=0), S.ORDER_FREE),
    "sketch of 20 bits": (dict(nd=0, sketch_bits=20), S.ORDER_FREE),
    "sketch of 16 bits": (dict(nd=0, sketch_bits=16), S.ORDER_FREE),
    "sketch of 15 bits": (dict(nd=0, sketch_bits=15), S.ORDER_FREE),
    "16-bit digit, no prefix": (dict(nd=1, shift=-16, radix_bits=16), S.ORDER_FREE),
    "16-bit digit, no prefix, and a sketch of 1 bit": (dict(nd=1, shift=-16, radix_bits=16, sketch_bits=1),
                                                      S.ORDER_FREE),
    "4 prefixes and a sketch of 16 bits": (dict(nd=4, shift=-16, radix_bits=8, sketch_bits=16), S.ORDER_FREE),
    "collect, 1 spec": (dict(nd=0, n_collect=1), S.ORDERED),
    "collect, 4 specs": (dict(nd=0, n_collect=4), S.ORDERED),
    "collect, 17 specs, a device array": (dict(nd=0, n_collect=17), S.ORDERED),
    "collect, 1 spec, and a sketch of 1 bit": (dict(nd=0, n_collect=1, sketch_bits=1), S.ORDERED),
    "all five": (dict(nd=4, shift=-16, radix_bits=8, n_collect=2, n_tee=2, sketch_bits=20), S.ORDERED),
    "all five, a sketch of 16 bits": (dict(nd=4, shift=-16, radix_bits=8, n_collect=2, n_tee=2, sketch_bits=16),
                                      S.ORDERED),
    "hist, 1 prefix, and its tee (a spill pass)": (dict(nd=1, shift=-16, radix_bits=8, n_tee=1, n_teed=1), S.ORDERED),
    "hist, no prefix, and the every-key tee (pass 0)": (dict(nd=1, shift=-8, radix_bits=8, n_tee=1, n_teed=1),
                                                       S.ORDERED),
    "hist, 4 prefixes, their tee and a parked spec": (dict(nd=4, shift=-24, radix_bits=8, n_tee=5, n_teed=4),
                                                      S.ORDERED),
    "hist, 8 prefixes, and 8 teed of 9 tee specs": (dict(nd=8, shift=-24, radix_bits=8, n_tee=9, n_teed=8),
                                                     S.ORDERED),
}


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("case", list(_PLAN_CASES))
def test_sweep_plan_routes_tiles_grid_and_budget(bits, case):
    """The kernel's launch plan for each part set: the ordered route exactly
    when a survivor buffer is asked for; 64 KB tiles, so a 2^26-word int32
    chunk takes 4096 tickets; the grid within the blocks an SM holds (by
    threads and shared memory) and within the work; shared memory within a
    block's 227 KB; sub-histogram copies within ``COPIES_SMEM`` and no more
    when twice as many would fit (in the cap and the block), up to 16 on
    the ordered route and 8 on the other; tee specs that are the histogram's prefixes
    (``n_teed``) take no place among the specs the kernel compares; int32
    counters in shared memory up to
    ``HIST_SMEM``, 16-bit ones for a histogram of one prefix or a sketch at
    ``PACKED_BITS`` on the order-free route, in the wide block, one an SM;
    parameters by value up to the capacity, in a device array above it."""
    kw, route = _PLAN_CASES[case]
    kw = dict(kw)
    if "shift" in kw:
        kw["shift"] += bits
    n, sms = (1 << 26) * 32 // bits, 132
    plan = S.sweep_plan(bits, n, sms=sms, **kw)
    assert plan.route == route
    wide = 2 in (plan.hist_smem, plan.deep_smem)
    assert plan.threads == (S.ORD_THREADS if route == S.ORDERED else S.WIDE_THREADS if wide else S.THREADS)
    if route == S.ORDERED:
        assert plan.tile_words * bits // 8 == S.TILE_BYTES and plan.n_tiles == 4096
        work = plan.n_tiles
    else:
        assert plan.tile_words == plan.n_tiles == 0
        work = -(-n // (plan.threads * S.UNROLL * 16 // (bits // 8)))
    n_specs = kw.get("n_collect", 0) + kw.get("n_tee", 0) - kw.get("n_teed", 0)  # the specs the kernel compares
    assert plan.smem == S._smem_bytes(plan.route, bits, kw["nd"], plan.tbits, plan.copies, kw.get("radix_bits", 1),
                                      plan.hist_smem, n_specs, kw.get("sketch_bits", 0), plan.deep_smem)
    assert plan.smem <= S.SMEM_PER_BLOCK
    assert 1 <= plan.per_sm * plan.threads <= S.MAX_THREADS_PER_SM
    assert plan.per_sm * (plan.smem + S.SMEM_RESERVED) <= S.SMEM_PER_SM
    assert 1 <= plan.blocks <= min(plan.per_sm * sms, work)
    copy = kw["nd"] * (4 << kw.get("radix_bits", 1))
    order_free = route == S.ORDER_FREE
    packed_hist = order_free and kw["nd"] == 1 and kw.get("radix_bits") in S.PACKED_BITS
    assert plan.hist_smem == (4 if 0 < copy <= S.HIST_SMEM else 2 if packed_hist else 0)
    most = 16 if route == S.ORDERED else 8
    assert plan.copies in (16, 8, 4, 2, 1)[(route != S.ORDERED):]
    assert plan.copies == 1 or plan.copies * copy <= S.COPIES_SMEM
    if plan.hist_smem == 4 and plan.copies < most:  # twice as many would pass the cap or the block
        twice = S._smem_bytes(plan.route, bits, kw["nd"], plan.tbits, 2 * plan.copies, kw.get("radix_bits", 1),
                              4, n_specs, kw.get("sketch_bits", 0), plan.deep_smem)
        assert 2 * plan.copies * copy > S.COPIES_SMEM or twice > S.SMEM_PER_BLOCK
    assert plan.tbits == (min(bits - kw["shift"] - kw["radix_bits"], S.TABLE_BITS) if kw["nd"] > 1 else 0)
    assert plan.prefixes_by_value == (kw["nd"] <= S.PARAM_PREFIXES)
    assert plan.specs_by_value == (n_specs <= S.PARAM_SPECS)
    sketch_bits = kw.get("sketch_bits", 0)
    in_registers = order_free and sketch_bits == 1  # the order-free route's 1-bit sketch
    assert plan.deep_smem == (4 if sketch_bits and not in_registers and (4 << sketch_bits) <= S.HIST_SMEM
                              else 2 if order_free and sketch_bits in S.PACKED_BITS else 0)
    assert plan.per_sm == 1 or not wide


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("width", range(13, S.MAX_BITS + 1))
def test_sweep_plan_packs_16_bit_counters(bits, width):
    """The sketch's counters, and those of a histogram of one prefix
    (prefix-free or not), lie in shared memory at every width up to 16
    within a block's ``SMEM_PER_BLOCK``: int32 up to 14 bits, 16-bit halves
    (two to a word, in the wide block) at 15 and 16; from 17 bits in
    global memory. Two prefixes at 15-16 bits stay global (one row only)."""
    n, sms = (1 << 26) * 32 // bits, 132
    want = 4 if width <= 14 else 2 if width in S.PACKED_BITS else 0
    plans = {
        "sketch": S.sweep_plan(bits, n, nd=0, sketch_bits=width, sms=sms),
        "no prefix": S.sweep_plan(bits, n, nd=1, shift=bits - width, radix_bits=width, sms=sms),
        "one prefix": S.sweep_plan(bits, n, nd=1, shift=bits - width - 8, radix_bits=width, sms=sms),
    }
    for label, plan in plans.items():
        smem = plan.deep_smem if label == "sketch" else plan.hist_smem
        assert smem == want, label
        assert plan.smem == want << width and plan.smem <= S.SMEM_PER_BLOCK
        assert plan.threads == (S.WIDE_THREADS if want == 2 else S.THREADS)
        assert plan.per_sm == (1 if want == 2 else max(1, min(8, S.SMEM_PER_SM // (plan.smem + S.SMEM_RESERVED))))
        assert plan.blocks == min(plan.per_sm * sms, -(-n // (plan.threads * S.UNROLL * 16 // (bits // 8))))
        assert plan.copies == 1 or want == 4
    two = S.sweep_plan(bits, n, nd=2, shift=bits - width - 8, radix_bits=width, sms=sms)
    assert two.hist_smem == (4 if 2 * (4 << width) <= S.HIST_SMEM else 0) and two.threads == S.THREADS


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("sketch_bits", [8, 14, 15, 16, 20])
@pytest.mark.parametrize("n_specs", [0, 2])
def test_sweep_plan_keeps_the_histogram_copies_beside_a_sketch(bits, sketch_bits, n_specs):
    """Shared memory goes first to the histogram: a launch with a sketch of
    any width keeps the sub-histogram copies of the same launch without
    it (order-free, and the ordered all-parts launch), and the sketch's
    counters take shared memory only where they fit beside them."""
    n, sms = (1 << 26) * 32 // bits, 132
    hist = dict(nd=4, shift=bits - 16, radix_bits=8, n_collect=n_specs, n_tee=n_specs)
    alone = S.sweep_plan(bits, n, sms=sms, **hist)
    both = S.sweep_plan(bits, n, sketch_bits=sketch_bits, sms=sms, **hist)
    assert (both.copies, both.hist_smem, both.route) == (alone.copies, alone.hist_smem, alone.route)
    assert alone.hist_smem == 4 and alone.copies > 1
    assert both.smem == alone.smem + (both.deep_smem << sketch_bits) <= S.SMEM_PER_BLOCK
    if n_specs:  # the ordered route's stages leave no room for a 16-bit sketch
        assert both.deep_smem == (4 if sketch_bits <= 8 else 0)
    else:
        assert both.deep_smem == (4 if sketch_bits <= 14 else 2 if sketch_bits in S.PACKED_BITS else 0)


def test_sweep_plan_refuses_a_table_past_half_full():
    S.sweep_plan(32, 1 << 20, nd=S.MAX_TABLE_PREFIXES, shift=0, radix_bits=8, sms=132)
    with pytest.raises(ValueError):
        S.sweep_plan(32, 1 << 20, nd=S.MAX_TABLE_PREFIXES + 1, shift=0, radix_bits=8, sms=132)
    for nd, n_tee, n_teed in ((1, 1, 2), (2, 1, 2), (0, 1, 1)):  # more teed prefixes than prefixes or tee specs
        with pytest.raises(ValueError):
            S.sweep_plan(32, 1 << 20, nd=nd, shift=16, radix_bits=8, n_tee=n_tee, n_teed=n_teed, sms=132)


@pytest.mark.parametrize("bits", [32, 64])
def test_launch_tees_the_histograms_prefixes_on_its_lookup(bits):
    """The wrapper's layout of a histogram + tee launch (``_layout``): a tee
    spec at the histogram's prefix width whose prefix the launch counts
    joins the lookup, its prefix placed among the first ``n_teed`` rows;
    every other tee spec is compared; each query's row still names its
    prefix; and on random keys, a key is teed (its row below ``n_teed``, or
    a compared spec) exactly when the plain version's union takes it."""
    rng = np.random.default_rng(bits)
    shift, rb = bits - 24, 8
    keys = rng.integers(0, 1 << bits, size=4000, dtype=np.uint64).astype(object)
    q = sorted({int(k) >> (bits - 16) for k in keys[:5]})
    prefixes = (q[0], q[1], q[2], q[1], 1 << 17)  # a repeat, and a prefix no key can hold
    tee = ((bits - 16, q[2]), (bits - 16, q[1]), (bits - 12, int(keys[7]) >> (bits - 12)), (bits - 16, q[3]),
           (bits - 16, q[1]))
    lay = S._layout(bits, 1 << 20, shift, rb, prefixes, (), tee, 0, 132)
    distinct = lay.groups[0][0]
    assert lay.n_teed == 2 and list(distinct) == [q[1], q[2], q[0]]  # the teed first, in the prefixes' order
    for p, r in zip(prefixes, lay.rows):
        assert distinct[r] == p if r < len(distinct) else p >> 16
    other = [tee[2], tee[3]]  # another width; a prefix the histogram does not count
    masks, wants = S.spec_masks(bits, other)
    assert lay.spec_words == tuple(masks + wants) and lay.n_other == 2 and lay.n_surv == 1
    plan = lay.groups[0][2]
    assert plan.route == S.ORDERED and plan.specs_by_value
    keys = list(keys[:3000]) + [int(k) ^ (int(k) & ((1 << (bits - 16)) - 1)) ^ 5 for k in keys[:1000]]
    for k in keys:
        row = distinct.index(k >> (shift + rb)) if k >> (shift + rb) in distinct else -1
        teed = 0 <= row < lay.n_teed or any(k & m == w for m, w in zip(masks, wants))
        assert teed == any(k >> s == p for s, p in tee), k


@pytest.mark.parametrize("bits", [32, 64])
def test_launch_folds_prefixes_and_specs_as_the_plain_version_reads_them(bits):
    """The wrapper's forms of the parts, against the plain version's
    arithmetic on random keys: each query's prefix row (repeats share a row;
    a prefix no key can hold, a too-wide or a negative one, takes the zero
    row) and each spec's ``key & mask == want`` (shifts 0 .. the word width,
    a prefix wider than the bits left)."""
    rng = np.random.default_rng(bits)
    keys = [int(k) & ((1 << bits) - 1) for k in rng.integers(0, 1 << 63, size=400, dtype=np.uint64)]
    full = (1 << bits) - 1
    shift, rb = bits - 16, 8
    prefixes = [keys[0] >> (bits - 8), keys[1] >> (bits - 8), keys[0] >> (bits - 8), 1 << 20, -5, 300]
    distinct, rows = S.distinct_prefixes(bits, shift, rb, prefixes)
    assert len(set(distinct)) == len(distinct) and rows[0] == rows[2] != rows[1]
    for p, r in zip(prefixes, rows):
        c = (p << rb) & full  # the plain version's z = (key >> shift) ^ c, a hit when z < 2^rb
        held = [k for k in keys if ((k >> shift) ^ c) < (1 << rb)]
        if r == len(distinct):
            assert not held and c >> rb >= 1 << (bits - shift - rb)
        else:
            assert distinct[r] == c >> rb
    specs = [(0, keys[2]), (1, keys[3] >> 1), (8, keys[4] >> 8), (bits - 1, 1), (bits, 0), (bits, 3),
             (8, 1 << (bits - 7)), (bits // 2, keys[5] >> (bits // 2))]
    masks, wants = S.spec_masks(bits, specs)
    for (s, p), m, w in zip(specs, masks, wants):
        for k in keys[:64] + [keys[2], keys[5], 0, full]:
            assert ((k & m) == w) == ((p == 0) if s >= bits else ((k >> s) == p)), (s, p, k)


TEE_SHARES = (0.01, 0.17, 0.5, 1.0)  # the tee kind's survivor shares under its one 8-bit prefix
N_TEE_CASES = len(TEE_SHARES) + 2


def tee_cases(bits, size, rng):
    """(label, keys, parts) of the spill passes' histogram + tee launch on
    ``size`` random ``bits``-wide keys: the histogram of the 8 bits below
    one 8-bit prefix (``radix_bits=8``, ``shift=bits-16``) beside the tee
    of that prefix, on keys of which about 1%, 17%, 50% and 100% hold it;
    4 such 16-bit prefixes (each on a tenth of the keys) beside the tee of
    their union and of a parked rank's 12-bit spec (on 1%); and pass 0's
    every-key tee beside the prefix-free first pass."""
    kdt = np.uint32 if bits == 32 else np.uint64
    base = rng.integers(0, 1 << bits, size=size, dtype=np.uint64).astype(kdt)

    def holding(keys, share, width, prefix):  # a share of the keys moved under the prefix
        low = kdt((1 << (bits - width)) - 1)
        moved = (keys & low) | kdt(prefix << (bits - width))
        return np.where(rng.random(size) < share, moved, keys).astype(kdt)

    p8 = int(base[0]) >> (bits - 8)
    one = dict(hist_prefixes=[p8], shift=bits - 16, radix_bits=8, tee=[(bits - 8, p8)])
    cases = [(f"one 8-bit prefix, {share:.0%} of keys", holding(base, share, 8, p8), one) for share in TEE_SHARES]
    q16 = sorted({int(k) >> (bits - 16) for k in base[1:9]})[:4]
    keys = base
    for q in q16:
        keys = holding(keys, 0.1, 16, q)
    p12 = int(base[9]) >> (bits - 12)
    cases.append(("4 16-bit prefixes and a parked 12-bit spec", holding(keys, 0.01, 12, p12), dict(
        hist_prefixes=q16, shift=bits - 24, radix_bits=8, tee=[(bits - 16, q) for q in q16] + [(bits - 12, p12)])))
    cases.append(("every key (pass 0)", base, dict(hist_prefixes=[0], shift=bits - 8, radix_bits=8, tee=[(bits, 0)])))
    return cases


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("case", range(N_TEE_CASES))
def test_plain_matches_jax_on_the_tee_kinds(bits, case):
    """Row 8's histogram + tee launch at each shape of :func:`tee_cases`,
    pads present, against the JAX package: ``sweep_ingest_core`` in
    interpret mode for 32-bit keys, its XLA fusion tier
    (``fused_ingest_core``, the JAX package's path for 64-bit key spaces,
    x64 enabled in scope) for 64-bit keys; counts and the whole tee buffer
    exactly, under each key op."""
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.pallas import fused_ingest as fi
    from mpi_k_selection_tpu.ops.pallas import sweep_ingest as si
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    rng = np.random.default_rng(100 + bits)
    bucket = 1 << 12
    n_valid = bucket - 37
    label, keys, parts = tee_cases(bits, bucket, rng)[case]
    kdt = keys.dtype.type
    keys = keys.copy()
    keys[n_valid:] = 0  # the JAX staging contract: pads are key 0
    ts, tp = _spec_arrays(parts["tee"], kdt)
    none = np.zeros(0, kdt)
    common = dict(shift=parts["shift"], radix_bits=parts["radix_bits"], hist_mode="multi", n_collect=0,
                  n_tee=len(parts["tee"]))

    def args():  # made in the x64 scope of the 64-bit call
        return (jnp.asarray(keys), np.int32(n_valid), jnp.asarray(np.array(parts["hist_prefixes"], kdt)),
                jnp.asarray(none), jnp.asarray(none), jnp.asarray(ts), jnp.asarray(tp))

    if bits == 32:
        ref = si.sweep_ingest_core(*args(), np.uint32(0), cert=False, sketch_bits=0, block_rows=8, interpret=True,
                                   **common)
        want_hist, want_tee = np.asarray(ref[0]), (np.asarray(ref[2][0]), int(ref[2][1]))
    else:
        with enable_x64():
            hist, _, tee = fi.fused_ingest_core(*args(), method="scatter", **common)
            want_hist, want_tee = np.asarray(hist), (np.asarray(tee[0]), int(tee[1]))
    valid = keys[:n_valid]
    held = np.zeros(n_valid, bool)
    for s, p in parts["tee"]:
        held |= (valid >> kdt(s) if s < bits else np.zeros_like(valid)) == p
    assert want_tee[1] == np.count_nonzero(held) > 0  # the reference against numpy first
    for key_op in ("none", "xor", "float"):
        hist, collect, tee, cert, sketch = _port_sweep(keys, n_valid, key_op, rng, **parts)
        assert collect == () and cert is None and sketch is None, label
        np.testing.assert_array_equal(hist.numpy(), want_hist, err_msg=label)
        assert tee[0].numpy().view(kdt).tobytes() == want_tee[0].tobytes(), label  # the whole buffer, zeros after
        assert int(tee[1]) == want_tee[1], label


def test_plain64_matches_jax_fused_ingest_and_numpy():
    """64-bit words: hist, collect and tee against the JAX package's XLA
    fusion tier (its path for 64-bit key spaces), the certificate and the
    sketch against numpy."""
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.pallas import fused_ingest as fi
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    rng = np.random.default_rng(64)
    bucket, n_valid = 3000, 2990
    keys = rng.integers(0, 1 << 64, size=bucket, dtype=np.uint64, endpoint=False)
    keys[n_valid:] = 0
    u = [int(v) for v in keys]
    prefixes = [u[0] >> 48, u[1] >> 48]
    collect = [(56, u[0] >> 56), (64, 0)]
    tee = [(40, u[7] >> 40), (56, u[2] >> 56)]
    vkey = u[50]
    with enable_x64():
        cs, cp = _spec_arrays(collect, np.uint64)
        ts, tp = _spec_arrays(tee, np.uint64)
        hist, ref_collect, ref_tee = fi.fused_ingest_core(
            jnp.asarray(keys), np.int32(n_valid), jnp.asarray(np.array(prefixes, np.uint64)),
            jnp.asarray(cs), jnp.asarray(cp), jnp.asarray(ts), jnp.asarray(tp),
            shift=40, radix_bits=8, method="scatter", hist_mode="multi", n_collect=2, n_tee=2,
        )
        hist = np.asarray(hist)
        ref_collect = [(np.asarray(b), int(c)) for b, c in ref_collect]
        ref_tee = (np.asarray(ref_tee[0]), int(ref_tee[1]))
    valid = keys[:n_valid]
    padded = np.where(np.arange(bucket) < n_valid, keys, 0).astype(np.uint64)
    deep = np.bincount((padded >> np.uint64(44)).astype(np.int64), minlength=1 << 20)
    want_cert = (np.count_nonzero(valid < vkey), np.count_nonzero(valid <= vkey))
    want_sketch = (deep, int(valid.min()), int(valid.max()))
    for key_op in ("none", "xor", "float"):
        got = _port_sweep(
            keys, n_valid, key_op, rng, shift=40, radix_bits=8, hist_prefixes=prefixes,
            collect=collect, tee=tee, vkey=vkey, sketch_bits=20,
        )
        _assert_parts_equal(got, hist, ref_collect, ref_tee, want_cert, want_sketch)


def test_plain_edge_parts():
    """No valid key (the extremes keep their identities), a bucket of one
    word, parts off (None), and the argument checks."""
    w = torch.tensor([5, 7, 9], dtype=torch.int32)
    hist, collect, tee, cert, sketch = S.sweep_ingest(w, 0, vkey=3, sketch_bits=4, collect=[(28, 0)])
    assert hist is None and tee is None
    assert (int(cert[0]), int(cert[1])) == (0, 0)
    assert sketch[0].tolist() == [3] + [0] * 15  # pads: three keys 0
    assert int(sketch[1]) == -1 and int(sketch[2]) == 0  # unsigned max and min identities
    assert collect[0][0].tolist() == [0, 0, 0] and int(collect[0][1]) == 0
    one = S.sweep_ingest(torch.tensor([6], dtype=torch.int32), 1, collect=[(0, 6)], tee=[(1, 3)])
    assert one[1][0][0].tolist() == [6] and one[2][0].tolist() == [6]
    for data, n_valid, kw in (
        (w.to(torch.int16), 3, {}), (w[::2], 2, {}), (w, 4, {}),
        (w, 3, dict(hist_prefixes=[0], shift=28, radix_bits=8)), (w, 3, dict(collect=[(33, 0)])),
        (w, 3, dict(sketch_bits=21)), (w, 3, dict(key_op="bogus")),
    ):
        with pytest.raises(ValueError):
            S.sweep_ingest(data, n_valid, **kw)


def test_padded_bucket_through_the_consumers():
    """A bucket longer than its chunk (pads of garbage bits) gives the same
    histograms (the consumer subtracts the pads) and survivors as the chunk
    staged at its own length."""
    rng = np.random.default_rng(7)
    x = rng.integers(-50, 50, size=1000).astype(np.int32)
    staged = pl.stage_chunk(x, torch.int32, torch.device("cpu"))
    raw = np.concatenate([x, rng.integers(-(1 << 31), 1 << 31, size=24).astype(np.int32)])
    padded = pl.StagedKeys(torch.from_numpy(raw), 1000, staged.key_op, staged.key_xor)
    assert staged.pad == 0 and padded.pad == 24
    out = []
    for keys in (staged, padded):
        for hist in ((24, 8, [None]), (16, 8, [0x80, 0x7F]), (24, 8, [0])):
            c = ex.FusedIngestConsumer(total_bits=32, hist=hist, collect_specs=[(24, 0x7FFFFF), (0, 0)])
            c.finish(c.dispatch(keys))
            out.append(({p: h.tolist() for p, h in c.hists.items()}, c.collected(np.uint32)))
    for a, b in zip(out[:3], out[3:]):
        assert a[0] == b[0]
        assert all(np.array_equal(a[1][s], b[1][s]) for s in a[1])
    assert out[0][1][(0, 0)].size == 1000 and sum(out[0][0][None]) == 1000


@pytest.mark.parametrize("name", DTYPES)
def test_kselect_streaming_matches_jax_and_numpy(name):
    """k in {1, n/2, n}, at depth 0 and 2, with the default knobs and with
    4-bit digits and a 64-survivor budget (several passes), numpy and torch
    chunks mixed: the port equals numpy and the JAX package (its default
    path, and its sweep-kernel tier over staged chunks), bit for bit."""
    from mpi_k_selection_tpu.streaming import streaming_kselect_many as ref_many
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    chunks = stream(name)
    x = np.concatenate(chunks)
    n = x.size
    ks = [1, n // 2, n]
    want = key_oracle(x, ks)
    narrow = dict(radix_bits=4, collect_budget=64)
    with enable_x64():
        assert bits(ref_many(chunks, ks, spill="off"), x.dtype) == want
        assert bits(ref_many(chunks, ks, spill="off", fused="kernel", devices=1, **narrow), x.dtype) == want
    mixed = [tensor_from_numpy(c, "cpu") if i % 2 else c for i, c in enumerate(chunks)]
    for depth in (0, 2):
        for kw in ({}, narrow):
            got = kt.kselect_streaming_many(mixed, ks, pipeline_depth=depth, device="cpu", **kw)
            assert bits(got, x.dtype) == want, (depth, kw)
        got = kt.kselect_streaming(chunks, ks[1], pipeline_depth=depth, device="cpu", **narrow)
        assert bits([got], x.dtype) == key_oracle(x, ks[1:2])


@pytest.mark.parametrize("name", ["int8", "uint32", "int64", "bfloat16", "float32", "float64"])
def test_streaming_rank_certificate_matches_jax_and_numpy(name):
    from mpi_k_selection_tpu.streaming import streaming_rank_certificate as ref_cert
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    chunks = stream(name, seed=3)
    x = np.concatenate(chunks)
    keys = dt.np_to_sortable_bits(x)
    probes = [x[0], x[-1], kt.kselect_streaming(chunks, x.size // 2, device="cpu")]
    if name in _NAN:
        probes += [x.dtype.type(-0.0), x[np.isnan(x)][0]]
    for v in probes:
        vk = dt.np_to_sortable_bits(np.array([v], x.dtype))[0]
        want = (int(np.count_nonzero(keys < vk)), int(np.count_nonzero(keys <= vk)))
        with enable_x64():
            assert tuple(int(c) for c in ref_cert(chunks, v)) == want
        for depth in (0, 2):
            assert kt.streaming_rank_certificate(chunks, v, pipeline_depth=depth, device="cpu") == want


def test_rejections_match_jax():
    """A one-shot iterator, dtype drift, an empty stream and an out-of-range
    k raise in both packages, with the JAX package's messages."""
    from mpi_k_selection_tpu.streaming import streaming_kselect as ref_select
    from mpi_k_selection_tpu.streaming import streaming_rank_certificate as ref_cert

    a = np.arange(10, dtype=np.int32)
    cases = (
        (lambda: iter([a]), {}, TypeError, "one-shot iterator/generator cannot be replayed"),
        (lambda: [a, a.astype(np.int64)], {}, TypeError, "requires one dtype per stream"),
        (lambda: [a[:0], a[:0]], {}, ValueError, "requires a non-empty stream"),
        (lambda: [a, a], {"k": 21}, ValueError, "out of range"),
        (lambda: [a, a], {"k": 0}, ValueError, "out of range"),
    )
    for make, kw, err, msg in cases:
        k = kw.get("k", 1)
        for depth in (0, 2):
            with pytest.raises(err, match=msg):
                kt.kselect_streaming(make(), k, pipeline_depth=depth, spill="off", device="cpu")
        with pytest.raises(err, match=msg):
            ref_select(make(), k, spill="off")
    with pytest.raises(ValueError, match="requires a non-empty stream"):
        kt.streaming_rank_certificate([a[:0]], 1, device="cpu")
    with pytest.raises(ValueError, match="requires a non-empty stream"):
        ref_cert([a[:0]], 1)
    with pytest.raises(ValueError, match="must divide key bits"):
        kt.kselect_streaming([a], 1, radix_bits=5, device="cpu")
    with pytest.raises(ValueError, match="pipeline_depth"):
        kt.kselect_streaming([a], 1, pipeline_depth=-1, device="cpu")


def test_producer_thread_runs_the_source_and_is_joined():
    """At depth >= 1 the source runs on a ``ksel-pipeline-*`` thread; a
    source that raises mid-stream re-raises in the caller, and a source
    that changes between passes fails the replay check. The autouse
    leak fixture then finds no such thread left."""
    seen = []
    chunk = np.arange(100, dtype=np.int32)

    def source():
        seen.append(threading.current_thread().name)
        for _ in range(4):
            yield chunk

    assert kt.kselect_streaming(source, 5, device="cpu", collect_budget=8, radix_bits=4) == 1
    assert seen and all(s.startswith(pl.THREAD_NAME_PREFIX) for s in seen)
    seen.clear()
    kt.kselect_streaming(source, 5, device="cpu", pipeline_depth=0)
    assert seen == [threading.current_thread().name] * 2  # pass 0, then the collect

    def failing():
        yield chunk
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        kt.kselect_streaming(failing, 5, device="cpu")
    calls = []

    def drifting():
        calls.append(1)
        yield chunk[len(calls):]  # another stream at every pass

    with pytest.raises(RuntimeError, match="not replay-stable"):
        kt.kselect_streaming(drifting, 50, device="cpu", radix_bits=4, collect_budget=2)
    assert not [t for t in threading.enumerate() if t.name.startswith(pl.THREAD_NAME_PREFIX)]


def test_cli_streaming_mode_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "mpi_k_selection_tpu_torch", "--streaming", "--n", "50000", "--chunk-elems",
         "12000", "--pipeline-depth", "2", "--dtype", "float32", "--gen", "normal", "--seed", "4",
         "--device", "cpu", "--verify", "--json"],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["extra"]["exact_match"] is True and rec["extra"]["certificate_ok"] is True
    assert rec["extra"]["chunks"] == 5 and rec["algorithm"] == "streaming-chunked"
    x = np.concatenate([
        datagen.generate(min(12000, 50000 - off), pattern="normal", seed=4 + i, dtype=np.float32)
        for i, off in enumerate(range(0, 50000, 12000))
    ])
    assert np.float32(rec["answer"]).tobytes() == key_oracle(x, [25000])
    bad = subprocess.run(
        [sys.executable, "-m", "mpi_k_selection_tpu_torch", "--streaming", "--quantiles", "0.5", "--device", "cpu"],
        capture_output=True, text=True, timeout=120,
    )
    assert bad.returncode != 0 and "k-th mode only" in bad.stderr


def test_resolve_ingest_workers_matches_jax():
    """None -> 1, ``"auto"`` -> min(4, cores), ints in [1, 64]; bools, floats
    and strings refused, with the JAX package's messages."""
    from mpi_k_selection_tpu.streaming import pipeline as ref

    assert (pl.DEFAULT_INGEST_WORKERS, pl.MAX_INGEST_WORKERS, pl.INGEST_WORKERS_AUTO_CAP) == (
        ref.DEFAULT_INGEST_WORKERS, ref.MAX_INGEST_WORKERS, ref.INGEST_WORKERS_AUTO_CAP)
    for good in (None, "auto", 1, np.int64(3), pl.MAX_INGEST_WORKERS):
        assert pl.resolve_ingest_workers(good) == ref.resolve_ingest_workers(good)
    for bad in (0, pl.MAX_INGEST_WORKERS + 1, True, False, 2.0, "three"):
        with pytest.raises(ValueError) as mine:
            pl.resolve_ingest_workers(bad)
        with pytest.raises(ValueError) as theirs:
            ref.resolve_ingest_workers(bad)
        assert str(mine.value) == str(theirs.value)
    assert pl.validate_pipeline_depth(None) == ref.validate_pipeline_depth(None) == 2


@pytest.mark.parametrize("name", ["int8", "bfloat16", "int32", "uint64", "float64"])
def test_ingest_pool_answers_bit_identical(name):
    """``ingest_workers`` 1, 2, 4 and ``"auto"`` at depth 1 and 2, numpy
    and torch chunks mixed: the same answers and certificates as NumPy,
    and no ``ksel-`` thread left."""
    chunks = stream(name, seed=9, sizes=(700, 1, 0, 333, 512, 90))
    x = np.concatenate(chunks)
    ks = [1, x.size // 3, x.size // 2, x.size]
    want = key_oracle(x, ks)
    mixed = [tensor_from_numpy(c, "cpu") if i % 2 else c for i, c in enumerate(chunks)]
    keys = dt.np_to_sortable_bits(x)
    for depth in (1, 2):
        for workers in (1, 2, 4, "auto"):
            got = kt.kselect_streaming_many(mixed, ks, radix_bits=4, collect_budget=32, pipeline_depth=depth,
                                            ingest_workers=workers, device="cpu")
            assert bits(got, x.dtype) == want, (depth, workers)
            vk = dt.np_to_sortable_bits(np.array([got[1]], x.dtype))[0]
            assert kt.streaming_rank_certificate(chunks, got[1], pipeline_depth=depth, ingest_workers=workers,
                                                 device="cpu") == (
                int(np.count_nonzero(keys < vk)), int(np.count_nonzero(keys <= vk)))
    assert not [t.name for t in threading.enumerate() if t.name.startswith(("ksel-pipeline", "ksel-ingest"))]


def test_ingest_workers_run_the_one_producer(monkeypatch):
    """``ingest_workers`` 1 stages each chunk of a pass once, in source
    order, on the one ``ksel-pipeline-*`` producer; above 1 each chunk is
    staged once on the ``ksel-ingest-*`` workers of the pooled plane (in
    whatever order they finish), and the consumer still gets the chunks in
    source order."""
    chunks = [np.arange(n, dtype=np.int32) for n in (5000, 10, 20, 30, 40, 50)]
    x = np.concatenate(chunks)
    stage = pl.stage_chunk
    staged, consumed = [], []

    def recording_stage(c, *args, **kw):
        staged.append((threading.current_thread().name, len(c)))
        return stage(c, *args, **kw)

    push = ex.StreamExecutor.push

    def recording_push(self, keys):
        consumed.append(keys.n_valid)
        return push(self, keys)

    monkeypatch.setattr(pl, "stage_chunk", recording_stage)
    monkeypatch.setattr(ex.StreamExecutor, "push", recording_push)
    sizes = [len(c) for c in chunks]
    for workers in (1, 2, 4, "auto"):
        staged.clear()
        consumed.clear()
        got = kt.streaming_rank_certificate(chunks, 25, pipeline_depth=2, ingest_workers=workers, device="cpu")
        assert got == (int(np.count_nonzero(x < 25)), int(np.count_nonzero(x <= 25)))
        assert consumed == sizes
        names = {name for name, _ in staged}
        if pl.resolve_ingest_workers(workers) == 1:
            assert [n for _, n in staged] == sizes
            assert len(names) == 1 and staged[0][0].startswith(pl.THREAD_NAME_PREFIX)
        else:
            assert sorted(n for _, n in staged) == sorted(sizes)
            assert names and all(name.startswith(pl.INGEST_THREAD_PREFIX + "-") for name in names)


def test_ingest_pool_errors_reach_the_caller_in_order():
    """A dtype that drifts at chunk 3 with ``ingest_workers`` > 1 raises
    the JAX package's TypeError; a source that raises mid-stream re-raises in
    the caller; a one-shot iterator is still refused by the descent with
    spill off; no thread outlives either."""
    good = np.arange(4096, dtype=np.int32)
    chunks = np.array_split(good, 6)
    chunks[3] = chunks[3].astype(np.float32)
    for workers in (2, 4):
        with pytest.raises(TypeError, match="requires one dtype per stream"):
            kt.kselect_streaming(chunks, 17, collect_budget=64, ingest_workers=workers, device="cpu")

        def failing():
            yield good
            yield good
            raise OSError("disk gone")

        with pytest.raises(OSError, match="disk gone"):
            kt.kselect_streaming(failing, 5, ingest_workers=workers, device="cpu")
        with pytest.raises(TypeError, match="one-shot iterator/generator cannot be replayed"):
            kt.kselect_streaming(iter([good]), 5, ingest_workers=workers, spill="off", device="cpu")
    with pytest.raises(ValueError, match="ingest_workers"):
        kt.kselect_streaming([good], 5, ingest_workers=0, device="cpu")
    assert not [t.name for t in threading.enumerate() if t.name.startswith(("ksel-pipeline", "ksel-ingest"))]


def test_as_chunk_source_forms():
    """Lists, one array, callables; a one-shot iterator only under
    ``one_shot_ok``, and then read once."""
    from mpi_k_selection_tpu_torch.streaming.chunked import as_chunk_source

    a = np.arange(5, dtype=np.int32)
    assert [list(c) for c in as_chunk_source([a, a])()] == [list(a)] * 2
    assert [list(c) for c in as_chunk_source(a)()] == [list(a)]
    once = as_chunk_source(iter([a]), one_shot_ok=True)
    assert [list(c) for c in once()] == [list(a)]
    with pytest.raises(RuntimeError, match="invoked a second time"):
        once()
    with pytest.raises(TypeError, match="one-shot"):
        as_chunk_source(iter([a]))
    with pytest.raises(TypeError, match="unsupported chunk source type"):
        as_chunk_source(5)


def test_staging_pool_reuse_limits_and_peaks():
    """Buffers come back by (bytes, device), at most ``max_per_key`` a key
    and ``max_bytes`` in all, the oldest dropped first; the peaks count
    what is handed out and what is held. (Plain CPU tensors stand in for
    pinned buffers: a released buffer is handed out again as it is.)"""
    pool = pl.StagingPool(max_per_key=2, max_bytes=300)
    bufs = [torch.empty(100, dtype=torch.uint8) for _ in range(3)]
    for b in bufs:
        pool._live += 100  # as if acquired
    for b in bufs:
        pool.release(b, "cuda:0")
    assert pool.resident_bytes == 200 and pool.live_bytes == 0  # the third exceeded max_per_key
    got = pool.acquire(100, "cuda:0")
    assert got is bufs[1] and pool.hits == 1 and pool.live_bytes == 100
    pool._live += 250  # as if acquired
    pool.release(torch.empty(250, dtype=torch.uint8), "cuda:1")  # evicts the oldest: 100 + 250 > 300
    assert pool.resident_bytes == 250 and pool.live_bytes == 100
    pool.release(got, "cuda:0")
    pool.clear()
    assert pool.resident_bytes == 0 and pool.live_bytes == 0


# --- on the card --------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [32, 64])
def test_sweep_kernel_matches_plain_on_card(cuda_device, bits):
    """Every part, pads of garbage, each key op, the shared-memory
    counters (below and above the 48 KB default) and the global ones (128
    prefixes, a 12-bit digit, a 20-bit sketch), a misaligned view (the
    scalar loads) and a multi-tile bucket, exactly."""
    gen = torch.Generator(device=cuda_device).manual_seed(bits)
    wdt = torch.int32 if bits == 32 else torch.int64
    n = 3 * (1 << 20) + 77
    w = torch.randint(-(1 << 62), 1 << 62, (n + 1,), generator=gen, device=cuda_device).to(wdt)
    keys = dt.keys_from_raw(w, "float")
    top = [int(v) & ((1 << bits) - 1) for v in keys[:64].tolist()]
    parts = [
        dict(hist_prefixes=[top[0] >> (bits - 8)], shift=bits - 16, radix_bits=8, collect=[(bits - 8, top[1] >> (bits - 8))]),
        dict(hist_prefixes=[t >> (bits - 8) for t in top[:40]], shift=bits - 16, radix_bits=8),
        dict(hist_prefixes=[t >> (bits - 8) for t in top[:60]], shift=bits - 16, radix_bits=8),  # 60 KB
        dict(hist_prefixes=[t >> (bits - 8) for t in top[:64]] * 2, shift=bits - 16, radix_bits=8),  # global
        dict(hist_prefixes=[0], shift=bits - 12, radix_bits=12, sketch_bits=20),
        dict(collect=[(bits, 0), (bits - 16, top[2] >> (bits - 16))], tee=[(bits - 8, top[3] >> (bits - 8)), (bits - 4, 5)],
             vkey=top[4], sketch_bits=8),
    ]
    S.reset_counts()
    for view in (w[:n], w[1:]):
        for key_op, key_xor in (("none", 0), ("xor", 1 << (bits - 1)), ("float", 0)):
            for kw in parts:
                for n_valid in (view.numel(), view.numel() - 1000):
                    got = _flat(S.sweep_ingest(view, n_valid, key_op=key_op, key_xor=key_xor, **kw))
                    want = _flat(S.sweep_ingest_plain(view, n_valid, key_op=key_op, key_xor=key_xor, **kw))
                    assert len(got) == len(want)
                    same = [a is b is None or torch.equal(a, b) for a, b in zip(got, want)]
                    assert all(same), (key_op, kw, n_valid)
    torch.cuda.synchronize()
    assert S.LAUNCHES[f"sweep_ingest{bits}"] > 0
    with pytest.raises(ValueError):
        S.sweep_ingest(w.view(torch.int16), 10)  # no 2-byte words: raises, no fallback
    with pytest.raises(ValueError):
        S.sweep_ingest(w[::2], 10)


T16 = 1 << 16  # a 16-bit counter's range: the add that reaches it credits the global counter


def _block_positions(plan, n: int, bits: int, block: int) -> np.ndarray:
    """The words of an ``n``-word bucket that block ``block`` of the
    order-free route reads (vector i goes to block (i mod stride) //
    threads), when the card runs ``plan.blocks`` blocks."""
    v = 16 // (bits // 8)
    vec = np.arange(n // v)
    mine = vec[(vec % (plan.blocks * plan.threads)) // plan.threads == block]
    return (mine[:, None] * v + np.arange(v)).ravel()


def skewed_buckets(bits: int, sketch_bits: int, sms: int, n: int = 1 << 24) -> dict:
    """Raw words (key_op "none": the words are the keys) of skewed buckets
    for the sketch part at ``sketch_bits``, label -> (words, n_valid): one
    hot counter (a 2^24-key chunk: every block's counter passes 2^16 many
    times); counters that one block's keys bring exactly to 2^16 and to
    2^16 + 1 (the rest of the bucket spread over other counters); two hot
    counters that share a 32-bit word in alternating keys; the last
    counter; pads only."""
    rng = np.random.default_rng(sketch_bits)
    ndt = np.uint32 if bits == 32 else np.uint64
    low = bits - sketch_bits

    def key(bin_):  # a key of counter bin_, its low bits random
        return (np.uint64(bin_) << np.uint64(low)) | (rng.integers(0, 1 << min(low, 62), dtype=np.uint64))

    def words(keys):
        return keys.astype(ndt).view(np.int32 if bits == 32 else np.int64)

    last = (1 << sketch_bits) - 1
    out = {"one hot counter": words(np.full(n, key(12345), np.uint64)),
           "the last counter": words(np.full(n, key(last), np.uint64))}
    plan = S.sweep_plan(bits, n, nd=0, sketch_bits=sketch_bits, sms=sms)
    spread = rng.integers(0, (1 << sketch_bits) - 8, size=n, dtype=np.uint64) << np.uint64(low)
    for extra, block in ((0, 0), (1, 1)):
        hot = np.uint64(last - 1 - block)  # two counters of one word at 16 bits
        k = spread.copy()
        k[_block_positions(plan, n, bits, block)[: T16 + extra]] = hot << np.uint64(low)
        out[f"a counter at 2^16 + {extra} in block {block}"] = words(k)
    alt = np.empty(n, np.uint64)
    alt[0::2], alt[1::2] = key(last - 1), key(last)
    out["two hot counters alternating"] = words(alt)
    cases = {label: (w, n) for label, w in out.items()}
    cases["pads only"] = (words(np.full(n, key(7), np.uint64)), 0)
    return cases


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("sketch_bits", [15, 16, 20])
def test_sweep_sketch_on_skewed_buckets_matches_plain_on_card(cuda_device, bits, sketch_bits):
    """The sketch part on skewed buckets (:func:`skewed_buckets`: 16-bit
    counters in shared memory at 15 and 16 bits, int32 in global memory at
    20), exactly equal to the plain version (tolerance: none; counts are
    integers), its counts summing to the padded bucket's length; and a
    histogram of one prefix, with and without a prefix, at the same
    width where it fits a digit."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    cases = skewed_buckets(bits, sketch_bits, sms)
    plan = S.sweep_plan(bits, 1 << 24, nd=0, sketch_bits=sketch_bits, sms=sms)
    assert plan.deep_smem == (2 if sketch_bits in S.PACKED_BITS else 0)
    S.reset_counts()
    for label, (raw, n_valid) in cases.items():
        w = torch.from_numpy(raw).to(cuda_device)
        parts = [dict(sketch_bits=sketch_bits)]
        if sketch_bits in S.PACKED_BITS:
            parts += [dict(hist_prefixes=[0], shift=bits - sketch_bits, radix_bits=sketch_bits),
                      dict(hist_prefixes=[(int(raw[0]) & ((1 << bits) - 1)) >> (bits - 4)],
                           shift=bits - 4 - sketch_bits, radix_bits=sketch_bits, sketch_bits=1)]
        for kw in parts:
            got = _flat(S.sweep_ingest(w, n_valid, **kw))
            want = _flat(S.sweep_ingest_plain(w, n_valid, **kw))
            assert len(got) == len(want)
            assert all(a is b is None or torch.equal(a, b) for a, b in zip(got, want)), (label, kw)
            if kw.get("sketch_bits", 0) > 1:
                assert int(got[-3].sum()) == w.numel(), label
    torch.cuda.synchronize()
    assert S.LAUNCHES[f"sweep_ingest{bits}"] > 0 and not S.PLAIN_CALLS["sweep_ingest"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["int16", "uint16", "float16", "bfloat16"])
def test_sweep_16_bit_keys_through_the_histogram_part_on_card(cuda_device, name):
    """16-bit keys widened into 32-bit words, the sketch consumer's launch
    (the prefix-free histogram part at a 16-bit digit, in 16-bit counters,
    and a 1-bit sketch for the extremes), exactly equal to the plain
    version on a 2^24-key chunk of random keys, of one key, of half one
    key, and with pads."""
    rng = np.random.default_rng(5)
    n = 1 << 24
    u = rng.integers(0, 1 << 16, size=n, dtype=np.uint16)
    half = u.copy()
    half[::2] = 0x3FC0
    x = {"random": u, "one key": np.full(n, 0xBF80, np.uint16), "half one key": half}
    kw = dict(hist_prefixes=[0], shift=0, radix_bits=16, sketch_bits=1)
    plan = S.sweep_plan(32, n, nd=1, shift=0, radix_bits=16, sketch_bits=1,
                        sms=torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    assert (plan.hist_smem, plan.threads) == (2, S.WIDE_THREADS)
    S.reset_counts()
    for label, raw in x.items():
        chunk = torch.from_numpy(raw.view(np.int16)).to(cuda_device).view(dt.torch_dtype(name))
        keys = pl.stage_chunk(chunk, dt.torch_dtype(name), cuda_device)
        for n_valid in (n, n - 4097):
            got = _flat(S.sweep_ingest(keys.data, n_valid, **kw))
            want = _flat(S.sweep_ingest_plain(keys.data, n_valid, **kw))
            assert all(a is b is None or torch.equal(a, b) for a, b in zip(got, want)), (label, n_valid)
            assert int(got[0].sum()) == n
        keys.release()
    torch.cuda.synchronize()
    assert S.LAUNCHES["sweep_ingest32"] == 6 and not S.PLAIN_CALLS["sweep_ingest"]


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [32, 64])
def test_sweep_kernel_routes_match_plain_on_card(cuda_device, bits):
    """Both routes of the kernel on the stream's hot bins (values in [1,
    10^8], shifted to the top of 64-bit words: the top digit takes a few
    values): K=128 prefixes with repeats
    (past the by-value capacity), 4 collect specs, a spec with no survivor,
    more specs than go by value, ``n_valid`` of 0 and 1, buckets that are
    not a multiple of a tile and a misaligned view, exactly against the
    plain version, buffers to the last word."""
    rng = np.random.default_rng(bits)
    wdt, ndt = (torch.int32, np.int32) if bits == 32 else (torch.int64, np.int64)
    tile = S.TILE_BYTES // (bits // 8)
    vals = rng.integers(1, 10**8, size=3 * tile + 4099, endpoint=True).astype(ndt) << (bits - 32)
    w = torch.from_numpy(vals).to(cuda_device)
    key_xor = 1 << (bits - 1)
    u = [int(v) ^ key_xor for v in vals[:256].tolist()]
    q8 = [v >> (bits - 8) for v in u[:4]]
    q16 = [v >> (bits - 16) for v in u[:128]]
    absent = (1 << 24) - 1  # a 24-bit prefix no key holds: keys lie below 0x86 << (bits - 8)
    specs = [(bits - 24, u[0] >> (bits - 24)), (bits - 24, u[1] >> (bits - 24)), (bits - 16, u[2] >> (bits - 16)),
             (bits - 24, absent)]
    parts = [
        dict(hist_prefixes=[0], shift=bits - 8, radix_bits=8),  # pass 0: the top digit's few hot bins
        dict(hist_prefixes=q8[:1], shift=bits - 16, radix_bits=8),
        dict(hist_prefixes=q8 + q8[:2], shift=bits - 16, radix_bits=8),  # K=6, repeats
        dict(hist_prefixes=q16[:64] + q16[:64], shift=bits - 24, radix_bits=8),  # K=128, hashed table
        dict(hist_prefixes=q16[:100] + [1 << 20, 5], shift=bits - 24, radix_bits=8),  # 100 by device array
        dict(collect=specs),  # 4 specs, one with no survivor
        dict(collect=specs[:1]),
        dict(collect=[(bits - 24, u[j] >> (bits - 24)) for j in range(20)]),  # specs by device array
        dict(collect=specs[3:] + specs[:1], tee=[(bits - 16, u[5] >> (bits - 16)), (bits - 24, absent)], vkey=u[9]),
        dict(hist_prefixes=q8, shift=bits - 16, radix_bits=8, collect=specs, vkey=u[3], sketch_bits=12),
        dict(vkey=u[7]),
    ]
    S.reset_counts()
    for view in (w, w[1:], w[: tile - 1], w[:1]):
        for kw in parts:
            for n_valid in {view.numel(), view.numel() - 1, 1, 0}:
                if n_valid < 0:
                    continue
                got = _flat(S.sweep_ingest(view, n_valid, key_op="xor", key_xor=key_xor, **kw))
                want = _flat(S.sweep_ingest_plain(view, n_valid, key_op="xor", key_xor=key_xor, **kw))
                assert len(got) == len(want)
                same = [a is b is None or torch.equal(a, b) for a, b in zip(got, want)]
                assert all(same), (view.numel(), kw, n_valid, same)
    torch.cuda.synchronize()
    assert S.LAUNCHES[f"sweep_ingest{bits}"] > 0 and not S.PLAIN_CALLS["sweep_ingest"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["int16", "uint32", "int64", "bfloat16", "float32", "float64"])
def test_streaming_entry_points_on_card(cuda_device, name):
    """Each entry point on the card at depth 0 and 2, numpy chunks and CUDA
    tensor chunks: equal to numpy, through the kernel only."""
    chunks = stream(name, seed=5, sizes=(300_000, 1, 0, 123_457))
    x = np.concatenate(chunks)
    ks = [1, 777, x.size // 2, x.size]
    on_card = [tensor_from_numpy(c, cuda_device) for c in chunks]
    for depth in (0, 2):
        for src in (chunks, on_card):
            S.reset_counts()
            got = kt.kselect_streaming_many(src, ks, pipeline_depth=depth, collect_budget=1024)
            assert bits(got, x.dtype) == key_oracle(x, ks)
            less, leq = kt.streaming_rank_certificate(src, got[2], pipeline_depth=depth)
            assert less < ks[2] <= leq
            one = kt.kselect_streaming(src, ks[1], pipeline_depth=depth, radix_bits=4)
            assert bits([one], x.dtype) == key_oracle(x, ks[1:2])
            assert not S.PLAIN_CALLS["sweep_ingest"] and sum(S.LAUNCHES.values()) > 0


@pytest.mark.gpu
def test_ingest_pool_on_card(cuda_device):
    """``ingest_workers`` 1, 2 and 4 on the card: the same answers, one
    launch per chunk per pass and no plain call, every host chunk copied
    once a pass into a pinned buffer of the pool, at most ``depth + 1`` of
    them in use at once (``depth + 1 + W`` on the pooled plane of ``W``
    workers), all back after the pass."""
    rng = np.random.default_rng(21)
    chunks = [rng.integers(0, 10**8, size=1 << 20).astype(np.int32) for _ in range(12)]
    x = np.concatenate(chunks)
    ks = [1, x.size // 2, x.size]
    passes = []

    def source():
        passes.append(1)
        return iter(chunks)

    for workers in (1, 2, 4):
        pl.STAGING_POOL.clear()
        pl.STAGING_POOL.reset_peaks()
        pl.HOST_COPY.reset()
        S.reset_counts()
        passes.clear()
        got = kt.kselect_streaming_many(source, ks, pipeline_depth=2, ingest_workers=workers)
        torch.cuda.synchronize()
        assert bits(got, x.dtype) == key_oracle(x, ks)
        assert S.LAUNCHES["sweep_ingest32"] == len(passes) * len(chunks) and not S.PLAIN_CALLS["sweep_ingest"]
        assert pl.HOST_COPY.count == len(passes) * len(chunks)
        # depth + 1 staged chunks, and one more a worker of the pooled plane
        assert 0 < pl.STAGING_POOL.peak_live_bytes <= (2 + 1 + (workers if workers > 1 else 0)) * chunks[0].nbytes
        assert pl.STAGING_POOL.live_bytes == 0
