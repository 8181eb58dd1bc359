"""The port's multi-rank selection (``kselect_many`` / ``quantiles``) and
its multi-prefix histogram against the JAX package and NumPy.

Counts are integers and selected elements are compared as bit patterns:
no tolerance anywhere. The JAX package's Pallas kernels run in interpret
mode at the small size its own tests use (``tests/test_pallas.py``); the
port's wrappers run their plain versions on the CPU. The ``gpu`` tests hold
the kernels against those plain versions on the card:

    python -m pytest --noconftest tests/test_torch_*.py -m gpu
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import mpi_k_selection_tpu_torch as kt
from mpi_k_selection_tpu_torch import api
from mpi_k_selection_tpu_torch.backends import cuda as cuda_backend
from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
from mpi_k_selection_tpu_torch.ops.radix import bucket_walk_step, bucket_walk_step_multi, row_cumsum
from mpi_k_selection_tpu_torch.utils import datagen
from mpi_k_selection_tpu_torch.utils import dtypes as dt
from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype, tensor_from_numpy, tensor_to_numpy

# one intra-op thread: in a parallel test run each worker's torch thread pool
# oversubscribes the cores, and small CPU ops stall on its barriers
torch.set_num_threads(1)

DTYPES = (
    "int8", "uint8", "int16", "uint16", "int32", "uint32",
    "int64", "uint64", "float16", "bfloat16", "float32", "float64",
)
N = 40_000
N_REF = 2 * 256 * 128 + 17  # two 256-row blocks of the Pallas grid plus a ragged tail


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs a CUDA device; on the card: "
            "python -m pytest --noconftest tests/test_torch_*.py -m gpu"
        )
    return torch.device("cuda")


def fixtures(name, n=N):
    """``adversarial_fixtures`` in ``name``'s dtype (uint64 and bfloat16
    from the int64 and float32 fixtures, which the generator can make)."""
    if name == "uint64":
        return [(p, x.view(np.uint64)) for p, x in datagen.adversarial_fixtures(n, dtype=np.int64)]
    if name == "bfloat16":
        bf = numpy_dtype("bfloat16")
        return [(p, x.astype(bf)) for p, x in datagen.adversarial_fixtures(n, dtype=np.float32)]
    return datagen.adversarial_fixtures(n, dtype=np.dtype(name))


def key_oracle(x, ks):
    """The k-th smallest of ``x`` in key order for each k of ``ks``, with
    ``ks``'s shape."""
    keys = np.sort(dt.np_to_sortable_bits(x.reshape(-1)))
    ks = np.asarray(ks)
    return dt.np_from_sortable_bits(keys[ks.reshape(-1) - 1], x.dtype).reshape(ks.shape)


def bits_of(t):
    return tensor_to_numpy(t).tobytes()


def forced_cutover(name):
    return min(3, dt.key_bits(name) // 4 - 1)


def _raw_case(dtype, n, seed=1234):
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        x = rng.standard_normal(n).astype(dtype)
        x[: n // 2] = -np.abs(x[: n // 2])
    elif dtype.kind == "u":
        x = rng.integers(0, np.iinfo(dtype).max, size=n, dtype=dtype, endpoint=True)
    else:
        x = rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max, size=n, dtype=dtype, endpoint=True)
    return x


def _fold(dtype):
    fold = dt.key_fold(dtype)
    return fold[0], (fold[1] if fold[0] == "xor" else 0)


def _numpy_hist(x, shift, rb, prefix):
    keys = dt.np_to_sortable_bits(x).astype(np.uint64)
    digit = (keys >> np.uint64(shift)) & np.uint64((1 << rb) - 1)
    digit = digit[(keys >> np.uint64(shift + rb)) == np.uint64(prefix)]
    return np.bincount(digit.astype(np.int64), minlength=1 << rb)


def _quartile_prefixes(x, shift, rb):
    """Three live prefixes, the middle one twice: a repeated prefix must
    get its whole histogram in both rows."""
    keys = np.sort(dt.np_to_sortable_bits(x).astype(np.uint64))
    n = len(keys)
    return [int(keys[i]) >> (shift + rb) for i in (n // 4, n // 2, n // 2, 3 * n // 4)]


def _port_multi(x, shift, rb, prefixes, device="cpu"):
    bits = x.dtype.itemsize * 8
    key_op, key_xor = _fold(x.dtype)
    p = torch.tensor(
        [dt.signed_const(v, bits) for v in prefixes],
        dtype=torch.int32 if bits == 32 else torch.int64, device=device,
    )
    h = H.radix_histogram_multi(
        tensor_from_numpy(x, device), shift=shift, radix_bits=rb, prefixes=p, key_op=key_op, key_xor=key_xor
    )
    return h.cpu().numpy()


# --- the multi-prefix histogram against the Pallas kernels (interpret mode) ---


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.uint32])
def test_multi_histogram32_matches_pallas(dtype):
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.pallas.histogram import pallas_radix_histogram_multi, prepare_raw_tiles32

    shift, rb = 20, 4
    x = _raw_case(dtype, 256 * 128 + 55)
    prefixes = _quartile_prefixes(x, shift, rb)
    key_op, key_xor = _fold(dtype)
    tiles, n = prepare_raw_tiles32(jnp.asarray(x), 256)
    want = np.asarray(pallas_radix_histogram_multi(
        shift=shift, radix_bits=rb, prefixes=jnp.asarray(np.array(prefixes, np.uint32)),
        tiles=tiles, orig_n=n, block_rows=256, key_op=key_op, key_xor=key_xor,
    ))
    got = _port_multi(x, shift, rb, prefixes)
    np.testing.assert_array_equal(got, want)
    for q, p in enumerate(prefixes):
        np.testing.assert_array_equal(got[q], _numpy_hist(x, shift, rb, p), err_msg=str(q))


@pytest.mark.parametrize("dtype", [np.int64, np.uint64, np.float64])
@pytest.mark.parametrize("shift", [36, 20, 0])
def test_multi_histogram64_matches_pallas(dtype, shift):
    """Shift 36 is the JAX kernel's hi-plane reroute, 20 and 0 its lo-plane
    kernel; the port reads whole 64-bit words for all three."""
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.pallas.histogram import pallas_radix_histogram64_multi, prepare_raw_tiles64
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    rb = 4
    x = _raw_case(dtype, 256 * 128 + 55)
    prefixes = _quartile_prefixes(x, shift, rb)
    key_op, key_xor = _fold(dtype)
    with enable_x64():
        hi, lo, n = prepare_raw_tiles64(jnp.asarray(x), 256)
        want = np.asarray(pallas_radix_histogram64_multi(
            shift=shift, radix_bits=rb, prefixes=jnp.asarray(np.array(prefixes, np.uint64)),
            tiles=(hi, lo), orig_n=n, block_rows=256, key_op=key_op, key_xor=key_xor,
        ))
    got = _port_multi(x, shift, rb, prefixes)
    np.testing.assert_array_equal(got, want)
    for q, p in enumerate(prefixes):
        np.testing.assert_array_equal(got[q], _numpy_hist(x, shift, rb, p), err_msg=str(q))


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.int64, np.float64])
@pytest.mark.parametrize("rb", [1, 4, 8])
def test_multi_histogram_matches_numpy_every_shift(dtype, rb):
    x = _raw_case(dtype, 3000 + rb)
    bits = x.dtype.itemsize * 8
    for shift in range(0, bits - rb, 4 if rb != 1 else 13):
        prefixes = _quartile_prefixes(x, shift, rb) + [(1 << (bits - shift - rb)) - 1]  # last: maybe absent
        got = _port_multi(x, shift, rb, prefixes)
        for q, p in enumerate(prefixes):
            np.testing.assert_array_equal(got[q], _numpy_hist(x, shift, rb, p), err_msg=f"{shift} {q}")


def test_multi_histogram_wrapper_checks():
    w = torch.zeros(256, dtype=torch.int32)
    p = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="no prefix bits"):
        H.radix_histogram_multi(w, shift=28, radix_bits=4, prefixes=p)
    with pytest.raises(ValueError, match="prefixes"):
        H.radix_histogram_multi(w, shift=0, radix_bits=4, prefixes=p.to(torch.int64))
    with pytest.raises(ValueError, match="prefixes"):
        H.radix_histogram_multi(w, shift=0, radix_bits=4, prefixes=p[:0])
    with pytest.raises(ValueError, match="key_op"):
        H.radix_histogram_multi(w, shift=0, radix_bits=4, prefixes=p, key_op="abs")


def _prefix_sets(x, shift, rb, seed=11):
    """Prefixes the kernel must answer in any form, by kind: ``shuffled``
    (live prefixes in no order), ``reversed``, ``repeats`` (a few live
    prefixes, each many times, interleaved), ``all_equal`` (one prefix K
    times), ``absent`` (prefixes that no key holds, one of them past the
    prefix width) and ``k64`` (64 queries: live, repeated and absent ones
    shuffled). Linear in len(x): no sort of the keys."""
    rng = np.random.default_rng(seed)
    bits = x.dtype.itemsize * 8
    width = bits - shift - rb
    tops = dt.np_to_sortable_bits(x).astype(np.uint64) >> np.uint64(shift + rb)
    held = np.zeros(min(1 << width, 4096), bool)
    held[tops[tops < len(held)].astype(np.int64)] = True
    absent = [int(v) for v in np.flatnonzero(~held)[:3]] + [(1 << width) + 1]
    sample = np.unique(tops[rng.integers(0, len(tops), 64)])
    picks = [int(v) for v in rng.permutation(sample)[:8]]
    return {
        "shuffled": picks,
        "reversed": sorted(picks, reverse=True),
        "repeats": [picks[i % 3] for i in (0, 1, 2, 0, 2, 1, 1, 0)],
        "all_equal": [picks[0]] * 6,
        "absent": absent,
        "k64": [int(v) for v in rng.permutation(picks * 7 + absent[:3] + [picks[0]] * 5)],
    }


PREFIX_SETS = ("shuffled", "reversed", "repeats", "all_equal", "absent")


def _set_cases(k64_dtype, other_dtype):
    """Every prefix set on both dtypes, and K=64 (about 25 s in interpret
    mode) on the first."""
    return [(d, kind) for kind in PREFIX_SETS for d in (k64_dtype, other_dtype)] + [(k64_dtype, "k64")]


@pytest.mark.parametrize(("dtype", "kind"), _set_cases(np.int32, np.float32))
def test_multi_histogram32_prefix_sets_match_pallas(dtype, kind):
    """The contract the kernel keeps whatever the prefixes' order, repeats
    or presence: row q is the histogram under prefixes[q], against the
    Pallas kernel (interpret mode) and NumPy. Shift 12 leaves 16 prefix
    bits, so that valid prefixes can be absent from the data."""
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.pallas.histogram import pallas_radix_histogram_multi, prepare_raw_tiles32

    shift, rb = 12, 4
    x = _raw_case(dtype, 256 * 128 + 55)
    prefixes = _prefix_sets(x, shift, rb)[kind]
    key_op, key_xor = _fold(dtype)
    tiles, n = prepare_raw_tiles32(jnp.asarray(x), 256)
    want = np.asarray(pallas_radix_histogram_multi(
        shift=shift, radix_bits=rb, prefixes=jnp.asarray(np.array(prefixes, np.uint32)),
        tiles=tiles, orig_n=n, block_rows=256, key_op=key_op, key_xor=key_xor,
    ))
    got = _port_multi(x, shift, rb, prefixes)
    np.testing.assert_array_equal(got, want)
    for q, p in enumerate(prefixes):
        np.testing.assert_array_equal(got[q], _numpy_hist(x, shift, rb, p), err_msg=str(q))


@pytest.mark.parametrize(("dtype", "kind"), _set_cases(np.float64, np.int64))
def test_multi_histogram64_prefix_sets_match_pallas(dtype, kind):
    """As the 32-bit test, against ``pallas_radix_histogram64_multi``
    under x64 (shift 20: its lo-plane kernel)."""
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.pallas.histogram import pallas_radix_histogram64_multi, prepare_raw_tiles64
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    shift, rb = 20, 4
    x = _raw_case(dtype, 256 * 128 + 55)
    prefixes = _prefix_sets(x, shift, rb)[kind]
    key_op, key_xor = _fold(dtype)
    with enable_x64():
        hi, lo, n = prepare_raw_tiles64(jnp.asarray(x), 256)
        want = np.asarray(pallas_radix_histogram64_multi(
            shift=shift, radix_bits=rb, prefixes=jnp.asarray(np.array(prefixes, np.uint64)),
            tiles=(hi, lo), orig_n=n, block_rows=256, key_op=key_op, key_xor=key_xor,
        ))
    got = _port_multi(x, shift, rb, prefixes)
    np.testing.assert_array_equal(got, want)
    for q, p in enumerate(prefixes):
        np.testing.assert_array_equal(got[q], _numpy_hist(x, shift, rb, p), err_msg=str(q))


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("rb", [4, 8])
@pytest.mark.parametrize("nq", [1, 4, 64, 128, 300])
def test_multi_plan_fits_two_blocks_per_sm(bits, rb, nq):
    """The kernel's launch plan: every launch's block within the 227 KB a
    block may hold and leaving two blocks on an SM (228 KB, 1 KB reserved
    each); the most sub-histogram copies within ``MULTI_COPIES_SMEM``; the
    queries split over as few launches as fit, for an exact prefix table
    (pass 1) and a hashed one (a deep pass)."""
    for shift in (bits - rb - 4, 0):
        per_launch, copies = H.multi_plan(bits, shift, rb, nq)
        table_bits = min(bits - shift - rb, H.MULTI_TABLE_BITS)
        q = min(nq, per_launch)

        def smem(queries, c):
            return H._multi_smem_bytes(bits, rb, table_bits, queries, c)

        assert smem(q, copies) <= 227 * 1024 and 2 * (smem(q, copies) + 1024) <= 228 * 1024, shift
        assert copies in (8, 4, 2, 1) and 1 <= per_launch <= H.MULTI_MAX_QUERIES
        assert copies == 1 or smem(q, copies) <= H.MULTI_COPIES_SMEM
        if copies < 8:  # twice the copies would take too much
            assert smem(q, 2 * copies) > H.MULTI_COPIES_SMEM
        if per_launch < nq:  # one more query would not fit
            assert smem(per_launch + 1, 1) > H.MULTI_SMEM_PER_BLOCK
    # the many-ranks walk's own shapes take one launch
    if rb == 4 and nq <= 128:
        assert H.multi_plan(bits, bits - 8, rb, nq)[0] == nq


@pytest.mark.parametrize("shape", [(1, 300), (4, 1000), (64, 3)])
def test_row_cumsum_matches_cumsum_along_rows(shape):
    cnt = torch.randint(0, 129, shape, dtype=torch.int32, generator=torch.Generator().manual_seed(1))
    assert torch.equal(row_cumsum(cnt), torch.cumsum(cnt, 1, dtype=torch.int64))


def test_bucket_walk_step_multi_matches_single_steps():
    rng = np.random.default_rng(7)
    hist = torch.tensor(rng.integers(0, 50, size=(5, 16)), dtype=torch.int64)
    kk = torch.tensor([1, 7, 30, 30, int(hist[4].sum())], dtype=torch.int64)
    prefixes = torch.tensor([3, 0, 9, 9, 1], dtype=torch.int32)
    got = bucket_walk_step_multi(hist, kk, prefixes, torch.int32, 4)
    for q in range(5):
        want = bucket_walk_step(hist[q], kk[q : q + 1], prefixes[q : q + 1], torch.int32, 4)
        for g, w in zip(got, want):
            assert int(g[q]) == int(w[0]), q
    shared = bucket_walk_step_multi(hist[0], kk, None, torch.int32, 4)
    for q in range(5):
        want = bucket_walk_step(hist[0], kk[q : q + 1], None, torch.int32, 4)
        assert [int(g[q]) for g in shared] == [int(w[0]) for w in want]


# --- kselect_many / quantiles against NumPy, all 12 dtypes -------------------


@pytest.mark.parametrize("name", DTYPES)
def test_kselect_many_matches_numpy(name):
    """Auto, a forced cutover with budget 1024 (rung 1) and 64 (rung 2 or
    the full schedule), on every fixture; ks hold 1, n and duplicates."""
    co = forced_cutover(name)
    ks = [N, 1, 250, N // 2, N // 2, N - 1]
    H.reset_counts()
    for pattern, x in fixtures(name):
        xd = tensor_from_numpy(x, "cpu")
        want = key_oracle(x, ks).tobytes()
        for kw in ({}, {"cutover": co, "cutover_budget": 1024}, {"cutover": co, "cutover_budget": 64}):
            assert bits_of(kt.kselect_many(xd, ks, **kw)) == want, (pattern, kw)
    assert H.PLAIN_CALLS["radix_histogram_multi"] > 0 and not any(H.LAUNCHES.values())


@pytest.mark.parametrize("name", ["int32", "float16", "float64"])
def test_kselect_many_2d_ks_and_sort_leg(name):
    x = fixtures(name)[0][1]
    xd = tensor_from_numpy(x, "cpu")
    ks = np.array([[1, N], [N // 3, N // 3], [7, N - 7]])
    want = key_oracle(x, ks)
    got = kt.kselect_many(xd, ks)
    assert tuple(got.shape) == ks.shape and bits_of(got) == want.tobytes()
    many = np.linspace(1, N, api.many_sort_dispatch_queries(N)).astype(np.int64)  # the sort leg
    assert bits_of(kt.kselect_many(xd, many)) == key_oracle(x, many).tobytes()
    assert bits_of(kt.kselect_many(xd[:1000], ks % 1000 + 1)) == key_oracle(x[:1000], ks % 1000 + 1).tobytes()


def test_kselect_many_scalar_tensor_and_range():
    x = datagen.generate(N, pattern="seqlike", seed=2)
    xd = tensor_from_numpy(x, "cpu")
    got = kt.kselect_many(xd, 250)
    assert got.shape == () and bits_of(got) == key_oracle(x, 250).tobytes()
    got = kt.kselect_many(xd, np.int64(250))
    assert got.shape == ()
    # a tensor of ks is clamped, as a traced ks is in the JAX package
    got = kt.kselect_many(xd, torch.tensor([0, 10**9, 5]))
    assert bits_of(got) == key_oracle(x, [1, N, 5]).tobytes()
    for ks in ([], np.zeros((0, 3), np.int64)):  # no queries: no answers, on either leg
        assert kt.kselect_many(xd, ks).shape == np.shape(ks)
        assert kt.kselect_many(xd[:100], ks).shape == np.shape(ks)
    for bad in ([0, 5], [5, N + 1], np.array([[1], [-2]])):
        with pytest.raises(ValueError, match="out of range"):
            kt.kselect_many(xd, bad)
    with pytest.raises(ValueError, match="non-empty"):
        kt.kselect_many(np.zeros(0, np.int32), [1], device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        kt.quantiles(np.zeros(0, np.int32), [0.5], device="cpu")
    with pytest.raises(ValueError, match="outside"):
        kt.quantiles(xd, [0.5, 1.5])


def test_sort_leg_warns_that_radix_options_are_ignored():
    x = tensor_from_numpy(datagen.generate(1000, seed=3), "cpu")
    with pytest.warns(UserWarning, match="radix options"):
        kt.kselect_many(x, [1, 2], cutover=2)
    big = tensor_from_numpy(datagen.generate(N, seed=3), "cpu")
    with pytest.warns(UserWarning, match=r"\['cutover_budget'\]"):
        kt.kselect_many(big, np.arange(1, 200), cutover_budget=64)


def test_cli_quantiles_mode_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "mpi_k_selection_tpu_torch", "--n", str(N), "--dtype", "float64",
         "--gen", "normal", "--seed", "4", "--quantiles", "0.5,0.9,0.99", "--device", "cpu",
         "--verify", "--json"],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["extra"]["exact_match"] is True
    x = datagen.generate(N, pattern="normal", seed=4, dtype=np.float64)
    want = key_oracle(x, api.quantile_ranks([0.5, 0.9, 0.99], N))
    assert np.array(rec["answer"], np.float64).tobytes() == want.tobytes()


def test_quantile_ranks_and_dispatch_rule_match_reference():
    from mpi_k_selection_tpu import api as ref_api

    for n in (1, 7, 100, 10**6, 2**31 + 5):
        qs = [0.0, 0.001, 0.5, 0.9, 0.99, 0.999, 1.0]
        assert api.quantile_ranks(qs, n) == ref_api.quantile_ranks(qs, n)
        assert api.many_sort_dispatch_queries(n) == ref_api.many_sort_dispatch_queries(n)
    assert api.quantile_ranks(0.99, 100) == [99]


# --- against the JAX package's radix_select_many and quantiles ---------------


@pytest.mark.parametrize(
    "name,cutover,ks",
    [
        ("int32", 3, [1, N_REF // 2, N_REF]),
        ("float32", 3, [N_REF, N_REF // 3, N_REF // 3]),
        ("int64", 5, [1, N_REF]),
        ("float64", 5, [N_REF // 2, N_REF]),
    ],
)
def test_kselect_many_matches_reference_radix_select_many(name, cutover, ks):
    """One forced cutover (budget 1024) over every fixture: rung 1 on
    spread keys, rung 2 or the full schedule on dense ones; the JAX
    descent runs its Pallas kernels in interpret mode."""
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.radix import radix_select_many as ref_many
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    method = "pallas64" if dt.key_bits(name) == 64 else "pallas"
    kw = {"cutover": cutover, "cutover_budget": 1024}
    ks = np.array(ks)
    with enable_x64():
        for pattern, x in fixtures(name, N_REF):
            ref = np.asarray(ref_many(jnp.asarray(x), jnp.asarray(ks), hist_method=method, block_rows=256, **kw))
            got = kt.radix_select_many(tensor_from_numpy(x, "cpu"), ks, **kw)
            assert bits_of(got) == ref.tobytes() == key_oracle(x, ks).tobytes(), pattern


@pytest.mark.parametrize("name", ["int32", "float32", "float64"])
def test_quantiles_match_reference(name):
    from mpi_k_selection_tpu import api as ref_api
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    qs = [0.5, 0.9, 0.99, 0.999]
    with enable_x64():
        for pattern, x in fixtures(name)[::2]:
            ref = np.asarray(ref_api.quantiles(x, qs))
            got = kt.quantiles(x, qs, device="cpu")
            assert bits_of(got) == ref.tobytes(), pattern
            assert bits_of(cuda_backend.quantiles(x, qs, device="cpu")) == ref.tobytes()
    assert kt.quantiles(x, 0.5, device="cpu").shape == (1,)


# --- on the card ----------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32, np.int64, np.uint64, np.float64])
def test_multi_histogram_kernel_matches_plain_on_card(cuda_device, dtype):
    x = _raw_case(dtype, (1 << 22) + 77)
    words = tensor_from_numpy(x, cuda_device)
    bits = x.dtype.itemsize * 8
    key_op, key_xor = _fold(dtype)
    wdt = torch.int32 if bits == 32 else torch.int64
    equal = tensor_from_numpy(np.full(len(x), 42, x.dtype), cuda_device)
    for rb in (4, 8):
        for shift in (bits - 2 * rb, bits - 3 * rb, 0):
            ps = _quartile_prefixes(x, shift, rb)
            for nq in (1, 4, 64, 300):  # 300 queries at rb=8: more than one launch
                p = torch.tensor([dt.signed_const(ps[q % 4], bits) for q in range(nq)], dtype=wdt, device=cuda_device)
                kw = dict(shift=shift, radix_bits=rb, prefixes=p, key_op=key_op, key_xor=key_xor)
                got = H.radix_histogram_multi(words, **kw)
                assert torch.equal(got, H.radix_histogram_multi_plain(words, **kw)), (rb, shift, nq)
            # reversed, shuffled, repeated, all equal and absent prefixes, and
            # one prefix 64 times on all-equal data (one hot bin)
            sets = [(words, kind, ps) for kind, ps in _prefix_sets(x, shift, rb).items()]
            sets.append((equal, "one hot bin", _quartile_prefixes(np.full(4, 42, x.dtype), shift, rb)[:1] * 64))
            for data, kind, ps in sets:
                p = torch.tensor([dt.signed_const(v, bits) for v in ps], dtype=wdt, device=cuda_device)
                kw = dict(shift=shift, radix_bits=rb, prefixes=p, key_op=key_op, key_xor=key_xor)
                got = H.radix_histogram_multi(data, **kw)
                assert torch.equal(got, H.radix_histogram_multi_plain(data, **kw)), (rb, shift, kind)
    # a storage offset breaks 16-byte alignment: the scalar loop
    p = torch.tensor([dt.signed_const(v, bits) for v in _quartile_prefixes(x[1:], bits - 8, 4)], dtype=wdt, device=cuda_device)
    kw = dict(shift=bits - 8, radix_bits=4, prefixes=p, key_op=key_op, key_xor=key_xor)
    assert torch.equal(H.radix_histogram_multi(words[1:], **kw), H.radix_histogram_multi_plain(words[1:], **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("name", DTYPES)
def test_kselect_many_on_card_matches_numpy(cuda_device, name):
    bits = dt.key_bits(name)
    cutover = 12 if bits == 64 else forced_cutover(name)
    n = 1 << 20
    ks = [1, 250, n // 2, n // 2, n - 3, n]
    # random bits spread the keys, so the collect runs for 16-bit keys too
    # (the fixtures' float16 values overflow to a few repeated keys)
    words = np.random.default_rng(5).integers(0, 2**bits, size=n, dtype=np.uint64)
    spread = words.astype(f"uint{bits}").view(numpy_dtype(name))
    H.reset_counts()
    for pattern, x in fixtures(name, n=n) + [("random bits", spread)]:
        got = kt.kselect_many(tensor_from_numpy(x, cuda_device), ks, cutover=cutover)
        assert bits_of(got) == key_oracle(x, ks).tobytes(), pattern
    assert not any(H.PLAIN_CALLS.values())
    assert H.LAUNCHES[f"radix_histogram_multi{max(bits, 32)}"] > 0
    if bits > 8:  # 8-bit keys overflow both rungs at this n: no collect
        assert H.LAUNCHES[f"match_counts{max(bits, 32)}"] > 0  # sub-32-bit keys count on widened words
