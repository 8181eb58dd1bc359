"""The port's histogram and match-count functions against the JAX package's
Pallas kernels (interpret mode on the CPU) and against NumPy, and the
match-count launcher's plan of the kernel's shared memory.

Counts are integers and compared exactly: no tolerance. On the CPU the
wrappers run their plain PyTorch versions; the kernels themselves are
checked against those plain versions on the card by the ``gpu`` tests:

    python -m pytest --noconftest tests/test_torch_*.py -m gpu

The JAX package is imported inside the tests that use it, so that this
file also collects where only PyTorch is installed.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
from mpi_k_selection_tpu_torch.utils import dtypes as dt
from mpi_k_selection_tpu_torch.utils.interop import tensor_from_numpy

# one intra-op thread: in a parallel test run each worker's torch thread pool
# oversubscribes the cores, and small CPU ops stall on its barriers
torch.set_num_threads(1)

N32 = 2 * 128 * 128 + 77  # two 128-row blocks of the Pallas grid plus a ragged tail


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs a CUDA device; on the card: "
            "python -m pytest --noconftest tests/test_torch_*.py -m gpu"
        )
    return torch.device("cuda")


def _raw_case(dtype, n, seed=1234):
    """Raw data with both signs (floats: an exact half negative)."""
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
    if prefix is not None:
        digit = digit[(keys >> np.uint64(shift + rb)) == np.uint64(prefix)]
    return np.bincount(digit.astype(np.int64), minlength=1 << rb)


def _median_prefix(x, shift, rb):
    """A live prefix: the median key's bits above the digit."""
    keys = np.sort(dt.np_to_sortable_bits(x).astype(np.uint64))
    return int(keys[len(keys) // 2]) >> (shift + rb)


def _prefix_tensor(value, bits, device="cpu"):
    wdt = torch.int32 if bits == 32 else torch.int64
    return torch.tensor([dt.signed_const(value, bits)], dtype=wdt, device=device)


def _port_hist(x, shift, rb, prefix, device="cpu"):
    bits = x.dtype.itemsize * 8
    key_op, key_xor = _fold(x.dtype)
    words = tensor_from_numpy(x, device)
    p = None if prefix is None else _prefix_tensor(prefix, bits, device)
    h = H.radix_histogram(words, shift=shift, radix_bits=rb, prefix=p, key_op=key_op, key_xor=key_xor)
    return h.cpu().numpy()


# --- against the Pallas kernels (interpret mode) ----------------------------


@pytest.mark.parametrize(
    "dtype,rb,with_prefix",
    [
        (np.uint32, 4, False), (np.uint32, 4, True),
        (np.int32, 4, False), (np.int32, 4, True),
        (np.float32, 4, False), (np.float32, 4, True),
        (np.int32, 8, False), (np.float32, 8, True),
    ],
)
def test_histogram32_matches_pallas(dtype, rb, with_prefix):
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.pallas.histogram import pallas_radix_histogram, prepare_raw_tiles32

    x = _raw_case(dtype, N32)
    shift = 12 if with_prefix else 32 - rb
    prefix = _median_prefix(x, shift, rb) if with_prefix else None
    key_op, key_xor = _fold(dtype)
    tiles, n = prepare_raw_tiles32(jnp.asarray(x), 128)
    want = pallas_radix_histogram(
        None, shift=shift, radix_bits=rb,
        prefix=None if prefix is None else jnp.uint32(prefix),
        tiles=tiles, orig_n=n, block_rows=128, key_op=key_op, key_xor=key_xor,
    )
    got = _port_hist(x, shift, rb, prefix)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, _numpy_hist(x, shift, rb, prefix))


@pytest.mark.parametrize("dtype", [np.int64, np.uint64, np.float64])
@pytest.mark.parametrize("shift", [60, 36, 8])
def test_histogram64_matches_pallas(dtype, shift):
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.pallas.histogram import pallas_radix_histogram64, prepare_raw_tiles64
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    rb = 4
    x = _raw_case(dtype, N32)
    prefix = None if shift + rb == 64 else _median_prefix(x, shift, rb)
    key_op, key_xor = _fold(dtype)
    with enable_x64():
        hi, lo, n = prepare_raw_tiles64(jnp.asarray(x), 256)
        want = np.asarray(pallas_radix_histogram64(
            None, shift=shift, radix_bits=rb,
            prefix=None if prefix is None else jnp.uint64(prefix),
            tiles=(hi, lo), orig_n=n, block_rows=256, key_op=key_op, key_xor=key_xor,
        ))
    got = _port_hist(x, shift, rb, prefix)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _numpy_hist(x, shift, rb, prefix))


def _numpy_match(x, res, prefixes):
    bits = x.dtype.itemsize * 8
    keys = dt.np_to_sortable_bits(x).astype(np.uint64)
    rows = -(-len(x) // 128)
    top = np.zeros(rows * 128, np.uint64)
    top[: len(x)] = keys >> np.uint64(bits - res)
    valid = np.arange(rows * 128) < len(x)
    return np.stack([
        ((top == np.uint64(p)) & valid).reshape(rows, 128).sum(axis=1) for p in prefixes
    ])


def _port_match(x, res, prefixes, device="cpu"):
    bits = x.dtype.itemsize * 8
    key_op, key_xor = _fold(x.dtype)
    p = torch.tensor(
        [dt.signed_const(v, bits) for v in prefixes],
        dtype=torch.int32 if bits == 32 else torch.int64, device=device,
    )
    c = H.match_counts(
        tensor_from_numpy(x, device), resolved_bits=res, prefixes=p, key_op=key_op, key_xor=key_xor
    )
    return c.cpu().numpy()


@pytest.mark.parametrize(
    "dtype,nq", [(np.int32, 1), (np.int32, 3), (np.float32, 3), (np.uint32, 1)]
)
def test_match_counts32_matches_pallas(dtype, nq):
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.pallas.histogram import pallas_match_counts, prepare_raw_tiles32

    res = 12
    x = _raw_case(dtype, N32)
    keys = np.sort(dt.np_to_sortable_bits(x).astype(np.uint64))
    prefixes = [int(keys[i]) >> (32 - res) for i in np.linspace(0, N32 - 1, nq).astype(int)]
    key_op, key_xor = _fold(dtype)
    tiles, n = prepare_raw_tiles32(jnp.asarray(x), 128)
    want = np.asarray(pallas_match_counts(
        resolved_bits=res, prefixes=jnp.asarray(np.array(prefixes, np.uint32)), tiles=tiles,
        orig_n=n, key_op=key_op, key_xor=key_xor, block_rows=128,
    ))
    got = _port_match(x, res, prefixes)
    # the Pallas output pads to whole 128-row blocks; the port has one row
    # per 128 input elements
    rows = got.shape[1]
    np.testing.assert_array_equal(got, want[:, :rows])
    assert not want[:, rows:].any()
    np.testing.assert_array_equal(got, _numpy_match(x, res, prefixes))


@pytest.mark.parametrize("dtype,nq", [(np.int64, 1), (np.float64, 3)])
def test_match_counts64_matches_pallas_hi_plane(dtype, nq):
    """The JAX package counts 64-bit keys on their hi plane (resolved bits
    <= 32); the port reads whole 64-bit words and agrees there, and beyond
    32 resolved bits agrees with NumPy."""
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.pallas.histogram import pallas_match_counts, prepare_raw_tiles64
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    x = _raw_case(dtype, N32)
    keys = np.sort(dt.np_to_sortable_bits(x).astype(np.uint64))
    picks = np.linspace(0, N32 - 1, nq).astype(int)
    key_op, key_xor = _fold(dtype)
    res = 24
    prefixes = [int(keys[i]) >> (64 - res) for i in picks]
    with enable_x64():
        hi, _lo, n = prepare_raw_tiles64(jnp.asarray(x), 128)
        want = np.asarray(pallas_match_counts(
            resolved_bits=res, prefixes=jnp.asarray(np.array(prefixes, np.uint32)), tiles=hi,
            orig_n=n, key_op=key_op, key_xor=(key_xor >> 32), block_rows=128,
        ))
    got = _port_match(x, res, prefixes)
    np.testing.assert_array_equal(got, want[:, : got.shape[1]])
    deep = [int(keys[i]) >> (64 - 44) for i in picks]
    np.testing.assert_array_equal(_port_match(x, 44, deep), _numpy_match(x, 44, deep))


# --- the plain versions against NumPy, wider grids ---------------------------


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32, np.int64, np.uint64, np.float64])
@pytest.mark.parametrize("rb", [1, 4, 8])
def test_histogram_matches_numpy_every_shift(dtype, rb):
    x = _raw_case(dtype, 5000 + rb)
    bits = x.dtype.itemsize * 8
    for shift in range(0, bits - rb + 1, 4 if rb != 1 else 13):
        got = _port_hist(x, shift, rb, None)
        np.testing.assert_array_equal(got, _numpy_hist(x, shift, rb, None), err_msg=str(shift))
        if shift + rb < bits:
            p = _median_prefix(x, shift, rb)
            got = _port_hist(x, shift, rb, p)
            np.testing.assert_array_equal(got, _numpy_hist(x, shift, rb, p), err_msg=str(shift))


def test_histogram_skew_all_equal():
    x = np.full(10_000, -7, np.int32)
    np.testing.assert_array_equal(_port_hist(x, 28, 4, None), _numpy_hist(x, 28, 4, None))
    np.testing.assert_array_equal(_port_hist(x, 0, 8, 0x7FFFFF), _numpy_hist(x, 0, 8, 0x7FFFFF))


def test_match_counts_full_width_and_tail():
    x = _raw_case(np.int32, 300)  # rows: 128, 128, 44
    keys = dt.np_to_sortable_bits(x).astype(np.uint64)
    prefixes = [int(keys[5]), int(keys[299])]
    got = _port_match(x, 32, prefixes)
    assert got.shape == (2, 3)
    np.testing.assert_array_equal(got, _numpy_match(x, 32, prefixes))


def test_cpu_tensors_run_the_plain_versions():
    H.reset_counts()
    x = _raw_case(np.int32, 1000)
    _port_hist(x, 28, 4, None)
    _port_match(x, 8, [3])
    assert H.PLAIN_CALLS == {"radix_histogram": 1, "match_counts": 1, "radix_histogram_multi": 0, "tau_counts": 0}
    assert all(v == 0 for v in H.LAUNCHES.values())


def test_wrappers_reject_what_the_kernels_do_not_take():
    w = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="1-D"):
        H.radix_histogram(w.view(2, 128), shift=0, radix_bits=4)
    with pytest.raises(ValueError, match="contiguous"):
        H.radix_histogram(w[::2], shift=0, radix_bits=4)
    with pytest.raises(ValueError, match="4- or 8-byte"):
        H.radix_histogram(w.to(torch.int16), shift=0, radix_bits=4)
    with pytest.raises(ValueError, match="key_op"):
        H.radix_histogram(w, shift=0, radix_bits=4, key_op="abs")
    with pytest.raises(ValueError, match="outside"):
        H.radix_histogram(w, shift=30, radix_bits=4)
    with pytest.raises(ValueError, match="prefix"):
        H.radix_histogram(w, shift=28, radix_bits=4, prefix=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="prefix"):
        H.radix_histogram(w, shift=0, radix_bits=4, prefix=torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="prefixes"):
        H.match_counts(w, resolved_bits=8, prefixes=torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="resolved_bits"):
        H.match_counts(w, resolved_bits=0, prefixes=torch.zeros(1, dtype=torch.int32))


# --- on the card: each kernel against its plain version ----------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32, np.int64, np.uint64, np.float64])
def test_histogram_kernel_matches_plain_on_card(cuda_device, dtype):
    x = _raw_case(dtype, (1 << 24) + 77)
    words = tensor_from_numpy(x, cuda_device)
    bits = x.dtype.itemsize * 8
    key_op, key_xor = _fold(dtype)
    for rb in (4, 8):
        for shift, live in ((bits - rb, False), (bits - 3 * rb, True), (0, True)):
            p = _prefix_tensor(_median_prefix(x, shift, rb), bits, cuda_device) if live else None
            kw = dict(shift=shift, radix_bits=rb, prefix=p, key_op=key_op, key_xor=key_xor)
            got = H.radix_histogram(words, **kw)
            assert torch.equal(got, H.radix_histogram_plain(words, **kw)), (rb, shift)
    # a storage offset breaks 16-byte alignment: the scalar loop
    kw = dict(shift=bits - 4, radix_bits=4, key_op=key_op, key_xor=key_xor)
    assert torch.equal(H.radix_histogram(words[1:], **kw), H.radix_histogram_plain(words[1:], **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.int64, np.float64])
def test_match_counts_kernel_matches_plain_on_card(cuda_device, dtype):
    x = _raw_case(dtype, (1 << 24) + 77)
    words = tensor_from_numpy(x, cuda_device)
    bits = x.dtype.itemsize * 8
    key_op, key_xor = _fold(dtype)
    keys = np.sort(dt.np_to_sortable_bits(x).astype(np.uint64))
    for res, nq in ((16, 1), (24, 3), (bits, 2)):
        prefixes = [int(keys[i]) >> (bits - res) for i in np.linspace(0, len(x) - 1, nq).astype(int)]
        p = torch.tensor(
            [dt.signed_const(v, bits) for v in prefixes],
            dtype=words.view(torch.int32 if bits == 32 else torch.int64).dtype, device=cuda_device,
        )
        kw = dict(resolved_bits=res, prefixes=p, key_op=key_op, key_xor=key_xor)
        assert torch.equal(H.match_counts(words, **kw), H.match_counts_plain(words, **kw)), res


# --- match counts at many prefixes: the plain version, the launcher's plan,
# and on the card the kernel at every query count, width and edge case -------


SMEM_TWO_BLOCKS = 228 * 1024 // 2 - 1024  # the shared memory of a block that leaves two on an SM


def _prefix_set(x, res, nq, seed=7):
    """``nq`` prefixes at ``res`` resolved bits: the top bits of keys of
    ``x`` at evenly spaced ranks, the second one repeated at the end, one
    value past every key's top bits (2^res, below the full width) and,
    where one exists, an in-range value that no key holds."""
    bits = x.dtype.itemsize * 8
    keys = np.sort(dt.np_to_sortable_bits(x).astype(np.uint64))
    tops = keys >> np.uint64(bits - res)
    live = [int(tops[i]) for i in np.linspace(0, len(x) - 1, max(1, nq - 3)).astype(int)]
    out = live + live[1:2]
    if res < bits:
        out.append(1 << res)  # past any key's top bits
    have = set(int(t) for t in np.unique(tops))
    rng = np.random.default_rng(seed)
    for _ in range(64):
        cand = int(rng.integers(0, 1 << min(res, 62)))
        if cand not in have:
            out.append(cand)
            break
    while len(out) < nq:
        out.append(live[len(out) % len(live)])
    return out[:nq]


def _prefixes_tensor(prefixes, bits, device="cpu"):
    return torch.tensor(
        [dt.signed_const(v, bits) for v in prefixes], dtype=torch.int32 if bits == 32 else torch.int64, device=device
    )


def _match_kw(x, res, prefixes, device="cpu"):
    bits = x.dtype.itemsize * 8
    key_op, key_xor = _fold(x.dtype)
    return dict(resolved_bits=res, prefixes=_prefixes_tensor(prefixes, bits, device), key_op=key_op, key_xor=key_xor)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_match_counts_plain_matches_pallas_at_64_prefixes(dtype):
    """64 prefixes, one repeated and two that no key holds (one past every
    key's top bits), through the Pallas kernel in interpret mode."""
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.pallas.histogram import pallas_match_counts, prepare_raw_tiles32

    res = 12
    x = _raw_case(dtype, N32)
    prefixes = _prefix_set(x, res, 64)
    assert len(set(prefixes)) < 64 and (1 << res) in prefixes
    key_op, key_xor = _fold(dtype)
    tiles, n = prepare_raw_tiles32(jnp.asarray(x), 128)
    want = np.asarray(pallas_match_counts(
        resolved_bits=res, prefixes=jnp.asarray(np.array(prefixes, np.uint32)), tiles=tiles,
        orig_n=n, key_op=key_op, key_xor=key_xor, block_rows=128,
    ))
    kw = _match_kw(x, res, prefixes)
    got = H.match_counts_plain(tensor_from_numpy(x, "cpu"), **kw).numpy()
    rows = got.shape[1]
    np.testing.assert_array_equal(got, want[:, :rows])
    assert not want[:, rows:].any()
    assert not got[prefixes.index(1 << res)].any()


@pytest.mark.parametrize("dtype,res", [(np.int32, 20), (np.uint32, 32), (np.float32, 9), (np.int64, 44),
                                       (np.float64, 64), (np.uint64, 3)])
def test_match_counts_plain_matches_numpy_at_130_prefixes(dtype, res):
    x = _raw_case(dtype, 3 * 128 + 45)
    prefixes = _prefix_set(x, res, 130)
    got = H.match_counts_plain(tensor_from_numpy(x, "cpu"), **_match_kw(x, res, prefixes)).numpy()
    np.testing.assert_array_equal(got, _numpy_match(x, res, prefixes))


@pytest.mark.parametrize("dtype", [np.int32, np.float64])
def test_match_counts_plain_counts_a_hot_prefix(dtype):
    """One prefix that every key holds, among others that none holds: each
    full row counts 128, the tail row its length."""
    n = 5 * 128 + 3
    x = np.full(n, 42, dtype)
    bits = x.dtype.itemsize * 8
    hot = int(dt.np_to_sortable_bits(x[:1]).astype(np.uint64)[0]) >> (bits - 20)
    prefixes = [hot + 1, hot, hot - 1, hot]
    got = H.match_counts_plain(tensor_from_numpy(x, "cpu"), **_match_kw(x, 20, prefixes)).numpy()
    np.testing.assert_array_equal(got, _numpy_match(x, 20, prefixes))
    np.testing.assert_array_equal(got[1], [128] * 5 + [3])
    assert not got[0].any() and not got[2].any()


def test_match_counts_cpu_tensor_runs_the_plain_version():
    H.reset_counts()
    x = _raw_case(np.int32, 1000)
    got = H.match_counts(tensor_from_numpy(x, "cpu"), **_match_kw(x, 20, _prefix_set(x, 20, 70)))
    assert got.shape == (70, 8)
    assert H.PLAIN_CALLS["match_counts"] == 1
    assert all(v == 0 for v in H.LAUNCHES.values())


# --- the launcher's plan -------------------------------------------------------


@pytest.mark.parametrize("bits", [32, 64])
def test_match_plan_fits_every_query_count(bits):
    """Over K in 1 .. 5000: at most MATCH_MAX_QUERIES a launch, as few
    launches as that allows, split evenly; the compare only where a launch
    holds at most MATCH_COMPARE_MAX, always with the largest tile; a tile
    of 8, 16 or 32 rows (16 KB of words at most), its most rows while the
    block's shared memory stays within MATCH_SMEM_TARGET, and every block
    leaving two on an SM."""
    most_rows = H.MATCH_TILE_BYTES // (128 * bits // 8)
    assert most_rows == (32 if bits == 32 else 16)
    seen = set()
    for nq in range(1, 5001):
        per_launch, tile_rows, compare = H._match_plan(bits, nq)
        launches = -(-nq // per_launch)
        assert per_launch <= H.MATCH_MAX_QUERIES and launches == -(-nq // H.MATCH_MAX_QUERIES), nq
        assert per_launch * launches - nq < launches, nq  # an even split
        assert compare == (nq <= H.MATCH_COMPARE_MAX), nq
        assert tile_rows in (8, 16, 32) and tile_rows <= most_rows, nq
        assert not compare or tile_rows == most_rows, nq  # the kernel's compare takes the largest tile only
        smem = H._match_smem_bytes(bits, per_launch, tile_rows, compare)
        assert smem <= SMEM_TWO_BLOCKS, nq
        if tile_rows < most_rows:
            assert H._match_smem_bytes(bits, per_launch, 2 * tile_rows, compare) > H.MATCH_SMEM_TARGET, nq
        seen.add((tile_rows, compare))
    assert (most_rows, True) in seen and (most_rows, False) in seen and (8, False) in seen


def test_match_plan_mirrors_the_kernel_source():
    """The launcher's constants against csrc/histogram.cu: the compare's
    most queries, the table's queries a launch and a tile's bytes."""
    text = (pathlib.Path(H.__file__).parents[2] / "csrc" / "histogram.cu").read_text()
    compare_max = int(re.search(r"constexpr int kCompareMax = (\d+);", text).group(1))
    assert 1 <= H.MATCH_COMPARE_MAX <= compare_max
    assert "constexpr int kMaxMatchQueries = kMaxMultiQueries;" in text
    assert H.MATCH_MAX_QUERIES == H.MULTI_MAX_QUERIES == 1 << (H.MULTI_TABLE_BITS - 1)
    assert "constexpr int kMatchTileBytes = kThreads * 4 * 16;" in text
    assert H.MATCH_TILE_BYTES == 256 * 4 * 16
    assert H._match_smem_bytes(32, 1, 32, True) == 4 * 32
    assert H._match_smem_bytes(64, 64, 16, False) == 16 + 64 * 8 + 4 * 16 * 65 + 2 * 64 + 2 * 4096


# --- on the card: the match-count kernel at chip_smoke.py's phase-2 shapes --------


def _hold_on_card(x, res, prefixes, device, launches=1, words=None):
    words = tensor_from_numpy(x, device) if words is None else words
    kw = _match_kw(x, res, prefixes, device)
    bits = x.dtype.itemsize * 8
    H.reset_counts()
    got = H.match_counts(words, **kw)
    torch.cuda.synchronize()
    assert H.LAUNCHES[f"match_counts{bits}"] == launches and H.PLAIN_CALLS["match_counts"] == 0
    want = torch.cat([H.match_counts_plain(words, **dict(kw, prefixes=kw["prefixes"][i:i + 256]))
                      for i in range(0, len(prefixes), 256)])
    assert torch.equal(got, want), (x.dtype, res, len(prefixes))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32, np.int64, np.float64])
@pytest.mark.parametrize("nq", [1, 3, 4, 64, 120, 160, 2100])
def test_match_counts_kernel_every_query_count_on_card(cuda_device, dtype, nq):
    """K in {1, 3, 4, 64, 120, 160, 2100} (two launches) at a ragged n, with
    repeated prefixes and prefixes no key holds."""
    x = _raw_case(dtype, (1 << 18) + 37)
    res = 20 if x.dtype.itemsize == 4 else 40
    _hold_on_card(x, res, _prefix_set(x, res, nq), cuda_device, launches=-(-nq // H.MATCH_MAX_QUERIES))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.int32, np.float64])
def test_match_counts_kernel_every_width_on_card(cuda_device, dtype):
    """Every resolved width of the key, at K=1, 4 (the compare) and 9 (the
    exact table up to 12 bits, the hashed one beyond)."""
    x = _raw_case(dtype, (1 << 16) + 128 * 3 + 5)
    words = tensor_from_numpy(x, cuda_device)
    for res in range(1, x.dtype.itemsize * 8 + 1):
        for nq in (1, 4, 9):
            _hold_on_card(x, res, _prefix_set(x, res, nq), cuda_device, words=words)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("nq", [1, 8, 64])
def test_match_counts_kernel_hot_prefix_on_card(cuda_device, dtype, nq):
    """Every key holds one prefix (and it is repeated among K), so every lane
    of every row hits: the warp's equal hits counted once a group."""
    x = np.full((1 << 18) + 100, -7, dtype)
    bits = x.dtype.itemsize * 8
    hot = int(dt.np_to_sortable_bits(x[:1]).astype(np.uint64)[0]) >> (bits - 24)
    prefixes = ([hot] + [hot + 1 + i for i in range(nq - 2)] + [hot])[:nq]
    _hold_on_card(x, 24, prefixes, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.int64])
@pytest.mark.parametrize("nq", [1, 64])
def test_match_counts_kernel_misaligned_and_ragged_on_card(cuda_device, dtype, nq):
    """A view that is not 16-byte aligned (the scalar loads), and lengths
    not a multiple of 128 or of 4 (the masked tail tile)."""
    x = _raw_case(dtype, (1 << 17) + 64)
    whole = tensor_from_numpy(x, cuda_device)
    for lo, hi in ((1, len(x)), (3, len(x) - 5), (0, len(x) - 3), (0, 1000 * 128 + 1)):
        sub = x[lo:hi]
        res = 16
        _hold_on_card(sub, res, _prefix_set(sub, res, nq), cuda_device, words=whole[lo:hi])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.int8, np.int16])
def test_match_counts_kernel_widened_keys_on_card(cuda_device, dtype):
    """8- and 16-bit keys widened into 32-bit words (the early exit's and the
    collect's form), every key width at K=1 and K=64."""
    rng = np.random.default_rng(3)
    kb = np.dtype(dtype).itemsize * 8
    small = rng.integers(-(1 << (kb - 1)), 1 << (kb - 1), size=(1 << 16) + 11).astype(dtype)
    words = dt.to_sortable_bits(torch.from_numpy(small)).to(cuda_device)
    x = words.cpu().numpy().view(np.uint32)
    for res in range(1, kb):
        wres = res + 32 - kb
        for nq in (1, 64):
            _hold_on_card(x, wres, _prefix_set(x, wres, nq), cuda_device, words=words)
