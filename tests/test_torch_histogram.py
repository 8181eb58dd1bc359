"""The port's histogram and match-count functions against the JAX package's
Pallas kernels (interpret mode on the CPU) and against NumPy.

Counts are integers and compared exactly: no tolerance. On the CPU the
wrappers run their plain PyTorch versions; the kernels themselves are
checked against those plain versions on the card by the ``gpu`` tests:

    python -m pytest --noconftest tests/test_torch_*.py -m gpu

The JAX package is imported inside the tests that use it, so that this
file also collects where only PyTorch is installed.
"""

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
