"""The port's batched top-k (``method="block"``) and per-row selection
(``batched_kselect`` / ``batched_median``) against the JAX package and
NumPy.

Values are compared as bit patterns and indices exactly: no tolerance.
The JAX package's ``pallas_batched_topk_values`` runs in interpret mode at
``(128, 4096)``, the smallest shapes inside its envelope; each distinct
call compiles for seconds, so the fixtures share a few arrays. The ``gpu``
tests hold the kernel against its plain version on the card:

    python -m pytest --noconftest tests/test_torch_*.py -m gpu
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import mpi_k_selection_tpu_torch as kt
from mpi_k_selection_tpu_torch.backends import cuda as cuda_backend
from mpi_k_selection_tpu_torch.cli import batched_topk_oracle
from mpi_k_selection_tpu_torch.ops import topk as T
from mpi_k_selection_tpu_torch.ops.cuda import topk as K
from mpi_k_selection_tpu_torch.utils import datagen
from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype, tensor_from_numpy, tensor_to_numpy

# one intra-op thread: in a parallel test run each worker's torch thread pool
# oversubscribes the cores, and small CPU ops stall on its barriers
torch.set_num_threads(1)

D = 4096
DTYPES = (
    "int8", "uint8", "int16", "uint16", "int32", "uint32",
    "int64", "uint64", "float16", "bfloat16", "float32", "float64",
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs a CUDA device; on the card: "
            "python -m pytest --noconftest tests/test_torch_*.py -m gpu"
        )
    return torch.device("cuda")


def neg_nan(dtype=np.float32):
    return np.copysign(np.array(np.nan, np.float32), -1.0).astype(dtype)


def bank(k, rows=128, seed=0):
    """``(rows, 4096)`` float32 rows, normal except for the fixtures: the
    TPU kernel's rescue rows (a top-8 in one 128-lane column) and its
    depth-4 band (one column holds the top-16), heavy ties, -inf rows, a
    top-16 inside one CUDA lane's elements (a stride of 32 lanes x 4
    float32 or x 8 bfloat16, in the lane's first loads and later ones),
    ascending and descending rows, +-0.0 at the k boundary in either
    position order and in one lane, and NaNs of both signs."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, D)).astype(np.float32)
    big = 100.0 + np.arange(16, dtype=np.float32)
    for r in (3, 17, 40):  # rescue rows: one lane of the TPU kernel
        x[r, 5 + 128 * np.arange(8)] = big[:8]
    x[7, 3 + 128 * np.arange(16)] = big  # depth-4 band: one lane holds the top-16
    x[20:24] = rng.integers(0, 11, size=(4, D))
    x[24] = rng.integers(0, 13, size=D)
    x[30] = -np.inf
    x[31, : D - 4] = -np.inf  # fewer finite values than k
    lane0 = (128 * np.arange(4)[:, None] + np.arange(4)).ravel()  # lane 0's first four float32 loads
    x[33, lane0] = big
    x[34, 2 + 128 * np.arange(4, 20)] = big  # lane 0, streamed
    x[35, (256 * np.arange(2)[:, None] + np.arange(8)).ravel()] = big  # lane 0's first two bfloat16 loads
    x[36, (256 * np.arange(2, 10)[:, None] + np.array([3, 6])).ravel()] = big[::-1]  # streamed
    x[41] = np.arange(D)
    x[42] = np.arange(D)[::-1]
    x[43] = np.arange(D) // 3
    for r, (pneg, ppos) in zip(range(50, 53), ((1000, 2000), (2000, 1000), (1000 + 128, 1000))):
        x[r] = -1.0  # k-1 winners, then +0.0 (the k-th) and -0.0
        x[r, 64 * np.arange(k - 1)] = 5.0
        x[r, pneg], x[r, ppos] = -0.0, 0.0
    x[53] = -1.0
    x[53, 100:103] = -0.0
    x[53, 200:210] = 0.0
    x[53, 50] = 7.0
    x[54] = rng.choice(np.array([0.0, -0.0], np.float32), size=D)
    x[60, rng.integers(0, D, 3)] = np.nan
    x[60, rng.integers(0, D, 3)] = neg_nan()
    x[61] = neg_nan()
    x[62] = np.where(rng.random(D) < 0.5, neg_nan(), -np.inf)
    x[63, rng.integers(0, D, 40)] = np.nan
    pool = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 2.5, neg_nan()], np.float32)
    x[44:46] = rng.choice(pool, size=(2, D))
    return x


def bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def plain_values(x, k):
    K.reset_counts()
    v = K.batched_topk_values(tensor_from_numpy(x, "cpu"), k)
    assert K.PLAIN_CALLS["batched_topk_values"] == 1 and not any(K.LAUNCHES.values())
    return tensor_to_numpy(v)


# --- the values: plain version vs the JAX kernel and lax.top_k ---------------


@pytest.mark.parametrize("dtype,k", [("float32", 1), ("float32", 5), ("float32", 8), ("float32", 16), ("bfloat16", 8)])
def test_plain_values_match_jax_kernel(dtype, k):
    import jax
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.pallas.topk import pallas_batched_topk_values

    x = bank(k).astype(numpy_dtype(dtype))
    got = plain_values(x, k)
    xj = jnp.asarray(x)
    np.testing.assert_array_equal(bits(got), bits(np.asarray(jax.lax.top_k(xj, k)[0])))
    np.testing.assert_array_equal(bits(got), bits(np.asarray(pallas_batched_topk_values(xj, k))))
    np.testing.assert_array_equal(bits(got), bits(batched_topk_oracle(x, k)[0]))


def test_plain_values_match_jax_kernel_fallback():
    """Every row clustered in one TPU lane with a rescue budget of 16: the
    JAX kernel takes its full ``lax.top_k`` fallback."""
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.pallas.topk import pallas_batched_topk_values

    x = np.random.default_rng(1).standard_normal((128, D)).astype(np.float32)
    x[:, 7 + 128 * np.arange(8)] = 50.0 + np.arange(8, dtype=np.float32)
    want = np.asarray(pallas_batched_topk_values(jnp.asarray(x), 8, rescue_rows=16))
    np.testing.assert_array_equal(bits(plain_values(x, 8)), bits(want))
    np.testing.assert_array_equal(bits(want), bits(np.sort(x, axis=1)[:, ::-1][:, :8]))


# --- values and positions against the JAX package's --------------------------


def tie_bank(k, rows=64, seed=7):
    """``(rows, 4096)`` float32 normal rows whose equal keys straddle the
    CUDA kernel's lanes and loads: in each row 50.0 at 24 positions, then
    60.0 at ``k // 3`` of them, drawn from the first 256 elements of blocks
    0, 1, 5 and 12 of 256 (float32: 4 elements a lane, loads 0-1, 2-3, 10-11
    and 24-25 of all 32 lanes; bfloat16: 8 a lane, loads 0, 1, 5 and 12).
    The top k takes the 60s and then the earliest 50s, spread over lanes:
    a merge that broke ties by lane, not position, would differ."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, D)).astype(np.float32)
    span = (256 * np.array([0, 1, 5, 12])[:, None] + np.arange(256)).ravel()
    for r in range(rows):
        cols = rng.choice(span, size=24, replace=False)
        x[r, cols] = 50.0
        x[r, cols[: k // 3]] = 60.0
    x[0, span[:24]] = 50.0  # one row of 24 consecutive ties: lanes 0-5 of load 0
    return x


def recovery_cases():
    """The cases of the JAX package's recovery tests
    (``tests/test_pallas_topk.py``), each ``(x, k)`` at (64, 4096), the
    fixture bank, and ties across lanes and loads (:func:`tie_bank`)."""
    rng = np.random.default_rng(5)
    b = 64
    c = {"random": (rng.standard_normal((b, D)).astype(np.float32), 8)}
    c["ties"] = (rng.integers(0, 16, size=(b, D)).astype(np.float32), 8)
    c["all-equal"] = (np.zeros((b, D), np.float32), 8)
    c["-inf"] = (np.full((b, D), -np.inf, np.float32), 8)
    xinf = rng.standard_normal((b, D)).astype(np.float32)
    xinf[5, 100], xinf[5, 200] = np.inf, -np.inf
    c["inf-mix"] = (xinf, 8)
    xdup = rng.integers(0, 4, size=(b, D)).astype(np.float32) * 100
    xdup[:, 5] = xdup[:, 999] = 1000.0
    c["dup-strict"] = (xdup, 8)
    xz = np.full((b, D), -1.0, np.float32)
    xz[:, 0], xz[:, 1] = -0.0, 0.0
    c["signed-zero"] = (xz, 8)
    xz2 = np.full((b, D), -1.0, np.float32)
    xz2[:, 100:103] = -0.0
    xz2[:, 200:210] = 0.0
    xz2[:, 50] = 7.0
    c["zeros+big"] = (xz2, 8)
    xd2 = np.zeros((b, D), np.float32)  # a NaN winner above a duplicated boundary
    xd2[3, 7] = np.nan
    xd2[3, 100] = xd2[3, 200] = 5.0
    c["nan-dup-boundary"] = (xd2, 2)
    xn = rng.standard_normal((b, D)).astype(np.float32)
    xn[3, 7] = np.nan
    xn[10, :] = np.nan
    c["nan-rows"] = (xn, 8)
    xall = rng.standard_normal((b, D)).astype(np.float32)
    xall[:, 0] = np.nan
    c["nan-all"] = (xall, 8)
    c["bank"] = (bank(16), 16)
    c["bank-bf16"] = (bank(8).astype(numpy_dtype("bfloat16")), 8)
    c["ties-lanes"] = (tie_bank(16), 16)
    c["ties-lanes-k8"] = (tie_bank(8, seed=8), 8)
    c["ties-lanes-bf16"] = (tie_bank(16, seed=9).astype(numpy_dtype("bfloat16")), 16)
    return c


RECOVERY = recovery_cases()


@pytest.mark.parametrize("name", list(RECOVERY))
def test_block_topk_matches_jax(name):
    """``batched_topk_plain`` and ``topk(method="block")`` (on the CPU,
    through the plain version) against ``lax.top_k`` and the JAX package's
    index recovery on ``lax.top_k``'s values: indices exactly, values as
    bits. The port has no recovery: its kernel returns the positions."""
    import jax
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.topk import _block_topk_indices as ref_indices

    x, k = RECOVERY[name]
    xj = jnp.asarray(x)
    rv, ri = jax.lax.top_k(xj, k)
    rv, ri, rec = np.asarray(rv), np.asarray(ri), np.asarray(ref_indices(xj, rv, k))
    np.testing.assert_array_equal(rec, ri)
    xt = tensor_from_numpy(x, "cpu")
    K.reset_counts()
    pv, pi = K.batched_topk_plain(xt, k)
    v, i = kt.topk(xt, k, method="block")
    assert K.PLAIN_CALLS["batched_topk"] == 1 and not any(K.LAUNCHES.values())
    for gv, gi in ((pv, pi), (v, i)):
        assert gi.dtype == torch.int64 and gv.dtype == xt.dtype
        np.testing.assert_array_equal(gi.numpy(), ri)
        np.testing.assert_array_equal(bits(tensor_to_numpy(gv)), bits(rv))
    np.testing.assert_array_equal(i.numpy(), batched_topk_oracle(x, k)[1])


# --- topk(method="block") --------------------------------------------------------


def test_topk_block_matches_jax_topk_block():
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.topk import topk as ref_topk

    x = bank(8)
    rv, ri = ref_topk(jnp.asarray(x), 8, method="block")
    K.reset_counts()
    v, i = kt.topk(tensor_from_numpy(x, "cpu"), 8, method="block")
    assert K.PLAIN_CALLS["batched_topk"] == 1
    assert i.dtype == torch.int64
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(bits(tensor_to_numpy(v)), bits(np.asarray(rv)))
    wv, wi = batched_topk_oracle(x, 8)
    np.testing.assert_array_equal(i.numpy(), wi)
    np.testing.assert_array_equal(bits(tensor_to_numpy(v)), bits(wv))


@pytest.mark.parametrize("dtype,k", [("float32", 1), ("float32", 9), ("float32", 16), ("bfloat16", 16)])
def test_batched_topk_block_matches_numpy(dtype, k):
    x = bank(k, rows=64, seed=k).astype(numpy_dtype(dtype))
    v, i = kt.batched_topk(tensor_from_numpy(x, "cpu"), k, method="block")
    wv, wi = batched_topk_oracle(x, k)
    np.testing.assert_array_equal(i.numpy(), wi)
    np.testing.assert_array_equal(bits(tensor_to_numpy(v)), bits(wv))


def test_topk_block_rejects():
    """Each refusal's whole message equals the JAX package's."""
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.topk import topk as ref_topk
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    x = np.zeros((64, D), np.float32)
    cases = [
        (x, 8, dict(largest=False)),
        (x.reshape(2, 32, D), 8, {}),
        (x, 17, {}),
        (x[:, :2048], 8, {}),
        (x.astype(np.float64), 8, {}),
    ]
    for a, k, kw in cases:
        with enable_x64(), pytest.raises(ValueError) as want:
            ref_topk(jnp.asarray(a), k, method="block", **kw)
        with pytest.raises(ValueError) as got:
            kt.topk(a, k, method="block", device="cpu", **kw)
        assert str(got.value) == str(want.value)


SUPPORTED = [
    ((4096, 32768), "float32", 8, True),
    ((4096, 32768), "float32", 9, True),
    ((4096, 32768), "float32", 16, True),
    ((4096, 32768), "bfloat16", 8, True),
    ((64, 4096), "float32", 1, True),
    ((4096, 32768), "float32", 17, False),
    ((4096, 32768), "float32", 0, False),
    ((4096, 32768), "float64", 8, False),
    ((4096, 32768), "float16", 8, False),
    ((4096, 32768), "int32", 8, False),
    ((100, 32768), "float32", 8, False),
    ((4096, 2048), "float32", 8, False),
    ((4096, 5000), "float32", 8, False),
    ((4096,), "float32", 8, False),
    ((2, 64, 4096), "float32", 8, False),
]


@pytest.mark.parametrize("shape,dtype,k,want", SUPPORTED)
def test_batched_topk_supported_truth_table(shape, dtype, k, want):
    from mpi_k_selection_tpu.ops.pallas.topk import batched_topk_supported as ref_supported

    assert K.batched_topk_supported(shape, numpy_dtype(dtype), k) is want
    assert K.batched_topk_supported(shape, getattr(torch, dtype), k) is want
    assert ref_supported(shape, numpy_dtype(dtype), k) is want


def test_auto_resolves_to_block_only_on_cuda():
    shape = (4096, 32768)
    assert T.resolve_topk_method("auto", shape, 8, torch.float32, "cuda") == "block"
    assert T.resolve_topk_method("auto", shape, 16, torch.bfloat16, torch.device("cuda", 0)) == "block"
    assert T.resolve_topk_method("auto", shape, 8, torch.float32, "cpu") == "flat"
    assert T.resolve_topk_method("auto", shape, 8, torch.float32, "cuda", largest=False) == "flat"
    assert T.resolve_topk_method("auto", shape, 17, torch.float32, "cuda") == "flat"
    assert T.resolve_topk_method("auto", shape, 8, torch.float64, "cuda") == "flat"
    assert T.resolve_topk_method("auto", (64, 1 << 16), 8, torch.float32, "cuda") == "block"
    assert T.resolve_topk_method("auto", (64, 1 << 16), 8, torch.float32, "cpu") == "chunked"
    assert T.resolve_topk_method("auto", (64, 4096), 8, torch.float32, "cuda") == "block"
    assert T.resolve_topk_method("auto", (64, 4096), 8, torch.float32, "cpu") == "flat"
    assert T.resolve_topk_method("auto", (1 << 20,), 8, torch.float32, "cuda") == "threshold"
    assert T.resolve_topk_method("flat", shape, 8, torch.float32, "cuda") == "flat"
    # on the CPU, auto keeps the non-block rule and agrees with NumPy
    x = bank(8, rows=64)
    K.reset_counts()
    v, i = kt.topk(tensor_from_numpy(x, "cpu"), 8)
    assert not any(K.PLAIN_CALLS.values())
    wv, wi = batched_topk_oracle(x, 8)
    np.testing.assert_array_equal(i.numpy(), wi)
    np.testing.assert_array_equal(bits(tensor_to_numpy(v)), bits(wv))


# --- batched_kselect / batched_median ------------------------------------------


def specials(shape, dtype, seed=0):
    """Heavy ties, +-0.0, +-inf and NaNs of both signs (floats), or a few
    repeated values (integers)."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    if dtype.kind == "f" or dtype == numpy_dtype("bfloat16"):
        pool = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 2.5], np.float32)
        x = rng.choice(pool, size=shape).astype(dtype)
        x[rng.random(shape) < 1 / 16] = neg_nan(dtype)
        return x
    return rng.integers(0, 5, size=shape).astype(dtype)


def random_rows(shape, name, seed=1):
    dtype = numpy_dtype(name)
    if name == "uint64":
        return datagen.generate(shape[1], pattern="seqlike", seed=seed, dtype=np.int64, batch=shape[:1]).view(np.uint64)
    if name == "bfloat16":
        return datagen.generate(shape[1], pattern="normal", seed=seed, dtype=np.float32, batch=shape[:1]).astype(dtype)
    pattern = "normal" if dtype.kind == "f" else "seqlike"
    return datagen.generate(shape[1], pattern=pattern, seed=seed, dtype=dtype, batch=shape[:1])


@pytest.mark.parametrize("name", DTYPES)
def test_batched_kselect_matches_jax(name):
    import jax.numpy as jnp

    from mpi_k_selection_tpu import api as ref_api
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    d = 257
    per_row = np.array([1, 5, 100, 128, 200, 257, 0, 300])  # the last two are clamped
    with enable_x64():
        for x in (specials((8, d), numpy_dtype(name)), random_rows((8, d), name)):
            xt = tensor_from_numpy(x, "cpu")
            for k in (1, 128, d, per_row, per_row.reshape(2, 4)):
                xs = x.reshape(2, 4, d) if np.ndim(k) == 2 else x
                want = np.asarray(ref_api.batched_kselect(jnp.asarray(xs), k))
                got = tensor_to_numpy(kt.batched_kselect(xt.reshape(xs.shape), k))
                assert got.shape == want.shape
                assert got.tobytes() == want.tobytes(), (name, k)
            want = np.asarray(ref_api.batched_median(jnp.asarray(x)))
            assert tensor_to_numpy(kt.batched_median(xt)).tobytes() == want.tobytes()
            ks = torch.tensor(per_row[:8] % d + 1)  # a tensor k: per row, no host check
            want = np.asarray(ref_api.batched_kselect(jnp.asarray(x), per_row[:8] % d + 1))
            assert tensor_to_numpy(kt.batched_kselect(xt, ks)).tobytes() == want.tobytes()


def test_batched_kselect_order_is_jnp_sort():
    """``jnp.sort``'s order, which ``batched_kselect`` follows, holds
    ``-0.0`` and ``+0.0`` equal and every NaN equal and above ``+inf``, in
    position order: not the sortable keys' total order of ``kselect`` and
    ``topk`` (``-nan`` below ``-inf``, ``-0.0 < +0.0``)."""
    import jax.numpy as jnp

    from mpi_k_selection_tpu import api as ref_api

    x = np.array([[1, np.nan, -0.0, 0.0, np.nan, -np.inf, 0.0, 2],
                  [0.0, np.nan, -0.0, np.nan, 3.0, -0.0, 0.0, -1]], np.float32)
    x[0, 1] = x[1, 3] = neg_nan()
    want_bits = [
        [0xFF800000, 0x80000000, 0, 0, 0x3F800000, 0x40000000, 0xFFC00000, 0x7FC00000],
        [0xBF800000, 0, 0x80000000, 0x80000000, 0, 0x40400000, 0x7FC00000, 0xFFC00000],
    ]
    for dtype in ("float32", "bfloat16"):
        xd = x.astype(numpy_dtype(dtype))
        shift = 16 if dtype == "bfloat16" else 0
        for k in range(1, 9):
            got = bits(tensor_to_numpy(kt.batched_kselect(xd, k, device="cpu"))).tolist()
            assert got == [w[k - 1] >> shift for w in want_bits], (dtype, k)
            assert got == bits(np.asarray(ref_api.batched_kselect(jnp.asarray(xd), k))).tolist()


def test_reference_kselect_order_depends_on_its_path():
    """Found while porting (ROADMAP Queue 3): the JAX package's ``kselect``
    answers in ``lax.sort``'s order at n <= 2^14 (its sort path: +-0.0
    equal, every NaN last) and in the sortable keys' order above it (its
    radix path). The port's ``kselect`` follows it path for path;
    ``batched_kselect`` follows ``jnp.sort`` as the reference's does."""
    import jax.numpy as jnp

    from mpi_k_selection_tpu import api as ref_api

    x = np.array([1, np.nan, -0.0, 0.0, np.nan, -np.inf, 0.0, 2], np.float32)
    x[1] = neg_nan()
    ninf, nnan = bits(np.float32(-np.inf)).item(), bits(neg_nan()).item()

    def first(v):
        return int(bits(np.asarray(v).reshape(1))[0])

    assert first(ref_api.kselect(jnp.asarray(x), 1)) == ninf  # sort path
    assert first(tensor_to_numpy(kt.kselect(x, 1, device="cpu"))) == ninf
    assert first(tensor_to_numpy(kt.batched_kselect(x[None], 1, device="cpu"))) == ninf
    big = np.concatenate([x, np.random.default_rng(0).standard_normal((1 << 14) + 8).astype(np.float32)])
    assert first(ref_api.kselect(jnp.asarray(big), 1)) == nnan  # radix path
    assert first(tensor_to_numpy(kt.kselect(big, 1, device="cpu"))) == nnan


def test_batched_kselect_rejects_and_clamps():
    x = np.arange(20, dtype=np.int32).reshape(4, 5)
    with pytest.raises(ValueError, match="use kselect for 1-D"):
        kt.batched_kselect(x[0], 1, device="cpu")
    for k in (0, 6):
        with pytest.raises(ValueError, match="out of range"):
            kt.batched_kselect(x, k, device="cpu")
    got = kt.batched_kselect(x, np.array([0, 1, 5, 9]), device="cpu")
    assert got.tolist() == [0, 5, 14, 19]
    assert kt.batched_median(x, device="cpu").tolist() == [1, 6, 11, 16]
    assert cuda_backend.batched_kselect(x, np.array([0, 1, 5, 9]), device="cpu").tolist() == [0, 5, 14, 19]
    assert cuda_backend.batched_median(x, device="cpu").tolist() == [1, 6, 11, 16]


# --- the CLI ------------------------------------------------------------------


@pytest.mark.parametrize("method,dtype", [("block", "float32"), ("block", "bfloat16"), ("auto", "float32")])
def test_cli_batched_topk_on_cpu(method, dtype):
    out = subprocess.run(
        [sys.executable, "-m", "mpi_k_selection_tpu_torch", "--n", "4096", "--batch", "64", "--dtype", dtype,
         "--gen", "normal", "--seed", "6", "--topk", "8", "--topk-method", method,
         "--device", "cpu", "--verify", "--json"],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["extra"]["exact_match"] is True and rec["extra"]["batch"] == 64
    assert rec["n"] == 64 * 4096
    x = datagen.generate(4096, pattern="normal", seed=6, dtype=numpy_dtype(dtype), batch=(64,))
    want, _ = batched_topk_oracle(x, 8)
    assert np.array(rec["answer"], np.float32).tobytes() == want[0].astype(np.float32).tobytes()


def test_cli_batch_needs_topk():
    out = subprocess.run(
        [sys.executable, "-m", "mpi_k_selection_tpu_torch", "--n", "4096", "--batch", "4", "--device", "cpu"],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and "--batch only applies to --topk" in out.stderr


# --- on the card ------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,k", [("float32", 1), ("float32", 8), ("float32", 9), ("float32", 16),
                                     ("bfloat16", 8), ("bfloat16", 16)])
def test_block_kernel_matches_plain_on_card(cuda_device, dtype, k):
    """The kernel's pair launch and its values-only launch against the
    plain version: values as bits, positions exactly."""
    bits_ = 16 if dtype == "bfloat16" else 32
    iv = torch.int16 if dtype == "bfloat16" else torch.int32
    for x in (bank(k), np.random.default_rng(k).standard_normal((1024, 8192)).astype(np.float32), tie_bank(k)):
        xd = tensor_from_numpy(x.astype(numpy_dtype(dtype)), cuda_device)
        want_v, want_i = K.batched_topk_plain(xd, k)
        K.reset_counts()
        v, i = K.batched_topk(xd, k)
        vo = K.batched_topk_values(xd, k)
        assert {n: c for n, c in K.LAUNCHES.items() if c} == {f"batched_topk{bits_}": 1, f"batched_topk_values{bits_}": 1}
        assert i.dtype == torch.int64 and torch.equal(i, want_i)
        assert torch.equal(v.view(iv), want_v.view(iv)) and torch.equal(vo.view(iv), want_v.view(iv))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,k", [("float32", 8), ("float32", 16), ("bfloat16", 8)])
def test_block_topk_on_card_matches_numpy(cuda_device, dtype, k):
    x = bank(k).astype(numpy_dtype(dtype))
    K.reset_counts()
    v, i = kt.batched_topk(tensor_from_numpy(x, cuda_device), k)  # auto: block
    assert {n: c for n, c in K.LAUNCHES.items() if c} == {f"batched_topk{16 if dtype == 'bfloat16' else 32}": 1}
    assert not any(K.PLAIN_CALLS.values())
    wv, wi = batched_topk_oracle(x, k)
    np.testing.assert_array_equal(i.cpu().numpy(), wi)
    np.testing.assert_array_equal(bits(tensor_to_numpy(v)), bits(wv))


@pytest.mark.gpu
@pytest.mark.parametrize("name", DTYPES)
def test_batched_kselect_on_card_matches_cpu(cuda_device, name):
    for x in (specials((16, 1000), numpy_dtype(name)), random_rows((16, 1000), name)):
        for k in (1, 500, 1000, np.arange(1, 17) * 60):
            got = tensor_to_numpy(kt.batched_kselect(tensor_from_numpy(x, cuda_device), k))
            want = tensor_to_numpy(kt.batched_kselect(x, k, device="cpu"))
            assert got.tobytes() == want.tobytes(), (name, k)
