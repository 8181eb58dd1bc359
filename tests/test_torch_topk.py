"""The port's top-k and its tau-count kernel against the JAX package and
NumPy.

Indices are compared exactly and values as bit patterns: no tolerance.
The order is the sortable keys' total order with ties by ascending
position, which ``lax.top_k`` and the JAX package's threshold path share;
the fixtures hold heavy ties, both signed zeros and both NaN signs. The
JAX package's ``pallas_tau_counts`` runs in interpret mode. The ``gpu``
tests hold the kernel against its plain version on the card:

    python -m pytest --noconftest tests/test_torch_*.py -m gpu
"""

import importlib
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import mpi_k_selection_tpu_torch as kt
from mpi_k_selection_tpu_torch.cli import topk_oracle
from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
from mpi_k_selection_tpu_torch.ops.radix import _Descent
from mpi_k_selection_tpu_torch.utils import datagen
from mpi_k_selection_tpu_torch.utils import dtypes as dt
from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype, tensor_from_numpy, tensor_to_numpy

# the module (the package ``ops`` exports its function ``topk`` under the same name)
T = importlib.import_module("mpi_k_selection_tpu_torch.ops.topk")

# one intra-op thread: in a parallel test run each worker's torch thread pool
# oversubscribes the cores, and small CPU ops stall on its barriers
torch.set_num_threads(1)

METHODS = ("threshold", "tournament", "chunked", "flat")
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


def numpy_topk(x, k, largest):
    """The oracle by full sorts: ``np.lexsort((arange, ~keys))`` for the
    largest, a stable ``argsort(keys)`` for the smallest."""
    keys = dt.np_to_sortable_bits(x)
    if largest:
        idx = np.lexsort((np.arange(x.size), ~keys))[:k]
    else:
        idx = np.argsort(keys, kind="stable")[:k]
    return x[idx], idx


def specials(n, dtype, seed=0):
    """Heavy ties, +-0.0, +-inf and NaNs of both signs (floats), or a few
    repeated values (integers)."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    if dtype.kind == "f" or dtype == numpy_dtype("bfloat16"):
        pool = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 2.5], np.float32)
        x = rng.choice(pool, size=n).astype(dtype)
        neg_nan = np.copysign(np.array(np.nan, np.float32), -1.0).astype(dtype)
        x[rng.integers(0, n, size=n // 16)] = neg_nan
        return x
    return rng.integers(0, 5, size=n).astype(dtype)


def random_words(n, dtype, seed=2):
    """Every bit pattern for integers; normal values with the specials
    mixed in for floats."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        x = rng.standard_normal(n).astype(dtype)
        s = specials(n, dtype, seed)
        return np.where(rng.random(n) < 0.1, s, x)
    return rng.integers(0, 1 << 63, size=n, dtype=np.int64).astype(dtype)


def cases(name, n):
    dtype = numpy_dtype(name)
    if name == "uint64":
        rand = datagen.generate(n, pattern="seqlike", seed=1, dtype=np.int64).view(np.uint64)
    elif name == "bfloat16":
        rand = datagen.generate(n, pattern="normal", seed=1, dtype=np.float32).astype(dtype)
    else:
        rand = datagen.generate(n, pattern="normal" if dtype.kind == "f" else "seqlike", seed=1, dtype=dtype)
    return [("random", rand), ("ties", specials(n, dtype))]


def check(got, want):
    (gv, gi), (wv, wi) = got, want
    np.testing.assert_array_equal(gi.cpu().numpy(), wi)
    assert tensor_to_numpy(gv).tobytes() == np.ascontiguousarray(wv).tobytes()


def test_nan_signs_and_ties_order_like_lax_top_k():
    import jax
    import jax.numpy as jnp

    x = np.array([0.0, -0.0, np.nan, 1.0, np.inf, -np.nan, 0.0, 1.0], np.float32)
    x[5] = np.copysign(np.nan, -1.0)
    _, ref = jax.lax.top_k(jnp.asarray(x), 8)
    assert np.asarray(ref).tolist() == [2, 4, 3, 7, 0, 6, 1, 5]
    for m in METHODS:
        v, i = kt.topk(x, 8, method=m, device="cpu")
        assert i.tolist() == [2, 4, 3, 7, 0, 6, 1, 5], m
        assert tensor_to_numpy(v).tobytes() == x[[2, 4, 3, 7, 0, 6, 1, 5]].tobytes()


# --- tau counts against the Pallas kernel (interpret mode) and NumPy --------


def _numpy_tau(x, tau, largest):
    keys = dt.np_to_sortable_bits(x).astype(np.uint64)
    rows = -(-x.size // 128)
    up = np.zeros(rows * 128, np.uint64)
    up[: x.size] = keys
    valid = np.arange(rows * 128) < x.size
    beyond = (up > np.uint64(tau)) if largest else (up < np.uint64(tau))
    return np.stack([(beyond & valid).reshape(rows, 128).sum(1), ((up == np.uint64(tau)) & valid).reshape(rows, 128).sum(1)])


def _port_tau(x, tau, largest, device="cpu"):
    bits = x.dtype.itemsize * 8
    fold = dt.key_fold(x.dtype)
    t = torch.tensor([dt.signed_const(tau, bits)], dtype=torch.int32 if bits == 32 else torch.int64, device=device)
    c = H.tau_counts(
        tensor_from_numpy(x, device), tau=t, largest=largest,
        key_op=fold[0], key_xor=fold[1] if fold[0] == "xor" else 0,
    )
    return c.cpu().numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_tau_counts_match_pallas(dtype):
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.pallas.histogram import pallas_tau_counts

    R = 128
    n = 128 * R - 37  # ragged: the last row is partly past n
    x = random_words(n, dtype, seed=3)
    key_op, key_xor = ("float", 0) if dtype == np.float32 else ("xor", 0x80000000)
    tiles = jnp.asarray(np.pad(x.view(np.uint32), (0, R * 128 - n)).reshape(R, 128).view(np.int32))
    keys = dt.np_to_sortable_bits(x)
    for tau in (int(keys[n // 3]), int(np.sort(keys)[n // 2]) ^ 1):  # from the data, and maybe absent
        for largest in (True, False):
            cgt, ceq = pallas_tau_counts(
                tau_key=jnp.asarray(np.uint32(tau)), tiles=tiles, orig_n=n, key_op=key_op,
                key_xor=key_xor, largest=largest, block_rows=128, interpret=True,
            )
            got = _port_tau(x, tau, largest)
            np.testing.assert_array_equal(got, np.stack([np.asarray(cgt), np.asarray(ceq)]))
            np.testing.assert_array_equal(got, _numpy_tau(x, tau, largest))


@pytest.mark.parametrize("dtype", [np.int64, np.uint64, np.float64, np.uint32])
def test_tau_counts_match_numpy(dtype):
    x = random_words(5000, dtype)
    keys = np.sort(dt.np_to_sortable_bits(x))
    for tau in (int(keys[0]), int(keys[2500]), int(keys[-1]), (1 << (x.itemsize * 8)) - 1, 0):
        for largest in (True, False):
            np.testing.assert_array_equal(_port_tau(x, tau, largest), _numpy_tau(x, tau, largest))


def test_tau_counts_wrapper_checks():
    w = torch.zeros(300, dtype=torch.int32)
    with pytest.raises(ValueError, match="tau"):
        H.tau_counts(w, tau=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="tau"):
        H.tau_counts(w, tau=torch.zeros(1, dtype=torch.int64))
    H.reset_counts()
    assert H.tau_counts(w, tau=torch.zeros(1, dtype=torch.int32)).tolist() == [[0, 0, 0], [128, 128, 44]]
    assert H.PLAIN_CALLS["tau_counts"] == 1 and not any(H.LAUNCHES.values())


# --- topk against NumPy, every dtype ------------------------------------------


@pytest.mark.parametrize("name", DTYPES)
def test_topk_matches_numpy(name):
    n, k = 30_000, 40
    for label, x in cases(name, n):
        for largest in (True, False):
            want = numpy_topk(x, k, largest)
            assert np.array_equal(topk_oracle(x, k, largest)[1], want[1])
            xd = tensor_from_numpy(x, "cpu")
            for m in METHODS:
                check(kt.topk(xd, k, largest=largest, method=m), want)


def test_topk_auto_dispatch_and_batched():
    assert T.resolve_topk_method("auto", (1 << 18,), 128) == "threshold"
    assert T.resolve_topk_method("auto", (1 << 17,), 128) == "chunked"
    assert T.resolve_topk_method("auto", (8, 1 << 16), 128) == "chunked"
    assert T.resolve_topk_method("auto", (1000,), 8) == "flat"
    assert T.resolve_topk_method("tournament", (10,), 8) == "tournament"
    with pytest.raises(ValueError, match="unknown topk method"):
        T.resolve_topk_method("heap", (10,), 1)
    x = specials(1 << 18, np.float32, seed=9)
    H.reset_counts()
    check(kt.topk(x, 128, device="cpu"), numpy_topk(x, 128, True))  # threshold
    assert H.PLAIN_CALLS["tau_counts"] == 1
    xb = np.stack([specials(4096, np.float32, seed=s) for s in range(3)])
    v, i = kt.batched_topk(xb, 8, method="chunked", num_chunks=4, device="cpu")
    for r in range(3):
        check((v[r], i[r]), numpy_topk(xb[r], 8, True))


@pytest.mark.parametrize("smallest", [False, True])
def test_cli_topk_mode_on_cpu(smallest):
    out = subprocess.run(
        [sys.executable, "-m", "mpi_k_selection_tpu_torch", "--n", "40000", "--dtype", "float32",
         "--gen", "normal", "--seed", "4", "--topk", "16", "--topk-method", "threshold",
         "--device", "cpu", "--verify", "--json"] + (["--smallest"] if smallest else []),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["extra"]["exact_match"] is True
    x = datagen.generate(40000, pattern="normal", seed=4, dtype=np.float32)
    want, _ = numpy_topk(x, 16, not smallest)
    assert np.array(rec["answer"], np.float32).tobytes() == want[:8].tobytes()


def test_topk_rejects():
    x = np.arange(100, dtype=np.float32)
    with pytest.raises(ValueError, match="out of range"):
        kt.topk(x, 0, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        kt.topk(x, 101, device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        kt.topk(x.reshape(10, 10), 3, method="threshold", device="cpu")
    with pytest.raises(ValueError, match="unsupported batched-topk shape"):
        kt.topk(x.reshape(10, 10), 3, method="block", device="cpu")


# --- against the JAX package's topk ------------------------------------------


@pytest.mark.parametrize("name", ["float32", "int32", "bfloat16", "float64"])
def test_topk_matches_reference_topk(name):
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.topk import topk as ref_topk
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    n, k = 1 << 16, 32
    with enable_x64():
        for label, x in cases(name, n):
            xj = jnp.asarray(x)
            for largest in (True, False):
                for m in METHODS:
                    rv, ri = ref_topk(xj, k, largest=largest, method=m)
                    got = kt.topk(tensor_from_numpy(x, "cpu"), k, largest=largest, method=m)
                    check(got, (np.asarray(rv), np.asarray(ri)))
                    check(got, numpy_topk(x, k, largest))


def test_threshold_collect_matches_reference_via_counts():
    """The winner collect on a prepared descent, fed the same tau: the JAX
    package's forced-Pallas ``_threshold_indices_via_counts`` (interpret
    mode) and the port's, as ``test_pallas_topk.py`` builds it."""
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.radix import _Descent as RefDescent
    from mpi_k_selection_tpu.ops.topk import _threshold_indices_via_counts as ref_collect

    n, k = 1 << 14, 32
    rng = np.random.default_rng(11)
    for label, x in (("random", rng.standard_normal(n).astype(np.float32)), ("ties", specials(n, np.float32))):
        ref_prep = RefDescent(jnp.asarray(x), None, "pallas", 32768, block_rows=128)
        prep = _Descent(tensor_from_numpy(x, "cpu"))
        keys = np.sort(dt.np_to_sortable_bits(x))
        for largest, tau in ((True, keys[n - k]), (False, keys[k - 1])):
            want = np.asarray(ref_collect(ref_prep, jnp.asarray(tau), k, largest))
            got = T._threshold_indices_via_counts(
                prep, torch.tensor([dt.signed_const(int(tau), 32)], dtype=torch.int32), k, largest
            )
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{label} {largest}")
            np.testing.assert_array_equal(got.numpy(), numpy_topk(x, k, largest)[1])


# --- on the card ----------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32, np.int64, np.uint64, np.float64])
def test_tau_counts_kernel_matches_plain_on_card(cuda_device, dtype):
    n = (1 << 22) + 77
    x = random_words(n, dtype)
    words = tensor_from_numpy(x, cuda_device)
    bits = x.itemsize * 8
    fold = dt.key_fold(x.dtype)
    keys = dt.np_to_sortable_bits(x)
    for tau in (int(keys[n // 3]), int(np.sort(keys)[n // 2]) ^ 1, 0, (1 << bits) - 1):
        t = torch.tensor([dt.signed_const(tau, bits)], dtype=torch.int32 if bits == 32 else torch.int64, device=cuda_device)
        for largest in (True, False):
            kw = dict(tau=t, largest=largest, key_op=fold[0], key_xor=fold[1] if fold[0] == "xor" else 0)
            assert torch.equal(H.tau_counts(words, **kw), H.tau_counts_plain(words, **kw)), (tau, largest)


@pytest.mark.gpu
@pytest.mark.parametrize("name", DTYPES)
def test_topk_on_card_matches_numpy(cuda_device, name):
    n, k = 1 << 20, 128
    H.reset_counts()
    for label, x in cases(name, n):
        xd = tensor_from_numpy(x, cuda_device)
        for largest in (True, False):
            want = topk_oracle(x, k, largest)
            for m in METHODS:
                check(kt.topk(xd, k, largest=largest, method=m), want)
    assert not any(H.PLAIN_CALLS.values())
    assert H.LAUNCHES[f"tau_counts{max(32, dt.key_bits(name))}"] > 0
