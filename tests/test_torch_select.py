"""The port's kselect / median against the JAX package's radix_select and
against NumPy, bit for bit, for all 12 dtypes.

Selected elements are compared as bit patterns (no tolerance), so -0.0 and
+0.0 differ and the NaN order is checked. The NumPy oracle sorts the
order-preserving keys (utils/dtypes.py), the order both packages define.
The reference runs its Pallas kernels in interpret mode with a forced
cutover, so its collect (``pallas_match_counts``) runs at this small size.
The JAX package is imported inside the tests that use it, so the ``gpu``
tests also collect where only PyTorch is installed:

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
from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
from mpi_k_selection_tpu_torch.ops.histogram import resolve_hist_method
from mpi_k_selection_tpu_torch.ops.radix import cutover_passes, resolve_cutover
from mpi_k_selection_tpu_torch.utils import datagen
from mpi_k_selection_tpu_torch.utils import dtypes as dt
from mpi_k_selection_tpu_torch.utils.debug import rank_certificate
from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype, tensor_from_numpy, tensor_to_numpy

# one intra-op thread: in a parallel test run each worker's torch thread pool
# oversubscribes the cores, and small CPU ops stall on its barriers
torch.set_num_threads(1)

DTYPES = (
    "int8", "uint8", "int16", "uint16", "int32", "uint32",
    "int64", "uint64", "float16", "bfloat16", "float32", "float64",
)
N = 40_000
KS = (1, 250, N // 2, N)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs a CUDA device; on the card: "
            "python -m pytest --noconftest tests/test_torch_*.py -m gpu"
        )
    return torch.device("cuda")


def fixtures(name, n=N):
    """``adversarial_fixtures`` in ``name``'s dtype. The generator cannot
    make uint64 (its clip overflows) or bfloat16 (no finfo), in either
    package; those come from the int64 fixtures' bits and from the float32
    fixtures rounded to bfloat16."""
    if name == "uint64":
        return [(p, x.view(np.uint64)) for p, x in datagen.adversarial_fixtures(n, dtype=np.int64)]
    if name == "bfloat16":
        bf = numpy_dtype("bfloat16")
        return [(p, x.astype(bf)) for p, x in datagen.adversarial_fixtures(n, dtype=np.float32)]
    return datagen.adversarial_fixtures(n, dtype=np.dtype(name))


def key_oracle(x, k):
    """The k-th smallest of ``x`` in key order, as a 1-element array."""
    keys = np.sort(dt.np_to_sortable_bits(x))
    return dt.np_from_sortable_bits(keys[k - 1 : k], x.dtype)


def sort_oracle(x, k):
    """The k-th smallest of ``x`` in ``lax.sort``'s order, the sort path's
    (NumPy's stable sort: -0.0 == +0.0, every NaN last, ties by position),
    as a 1-element array of the element's own bits."""
    v = x.astype(np.float32) if x.dtype.itemsize == 2 and x.dtype.kind not in "iu" else x
    return x[np.argsort(v, kind="stable")[k - 1 : k]]


def bits_of(t):
    return tensor_to_numpy(t.reshape(1)).tobytes()


def forced_cutover(name):
    """A cutover every dtype accepts: 3 passes, or one below the pass count
    of an 8-bit key (which has only 2)."""
    return min(3, dt.key_bits(name) // 4 - 1)


@pytest.mark.parametrize("name", DTYPES)
def test_kselect_matches_numpy(name):
    co = forced_cutover(name)
    for pattern, x in fixtures(name):
        xd = tensor_from_numpy(x, "cpu")
        for k in KS:
            want = key_oracle(x, k).tobytes()
            for kw in (
                {},  # auto: the full schedule at this n
                {"cutover": co, "cutover_budget": 1024},
                {"cutover": co, "cutover_budget": 64},
            ):
                got = kt.kselect(xd, k, algorithm="radix", **kw)
                assert bits_of(got) == want, (pattern, k, kw)
            assert bits_of(kt.kselect(xd, k, algorithm="sort")) == sort_oracle(x, k).tobytes(), (pattern, k)
        assert bits_of(kt.median(x, device="cpu")) == key_oracle(x, N // 2).tobytes()


@pytest.mark.parametrize("name", DTYPES)
def test_kselect_matches_reference_radix_select(name):
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.radix import radix_select as ref_select
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    method = "pallas64" if dt.key_bits(name) == 64 else "pallas"
    kw = {"cutover": forced_cutover(name), "cutover_budget": 1024}
    with enable_x64():
        for pattern, x in fixtures(name):
            xj = jnp.asarray(x)
            xd = tensor_from_numpy(x, "cpu")
            for k in KS:
                ref = np.asarray(ref_select(xj, k, hist_method=method, block_rows=128, **kw))
                got = kt.kselect(xd, k, algorithm="radix", **kw)
                assert bits_of(got) == ref.reshape(1).tobytes(), (pattern, k)


def _counted_select(x, k, **kw):
    H.reset_counts()
    got = kt.kselect(tensor_from_numpy(x, "cpu"), k, algorithm="radix", **kw)
    return got, dict(H.PLAIN_CALLS)


@pytest.mark.parametrize(
    "name,cutover,budget2,ks2",
    [("int32", 3, 64, (1, N // 2, N)), ("float64", 5, 32, (N // 2, N))],
)
def test_cutover_ladder_rungs_match_reference(name, cutover, budget2, ks2):
    """Rung 1 (the collect after ``cutover`` passes), rung 2 (one more
    pass, then the collect; ``budget2`` overflows rung 1 for the ranks
    ``ks2``) and the full-schedule fallback (``equal`` overflows every
    budget), each proven by the passes and collects it ran, each equal to
    the reference and to NumPy."""
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.radix import radix_select as ref_select
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    method = "pallas64" if dt.key_bits(name) == 64 else "pallas"
    npasses = dt.key_bits(name) // 4
    uniform = datagen.generate(N, pattern="uniform", seed=3, dtype=np.dtype(name))
    equal = datagen.generate(N, pattern="equal", seed=3, dtype=np.dtype(name))
    cases = (
        (uniform, 1024, (1, N // 2, N), {"radix_histogram": cutover, "match_counts": 1}),
        (uniform, budget2, ks2, {"radix_histogram": cutover + 1, "match_counts": 1}),
        (equal, 1024, (1, N // 2, N), {"radix_histogram": npasses, "match_counts": 0}),
    )
    unused = {"radix_histogram_multi": 0, "tau_counts": 0}
    with enable_x64():
        for x, budget, ks, calls in cases:
            for k in ks:
                got, ran = _counted_select(x, k, cutover=cutover, cutover_budget=budget)
                assert ran == {**calls, **unused}, (budget, k, ran)
                ref = np.asarray(ref_select(
                    jnp.asarray(x), k, hist_method=method, block_rows=128,
                    cutover=cutover, cutover_budget=budget,
                ))
                assert bits_of(got) == ref.reshape(1).tobytes() == key_oracle(x, k).tobytes()
    assert all(v == 0 for v in H.LAUNCHES.values())  # no kernel on the CPU


def test_small_n_order_follows_the_reference_path():
    """ROADMAP Queue 3, fixed: ``kselect`` and ``kselect_many`` answer as
    the JAX package's do, path for path and bit for bit: in ``lax.sort``'s
    order at n <= 2^14 and on the many-ranks sort leg, in the keys' order
    on the radix paths just above 2^14."""
    import jax.numpy as jnp

    from mpi_k_selection_tpu import api as ref_api
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    nan8 = np.array([1, np.nan, -0.0, 0.0, np.nan, -np.inf, 0.0, 2], np.float32)
    nan8.view(np.uint32)[1] |= 0x80000000  # -nan
    ks8 = list(range(1, 9))
    ref = np.asarray(ref_api.kselect_many(jnp.asarray(nan8), ks8))
    assert tensor_to_numpy(kt.kselect_many(nan8, ks8, device="cpu")).tobytes() == ref.tobytes()
    for k in ks8:
        want = np.asarray(ref_api.kselect(jnp.asarray(nan8), k)).reshape(1)
        assert bits_of(kt.kselect(nan8, k, device="cpu")) == want.tobytes() == sort_oracle(nan8, k).tobytes()
    with enable_x64():
        for name in ("float32", "float16", "float64", "int32"):
            for n in (1 << 14, (1 << 14) + 8):
                ks = [1, 250, n // 2, n]
                many = np.linspace(1, n, 64).astype(np.int64)  # the sort leg at both sizes
                for pattern, x in fixtures(name, n):
                    if name == "float32":
                        x = np.concatenate([nan8, x[8:]])
                    ref = np.asarray(ref_api.kselect_many(jnp.asarray(x), ks))
                    got = kt.kselect_many(x, ks, device="cpu")
                    assert tensor_to_numpy(got).tobytes() == ref.tobytes(), (name, n, pattern)
                    for k, want in zip(ks, ref):
                        got = kt.kselect(x, k, device="cpu")
                        assert bits_of(got) == want.tobytes(), (name, n, pattern, k)
                    ref = np.asarray(ref_api.kselect_many(jnp.asarray(x), many))
                    got = kt.kselect_many(x, many, device="cpu")
                    assert tensor_to_numpy(got).tobytes() == ref.tobytes(), (name, n, pattern)


def test_out_of_range_k_raises_in_both_packages():
    from mpi_k_selection_tpu import api as ref_api

    x = datagen.generate(100, seed=1)
    for k in (0, 101, -3):
        with pytest.raises(ValueError, match="out of range"):
            kt.kselect(x, k, device="cpu")
        with pytest.raises(ValueError, match="out of range"):
            ref_api.kselect(x, k)
    with pytest.raises(ValueError, match="non-empty"):
        kt.kselect(np.zeros(0, np.int32), 1, device="cpu")
    with pytest.raises(ValueError, match="algorithm"):
        kt.kselect(x, 1, algorithm="bogus", device="cpu")
    with pytest.raises(ValueError, match="cutover"):
        kt.kselect(x, 1, algorithm="radix", device="cpu", cutover=8)


def test_tensor_k_is_clamped_like_a_traced_k():
    x = tensor_from_numpy(datagen.generate(5000, seed=2), "cpu")
    lo, hi = key_oracle(tensor_to_numpy(x), 1), key_oracle(tensor_to_numpy(x), 5000)
    assert bits_of(kt.kselect(x, torch.tensor(0), algorithm="radix")) == lo.tobytes()
    assert bits_of(kt.kselect(x, torch.tensor(10**6), algorithm="radix")) == hi.tobytes()


def test_cutover_schedule_matches_reference():
    from mpi_k_selection_tpu.ops import radix as ref_radix

    for n in (1 << 19, 1 << 20, 1 << 24, 1 << 27, 1 << 30, 3 * 10**9):
        for bits in (8, 16, 32, 64):
            for budget in (64, 1024, 8192):
                want = ref_radix.cutover_passes(n, bits, 4, budget)
                assert cutover_passes(n, bits, 4, budget) == want
                assert resolve_cutover("auto", n, bits, 4, budget) == want
    assert cutover_passes(1 << 30, 32, 4, 8192) == 6  # the 2^30 int32 median


def test_rank_certificate_brackets_the_answer():
    x = datagen.generate(N, pattern="seqlike", seed=5)
    xd = tensor_from_numpy(x, "cpu")
    for k in KS:
        less, leq = rank_certificate(xd, kt.kselect(xd, k))
        assert int(less) < k <= int(leq)


def test_cuda_backend_plan():
    assert cuda_backend.plan(1 << 14) == ("sort", False)
    assert cuda_backend.plan((1 << 14) + 1) == ("radix", False)
    assert cuda_backend.plan(10, "radix") == ("radix", False)
    with pytest.raises(ValueError, match="algorithm"):
        cuda_backend.plan(1 << 20, "bogus")
    # cgm is distributed only: with no process group it plans a mesh that
    # the distributed entry refuses, as the JAX package's does on one device
    assert cuda_backend.plan(1 << 20, "cgm") == ("cgm", True)
    with pytest.raises(ValueError, match="needs >= 2 devices"):
        cuda_backend.kselect(np.arange(1 << 10, dtype=np.int32), 5, algorithm="cgm", device="cpu")
    x = datagen.generate(20_000, pattern="descending", seed=0)
    assert bits_of(cuda_backend.median(x, device="cpu")) == key_oracle(x, 10_000).tobytes()


def test_hist_method_follows_the_device():
    assert resolve_hist_method("cpu") == "plain"
    assert resolve_hist_method(torch.device("cuda", 0)) == "cuda"
    x = tensor_from_numpy(datagen.generate(1000, seed=0), "cpu")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kt.radix_select(x.to("meta"), 5)
    H.reset_counts()
    assert bits_of(kt.radix_select(x, 5)) == key_oracle(tensor_to_numpy(x), 5).tobytes()
    assert H.PLAIN_CALLS["radix_histogram"] == 8 and not any(H.LAUNCHES.values())


def test_cli_kth_mode_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "mpi_k_selection_tpu_torch", "--n", "40000", "--dtype", "float32",
         "--gen", "normal", "--seed", "4", "--k", "250", "--device", "cpu", "--verify", "--json"],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["extra"]["exact_match"] is True
    x = datagen.generate(40000, pattern="normal", seed=4, dtype=np.float32)
    assert np.float32(rec["answer"]).tobytes() == key_oracle(x, 250).tobytes()


# --- on the card --------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("name", DTYPES)
def test_kselect_on_card_matches_numpy(cuda_device, name):
    bits = dt.key_bits(name)
    # 64-bit fixtures hold values below 2^27, so their keys share the top 37
    # bits: the collect needs 12 resolved passes to fit the budget
    cutover = 12 if bits == 64 else forced_cutover(name)
    H.reset_counts()
    for pattern, x in fixtures(name, n=1 << 20):
        xd = tensor_from_numpy(x, cuda_device)
        for k in (1, 250, 1 << 19, 1 << 20):
            got = kt.kselect(xd, k, cutover=cutover, cutover_budget=8192)
            assert bits_of(got) == key_oracle(x, k).tobytes(), (pattern, k)
    assert not any(H.PLAIN_CALLS.values())
    assert H.LAUNCHES[f"radix_histogram{max(bits, 32)}"] > 0
    if bits >= 32:
        assert H.LAUNCHES[f"match_counts{bits}"] > 0
