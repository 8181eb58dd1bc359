"""``early_exit_budget``, the per-pass early exit of the resident radix
descent, against the JAX package's ``radix_select`` and NumPy.

With ``early_exit_budget=b`` below n, pass 0 always runs and each later
pass only while the chosen bucket's population exceeds ``b``; the first
population that fits is collected at the resolved width and sorted. The
answers are compared as bit patterns with the JAX package's on the same
NumPy inputs (the JAX package first held against NumPy), and the port's
plain histogram and ``match_counts`` calls (``PLAIN_CALLS``) against the
count NumPy predicts from the data (:func:`predicted`). ``radix_bits`` is
passed to both packages: the JAX package's CPU route defaults to 8-bit
digits, the port to 4-bit ones.

The ``gpu`` tests run the same path on the card:

    python -m pytest --noconftest tests/test_torch_early_exit.py -m gpu
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import mpi_k_selection_tpu_torch as kt
from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
from mpi_k_selection_tpu_torch.utils import datagen
from mpi_k_selection_tpu_torch.utils import dtypes as dt
from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype, tensor_from_numpy, tensor_to_numpy

torch.set_num_threads(1)

DTYPES = (
    "int8", "uint8", "int16", "uint16", "int32", "uint32",
    "int64", "uint64", "float16", "bfloat16", "float32", "float64",
)
REF_N = 200_001  # tests/test_radix.py's early-exit cases
FIX_N = 3000  # the adversarial fixtures
SWEEP_N = 5000  # the budget and digit-width sweep


def fixtures(name, n=FIX_N):
    """``adversarial_fixtures`` in ``name``'s dtype (uint64 from the int64
    fixtures' bits, bfloat16 from the float32 ones rounded), and for floats
    one more array holding +-0.0 and NaNs of both signs among ties."""
    if name == "uint64":
        out = [(p, x.view(np.uint64)) for p, x in datagen.adversarial_fixtures(n, dtype=np.int64)]
    elif name == "bfloat16":
        bf = numpy_dtype("bfloat16")
        out = [(p, x.astype(bf)) for p, x in datagen.adversarial_fixtures(n, dtype=np.float32)]
    else:
        out = list(datagen.adversarial_fixtures(n, dtype=np.dtype(name)))
    if name.startswith(("float", "bfloat")):
        rng = np.random.default_rng(7)
        v = np.round(rng.standard_normal(n) * 4)
        v[rng.integers(0, n, n // 8)] = np.repeat([np.nan, -np.nan, 0.0, -0.0], n // 32 + 1)[: n // 8]
        x = v.astype(numpy_dtype(name))
        neg_nan = np.array(-np.nan, dtype=np.float64).astype(x.dtype)
        x[np.flatnonzero(np.isnan(x.astype(np.float64)))[::2]] = neg_nan
        out.append(("signed zeros and nans", x))
    return out


def key_oracle(x, k) -> bytes:
    """The bits of the k-th smallest of ``x`` in key order."""
    keys = np.sort(dt.np_to_sortable_bits(x))
    return dt.np_from_sortable_bits(keys[k - 1 : k], x.dtype).tobytes()


def predicted(x, k, radix_bits, budget):
    """(passes, collects) of the early exit on ``x`` at rank ``k``: passes
    is the least p >= 1 at which the keys sharing the answer's top ``p *
    radix_bits`` key bits number at most ``budget`` (else every pass), and
    one collect when that p is below the pass count (at the last pass every
    bit is resolved and the prefix is the answer)."""
    keys = dt.np_to_sortable_bits(x.reshape(-1))
    total = keys.dtype.itemsize * 8
    npasses = total // radix_bits
    ans = np.sort(keys)[min(max(k, 1), keys.size) - 1]
    for p in range(1, npasses):
        shift = keys.dtype.type(total - p * radix_bits)
        if np.count_nonzero((keys >> shift) == (ans >> shift)) <= budget:
            return p, 1
    return npasses, 0


def port_select(x, k, **kw):
    """The port's answer bits on CPU tensors and its (passes, collects)."""
    H.reset_counts()
    got = kt.radix_select(tensor_from_numpy(x, "cpu"), k, **kw)
    return tensor_to_numpy(got.reshape(1)).tobytes(), (H.PLAIN_CALLS["radix_histogram"], H.PLAIN_CALLS["match_counts"])


def jax_select(x, k, **kw) -> bytes:
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.radix import radix_select as ref_select
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    with enable_x64():
        return np.asarray(ref_select(jnp.asarray(x), k, **kw)).reshape(1).tobytes()


def held(x, k, radix_bits, budget, *, jax=True, what=""):
    """One select through both packages: the JAX package against NumPy,
    the port against both, and the port's counts against NumPy's
    prediction when the early exit runs (n > budget)."""
    want = key_oracle(x, k)
    kw = dict(radix_bits=radix_bits, early_exit_budget=budget)
    if jax:
        assert jax_select(x, k, **kw) == want, ("jax", what, k, kw)
    got, counts = port_select(x, k, **kw)
    assert got == want, (what, k, kw)
    if x.size > budget:
        assert counts == predicted(x, k, radix_bits, budget), (what, k, kw)
    return counts


# -- tests/test_radix.py's early-exit cases ----------------------------------


def reference_case(case: str) -> tuple[np.ndarray, list[int]]:
    if case == "duplicates":  # duplicates straddling the budget
        rng = np.random.default_rng(17)
        x = np.repeat(rng.integers(0, 50, size=100, dtype=np.int32), 5000)
        rng.shuffle(x)
        return x, [1, x.size // 2, x.size]
    if case == "float32":
        rng = np.random.default_rng(19)
        return rng.standard_normal(100_001).astype(np.float32), [1, 31_337, 100_001]
    x = datagen.generate(REF_N, pattern=case, seed=13, dtype=np.int32)
    return x, [1, REF_N // 2, REF_N]


@pytest.mark.parametrize("radix_bits", (4, 8))
@pytest.mark.parametrize("case", ("uniform", "descending", "equal", "seqlike", "duplicates", "float32"))
def test_reference_cases_match_jax(case, radix_bits):
    x, ks = reference_case(case)
    for k in ks:
        held(x, k, radix_bits, 4096, what=case)


# -- every dtype, the adversarial fixtures -----------------------------------


def budgets(n: int) -> tuple[int, ...]:
    return (1, 2, 64, 4096, n - 1, n, n + 1)


def jax_cases(n: int) -> tuple[tuple[int, int], ...]:
    """(radix_bits, budget) held against the JAX package on every fixture."""
    return ((4, 1), (8, 64), (4, n - 1))


@pytest.mark.parametrize("name", DTYPES)
def test_adversarial_dtypes_match_jax(name):
    bits = dt.key_bits(name)
    for pattern, x in fixtures(name):
        n = x.size
        for rb, budget in jax_cases(n):
            for k in (1, n // 2, n):
                held(x, k, rb, budget, what=f"{name} {pattern}")
        # every budget at the narrowest and widest digits that divide the
        # key, on the port against NumPy (the sweep below takes every width)
        for rb in (w for w in (1, 16) if bits % w == 0):
            for budget in budgets(n):
                for k in (1, n // 2, n):
                    held(x, k, rb, budget, jax=False, what=f"{name} {pattern}")


# -- the budget and digit-width sweep ---------------------------------------


@pytest.mark.parametrize("radix_bits", (1, 2, 4, 8, 16))
def test_budget_and_width_sweep_matches_jax(radix_bits):
    """Every budget at every digit width, k in {1, n/2, n} and tensor ks
    clamped to [1, n] (as the JAX package clamps a traced k), through both
    packages on int32 and through the port on float64."""
    import jax.numpy as jnp

    n = SWEEP_N
    x = datagen.generate(n, pattern="uniform", seed=3, dtype=np.int32)
    f = datagen.generate(n, pattern="normal", seed=3, dtype=np.float64)
    for budget in budgets(n):
        kw = dict(radix_bits=radix_bits, early_exit_budget=budget)
        for k in (1, n // 2, n, 0, 1234, 10**6):
            want = key_oracle(x, min(max(k, 1), n))
            # one k type for the JAX package, so each budget compiles once
            assert jax_select(x, jnp.asarray(k, jnp.int32), **kw) == want, (budget, k)
            for kk in ((k, torch.tensor(k)) if 1 <= k <= n else (torch.tensor(k),)):
                got, counts = port_select(x, kk, **kw)
                assert got == want, (budget, k)
                if n > budget:
                    assert counts == predicted(x, k, radix_bits, budget), (budget, k)
            if 1 <= k <= n:
                held(f, k, radix_bits, budget, jax=False, what="float64")


# -- the strict ``>`` and the last pass -------------------------------------


def test_population_equal_to_budget_fits():
    """Pass 0's bucket holds exactly ``b`` keys: at budget b it fits (the
    strict ``pop > budget`` of the JAX package) and one pass runs before
    the collect; at b - 1 the descent goes on until it fits."""
    rng = np.random.default_rng(5)
    b, n = 1000, 20_000
    low = rng.integers(0, 1 << 24, b, dtype=np.int32)  # key top digit 8, then digit 0
    high = rng.integers(1 << 28, (1 << 31) - 1, n - b, dtype=np.int32)  # key top digits 9..15
    x = np.concatenate([low, high])
    rng.shuffle(x)
    k = b // 2
    keys = dt.np_to_sortable_bits(x)
    assert np.count_nonzero((keys >> np.uint32(28)) == 8) == b
    assert held(x, k, 4, b) == (1, 1)
    assert held(x, k, 4, b - 1) == (3, 1)  # digit 1 is 0 for every low key: pass 1 keeps all b
    assert held(x, k, 4, b + 1) == (1, 1)


def test_population_fits_only_after_the_last_pass():
    """Every key shares its top 24 bits and each value repeats 40 times: at
    budget 100 the population first fits after the last pass, so the port
    returns the prefix with no collect (the JAX package collects and picks
    the same bits)."""
    rng = np.random.default_rng(6)
    x = np.repeat(np.arange(256, dtype=np.int32) + (7 << 20), 40)
    rng.shuffle(x)
    for k in (1, 5000, x.size):
        assert predicted(x, k, 8, 100) == (4, 0)
        assert held(x, k, 8, 100) == (4, 0)
    assert held(x, 5000, 8, 40) == (4, 0)  # the answer's 40 copies: equal to the budget after the last pass
    assert held(x, 5000, 8, 39) == (4, 0)  # and beyond it: the prefix all the same


# -- the contract ------------------------------------------------------------


def test_invalid_cutover_is_ignored_on_the_early_path():
    import jax.numpy as jnp

    from mpi_k_selection_tpu.ops.radix import radix_select as ref_select

    x = datagen.generate(SWEEP_N, pattern="uniform", seed=1, dtype=np.int32)
    want = key_oracle(x, 5)
    for cutover in ("bad", 99):
        kw = dict(radix_bits=8, early_exit_budget=4096, cutover=cutover)
        assert np.asarray(ref_select(jnp.asarray(x), 5, **kw)).reshape(1).tobytes() == want
        assert port_select(x, 5, **kw)[0] == want
        # n <= budget: the cutover path resolves it and both packages raise
        kw["early_exit_budget"] = SWEEP_N
        with pytest.raises(ValueError):
            ref_select(jnp.asarray(x), 5, **kw)
        with pytest.raises(ValueError):
            kt.radix_select(tensor_from_numpy(x, "cpu"), 5, **kw)


@pytest.mark.parametrize("budget", (0, -1))
def test_budget_below_one(budget):
    """The port refuses a budget below 1; the JAX package crashes inside
    its collect (IndexError at 0, TypeError at -1)."""
    import jax.numpy as jnp

    import mpi_k_selection_tpu as ks

    x = datagen.generate(SWEEP_N, pattern="uniform", seed=1, dtype=np.int32)
    crash = IndexError if budget == 0 else TypeError
    with pytest.raises(crash):
        ks.radix_select(jnp.asarray(x), 5, early_exit_budget=budget)
    msg = f"early_exit_budget={budget} must be >= 1"
    xd = tensor_from_numpy(x, "cpu")
    with pytest.raises(ValueError, match=msg):
        kt.radix_select(xd, 5, early_exit_budget=budget)
    with pytest.raises(ValueError, match=msg):
        kt.kselect(xd, 5, algorithm="radix", early_exit_budget=budget)
    with pytest.raises(ValueError, match=msg):
        kt.median(x, device="cpu", algorithm="radix", early_exit_budget=budget, cutover=None)


def test_many_paths_refuse_the_keyword_in_both_packages():
    import jax.numpy as jnp

    import mpi_k_selection_tpu as ks
    from mpi_k_selection_tpu.ops.radix import radix_select_many

    x = datagen.generate(1 << 15, pattern="uniform", seed=2, dtype=np.int32)  # above 2^14: the radix walk
    ks_ = [1, 100, 1 << 14]
    with pytest.raises(TypeError):
        ks.kselect_many(jnp.asarray(x), ks_, early_exit_budget=4096)
    with pytest.raises(TypeError):
        radix_select_many(jnp.asarray(x), ks_, early_exit_budget=4096)
    with pytest.raises(TypeError):
        kt.kselect_many(x, ks_, device="cpu", early_exit_budget=4096)
    with pytest.raises(TypeError):
        kt.radix_select_many(tensor_from_numpy(x, "cpu"), ks_, early_exit_budget=4096)


def test_kselect_and_median_forward_the_keyword():
    import jax.numpy as jnp

    import mpi_k_selection_tpu as ks
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    x = datagen.generate(REF_N, pattern="seqlike", seed=4, dtype=np.float64)
    n = x.size
    with enable_x64():
        xj = jnp.asarray(x)
        ref_k = np.asarray(ks.kselect(xj, 777, algorithm="radix", radix_bits=4, early_exit_budget=4096))
        ref_m = np.asarray(ks.median(xj, algorithm="radix", radix_bits=4, early_exit_budget=4096))
    assert ref_k.reshape(1).tobytes() == key_oracle(x, 777)
    assert ref_m.reshape(1).tobytes() == key_oracle(x, n // 2)
    H.reset_counts()
    got = kt.kselect(x, 777, device="cpu", early_exit_budget=4096)
    assert tensor_to_numpy(got.reshape(1)).tobytes() == ref_k.reshape(1).tobytes()
    assert (H.PLAIN_CALLS["radix_histogram"], H.PLAIN_CALLS["match_counts"]) == predicted(x, 777, 4, 4096)
    H.reset_counts()
    got = kt.median(x, device="cpu", early_exit_budget=4096)
    assert tensor_to_numpy(got.reshape(1)).tobytes() == ref_m.reshape(1).tobytes()
    assert (H.PLAIN_CALLS["radix_histogram"], H.PLAIN_CALLS["match_counts"]) == predicted(x, n // 2, 4, 4096)
    # the sort path (n <= 2^14) ignores the keyword in both packages
    small = x[:1000]
    want = np.asarray(ks.kselect(jnp.asarray(small.astype(np.float32)), 10, early_exit_budget=4))
    H.reset_counts()
    got = kt.kselect(small.astype(np.float32), 10, device="cpu", early_exit_budget=4)
    assert tensor_to_numpy(got.reshape(1)).tobytes() == want.reshape(1).tobytes()
    assert not any(H.PLAIN_CALLS.values())


@pytest.mark.parametrize("name", ("int32", "float64", "int16", "uint8"))
def test_no_budget_changes_nothing(name):
    """``early_exit_budget=None`` (and any budget at or above n) leaves the
    cutover path's answers and calls exactly as they were."""
    x = fixtures(name, 40_000)[0][1]
    n = x.size
    for kw in ({}, {"cutover": 1, "cutover_budget": 1024}, {"cutover": None}):
        for k in (1, n // 2, n):
            base = port_select(x, k, **kw)
            assert base[0] == key_oracle(x, k)
            for budget in (None, n, n + 1):
                assert port_select(x, k, early_exit_budget=budget, **kw) == base, (kw, k, budget)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs a CUDA device; on the card: "
            "python -m pytest --noconftest tests/test_torch_early_exit.py -m gpu"
        )
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name,pattern", (("int32", "uniform"), ("float64", "normal"), ("int16", "seqlike"),
                                          ("int32", "equal"), ("uint64", "uniform")))
@pytest.mark.parametrize("radix_bits", (4, 8, 16))
def test_early_exit_on_card_matches_numpy(cuda_device, name, pattern, radix_bits):
    """The early exit on CUDA tensors: NumPy's answer bits, the histogram
    kernel once a pass and ``match_counts`` once a collect (the sweep
    kernel's histogram part at 16-bit digits), no plain call."""
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S

    n = 1 << 22
    if name == "uint64":
        x = datagen.generate(n, pattern=pattern, seed=9, dtype=np.int64).view(np.uint64)
    else:
        x = datagen.generate(n, pattern=pattern, seed=9, dtype=np.dtype(name))
    xc = tensor_from_numpy(x, "cuda")
    bits = 64 if x.itemsize == 8 else 32
    for budget in (64, 4096, 8192):
        for k in (1, n // 2, n):
            H.reset_counts()
            S.reset_counts()
            got = kt.radix_select(xc, k, radix_bits=radix_bits, early_exit_budget=budget)
            assert tensor_to_numpy(got.reshape(1)).tobytes() == key_oracle(x, k), (budget, k)
            passes, collects = predicted(x, k, radix_bits, budget)
            hist = S.LAUNCHES[f"sweep_ingest{bits}"] if radix_bits > 8 else H.LAUNCHES[f"radix_histogram{bits}"]
            assert (hist, H.LAUNCHES[f"match_counts{bits}"]) == (passes, collects), (budget, k)
            assert not any(H.PLAIN_CALLS.values()) and not any(S.PLAIN_CALLS.values())
