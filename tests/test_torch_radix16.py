"""16-bit digits and the ``cutover_budget`` check, against the JAX package.

The JAX package takes any ``radix_bits`` that divides the key bits. The
port's resident and distributed radix paths take 16-bit digits too: on the
CPU through the plain histograms, on the card through the sweep kernel's
histogram part (``ops/cuda/sweep_ingest.py:wide_histogram``), which the
``gpu`` tests hold against the plain version at max_abs_err 0.

``kselect(algorithm="radix")``, ``kselect_many``, ``quantiles``, ``median``
and ``distributed_radix_select(_many)`` at ``radix_bits=16`` return the
JAX package's bits on every dtype of 16 bits or more (uint64, which the
JAX package cannot make from its generator, against NumPy). Each JAX
answer is first held against NumPy.

``cutover_budget`` below 1 is refused by the port in every case. The JAX
package answers when no cutover runs and crashes inside a forced collect
(IndexError at 0, TypeError at -1); both behaviours are pinned here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import mpi_k_selection_tpu_torch as kt
from mpi_k_selection_tpu_torch import parallel as P
from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
from mpi_k_selection_tpu_torch.parallel import multihost
from mpi_k_selection_tpu_torch.utils import dtypes as dt
from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype, tensor_from_numpy, tensor_to_numpy

torch.set_num_threads(1)

DTYPES = ("int16", "uint16", "float16", "bfloat16", "int32", "uint32", "float32", "int64", "float64")
N = 20_000  # above 2^14: kselect_many and quantiles take the radix walk
KS = [1, 1234, N // 2, N - 1, N]
QS = [0.0, 0.25, 0.5, 0.9, 0.99, 1.0]
WORLD = 2


def make_input(name: str, n: int = N, seed: int = 0) -> np.ndarray:
    """Seeded values of ``name``'s dtype with ties; floats also carry NaNs
    of both signs, +-0.0 and +-inf."""
    rng = np.random.default_rng(seed)
    if name[0] in "iu":
        info = np.iinfo(name)
        x = rng.integers(info.min, info.max, size=n, dtype=name, endpoint=True)
        x[rng.integers(0, n, n // 8)] = x[:16].repeat(n // 128 + 1)[: n // 8]  # ties
        return x
    x = rng.standard_normal(n) * 1e3
    x[rng.integers(0, n, n // 8)] = np.round(x[: n // 8])
    x[rng.integers(0, n, 6 * 16)] = np.repeat([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf], 16)
    x = x.astype(numpy_dtype(name))
    neg_nan = np.array(-np.nan, dtype=np.float64).astype(x.dtype)
    x[np.flatnonzero(np.isnan(x.astype(np.float64)))[::2]] = neg_nan
    return x


def key_oracle(x: np.ndarray, ks) -> np.ndarray:
    keys = np.sort(dt.np_to_sortable_bits(x))
    return dt.np_from_sortable_bits(keys[np.asarray(ks) - 1], x.dtype)


def quantile_ks(n: int, qs) -> list[int]:
    from mpi_k_selection_tpu_torch.api import quantile_ranks

    return [int(k) for k in quantile_ranks(qs, n)]


def bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def forced(name: str) -> dict:
    """A forced cutover where the key has more than one 16-bit pass."""
    return {"cutover": 1, "cutover_budget": 64} if dt.key_bits(name) > 16 else {}


def jax_answers(name: str, x: np.ndarray) -> dict:
    import jax.numpy as jnp

    import mpi_k_selection_tpu as ks
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    with enable_x64():
        xj = jnp.asarray(x)
        return {
            "kselect": np.stack([np.asarray(ks.kselect(xj, k, algorithm="radix", radix_bits=16)) for k in KS]),
            "forced": np.stack(
                [np.asarray(ks.kselect(xj, k, algorithm="radix", radix_bits=16, **forced(name))) for k in KS]
            ),
            "many": np.asarray(ks.kselect_many(xj, KS, radix_bits=16, **forced(name))),
            "quantiles": np.asarray(ks.quantiles(xj, QS, radix_bits=16)),
            "median": np.asarray(ks.median(xj, algorithm="radix", radix_bits=16)),
        }


def port_answers(name: str, x: np.ndarray) -> dict:
    xd = tensor_from_numpy(x, "cpu")
    return {
        "kselect": np.stack([tensor_to_numpy(kt.kselect(xd, k, algorithm="radix", radix_bits=16)) for k in KS]),
        "forced": np.stack(
            [tensor_to_numpy(kt.kselect(xd, k, algorithm="radix", radix_bits=16, **forced(name))) for k in KS]
        ),
        "many": tensor_to_numpy(kt.kselect_many(xd, KS, radix_bits=16, **forced(name))),
        "quantiles": tensor_to_numpy(kt.quantiles(xd, QS, radix_bits=16)),
        "median": tensor_to_numpy(kt.median(xd, algorithm="radix", radix_bits=16)),
    }


def oracle_answers(x: np.ndarray) -> dict:
    return {
        "kselect": key_oracle(x, KS),
        "forced": key_oracle(x, KS),
        "many": key_oracle(x, KS),
        "quantiles": key_oracle(x, quantile_ks(x.size, QS)),
        "median": key_oracle(x, [N // 2])[0],
    }


@pytest.mark.parametrize("name", DTYPES)
def test_radix16_resident_paths_match_jax(name):
    x = make_input(name)
    want = jax_answers(name, x)
    oracle = oracle_answers(x)
    got = port_answers(name, x)
    for path in want:
        assert bits(want[path]) == bits(oracle[path]), path  # the reference first
        assert bits(got[path]) == bits(want[path]), path


def test_radix16_uint64_matches_numpy():
    x = make_input("int64").view(np.uint64)
    got = port_answers("uint64", x)
    for path, want in oracle_answers(x).items():
        assert bits(got[path]) == bits(want), path


def test_radix16_refusals():
    x = tensor_from_numpy(make_input("int64"), "cpu")
    with pytest.raises(ValueError, match="must divide key bits 64"):
        kt.kselect(x, 5, algorithm="radix", radix_bits=12)
    w = x.view(torch.int64)
    with pytest.raises(ValueError, match=r"radix_bits=32 outside \[1, 16\]"):
        H.radix_histogram(w, shift=32, radix_bits=32)
    with pytest.raises(ValueError, match="counts under a prefix"):
        H.radix_histogram(w, shift=0, radix_bits=16)  # a wide digit below the top needs a prefix
    with pytest.raises(ValueError, match="radix_bits=17"):
        H.radix_histogram_multi(w, shift=0, radix_bits=17, prefixes=torch.zeros(1, dtype=torch.int64))


@pytest.mark.parametrize("bits_", (32, 64))
@pytest.mark.parametrize("key_op", ("none", "xor", "float"))
def test_wide_histogram_buckets_and_prefixes_match_plain(monkeypatch, bits_, key_op):
    """The card's 16-bit route, run here on CPU tensors (its sweep launches
    take the plain version): buckets of 2^12 words summed, repeated and
    absent prefixes, against the plain histograms."""
    monkeypatch.setattr(S, "WIDE_BUCKET", 1 << 12)
    g = torch.Generator().manual_seed(bits_)
    dtype = torch.int32 if bits_ == 32 else torch.int64
    w = torch.randint(-(2**31), 2**31 - 1, (50_001,), generator=g).to(dtype)
    kw = dict(key_op=key_op, key_xor=5 if key_op == "xor" else 0)
    top = H.radix_histogram_plain(w, shift=bits_ - 16, radix_bits=16, **kw)
    busy = int(top.argmax())
    prefixes = [busy, 0, busy, (1 << 16) - 1, 1 << 20]  # the last one no key holds
    got = S.wide_histogram(w, shift=bits_ - 32, radix_bits=16, prefixes=prefixes, **kw)
    want = H.radix_histogram_multi_plain(
        w, shift=bits_ - 32, radix_bits=16, prefixes=torch.tensor(prefixes, dtype=dtype), **kw
    )
    assert torch.equal(got, want)
    assert torch.equal(S.wide_histogram(w, shift=bits_ - 16, radix_bits=16, prefixes=[0], **kw)[0], top)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ("int16", "int32", "float32", "int64", "float64"))
def test_radix16_card_route_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card: python -m pytest --noconftest tests/test_torch_*.py -m gpu")
    x = make_input(name, 1 << 20)
    xc = tensor_from_numpy(x, "cuda")
    S.reset_counts()
    got = tensor_to_numpy(kt.kselect_many(xc, KS, radix_bits=16, **forced(name)).cpu())
    assert sum(S.LAUNCHES.values()) > 0  # the 16-bit passes ran on the sweep kernel
    assert bits(got) == bits(key_oracle(x, KS))
    words = xc.reshape(-1).view(torch.int32 if x.itemsize <= 4 else torch.int64)
    if x.itemsize == 2:
        words = dt.to_sortable_bits(xc.reshape(-1))
    wb = words.element_size() * 8
    top = dict(shift=wb - 16, radix_bits=16)
    assert torch.equal(H.radix_histogram(words, **top).cpu(), H.radix_histogram_plain(words.cpu(), **top))
    low = dict(shift=wb - 32, radix_bits=16)
    busy = H.radix_histogram_plain(words.cpu(), **top).argmax().reshape(1).to(words.dtype)
    assert torch.equal(H.radix_histogram(words, prefix=busy.cuda(), **low).cpu(),
                       H.radix_histogram_plain(words.cpu(), prefix=busy, **low))
    for nq in (4, 64):
        prefixes = (torch.arange(nq, dtype=words.dtype) * 997 + busy) % (1 << 16)
        want = H.radix_histogram_multi_plain(words.cpu(), prefixes=prefixes, **low)
        assert torch.equal(H.radix_histogram_multi(words, prefixes=prefixes.cuda(), **low).cpu(), want)


# -- distributed, over gloo on the CPU -------------------------------------

DIST_DTYPES = ("int16", "int32", "float32", "int64", "float64")
DIST_N = 1 << 15


def run_dist_cases(mesh):
    torch.set_num_threads(2)
    out = {}
    for name in DIST_DTYPES:
        x = make_input(name, DIST_N, seed=3)
        ks = [1, 250, DIST_N // 2, DIST_N]
        out[f"one-{name}"] = np.stack(
            [tensor_to_numpy(P.distributed_radix_select(x, k, mesh=mesh, radix_bits=16, **forced(name)).reshape(1))[0]
             for k in ks]
        )
        out[f"many-{name}"] = tensor_to_numpy(
            P.distributed_radix_select_many(x, ks, mesh=mesh, radix_bits=16, **forced(name))
        )
    return out


@pytest.fixture(scope="module")
def dist():
    return multihost.run_ranks(run_dist_cases, WORLD, device="cpu", timeout=120)


@pytest.mark.parametrize("name", DIST_DTYPES)
def test_radix16_distributed_matches_jax(dist, name):
    from mpi_k_selection_tpu.parallel import distributed_radix_select, distributed_radix_select_many
    from mpi_k_selection_tpu.parallel import make_mesh
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    x = make_input(name, DIST_N, seed=3)
    ks = [1, 250, DIST_N // 2, DIST_N]
    mesh = make_mesh(WORLD)
    with enable_x64():
        one = np.stack([np.asarray(distributed_radix_select(x, k, mesh=mesh, radix_bits=16, **forced(name)))
                        for k in ks])
        many = np.asarray(distributed_radix_select_many(x, ks, mesh=mesh, radix_bits=16, **forced(name)))
    assert bits(one) == bits(key_oracle(x, ks)) and bits(many) == bits(one)
    assert bits(dist[f"one-{name}"]) == bits(one)
    assert bits(dist[f"many-{name}"]) == bits(many)


# -- cutover_budget below 1 ------------------------------------------------


@pytest.mark.parametrize("budget", (0, -1))
def test_cutover_budget_below_one_pins_both_packages(budget):
    import jax.numpy as jnp

    import mpi_k_selection_tpu as ks

    x = make_input("int32")
    xj, xd = jnp.asarray(x), tensor_from_numpy(x, "cpu")
    want = key_oracle(x, [1234, N // 2])
    # no cutover: the JAX package answers equal to NumPy
    assert bits(np.asarray(ks.kselect(xj, 1234, algorithm="radix", cutover=None, cutover_budget=budget))) == bits(want[0])
    assert bits(np.asarray(ks.kselect_many(xj, [1234], cutover=None, cutover_budget=budget))) == bits(want[:1])
    assert bits(np.asarray(ks.median(xj, algorithm="radix", cutover=None, cutover_budget=budget))) == bits(want[1])
    # a forced cutover: the JAX package crashes inside the collect
    crash = IndexError if budget == 0 else TypeError
    for fn in (ks.kselect, ks.median):
        args = (xj, 1234) if fn is ks.kselect else (xj,)
        with pytest.raises(crash):
            fn(*args, algorithm="radix", cutover=1, radix_bits=8, cutover_budget=budget)
    # the port refuses every case
    msg = f"cutover_budget={budget} must be >= 1"
    for kw in ({"cutover": None}, {"cutover": 1, "radix_bits": 8}, {}):
        with pytest.raises(ValueError, match=msg):
            kt.kselect(xd, 1234, algorithm="radix", cutover_budget=budget, **kw)
        with pytest.raises(ValueError, match=msg):
            kt.kselect_many(xd, [1234], cutover_budget=budget, **kw)
        with pytest.raises(ValueError, match=msg):
            kt.median(xd, algorithm="radix", cutover_budget=budget, **kw)
    with pytest.raises(ValueError, match=msg):
        P.radix._check_budget(budget)
