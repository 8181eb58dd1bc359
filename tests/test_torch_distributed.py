"""The port's distributed selection against the JAX package's, bit for bit.

``distributed_radix_select``, ``distributed_radix_select_many``,
``distributed_cgm_select`` (value and round count) and
``distributed_topk`` (values, and indices after an int64 cast) run on
world P in {2, 4} spawned ranks over gloo on the CPU, and the JAX
package's counterparts on ``make_mesh(P)`` of its 8-device virtual CPU
mesh, on the same seeded inputs; each JAX answer is first held against a
NumPy oracle. One spawn per world size runs every case (the module
fixture ``port``); the parametrised tests read its results, so each case
counts. JAX is imported inside the tests only: the spawned ranks and the
card's machine never load it.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from mpi_k_selection_tpu_torch import parallel as P
from mpi_k_selection_tpu_torch.parallel import mesh as mesh_lib, multihost
from mpi_k_selection_tpu_torch.utils import dtypes as dt
from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype, tensor_to_numpy

WORLDS = (2, 4)
N = 1 << 17  # the forced ladder collects at this size
ODD = N + 3  # a multiple of neither world: the shards carry sentinels
DTYPES = ("int32", "float32", "bfloat16", "int64", "float64")
LADDER = dict(radix_bits=8, cutover=1, cutover_budget=64)  # rung 1 overflows, rung 2 collects
SPAWN_TIMEOUT_S = 120


def make_input(name: str, n: int, seed: int = 0) -> np.ndarray:
    """Seeded values of ``name``'s dtype with ties; floats also carry NaNs
    of both signs, +-0.0 and +-inf."""
    rng = np.random.default_rng(seed)
    if name in ("int32", "int64"):
        info = np.iinfo(name)
        x = rng.integers(info.min, info.max, size=n, dtype=name, endpoint=True)
        x[rng.integers(0, n, n // 8)] = x[:16].repeat(n // 128 + 1)[: n // 8]  # ties
        return x
    x = (rng.standard_normal(n) * 1e3).astype(np.float64)
    x[rng.integers(0, n, n // 8)] = np.round(x[: n // 8])  # ties
    special = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf]
    x[rng.integers(0, n, 6 * 64)] = np.repeat(special, 64)
    x = x.astype(numpy_dtype(name))
    neg_nan = np.array(-np.nan, dtype=np.float64).astype(x.dtype)  # astype may drop a NaN's sign
    x[np.flatnonzero(np.isnan(x.astype(np.float64)))[::2]] = neg_nan
    return x


def sentinel_tie_input(name: str, largest: bool) -> np.ndarray:
    """Mostly the order-extreme value that pads a top-k's shards, so a pad
    ties real elements into the result (n a multiple of neither world)."""
    n = 1003
    bits = dt.key_bits(name)
    key = 0 if largest else (1 << bits) - 1
    x = dt.np_from_sortable_bits(np.full(n, key, dtype=f"uint{bits}"), numpy_dtype(name))
    x[[7, 300, 901]] = np.array([5, 6, 7]).astype(numpy_dtype(name))
    return x


def radix_cases():
    for name in DTYPES:
        yield f"radix-{name}-ladder", name, N, LADDER
        yield f"radix-{name}-odd", name, ODD, {}
    yield "radix-int32-equal-ladder", "equal", N, LADDER  # the population never fits: the full schedule


def case_input(name: str, n: int) -> np.ndarray:
    if name == "equal":
        return np.full(n, 42, dtype=np.int32)
    return make_input(name, n)


def ks_of(n: int) -> list[int]:
    return [1, 250, n // 2, n - 1, n]


def run_cases(mesh):
    """Every case on this rank; returns ``{case: numpy result}``."""
    torch.set_num_threads(2)
    out = {}
    for case, name, n, kw in radix_cases():
        x = case_input(name, n)
        out[case] = np.concatenate(
            [tensor_to_numpy(P.distributed_radix_select(x, k, mesh=mesh, **kw).reshape(1)) for k in ks_of(n)]
        )
    for name in DTYPES:
        x = make_input(name, ODD)
        out[f"many-{name}"] = tensor_to_numpy(P.distributed_radix_select_many(x, ks_of(ODD), mesh=mesh, **LADDER))
        for n in (N, ODD) if name == "int32" else (ODD,):
            x = make_input(name, n, seed=1)
            vals = []
            for k in (1, n // 2, n):
                v, r = P.distributed_cgm_select(x, k, mesh=mesh, return_rounds=True)
                vals.append((tensor_to_numpy(v.reshape(1))[0], r))
            out[f"cgm-{name}-{n}"] = vals
        for largest in (True, False):
            x = make_input(name, ODD, seed=2)
            v, i = P.distributed_topk(x, 16, largest=largest, mesh=mesh)
            out[f"topk-{name}-{largest}"] = (tensor_to_numpy(v), i.numpy())
    for name, largest in (("int32", True), ("float32", False)):
        v, i = P.distributed_topk(sentinel_tie_input(name, largest), 16, largest=largest, mesh=mesh)
        out[f"tie-{name}-{largest}"] = (tensor_to_numpy(v), i.numpy())
    # a placed shard answers as the global array does
    x = make_input("int32", ODD)
    out["shard"] = int(P.distributed_radix_select(mesh_lib.shard_1d(x, mesh), ODD // 2, mesh=mesh))
    out["stats"] = (mesh.backend, mesh.collectives, str(mesh.device))
    # the hybrid groups: sums of the ranks within each host, then across
    hy = multihost.make_hybrid_mesh(per_host=2, device="cpu")
    r = torch.tensor([mesh.rank], dtype=torch.int64)
    out["hybrid"] = (int(hy.local.all_reduce(r)), int(hy.hosts.all_reduce(hy.local.all_reduce(r))))
    return out


@pytest.fixture(scope="module")
def port():
    return {w: multihost.run_ranks(run_cases, w, device="cpu", timeout=SPAWN_TIMEOUT_S) for w in WORLDS}


def key_oracle(x: np.ndarray, ks) -> np.ndarray:
    keys = dt.np_to_sortable_bits(x)
    idx = np.asarray(ks) - 1
    return dt.np_from_sortable_bits(np.sort(keys)[idx], x.dtype)


def topk_oracle(x: np.ndarray, k: int, largest: bool):
    keys = dt.np_to_sortable_bits(x)
    order = np.lexsort((np.arange(x.size), ~keys if largest else keys))[:k]
    return x[order], order


def bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def jax_mesh(world):
    from mpi_k_selection_tpu.parallel import make_mesh

    return make_mesh(world)


def wide(name: str) -> bool:
    return dt.key_bits(name if name != "equal" else "int32") == 64


def jax_run(name, fn):
    """``fn()`` with x64 on for 64-bit dtypes, its outputs as NumPy."""
    import jax

    from mpi_k_selection_tpu.utils.x64 import enable_x64

    if wide(name):
        with enable_x64():
            return jax.tree_util.tree_map(np.asarray, fn())
    return jax.tree_util.tree_map(np.asarray, fn())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", [c[0] for c in radix_cases()])
def test_distributed_radix_select_matches_jax(port, world, case):
    from mpi_k_selection_tpu.parallel import distributed_radix_select

    _, name, n, kw = next(c for c in radix_cases() if c[0] == case)
    x = case_input(name, n)
    ks = ks_of(n)
    mesh = jax_mesh(world)
    want = np.stack(jax_run(name, lambda: [distributed_radix_select(x, k, mesh=mesh, **kw) for k in ks]))
    assert bits(want) == bits(key_oracle(x, ks))  # the reference path first
    assert bits(port[world][case]) == bits(want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", DTYPES)
def test_distributed_radix_select_many_matches_jax(port, world, name):
    from mpi_k_selection_tpu.parallel import distributed_radix_select_many

    x = make_input(name, ODD)
    ks = ks_of(ODD)
    mesh = jax_mesh(world)
    want = jax_run(name, lambda: distributed_radix_select_many(x, ks, mesh=mesh, **LADDER))
    assert bits(want) == bits(key_oracle(x, ks))
    assert bits(port[world][f"many-{name}"]) == bits(want)


CGM_CASES = [("int32", N)] + [(name, ODD) for name in DTYPES]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,n", CGM_CASES)
def test_distributed_cgm_select_matches_jax_value_and_rounds(port, world, name, n):
    from mpi_k_selection_tpu.parallel import distributed_cgm_select

    x = make_input(name, n, seed=1)
    ks = (1, n // 2, n)
    mesh = jax_mesh(world)
    want = jax_run(name, lambda: [distributed_cgm_select(x, k, mesh=mesh, return_rounds=True) for k in ks])
    assert bits([v for v, _ in want]) == bits(key_oracle(x, ks))
    got = port[world][f"cgm-{name}-{n}"]
    assert bits(np.stack([v for v, _ in got])) == bits(np.stack([v for v, _ in want]))
    assert [r for _, r in got] == [int(r) for _, r in want]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("name", DTYPES)
def test_distributed_topk_matches_jax(port, world, name, largest):
    from mpi_k_selection_tpu.parallel import distributed_topk

    x = make_input(name, ODD, seed=2)
    mesh = jax_mesh(world)
    wv, wi = jax_run(name, lambda: distributed_topk(x, 16, largest=largest, mesh=mesh))
    ov, oi = topk_oracle(x, 16, largest)
    assert bits(wv) == bits(ov) and np.array_equal(wi.astype(np.int64), oi)
    gv, gi = port[world][f"topk-{name}-{largest}"]
    assert bits(gv) == bits(wv)
    assert np.array_equal(gi, wi.astype(np.int64))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,largest", [("int32", True), ("float32", False)])
def test_distributed_topk_sentinel_ties_remap_like_jax(port, world, name, largest):
    from mpi_k_selection_tpu.parallel import distributed_topk

    x = sentinel_tie_input(name, largest)
    mesh = jax_mesh(world)
    wv, wi = jax_run(name, lambda: distributed_topk(x, 16, largest=largest, mesh=mesh))
    assert (wi < x.size).all() and len(set(wi.tolist())) == 16
    assert bits(x[wi]) == bits(wv)  # every index names a real element of that value
    gv, gi = port[world][f"tie-{name}-{largest}"]
    assert bits(gv) == bits(wv)
    assert np.array_equal(gi, wi.astype(np.int64))


@pytest.mark.parametrize("world", WORLDS)
def test_shard_hybrid_groups_and_stats(port, world):
    x = make_input("int32", ODD)
    assert port[world]["shard"] == key_oracle(x, [ODD // 2])[0]
    backend, collectives, device = port[world]["stats"]
    assert (backend, device) == ("gloo", "cpu") and collectives > 0
    local, total = port[world]["hybrid"]
    assert local == 1 and total == sum(range(world))  # rank 0's host holds ranks 0 and 1


@pytest.mark.parametrize("world", WORLDS)
def test_shard_1d_blocks_are_the_jax_shardings(world):
    import jax

    from mpi_k_selection_tpu.parallel import mesh as jmesh

    for name, n in (("int32", 11), ("float32", 13), ("int32", 12)):
        x = make_input(name, n)
        xp, _ = jmesh.pad_to_multiple(jax.numpy.asarray(x), world)
        want = np.asarray(jmesh.shard_1d(xp, jax_mesh(world)))
        per = want.size // world
        for r in range(world):
            m = mesh_lib.Mesh(None, r, world, "cpu", None)
            got = tensor_to_numpy(mesh_lib.shard_1d(x, m).block)
            assert bits(got) == bits(want[r * per : (r + 1) * per]), (name, n, r)
        padded, n0 = mesh_lib.pad_to_multiple(torch.from_numpy(x), world)
        assert n0 == n and bits(padded.numpy()) == bits(want)


def test_single_rank_mesh_and_backend_choice_refuse():
    from mpi_k_selection_tpu.parallel import make_mesh as jax_make_mesh, require_distributed as jax_require

    mesh = P.make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, None)
    with pytest.raises(ValueError) as got:
        P.distributed_radix_select(np.arange(10, dtype=np.int32), 3, mesh=mesh)
    with pytest.raises(ValueError) as want:
        jax_require(jax_make_mesh(1))
    assert str(got.value) == str(want.value)
    for fn in (P.distributed_cgm_select, P.distributed_topk):
        with pytest.raises(ValueError, match="needs >= 2 devices"):
            fn(np.arange(10, dtype=np.int32), 3, mesh=mesh)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        P.make_mesh(2, device="cpu")
    assert mesh_lib.choose_backend(4, "cpu") == "gloo"
    with pytest.raises(ValueError, match="nccl needs a card for each rank"):
        mesh_lib.choose_backend(4, "cuda", "nccl")
    with pytest.raises(ValueError, match="nccl needs a card"):
        mesh_lib.choose_backend(2, "cpu", "nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.run_ranks(run_cases, 2)


def test_topk_refuses_k_past_the_shard_like_jax():
    from mpi_k_selection_tpu.parallel import distributed_topk as jax_topk

    x = np.arange(10, dtype=np.int32)
    with pytest.raises(ValueError) as want:
        jax_topk(x, 6, mesh=jax_mesh(2))
    m = mesh_lib.Mesh(None, 0, 2, "cpu", None)  # the check runs before any collective
    with pytest.raises(ValueError) as got:
        P.distributed_topk(x, 6, mesh=m)
    assert str(got.value) == str(want.value)


def fail_on_rank_one(mesh):
    """Rank 1 raises; rank 0 waits outside any collective (a collective
    would see rank 1's group close and report first) until the launcher
    ends it."""
    if mesh.rank == 1:
        raise ValueError("rank one fails")
    threading.Event().wait(60)
    return "unreachable"


def sleep_past_the_deadline(mesh):
    threading.Event().wait(60)


def test_a_failed_or_late_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*rank one fails"):
        multihost.run_ranks(fail_on_rank_one, 2, device="cpu", timeout=60)
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] did not finish within 6 s"):
        multihost.run_ranks(sleep_past_the_deadline, 2, device="cpu", timeout=6)


# --- on the card ----------------------------------------------------------------


def card_cases(mesh):
    """World 2 sharing cuda:0: each path's answer and the kernels' launches."""
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H

    n = (1 << 22) + 3
    x = np.random.default_rng(3).integers(-(2**31), 2**31 - 1, size=n, dtype=np.int32)
    H.reset_counts()
    out = {
        "radix": int(P.distributed_radix_select(x, n // 2, mesh=mesh)),
        "many": P.distributed_radix_select_many(x, [1, n // 3, n], mesh=mesh, cutover=3).tolist(),
        "cgm": int(P.distributed_cgm_select(x, 150, mesh=mesh)),
        "topk": P.distributed_topk(x, 16, mesh=mesh)[1].tolist(),
        "launches": dict(H.LAUNCHES), "plain": dict(H.PLAIN_CALLS), "device": str(mesh.device),
        "backend": mesh.backend,
    }
    return out


@pytest.mark.gpu
def test_distributed_paths_on_card_match_numpy():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card: python -m pytest --noconftest tests/test_torch_*.py -m gpu")
    out = multihost.run_ranks(card_cases, 2, timeout=600)
    n = (1 << 22) + 3
    x = np.random.default_rng(3).integers(-(2**31), 2**31 - 1, size=n, dtype=np.int32)
    s = np.sort(x)
    assert out["radix"] == s[n // 2 - 1] and out["cgm"] == s[149]
    assert out["many"] == [s[0], s[n // 3 - 1], s[-1]]
    assert out["topk"] == topk_oracle(x, 16, True)[1].tolist()
    assert out["device"] == "cuda:0" and out["backend"] == ("nccl" if torch.cuda.device_count() >= 2 else "gloo")
    assert not any(out["plain"].values())
    for name in ("radix_histogram32", "radix_histogram_multi32", "match_counts32", "tau_counts32"):
        assert out["launches"][name] > 0, name
