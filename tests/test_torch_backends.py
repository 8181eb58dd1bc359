"""The port's backends, native runtime, checks, DeviceVector and CLI
against the JAX package's.

- ``seq`` (the host oracle) against the JAX ``seq``: ``kselect``,
  ``kselect_sort``, ``topk``, ``median``;
- ``mpi`` (the native forked-rank CGM) against the JAX ``mpi``, native on
  both sides, and the port's build of its own copy of the C++ source;
- ``DeviceVector`` operation by operation against
  ``mpi_k_selection_tpu.buffer``;
- the messages of ``validate_input``, ``checked_kselect`` and the eager
  ``checkify_kselect``;
- ``plan`` / ``plan_many`` against ``backends/tpu.py``;
- the CLI's ``--backend seq|mpi`` and ``--devices 2 --distribute always``
  (radix and cgm) with ``--device cpu --verify``.

JAX is imported inside the tests only.
"""

from __future__ import annotations

import contextlib
import json
import pathlib

import numpy as np
import pytest
import torch

import mpi_k_selection_tpu_torch as kt
from mpi_k_selection_tpu_torch import cli
from mpi_k_selection_tpu_torch.backends import cuda as cuda_backend, get_backend, mpi as mpi_backend, seq
from mpi_k_selection_tpu_torch.buffer import DeviceVector
from mpi_k_selection_tpu_torch.errors import NativeUnavailableError
from mpi_k_selection_tpu_torch.native import build as native_build, cgm_driver, loader
from mpi_k_selection_tpu_torch.utils import datagen, debug
from mpi_k_selection_tpu_torch.utils.interop import tensor_from_numpy, tensor_to_numpy

PORT = pathlib.Path(kt.__file__).resolve().parent


def host_input(dtype, n=70_001, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return (rng.standard_normal(n) * 1e6).astype(dtype)
    return rng.integers(-(10**6), 10**6, size=n).astype(dtype)


# --- seq --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32, np.float64, np.int16, np.uint32])
@pytest.mark.parametrize("n", [1000, 70_001])  # below and above the native cut-over (2^16)
def test_seq_matches_jax_seq(dtype, n):
    from mpi_k_selection_tpu.backends import seq as jseq

    x = host_input(dtype, n)
    for k in (1, 2, n // 2, n):
        want = jseq.kselect(x, k)
        assert want == np.sort(x)[k - 1]  # the reference path first
        assert seq.kselect(x, k) == want and seq.kselect_sort(x, k) == jseq.kselect_sort(x, k)
    assert seq.median(x) == jseq.median(x)
    for largest in (True, False):
        gv, gi = seq.topk(x, 7, largest=largest)
        wv, wi = jseq.topk(x, 7, largest=largest)
        assert np.array_equal(gv, wv) and np.array_equal(gi, wi)
    xb = x[: 4 * (n // 4)].reshape(4, -1)
    assert all(np.array_equal(a, b) for a, b in zip(seq.topk(xb, 5), jseq.topk(xb, 5)))


def test_seq_rejects_like_jax_seq():
    from mpi_k_selection_tpu.backends import seq as jseq

    x = np.arange(10, dtype=np.int32)
    for fn, jfn, k in ((seq.kselect, jseq.kselect, 0), (seq.kselect_sort, jseq.kselect_sort, 11), (seq.topk, jseq.topk, 11)):
        with pytest.raises(ValueError) as got:
            fn(x, k)
        with pytest.raises(ValueError) as want:
            jfn(x, k)
        assert str(got.value) == str(want.value)


# --- native runtime and mpi -------------------------------------------------------


def test_port_builds_its_own_copy_of_the_native_source():
    src = native_build.SOURCES[0]
    assert src == PORT / "native" / "kselect_native.cpp" and src.exists()
    lib = native_build.build()
    assert lib == native_build.lib_path() and lib.parent == PORT / "_build" and lib.exists()
    assert loader.get_lib() is not None
    # the library's name carries the source's hash: an edited copy builds anew
    assert native_build.lib_path().name.startswith("libkselect_native-")


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32, np.float64])
def test_native_nth_element_matches_jax_native(dtype):
    from mpi_k_selection_tpu.native import loader as jloader

    x = host_input(dtype, 50_001)
    for k in (1, 25_000, 50_001):
        want = jloader.get_lib().nth_element(x, k)
        assert want == np.sort(x)[k - 1]
        assert loader.get_lib().nth_element(x, k) == want
    with pytest.raises(ValueError, match="native nth_element failed"):
        loader.get_lib().nth_element(x, 0)


@pytest.mark.parametrize("num_procs,c", [(2, 500), (4, 500), (4, 50), (7, 500)])
@pytest.mark.parametrize("pattern", ["uniform", "equal", "sequential"])
def test_mpi_matches_jax_mpi(num_procs, c, pattern):
    from mpi_k_selection_tpu.backends import mpi as jmpi
    from mpi_k_selection_tpu.native import cgm_driver as jdriver

    x = datagen.generate(200_003, pattern=pattern, seed=4)
    for k in (1, 150, x.size // 2, x.size):
        want, wrounds, _, wfound = jdriver.kselect_full(x, k, num_procs=num_procs, c=c)
        assert want == np.sort(x)[k - 1]
        got, rounds, _, found = cgm_driver.kselect_full(x, k, num_procs=num_procs, c=c)
        assert (got, rounds, found) == (want, wrounds, wfound)
    assert mpi_backend.median(x, num_procs=num_procs, c=c) == jmpi.median(x, num_procs=num_procs, c=c)


def test_mpi_rejects_like_jax_mpi():
    from mpi_k_selection_tpu.native import cgm_driver as jdriver

    x = np.arange(100, dtype=np.int32)
    cases = [(x.astype(np.int64), 5, 4), (x, 5, 1), (x, 5, 65), (x, 0, 4)]
    for arr, k, procs in cases:
        with pytest.raises(ValueError) as want:
            jdriver.kselect_full(arr, k, num_procs=procs)
        with pytest.raises(ValueError) as got:
            cgm_driver.kselect_full(arr, k, num_procs=procs)
        assert str(got.value) == str(want.value)


def test_native_unavailable_raises_typed_error(monkeypatch):
    monkeypatch.setattr(loader, "get_lib", lambda: None)
    with pytest.raises(NativeUnavailableError, match="native runtime is unavailable"):
        mpi_backend.kselect(np.arange(10, dtype=np.int32), 3)
    x = host_input(np.int32, 70_001)
    assert seq.kselect(x, 5) == np.sort(x)[4]  # the oracle answers with NumPy


def test_backend_registry():
    assert [get_backend(b).NAME for b in ("seq", "cuda", "mpi")] == ["seq", "cuda", "mpi"]
    with pytest.raises(ValueError, match="unknown backend 'tpu'"):
        get_backend("tpu")


# --- DeviceVector -----------------------------------------------------------------


def _same(got, want) -> bool:
    g = tensor_to_numpy(torch.as_tensor(got).reshape(-1))
    w = np.asarray(want).reshape(-1)
    return g.dtype == w.dtype and g.tobytes() == w.tobytes()


def _same_value(got, want) -> bool:
    """Equal dtype and value, NaN equal to NaN (both packages' float
    ``min`` of a vector with dead slots is a NaN: the order-maximal
    identity is one, and a native min propagates it)."""
    g = tensor_to_numpy(torch.as_tensor(got).reshape(-1))
    w = np.asarray(want).reshape(-1)
    return g.dtype == w.dtype and bool(np.array_equal(g.astype(np.float64), w.astype(np.float64), equal_nan=True))


def _vec_state(v) -> tuple:
    return int(v.size), v.capacity


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32"])
def test_device_vector_matches_jax_op_by_op(dtype):
    from mpi_k_selection_tpu.buffer import DeviceVector as JV
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    x = np.array([5, -3, 9, 0, 5, 7, -8, 2], dtype=dtype)
    if dtype == "float32":
        x[3] = -0.0
    with enable_x64() if dtype == "int64" else contextlib.nullcontext():
        steps = [
            ("add", lambda v: v.add(4)),
            ("add past capacity", lambda v: v.add(11).add(12)),
            ("erase", lambda v: v.erase(1)),
            ("erase out of range", lambda v: v.erase(50)),
            ("set", lambda v: v.set(2, 6)),
            ("compact", lambda v: v.compact(np.arange(v.capacity) % 3 != 1)),
            ("sort", lambda v: v.sort()),
        ]
        g, w = DeviceVector.from_array(x, device="cpu"), JV.from_array(x)
        for name, op in steps:
            g, w = op(g), op(w)
            assert _vec_state(g) == _vec_state(w), name
            assert _same(g.to_array(), w.to_array()), name
            assert _same_value(g.min(), w.min()) and _same_value(g.max(), w.max()), name
            assert _same_value(g.sum(), w.sum()), name
            assert float(g.mean()) == pytest.approx(float(w.mean()), rel=1e-6), name  # summation order
            for e in (5, 9, -8, 0, 99):
                assert g.search(e) == int(w.search(e)) and g.search(e, 2) == int(w.search(e, 2)), (name, e)
            assert g.is_full() == bool(w.is_full()), name
        for e in (-8, 0, 5, 12, 3):  # on the sorted vector
            assert g.binary_search(e) == int(w.binary_search(e)), e
        for i in range(int(w.size)):
            assert _same(g.get(i), w.get(i))
        for bad in (-1, int(w.size)):
            with pytest.raises(IndexError) as ge:
                g.get(bad)
            with pytest.raises(IndexError) as we:
                w.get(bad)
            assert str(ge.value) == str(we.value)
        e0, je = DeviceVector.new(4, getattr(torch, dtype), device="cpu"), JV.new(4, dtype)
        assert _same_value(e0.min(), je.min()) and _same_value(e0.max(), je.max())
        assert e0.search(0) == int(je.search(0))


# --- checks -----------------------------------------------------------------------


def _message(fn, *args, **kwargs):
    with pytest.raises(Exception) as e:
        fn(*args, **kwargs)
    return type(e.value), str(e.value)


def test_validate_input_and_checked_kselect_messages_match_jax():
    from mpi_k_selection_tpu.utils import debug as jdebug

    f = np.array([1.0, np.nan, 3.0], np.float32)
    for args in ((np.array([], np.int32), 1), (np.arange(5, dtype=np.int32), 0), (np.arange(5, dtype=np.int32), 6),
                 (f, 1)):
        assert _message(debug.validate_input, *args) == _message(jdebug.validate_input, *args)
    debug.validate_input(f, 1, allow_nan=True)
    x = datagen.generate(20_000, seed=3)
    got = debug.checked_kselect(x, 777, device="cpu")
    assert int(got) == int(jdebug.checked_kselect(x, 777)) == np.sort(x)[776]
    assert _message(debug.checked_kselect, f, 2, device="cpu") == _message(jdebug.checked_kselect, f, 2)


def test_checked_kselect_reports_a_wrong_answer(monkeypatch):
    from mpi_k_selection_tpu_torch import api

    monkeypatch.setattr(api, "kselect", lambda x, k, **kw: x.max())
    with pytest.raises(AssertionError, match=r"selection certificate failed: value .* has rank range \(9, 10\] but k=3"):
        debug.checked_kselect(np.arange(10, dtype=np.int32), 3, device="cpu")


def test_checkify_kselect_raises_the_jax_messages():
    from mpi_k_selection_tpu.utils import debug as jdebug

    x = np.arange(100, dtype=np.int32)[::-1].copy()
    for k in (0, 101):
        err, _ = jdebug.checkify_kselect(x, k)
        with pytest.raises(ValueError) as got:
            debug.checkify_kselect(x, k, device="cpu")
        assert str(got.value) in err.get()
    err, want = jdebug.checkify_kselect(x, 37)
    assert err.get() is None and int(debug.checkify_kselect(x, 37, device="cpu")) == int(want) == 36


# --- plan / plan_many ---------------------------------------------------------------

PLAN_CASES = [
    (n, algorithm, distribute, n_dev)
    for n in (1 << 10, (1 << 14) + 1, 1 << 20)
    for algorithm in ("auto", "radix", "sort", "cgm")
    for distribute in ("auto", "never", "always", "sometimes")
    for n_dev in (1, 2, 4)
]


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_plan_matches_jax_tpu_plan(n_dev):
    from mpi_k_selection_tpu.backends import tpu as jtpu

    for n, algorithm, distribute, nd in PLAN_CASES:
        if nd != n_dev:
            continue
        try:
            want = jtpu.plan(n, algorithm, distribute, n_dev=nd)
        except ValueError as e:
            assert _message(cuda_backend.plan, n, algorithm, distribute, n_dev=nd) == (ValueError, str(e))
            continue
        assert cuda_backend.plan(n, algorithm, distribute, n_dev=nd) == want, (n, algorithm, distribute)


def test_plan_many_matches_jax_on_one_device():
    from mpi_k_selection_tpu.backends import tpu as jtpu

    for n in (1 << 10, 1 << 21):
        for distribute in ("auto", "never", "always", "maybe"):
            # no process group here: the port's plan_many sees one device
            try:
                want = jtpu.plan_many(n, distribute, devices=1)
            except ValueError as e:
                assert _message(cuda_backend.plan_many, n, distribute) == (ValueError, str(e))
                assert _message(cuda_backend.plan, n, "radix", distribute, n_dev=1) == (ValueError, str(e))
                continue
            assert want is None and cuda_backend.plan_many(n, distribute) is None
            assert cuda_backend.plan(n, "radix", distribute, n_dev=1)[1] is False
    assert cuda_backend.group_size() == 1


def test_cuda_backend_entry_points_on_one_device():
    x = datagen.generate(1 << 15, seed=9)
    s = np.sort(x)
    assert int(cuda_backend.kselect(x, 5, distribute="never", device="cpu")) == s[4]
    assert tensor_to_numpy(cuda_backend.kselect_many(tensor_from_numpy(x, "cpu"), [1, 9])).tolist() == [s[0], s[8]]
    assert tensor_to_numpy(cuda_backend.quantiles(tensor_from_numpy(x, "cpu"), [0.5])).tolist() == [s[x.size // 2 - 1]]
    with pytest.raises(ValueError, match="distribute='always' needs >= 2 devices, have 1"):
        cuda_backend.kselect_many(x, [1], distribute="always", device="cpu")


# --- CLI ----------------------------------------------------------------------------


def run_cli(capsys, *argv):
    rc = cli.main(["--json", "--verify", *argv])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return rc, json.loads(out)


@pytest.mark.parametrize("argv,backend,algorithm", [
    (("--backend", "seq", "--k", "250"), "seq", "partition"),
    (("--backend", "seq", "--dtype", "float64", "--gen", "normal"), "seq", "partition"),
    (("--backend", "mpi", "--k", "150"), "mpi", "cgm"),
    (("--backend", "mpi", "--num-procs", "2", "--c", "50"), "mpi", "cgm"),
])
def test_cli_host_backends(capsys, argv, backend, algorithm):
    rc, rec = run_cli(capsys, "--n", "200003", *argv)
    assert rc == 0 and rec["extra"]["exact_match"] is True
    assert (rec["backend"], rec["algorithm"]) == (backend, algorithm)
    if backend == "mpi":
        from mpi_k_selection_tpu.native import cgm_driver as jdriver

        x = datagen.generate(200003, seed=0)
        procs = rec["n_devices"]
        assert rec["rounds"] == jdriver.kselect_full(x, rec["k"], num_procs=procs, c=50 if procs == 2 else 500)[1]


def test_cli_distributed_radix_and_cgm_on_two_ranks(capsys):
    """One test, so the spawns stay few: radix (default k and k=1) and cgm
    (its rounds equal the JAX package's on make_mesh(2))."""
    from mpi_k_selection_tpu.parallel import distributed_cgm_select, make_mesh

    n = 200_003
    rc, rec = run_cli(capsys, "--n", str(n), "--devices", "2", "--distribute", "always", "--device", "cpu")
    assert rc == 0 and rec["extra"]["exact_match"] is True
    # two ranks on the one CPU device: the per-chip rate counts it once
    assert (rec["algorithm"], rec["extra"]["ranks"], rec["n_devices"]) == ("radix-distributed", 2, 1)
    assert rec["extra"]["process_group"] == "gloo"
    assert rec["extra"]["collectives"] > 0
    rc, rec = run_cli(capsys, "--n", str(n), "--devices", "2", "--algorithm", "cgm", "--device", "cpu", "--k", "150")
    assert rc == 0 and rec["extra"]["exact_match"] is True and rec["algorithm"] == "cgm-distributed"
    x = datagen.generate(n, seed=0)
    _, want_rounds = distributed_cgm_select(x, 150, mesh=make_mesh(2), return_rounds=True)
    assert rec["rounds"] == int(want_rounds)


def test_cli_refuses_what_a_backend_cannot_run(capsys):
    for argv, msg in [
        (("--backend", "mpi", "--topk", "5"), "mpi backend runs the k-th mode only"),
        (("--backend", "seq", "--quantiles", "0.5"), "run on the cuda backend"),
        (("--backend", "seq", "--devices", "2"), "--devices runs the cuda backend"),
        (("--devices", "2", "--topk", "3"), "--devices runs the cuda backend"),
        (("--algorithm", "cgm", "--device", "cpu"), "needs >= 2 devices, got 1"),
        (("--distribute", "always", "--device", "cpu"), "needs >= 2 devices, have 1"),
    ]:
        with pytest.raises(SystemExit, match=msg):
            cli.main(["--n", "1000", *argv])


# --- on the card ----------------------------------------------------------------


@pytest.mark.gpu
def test_cli_cgm_on_two_ranks_sharing_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card: python -m pytest --noconftest tests/test_torch_*.py -m gpu")
    n = (1 << 22) + 1
    rc, rec = run_cli(capsys, "--n", str(n), "--devices", "2", "--algorithm", "cgm", "--k", "150")
    x = datagen.generate(n, seed=0)
    assert rc == 0 and rec["answer"] == int(np.partition(x, 149)[149]) and rec["rounds"] > 0
    assert rec["extra"]["process_group"] == ("nccl" if torch.cuda.device_count() >= 2 else "gloo")
    rc, rec = run_cli(capsys, "--n", str(n), "--devices", "2", "--distribute", "always")
    assert rc == 0 and rec["answer"] == int(np.partition(x, n // 2 - 1)[n // 2 - 1])
