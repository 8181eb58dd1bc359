"""The plain references against NumPy at tiny sizes, and the comparison
that decides ``correct`` against the control and the planted faults."""

import math

import numpy as np
import pytest
import torch

from kbench import faults, gen, harness, keyorder, manifest

MAN = manifest.load()
CELLS = [w["name"] for w in MAN["workloads"]]
SMALL = {"n": 1 << 15, "batch": 64, "width": 4096, "ring": 2}  # a size a test run holds, on the CPU


def _cell(name):
    c = manifest.Cell(MAN, name)
    c.config.update({k: v for k, v in SMALL.items() if k in c.config})
    c.params.pop("expect_algorithm", None)  # the dispatch depends on the size: the card's run checks it
    return c


def _np_order(x: np.ndarray) -> np.ndarray:
    """NumPy's key for the port's total order: integers as they are; floats by
    their bits, negatives flipped (so -0.0 < +0.0, NaNs by sign)."""
    if x.dtype.kind in "iu":
        return x.astype(np.int64)
    b = x.view({4: np.int32, 8: np.int64}[x.itemsize]).astype(np.int64)
    return np.where(b < 0, b ^ np.int64({4: 0x7FFFFFFF, 8: 0x7FFFFFFFFFFFFFFF}[x.itemsize]), b)


def test_key_order_is_the_total_order():
    vals = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -1.5, 2e-45, -2e-45], dtype=np.float32)
    keys = keyorder.to_keys(torch.from_numpy(vals)).numpy()
    # -nan, -inf, -1.5, -tiny, -0.0, +0.0, +tiny, 1.5, inf, nan
    assert np.argsort(keys, kind="stable").tolist() == [1, 3, 7, 9, 5, 4, 8, 6, 2, 0]
    back = keyorder.from_keys(torch.from_numpy(keys), torch.float32).numpy()
    assert back.view(np.int32).tolist() == vals.view(np.int32).tolist()
    np.testing.assert_array_equal(np.argsort(keys, kind="stable"), np.argsort(_np_order(vals), kind="stable"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_reference_against_numpy_sort(seed):
    c = _cell("keys-i32-1g.select")
    inputs = c.op.make_inputs(c.config, c.params, seed, "cpu")
    ref = c.reference.Ref(inputs, c.config, c.params, c.config["dtype"])
    s = np.sort(inputs["x"].numpy())
    for k in (1, 150, 250, s.size // 2, s.size):
        assert int(ref.answer(k)) == s[k - 1]
    assert 1 <= s[0] and s[-1] <= 99_999_999


def test_quantile_reference_against_numpy_sort():
    c = _cell("keys-i32-1g.pct99")
    inputs = c.op.make_inputs(c.config, c.params, 5, "cpu")
    ref = c.reference.Ref(inputs, c.config, c.params, c.config["dtype"])
    qs = c.op.Plan(c.config, c.params, 5).query(3)
    s = np.sort(inputs["x"].numpy())
    n = s.size
    want = [s[max(1, min(n, math.ceil(q * n))) - 1] for q in qs]
    assert ref.answer(qs).tolist() == want
    assert len(qs) == 99 and 0.01 <= qs[0] < 0.02 and qs[-1] < 1.0


def _np_topk(x: np.ndarray, k: int):
    """Every row's k largest by the total order, ties by ascending position."""
    key = _np_order(x)
    pos = np.broadcast_to(np.arange(x.shape[1]), x.shape)
    order = np.lexsort((pos, -key), axis=1)[:, :k]
    return np.take_along_axis(x, order, 1), order


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_reference_against_numpy_with_ties(dtype):
    c = _cell("rows-f32-4096x32768.topk8")
    rng = np.random.default_rng(3)
    x = rng.integers(-3, 4, size=(2, 8, 300)).astype(np.float32) / 2  # heavy ties
    x[0, 0, :5] = [-0.0, 0.0, np.inf, -np.inf, np.nan]
    xt = torch.from_numpy(x)
    for k in (1, 8, 50):
        ref = c.reference.Ref({"x": xt, "k": k}, c.config, c.params, dtype)
        xd = xt.to(torch.bfloat16).float() if dtype == "bfloat16" else xt
        for r in range(2):
            v, i = ref.answer(r)
            wv, wi = _np_topk(xd[r].numpy(), k)
            assert i.numpy().tolist() == wi.tolist()
            assert v.numpy().view(np.int32).tolist() == wv.view(np.int32).tolist()


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = harness.run_cell(_cell(cell), 2**31 + 7, 0.2, device="cpu")
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["checks"]["checked_answers"]["value"] > 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, seed):
    """The reference in the configuration's control_dtype, in the port's
    place: at least one number passes its limit."""
    c = _cell(cell)
    ref = c.reference

    def control(inputs):
        ctrl = ref.Ref(inputs, c.config, c.params, c.config["control_dtype"])
        return lambda _inputs, q: ctrl.answer(q)

    r = harness.run_cell(c, seed, 0.2, device="cpu", call_factory=control)
    assert not r["correct"]
    assert any(v["value"] > v["limit"] for v in r["checks"].values() if v["limit"] is not None)


@pytest.mark.parametrize("fault", faults.KINDS)
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault):
    c = _cell(cell)
    r = harness.run_cell(c, 21, 0.2, device="cpu", call_factory=faults.factory(fault, c.op.call))
    assert not r["correct"], (fault, r["checks"])
    assert r["failed"] > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64", "float8_e4m3fn"])
def test_key_order_round_trip_and_order(dtype):
    dt = gen.torch_dtype(dtype)
    x = torch.randn(2000, dtype=torch.float32).to(dt)
    keys = keyorder.to_keys(x)
    assert keyorder.bits_of(keyorder.from_keys(keys.to(torch.int64), dt)).tolist() == keyorder.bits_of(x).tolist()
    wide = x.to(torch.float64)[torch.argsort(keys.to(torch.int64), stable=True)]
    assert bool((wide[1:] >= wide[:-1]).all())
