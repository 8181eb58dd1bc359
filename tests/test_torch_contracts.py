"""The torch contract checks (``analysis/contracts.py``, KSC101-KSC105).

Their CPU halves run here on the plain versions; the ``gpu`` tests run
the same checks on the CUDA kernels:

    python -m pytest --noconftest tests/test_torch_*.py -m gpu

Each check also catches what it exists to catch: a missing or stale
budget row, a read over budget, a trail that differs between two sizes,
an unsanctioned crossing and a stale sanctioned site.
"""

from __future__ import annotations

import pytest
import torch

from mpi_k_selection_tpu_torch import resource_protocols as rp
from mpi_k_selection_tpu_torch.analysis import contracts as C
from mpi_k_selection_tpu_torch.analysis import placement

torch.set_num_threads(1)

IDS = [c.id for c in C.CONTRACT_CHECKS]


def _check(cid):
    return next(c for c in C.CONTRACT_CHECKS if c.id == cid)


def test_the_five_checks_are_registered():
    assert IDS == ["KSC101", "KSC102", "KSC103", "KSC104", "KSC105"]


@pytest.mark.parametrize("cid", IDS)
def test_cpu_half_passes(cid):
    findings = _check(cid).run("cpu")
    assert findings == [], [f.message for f in findings]


@pytest.mark.gpu
@pytest.mark.parametrize("cid", IDS)
def test_cuda_half_passes(cid):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card: python -m pytest --noconftest tests/test_torch_*.py -m gpu")
    findings = _check(cid).run("cuda")
    assert findings == [], [f.message for f in findings]


def test_launch_trails_are_recorded():
    assert _check("KSC103").run("cpu") == []
    lengths = C.DETAILS["KSC103"]["trail_lengths"]
    assert all(v >= 1 for v in lengths.values())
    assert lengths["radix_select"] == 8  # 32-bit keys, 4-bit digits, no cutover at this n


def test_census_catches_budget_drift(monkeypatch):
    budgets = dict(C.HOST_READ_BUDGETS)
    del budgets["sketch"]
    budgets["stale"] = 1
    budgets["collect"] = 1  # a collect reads its count, then its survivors
    monkeypatch.setattr(C, "HOST_READ_BUDGETS", budgets)
    messages = sorted(f.message for f in _check("KSC104").run("cpu"))
    assert any("sketch has no host-read budget" in m for m in messages)
    assert any("budget row stale names no streamed program" in m for m in messages)
    assert any(m.startswith("collect at 4096 words reads 2 times, budget 1") for m in messages)


def test_trail_check_catches_a_size_dependent_route(monkeypatch):
    calls = []
    real = C._consume

    def uneven(programs, x, device):
        out = real(programs, x, device)
        calls.append(x.numel())
        if x.numel() == C.BUCKETS[1]:
            out["collect"] = out["collect"] * 2
        return out

    monkeypatch.setattr(C, "_consume", uneven)
    messages = [f.message for f in _check("KSC103").run("cpu")]
    assert any(m.startswith("streamed collect: trail") for m in messages), messages


def test_placement_agreement_catches_unsanctioned_and_stale_sites(monkeypatch):
    sites = dict(rp.SANCTIONED_TRANSFER_SITES)
    del sites["streaming/executor.py"]
    sites["ops/radix.py"] = "no crossing lives here"
    monkeypatch.setattr(rp, "SANCTIONED_TRANSFER_SITES", sites)
    placement._CACHE.clear()
    try:
        messages = [f.message for f in _check("KSC105").run("cpu")]
    finally:
        placement._CACHE.clear()
    assert any("unsanctioned site" in m for m in messages)
    assert any("lists ops/radix.py, which has no crossing site" in m for m in messages)


def test_counter_width_refuses_a_2_31_bucket():
    from mpi_k_selection_tpu_torch.ops.cuda.sweep_ingest import sweep_ingest

    with pytest.raises(ValueError, match="2\\^31"):
        sweep_ingest(torch.empty(1 << 31, dtype=torch.int32, device="meta"), 0, hist_prefixes=[0])


def test_a_crash_is_a_finding():
    check = C.ContractCheck("KSC999", "t", "r", lambda device: 1 / 0)
    [f] = check.run("cpu")
    assert f.rule == "KSC999" and "ZeroDivisionError" in f.message
