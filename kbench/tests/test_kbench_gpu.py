"""The harness on the card at a small size: the port's kernels against the
references, and the traced run's readers. Skips without a card.

    python -m pytest kbench/tests -m gpu
"""

import pytest

from kbench import harness, manifest

MAN = manifest.load()
CELLS = [w["name"] for w in MAN["workloads"]]
# the cells' dispatch legs hold at this size too: at 2^27 keys 99 ranks stay
# below the sort crossover (121), and 512 rows keep row 7's envelope
SMALL = {"n": 1 << 27, "batch": 512, "ring": 2}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _cell(name):
    c = manifest.Cell(MAN, name)
    c.config.update({k: v for k, v in SMALL.items() if k in c.config})
    return c


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    r = harness.run_cell(_cell(cell), 2**32 + 5, 1.0, device=card)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"queries_per_s", "latency_p95_ms", "peak_mem_gib", "setup_s"}
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_traced_cell_on_the_card(card, cell):
    c = _cell(cell)
    r = harness.run_cell(c, 2**32 + 6, 1.0, traced=True, device=card)
    assert r["correct"], r["checks"]
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert set(r["metrics"]) == {m["name"] for m in c.per_layer}
    for m in r["metrics"].values():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100
    assert r["breakdown"]["device_ops"]
