"""The manifest against the benchmark's contract, and every name against
its file."""

import json
import pathlib
import shutil

import pytest

from kbench import harness, manifest

MAN = manifest.load()
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_manifest_meets_the_contract():
    assert manifest.problems(MAN) == []


@pytest.mark.parametrize("name", [c["name"] for c in MAN["configs"]] + CELLS + [m["name"] for m in METRICS]
                         + [w[k] for w in MAN["workloads"] for k in ("config", "traffic")]
                         + [k for c in MAN["configs"] for k in c["reduced"]])
def test_name_characters(name):
    assert manifest.NAME_RE.fullmatch(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_unit_characters(metric):
    assert manifest.UNIT_RE.fullmatch(metric["unit"]), metric["unit"]


def test_names_and_units_refuse_what_the_contract_refuses():
    for bad in ("has space", "a,b", "a/b", "µs", "", "-lead", "x" * 65):
        assert not manifest.NAME_RE.fullmatch(bad), bad
    for bad in ("tokens per second", "µs", "", "x" * 17):
        assert not manifest.UNIT_RE.fullmatch(bad), bad


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = manifest.Cell(MAN, cell)
    assert manifest.cell_file(manifest.ROOT, cell).is_file()
    assert manifest.op_file(manifest.ROOT, c.kind).is_file()
    assert manifest.reference_file(manifest.ROOT, c.kind).is_file()
    for fn in ("make_inputs", "call", "least_bytes"):
        assert callable(getattr(c.op, fn))
    assert hasattr(c.op, "Plan") and hasattr(c.op, "KEEP_ALL")
    assert hasattr(c.reference, "Ref") and callable(c.reference.compare) and c.reference.LIMITS
    assert c.config["name"] == c.entry["config"]
    assert c.config["control_dtype"] != c.config["dtype"]
    assert c.params["why"] and len(c.entry["why"]) <= 200
    assert {m["name"] for m in c.end_to_end} == {"queries_per_s", "latency_p95_ms", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_metric_resolves_to_its_reader(metric):
    c = manifest.Cell(MAN, metric["workloads"][0])
    assert callable(c.metric_reader(metric["name"]).read)


@pytest.mark.parametrize("config", MAN["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_source_and_cut(config):
    f = manifest.read_json(manifest.ROOT / config["file"])
    assert f["name"] == config["name"] and f["source"] == config["source"]
    assert f["reduced"] == config["reduced"] and f["assumed"] and f["guarantees"]


def test_adding_a_cell_needs_no_edit(tmp_path):
    """A new cell is a new cell file and a new manifest entry: the harness
    finds and runs it, and no file that was there changes."""
    shutil.copytree(manifest.PKG, tmp_path / "kbench", ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads(json.dumps(MAN))
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "kbench").rglob("*") if p.is_file()}
    (tmp_path / "kbench" / "cells" / "keys-i32-1g.k1.json").write_text(json.dumps(
        {"op": "kselect", "loop": "closed, one caller", "first_ks": [1], "why": "the minimum, then uniform ranks"}))
    man["workloads"].append({"name": "keys-i32-1g.k1", "config": "keys-i32-1g", "traffic": "k1", "chips": 1,
                             "why": "k = 1 then uniform ranks"})
    for m in man["per_layer"]:
        if m["name"] == "device.idle_pct":
            m["workloads"].append("keys-i32-1g.k1")
    (tmp_path / manifest.MANIFEST).write_text(json.dumps(man))
    assert manifest.problems(manifest.load(tmp_path), tmp_path) == []
    cell = manifest.Cell(manifest.load(tmp_path), "keys-i32-1g.k1", tmp_path)
    cell.config["n"] = 1 << 15
    r = harness.run_cell(cell, 12, 0.2, device="cpu")
    assert r["correct"] and r["attempted"] > 1
    after = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "kbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert {k: v for k, v in after.items() if k in before} == before


def test_manifest_problems_are_found(tmp_path):
    man = json.loads(json.dumps(MAN))
    man["end_to_end"][0]["bound"] = 0.5
    man["workloads"][0]["why"] = "two\nlines"
    man["per_layer"][0]["unit"] = "per cent"
    found = manifest.problems(man)
    assert any("bound" in p for p in found) and any("why" in p for p in found)
    assert any("unit" in p for p in found)
