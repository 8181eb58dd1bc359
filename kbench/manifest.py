"""``BENCHMARK.json`` and the files its names lead to.

A cell ``<c>`` is ``cells/<c>.json``; its configuration ``<g>`` is
``configs/<g>.json``; its op kind ``<k>`` (the cell file's ``op``) is
``ops/<k>.py`` with its reference ``reference/<k>.py``; a per-layer metric
``<m>`` is ``metrics/<m>.py``. Adding a cell, a configuration, an op kind or
a metric adds files and manifest entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re
import sys

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent
MANIFEST = "BENCHMARK.json"

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH_RE = re.compile(r"[A-Za-z0-9_./-]{1,200}")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
E2E_SOURCES = ("device_trace", "host_clock")

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def load(root=ROOT) -> dict:
    return json.loads((pathlib.Path(root) / MANIFEST).read_text())


def bench_dir(root=ROOT) -> pathlib.Path:
    return pathlib.Path(root) / PKG.name


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in {MANIFEST}; it has {[w['name'] for w in manifest['workloads']]}")


def config_entry(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in {MANIFEST}")


def read_json(path: pathlib.Path) -> dict:
    return json.loads(pathlib.Path(path).read_text())


def cell_file(root, name: str) -> pathlib.Path:
    return bench_dir(root) / "cells" / f"{name}.json"


def op_file(root, kind: str) -> pathlib.Path:
    return bench_dir(root) / "ops" / f"{kind}.py"


def reference_file(root, kind: str) -> pathlib.Path:
    return bench_dir(root) / "reference" / f"{kind}.py"


def metric_file(root, name: str) -> pathlib.Path:
    return bench_dir(root) / "metrics" / f"{name}.py"


def load_module(path: pathlib.Path, prefix: str):
    """The Python file at ``path`` as a module (its name may hold dots and
    dashes, so it is loaded by path, once a process)."""
    modname = f"kbench_{prefix}_" + re.sub(r"\W", "_", path.stem)
    mod = sys.modules.get(modname)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload with everything its names lead to: the cell's and the
    configuration's parameters, the op and reference modules, and the
    per-layer metrics that list it (or list no cells)."""

    def __init__(self, manifest: dict, name: str, root=ROOT):
        self.root = pathlib.Path(root)
        self.manifest = manifest
        self.entry = workload(manifest, name)
        self.name = name
        self.chips = int(self.entry["chips"])
        centry = config_entry(manifest, self.entry["config"])
        self.config = read_json(self.root / centry["file"])
        self.params = read_json(cell_file(root, name))
        self.kind = self.params["op"]
        self.op = load_module(op_file(root, self.kind), "op")
        self.reference = load_module(reference_file(root, self.kind), "ref")
        self.end_to_end = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"] if name in m.get("workloads", [name])]

    def metric_reader(self, name: str):
        return load_module(metric_file(self.root, name), "metric")


def _line_ok(text, limit=200) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def problems(manifest: dict, root=ROOT) -> list[str]:
    """Every way ``manifest`` breaks the benchmark's contract that can be
    seen without a run (names, units, keys, counts, files); empty when
    none."""
    out = []
    root = pathlib.Path(root)
    if set(manifest) != TOP_KEYS:
        out.append(f"top-level keys {sorted(manifest)}")
    cmd = manifest.get("command", [])
    if not (1 <= len(cmd) <= 32 and all(_line_ok(w) for w in cmd)):
        out.append("command")
    paths = manifest.get("paths", [])
    if not 1 <= len(paths) <= 16 or any(not PATH_RE.fullmatch(p) or p.startswith("/") or ".." in p.split("/")
                                        for p in paths):
        out.append("paths")
    rs = manifest.get("run_seconds")
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        out.append("run_seconds")

    def under_paths(f):
        return any(f == p or f.startswith(p.rstrip("/") + "/") for p in paths)

    names = []
    for c in manifest.get("configs", []):
        names.append(("config", c.get("name")))
        if set(c) != CONFIG_KEYS:
            out.append(f"config {c.get('name')} keys {sorted(c)}")
        if not under_paths(c.get("file", "")) or not (root / c.get("file", "")).is_file():
            out.append(f"config {c.get('name')} file {c.get('file')}")
        if len(c.get("reduced", [])) > 16 or any(not NAME_RE.fullmatch(k) for k in c.get("reduced", [])):
            out.append(f"config {c.get('name')} reduced")
        if not (_line_ok(c.get("source")) and _line_ok(c.get("why"))):
            out.append(f"config {c.get('name')} source/why")
    files = [c.get("file") for c in manifest.get("configs", [])]
    if len(set(files)) != len(files):
        out.append("two configurations share a file")
    cfg_names = {c.get("name") for c in manifest.get("configs", [])}
    used = set()
    pairs = set()
    for w in manifest.get("workloads", []):
        names.append(("workload", w.get("name")))
        if set(w) != CELL_KEYS:
            out.append(f"workload {w.get('name')} keys {sorted(w)}")
        if w.get("config") not in cfg_names:
            out.append(f"workload {w.get('name')} config {w.get('config')}")
        used.add(w.get("config"))
        if w.get("chips") not in (1, 4):
            out.append(f"workload {w.get('name')} chips")
        if not _line_ok(w.get("why")):
            out.append(f"workload {w.get('name')} why")
        for key in ("config", "traffic"):
            if not NAME_RE.fullmatch(str(w.get(key))):
                out.append(f"workload {w.get('name')} {key}")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            out.append(f"workload {w.get('name')} repeats {pair}")
        pairs.add(pair)
        if not cell_file(root, str(w.get("name"))).is_file():
            out.append(f"workload {w.get('name')} has no cell file")
    if used != cfg_names:
        out.append(f"configurations used by no cell: {sorted(cfg_names - used)}")
    n_cells = len(manifest.get("workloads", []))
    if not 1 <= n_cells <= 24 or not 1 <= len(manifest.get("configs", [])) <= 24:
        out.append("cell or configuration count")
    if sum(w.get("chips") == 4 for w in manifest.get("workloads", [])) > max(1, n_cells // 4):
        out.append("too many four-chip cells")
    cell_names = {w.get("name") for w in manifest.get("workloads", [])}
    e2e = manifest.get("end_to_end", [])
    if not 1 <= len(e2e) <= 16 or "setup_s" not in {m.get("name") for m in e2e}:
        out.append("end_to_end count or setup_s")
    for m in e2e:
        names.append(("metric", m.get("name")))
        if set(m) - {"workloads"} != E2E_KEYS:
            out.append(f"end_to_end {m.get('name')} keys {sorted(m)}")
        if m.get("source") not in E2E_SOURCES:
            out.append(f"end_to_end {m.get('name')} source")
        b = m.get("bound")
        if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
            out.append(f"end_to_end {m.get('name')} bound")
    pl = manifest.get("per_layer", [])
    if not 1 <= len(pl) <= 128:
        out.append("per_layer count")
    e2e_by_name = {m.get("name"): m for m in e2e}
    for m in pl:
        names.append(("metric", m.get("name")))
        if set(m) - {"workloads"} != LAYER_KEYS:
            out.append(f"per_layer {m.get('name')} keys {sorted(m)}")
        if m.get("source") not in SOURCES or not _line_ok(m.get("layer")):
            out.append(f"per_layer {m.get('name')} source/layer")
        moved = e2e_by_name.get(m.get("moves"))
        if moved is None:
            out.append(f"per_layer {m.get('name')} moves {m.get('moves')}")
        for c in m.get("workloads", []):
            if c not in cell_names or (moved is not None and c not in moved.get("workloads", cell_names)):
                out.append(f"per_layer {m.get('name')} cell {c}")
        if not metric_file(root, str(m.get("name"))).is_file():
            out.append(f"per_layer {m.get('name')} has no reader")
    for m in e2e + pl:
        if not UNIT_RE.fullmatch(str(m.get("unit"))) or m.get("better") not in ("lower", "higher"):
            out.append(f"metric {m.get('name')} unit/better")
    for what, name in names:
        if not NAME_RE.fullmatch(str(name)):
            out.append(f"{what} name {name!r}")
    for what in ("config", "workload", "metric"):
        listed = [n for w, n in names if w == what]
        if len(set(listed)) != len(listed):
            out.append(f"two {what}s share a name")
    for w in cell_names:
        reports_e2e = [m for m in e2e if w in m.get("workloads", [w])]
        if len(reports_e2e) < 2 or not any(w in m.get("workloads", [w]) for m in pl):
            out.append(f"workload {w} reports too few metrics")
    if len(json.dumps(manifest)) > 64 * 1024:
        out.append("manifest over 64 KiB")
    return out
