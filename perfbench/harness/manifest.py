"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
configuration's ``file`` is under ``perfbench/configs/``, the mix is
``perfbench/traffic/<traffic>.json`` and each metric's reader is
``perfbench/metrics/<name>.py``. Nothing here lists them: a later change
adds a cell, a configuration, a mix or a reader by adding files and
entries.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(manifest: Dict, name: str) -> Dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"({[w['name'] for w in manifest['workloads']]})")


def config(manifest: Dict, name: str, root: Path = ROOT) -> Dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, bench: Path = BENCH) -> Dict:
    return json.loads((bench / "traffic" / f"{name}.json").read_text())


def metrics_of(manifest: Dict, cell: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it, and those that list no cells."""
    return [m for m in manifest[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str, bench: Path = BENCH) -> Callable:
    """``read(run) -> float | None`` of ``perfbench/metrics/<name>.py``."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def problems(manifest: Dict) -> List[str]:
    """What breaks the manifest's rules of names, units and wiring (empty
    when it is sound)."""
    out: List[str] = []
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    names = [m["name"] for m in metrics]
    for kind, items in (("config", manifest["configs"]),
                        ("workload", manifest["workloads"]),
                        ("metric", metrics)):
        seen = set()
        for it in items:
            if not NAME.match(it["name"]):
                out.append(f"{kind} name {it['name']!r}")
            if it["name"] in seen:
                out.append(f"duplicate {kind} {it['name']!r}")
            seen.add(it["name"])
    for m in metrics:
        if not UNIT.match(m["unit"]):
            out.append(f"unit {m['unit']!r} of {m['name']}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"better of {m['name']}")
    cells = {w["name"]: w for w in manifest["workloads"]}
    configs = {c["name"] for c in manifest["configs"]}
    for w in manifest["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.match(w[key]):
                out.append(f"{key} {w[key]!r} of {w['name']}")
        if w["config"] not in configs:
            out.append(f"config {w['config']!r} of {w['name']}")
        if not (BENCH / "traffic" / f"{w['traffic']}.json").exists():
            out.append(f"no traffic file for {w['name']}")
    for name in names:
        if not (BENCH / "metrics" / f"{name}.py").exists():
            out.append(f"no reader for {name}")
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        moved = e2e.get(m["moves"])
        if moved is None:
            out.append(f"{m['name']} moves {m['moves']!r}, no such metric")
            continue
        for cell in m.get("workloads", list(cells)):
            if cell not in cells:
                out.append(f"{m['name']} lists no cell {cell!r}")
            elif "workloads" in moved and cell not in moved["workloads"]:
                out.append(f"{m['name']} in {cell}, which does not report "
                           f"{m['moves']}")
    for cell in cells:
        got = {m["name"] for m in metrics_of(manifest, cell, "end_to_end")}
        if "setup_s" not in got or len(got) < 2:
            out.append(f"{cell} reports {sorted(got)}")
        if not metrics_of(manifest, cell, "per_layer"):
            out.append(f"{cell} reports no per-layer metric")
    return out

