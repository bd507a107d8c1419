"""The benchmark's definition, found by name.

`BENCHMARK.json` names the cells; a cell names a configuration (the file its
entry gives, relative to BENCHMARK.json) and a traffic mix
(`traffic/<traffic>.json`); a configuration names its model family
(`"family"`, no default), whose module `families/<family>.py` makes the
weights, builds the service, declares the conditions a request carries,
recomputes answers and counts an image's operations (`families/__init__.py`);
a metric is read by `metrics/<name>.py` or, where that file is absent, by the
reader of the part of its name before the first dot (`process_roofline.grid`
-> `process_roofline.py`). Families, mixes and readers are looked up in
`portbench/`, after any directories given first. A later change adds a
configuration, a family, a mix or a metric by adding files and entries.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

ROOT = Path(__file__).resolve().parents[2]  # the checkout
BENCH = Path(__file__).resolve().parents[1]  # portbench/
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Spec:
    def __init__(self, path: Optional[Path] = None, first: Sequence[Path] = ()):
        self.path = Path(path) if path else ROOT / "BENCHMARK.json"
        self.dirs = [Path(d) for d in first] + [BENCH]
        self._modules: Dict[tuple, object] = {}
        with open(self.path) as f:
            self.data = json.load(f)
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.cells = {w["name"]: w for w in self.data["workloads"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in {self.path}; "
                           f"cells: {sorted(self.cells)}")
        return self.cells[name]

    def config(self, name: str) -> dict:
        with open(self.path.parent / self.configs[name]["file"]) as f:
            return json.load(f)

    def _find(self, kind: str, name: str) -> Optional[Path]:
        return next((d / kind / name for d in self.dirs if (d / kind / name).exists()), None)

    def _load(self, kind: str, name: str):
        """The module `<kind>/<name>.py`, loaded once; None where absent."""
        if (kind, name) not in self._modules:
            path = self._find(kind, f"{name}.py")
            mod = None
            if path is not None:
                spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
            self._modules[kind, name] = mod
        return self._modules[kind, name]

    def family(self, cfg: dict):
        """The module of the configuration's model family."""
        if "family" not in cfg:
            raise KeyError(f"configuration {cfg.get('name')!r} names no 'family'")
        mod = self._load("families", cfg["family"])
        if mod is None:
            raise FileNotFoundError(f"no family {cfg['family']!r} under {self.dirs}")
        return mod

    def traffic(self, name: str) -> dict:
        path = self._find("traffic", f"{name}.json")
        if path is None:
            raise FileNotFoundError(f"no traffic mix {name!r} under {self.dirs}")
        with open(path) as f:
            return json.load(f)

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The metrics a run of `cell` reports: end to end without a trace,
        per layer with one; each where it has no `workloads` or lists the
        cell."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> Callable:
        for name in (metric, metric.split(".")[0]):
            mod = self._load("metrics", name)
            if mod is not None:
                return mod.read
        raise FileNotFoundError(f"no reader for metric {metric!r} under {self.dirs}")


def problems(data: Dict) -> List[str]:
    """What in a BENCHMARK.json breaks the naming rules (names, units)."""
    out = []
    names = ([c["name"] for c in data["configs"]] + [w["name"] for w in data["workloads"]]
             + [w[k] for w in data["workloads"] for k in ("config", "traffic")]
             + [m["name"] for m in data["end_to_end"] + data["per_layer"]]
             + [k for c in data["configs"] for k in c["reduced"]])
    out += [f"name {n!r}" for n in names if not NAME.match(n)]
    out += [f"unit {m['unit']!r}" for m in data["end_to_end"] + data["per_layer"]
            if not UNIT.match(m["unit"])]
    return out
