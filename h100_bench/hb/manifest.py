"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is the ``file`` its ``configs`` entry names; its
traffic mix is ``traffic/<traffic>.json``, run by the generator of its
``kind``, ``kinds/<kind>.py``; its correctness limits are
``limits/<cell>.json``; a metric's reader is ``metrics/<metric>.py``.
Adding a cell, a mix, a configuration or a metric adds files and entries
and edits none.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Manifest:
    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root, self.bench_dir = Path(root), Path(bench_dir)
        with open(self.root / "BENCHMARK.json") as f:
            self.data = json.load(f)
        self._kinds: dict = {}

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return _load(self.root / c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _load(self.bench_dir / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> dict:
        return _load(self.bench_dir / "limits" / f"{cell}.json")

    def metrics(self, cell: str, traced: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: the end-to-end ones
        untraced, the per-layer ones traced; an entry with ``workloads``
        only in those cells."""
        group = self.data["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
        return _module(self.bench_dir / "metrics" / f"{metric}.py",
                       "hb_metric_" + metric.replace(".", "_")).read

    def kind(self, name: str):
        """The module ``kinds/<name>.py``: a traffic kind's ``setup``,
        ``window``, ``traced_window``, ``release``, ``numbers`` and
        ``stand_in_numbers``, loaded once."""
        if name not in self._kinds:
            self._kinds[name] = _module(
                self.bench_dir / "kinds" / f"{name}.py", "hb_kind_" + name)
        return self._kinds[name]


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)
