"""BENCHMARK.json and the files it names, found by name: a cell is a
workload entry; its configuration's file is the one BENCHMARK.json gives,
its traffic is traffic/<traffic>.json and each metric is read by
metrics/<metric>.py.  Adding a cell, a traffic or a metric adds files and
entries and edits none."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # metric entries of BENCHMARK.json reported with --trace 0
    per_layer: list  # those reported with --trace 1

    def limits(self) -> dict:
        """The correctness limits: the configuration's, then the traffic's."""
        return {**self.config.get("check", {}), **self.traffic.get("check", {})}


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str, pb: Path = HERE) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((pb / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def reader(name: str, pb: Path = HERE):
    """The read(rec) function of metrics/<name>.py."""
    path = pb / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
