"""A cell's files, found by the names in ``BENCHMARK.json``.

For the workload ``<config>.<traffic>``:

* ``configs/<config>.json`` - the model: registry name, widths, source,
  ``assumed`` and ``reduced``, and which plain reference follows it;
* ``traffic/<traffic>.json`` - the training job: its method, batch,
  data set and trainer settings, and how many steps the check follows;
* ``limits/<workload>.json`` - the limit of each number the check
  compares;
* ``metrics/<metric>.py`` - one reader per metric (``read(record)``,
  ``UNIT``, ``LAYER``, ``MOVES``, ``SOURCE``).

Everything is relative to the benchmark's folder, so a test can lay out a
cell of its own elsewhere.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: Path

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics this cell reports: the end-to-end ones, or with
        ``trace`` the per-layer ones."""
        return self.per_layer if trace else self.end_to_end


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def resolve(root: Path, workload: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json``; raises
    ``KeyError`` for a name it does not hold and ``FileNotFoundError``
    for a file that is missing."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(Path(root) / configs[w["config"]]["file"])
    return Cell(workload=w, config=config,
                traffic=_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                limits=_json(bench_dir / "limits" / f"{workload}.json"),
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"],
                bench_dir=bench_dir)


def load_metric(bench_dir: Path, name: str) -> ModuleType:
    """``metrics/<name>.py`` as a module (a name may hold dots)."""
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{name.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
