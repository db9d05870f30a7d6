"""A benchmark of a tiny cell laid out in a folder of its own: the harness
finds it by name there, as it finds the real cells, and runs it on the
CPU. The tiny model keeps the real one's structure (four stages, 14 -> 7
SS2D calls) at widths and sizes a test can hold; it runs in fp32,
against limits set for fp32 on both sides."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent

TINY_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-3,
               "batch_mismatch": 0}


def lay_out(root: Path) -> Path:
    """Write ``root/BENCHMARK.json`` and ``root/port_bench/{configs,
    traffic,limits,metrics}`` for the cell ``tiny.sup``; returns the
    benchmark folder."""
    bench = Path(root) / "port_bench"
    shutil.copytree(BENCH / "metrics", bench / "metrics",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for d in ("configs", "traffic", "limits"):
        (bench / d).mkdir(parents=True, exist_ok=True)
    cfg = _load(BENCH / "configs" / "mamba_unet.json")
    cfg.update(name="tiny", dims=[8, 16, 32, 64], depths=[1, 1, 1, 1],
               img_size=32, source="test", assumed=[])
    _dump(bench / "configs" / "tiny.json", cfg)
    sup = _load(BENCH / "traffic" / "train_bs24.json")
    sup.update(slices=24, native_size=[40, 36], batch_size=4,
               patch_size=[32, 32], bf16=False, warmup_steps=1,
               trace_steps=2)
    _dump(bench / "traffic" / "sup.json", sup)
    _dump(bench / "limits" / "tiny.sup.json", TINY_LIMITS)
    real = _load(BENCH.parent / "BENCHMARK.json")
    real["configs"] = [dict(name="tiny", source="test",
                            file="port_bench/configs/tiny.json", reduced=[],
                            why="test")]
    real["workloads"] = [dict(name="tiny.sup", config="tiny", traffic="sup",
                              chips=1, why="test")]
    _dump(Path(root) / "BENCHMARK.json", real)
    return bench


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _dump(path: Path, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
