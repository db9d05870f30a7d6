"""``BENCHMARK.json`` and the files its names lead to."""

import json
import re
from pathlib import Path

import pytest

from port_bench.bench.cell import BENCH_DIR, load_metric, resolve

ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.load(open(ROOT / "BENCHMARK.json"))


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("port_bench/")
        assert 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert 1 <= len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("workload",
                         [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(workload):
    cell = resolve(ROOT, workload)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.config["reduced"] == []
    assert {"grad_gap", "update_gap", "batch_mismatch"} <= set(cell.limits)
    assert set(cell.limits) <= {"loss_gap", "grad_gap", "update_gap",
                                "batch_mismatch"}
    assert cell.limits["batch_mismatch"] == 0
    for m in cell.metrics(False) + cell.metrics(True):
        reader = load_metric(BENCH_DIR, m["name"])
        assert reader.UNIT == m["unit"] and reader.SOURCE == m["source"]
        if m in BENCH["per_layer"]:
            assert reader.LAYER == m["layer"]
            assert reader.MOVES == m["moves"]
    assert cell.metrics(False) and cell.metrics(True)


def test_a_cell_that_lives_in_another_folder(tiny_root):
    """A cell added by data files alone: the harness finds it by name."""
    bench = Path(tiny_root) / "port_bench"
    cell = resolve(tiny_root, "tiny.sup", bench)
    assert cell.traffic["method"] == "supervised"
    assert cell.config["dims"] == [8, 16, 32, 64]
    with pytest.raises(KeyError):
        resolve(tiny_root, "mamba_unet.train_bs24", bench)


def test_methods_and_model_families_are_found_by_name():
    """A training method is ``drive/<method>.py`` with
    ``reference/<method>.py``, a model family ``reference/<name>.py``:
    a later one comes as new files, found by the names in its data."""
    from port_bench.drive import driver_class
    from port_bench.drive.supervised import Driver
    from port_bench.reference import supervised, vssm
    from port_bench.reference.net import family
    from port_bench.reference.train import method

    assert driver_class("supervised") is Driver
    assert method({"method": "supervised"}) is supervised
    assert family({"reference": "vssm"}) is vssm
    with pytest.raises(ModuleNotFoundError):
        driver_class("no_such_method")
    with pytest.raises(ValueError):
        method({"method": "../train"})
