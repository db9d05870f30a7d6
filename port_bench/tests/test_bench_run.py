"""Whole runs of the tiny cells on the CPU, past the harness's look for a
chip: the result line, the check passing on the sound program and
failing with the timed path broken underneath or with the control in
the program's place."""

import json
import subprocess
import sys
import time

import pytest

from port_bench.bench import check
from port_bench.bench.cell import resolve
from port_bench.bench.runner import execute
from port_bench.drive import driver_class

SEED = 2 ** 31 + 4321  # more than 32 signed bits hold


def _cell(tiny_root, name):
    return resolve(tiny_root, name, tiny_root / "port_bench")


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_prints_its_result(tiny_root, trace):
    cell = _cell(tiny_root, "tiny.sup")
    code, result = execute(cell, SEED, 1.0, trace, "cpu",
                           time.perf_counter())
    assert code == 0
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(result)
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["checks"]) == set(cell.limits)
    # no device here: the metrics read from the card's trace find nothing
    want = {m["name"] for m in cell.metrics(trace)
            if m["source"] != "device_trace"}
    assert set(result["metrics"]) == want
    if trace:
        assert want == {"loader_wait_ms.train", "wall_samples_per_s.train"}
        assert {"device_ops", "idle_gaps"} == set(result["breakdown"])
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        assert want == {"setup_s"}
    json.dumps(result)


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "altered"])
def test_a_broken_step_is_not_correct(tiny_root, fault):
    cell = _cell(tiny_root, "tiny.sup")
    code, result = execute(cell, SEED, 0.5, False, "cpu",
                           time.perf_counter(), fault=fault)
    assert code == 0
    assert result["correct"] is False


def test_the_control_is_not_correct(tiny_root):
    """The reference in the program's place, its products' operands in
    float8: the nearest precision below the configuration's."""
    cell = _cell(tiny_root, "tiny.sup")
    drv = driver_class(cell.traffic["method"])(cell.config, cell.traffic,
                                               SEED + 1, "cpu")
    drv.build()
    drv.release()
    ref = drv.reference("fp32")
    values = {k: v for k, (v, _) in
              check.numbers(drv.reference("fp8"), ref).items()}
    values["batch_mismatch"] = 0.0
    correct, _ = check.judge(values, cell.limits)
    assert not correct


def test_the_command_refuses_without_a_card(tmp_path):
    """In a checkout without the program, or on a machine without the
    card, the command prints no result and exits non-zero."""
    from port_bench.bench.cell import BENCH_DIR

    proc = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload",
         "mamba_unet.train_bs24", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
