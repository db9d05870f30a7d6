"""One run of one cell: set-up, the window, the check, the result line.

Set-up is everything from the process's start to the window: imports,
the data, the model and its weights, the trainer, the checked steps and
the warm-up. The window drives ``fit`` for ``seconds`` under the
profiler, which records the card's activity; with a trace it drives
``fit`` for ``seconds`` timed by the host's clock alone, then the
traffic's ``trace_steps`` steps under the profiler. After it the peak
memory is read, the program's state is freed, and the reference follows
the checked steps to decide ``correct``.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Dict, Optional, Tuple

from port_bench.bench import check, device as devmod
from port_bench.bench.cell import Cell, load_metric
from port_bench.drive import driver_class


def _log(msg: str) -> None:
    print(f"port_bench: {msg}", file=sys.stderr, flush=True)


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, fault: Optional[str] = None
            ) -> Tuple[int, Optional[Dict]]:
    """(exit code, result) of one run; no result where the run may not
    report one."""
    import torch

    drv = driver_class(cell.traffic["method"])(cell.config, cell.traffic,
                                               seed, device, fault)
    drv.setup()
    record: Dict[str, object] = {"setup_s": time.perf_counter() - t_start}
    _log(f"set-up {record['setup_s']:.3f} s "
         + " ".join(f"{k} {v:.3f}" for k, v in drv.parts.items()))
    record.update(drv.traced_window(seconds, cell.traffic["trace_steps"])
                  if trace else drv.window(seconds))
    tr = record["trace"]
    _log(f"window {record['window_s']:.3f} s, {record['steps']} steps, "
         f"the card busy {tr['busy_s']:.4f} s of {tr['steps']} traced steps")
    if trace:
        _log(f"{tr['untraced_steps']} steps untraced {tr['untraced_s']:.4f} "
             f"s, {tr['steps']} traced {tr['window_s']:.4f} s")
    dev_info = devmod.describe(device, cell.chips)
    found = devmod.forbidden_modules()
    if found:
        _log(f"forbidden modules loaded: {', '.join(found)}")
        return 3, None
    drv.release()

    t = time.perf_counter()
    ref = drv.reference("fp32")
    values = {}
    for name, (v, at) in check.numbers(drv.readings, ref).items():
        values[name] = v
        _log(f"{name} read at {at}")
    values["batch_mismatch"] = float(drv.batch_mismatch())
    correct, report = check.judge(values, cell.limits)
    _log(f"reference {time.perf_counter() - t:.3f} s")

    if trace:
        from port_bench.count.step import step_cost

        record.update(step_cost(cell.config, cell.traffic))
    metrics = {}
    for m in cell.metrics(trace):
        value = load_metric(cell.bench_dir, m["name"]).read(record)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result: Dict[str, object] = {
        "correct": correct, "attempted": record["steps"], "failed": 0,
        "metrics": metrics, "device": dev_info}
    if torch.device(device).type == "cuda":
        dev_info["power_limit_w"] = devmod.power_limit_w()
    if trace:
        tr = record["trace"]
        dev_info["busy_s"] = tr["busy_s"]
        dev_info["window_s"] = tr["window_s"]
        from port_bench.bench.trace import top

        result["breakdown"] = {"device_ops": top(tr["op_s"]),
                               "idle_gaps": top(tr["gap_s"])}
        result["traced_steps_s"] = {
            "untraced": tr["untraced_s"],
            "untraced_steps": tr["untraced_steps"],
            "traced": tr["window_s"], "traced_steps": tr["steps"]}
    result["setup_parts"] = drv.parts
    result["checks"] = report
    found = devmod.forbidden_modules()
    if found:
        _log(f"forbidden modules loaded: {', '.join(found)}")
        return 3, None
    for name, r in report.items():
        _log(f"check {name} {r['value']} limit {r['limit']}")
    return 0, result
