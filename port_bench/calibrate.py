"""The readings that a cell's limits are set from, on the card.

    python3 port_bench/calibrate.py --workload <name> --seeds 11 12 ... \\
        [--control 3] [--faults half_batch] [--fault-seeds 3] \\
        [--out readings.jsonl]

For each seed: the program's checked steps (no window) and the
reference's, in fp32; for the first ``--control`` seeds also the
control, the reference in the program's place with its products' operands
in float8 e4m3 (the nearest precision below the configuration's bf16);
for the first ``--fault-seeds`` seeds the program with each of
``--faults`` planted. One JSON line per reading: each compared number
and the leaf or step it was read at.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _line(out, **kw) -> None:
    text = json.dumps(kw)
    print(text, flush=True)
    if out is not None:
        out.write(text + "\n")
        out.flush()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from port_bench.bench import check
    from port_bench.bench import device as devmod
    from port_bench.bench.cell import resolve

    cell = resolve(ROOT, args.workload)
    devmod.set_cache_dirs(ROOT)
    devmod.require_chips(cell.chips)
    from port_bench.drive import driver_class

    cls = driver_class(cell.traffic["method"])
    out = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(args.seeds):
            t = time.perf_counter()
            drv = cls(cell.config, cell.traffic, seed, "cuda")
            drv.setup(warmup=False)
            drv.release()
            t_prog = time.perf_counter() - t
            t = time.perf_counter()
            ref = drv.reference("fp32")
            t_ref = time.perf_counter() - t
            nums = check.numbers(drv.readings, ref)
            _line(out, workload=cell.name, seed=seed, kind="program",
                  batch_mismatch=drv.batch_mismatch(),
                  numbers={k: list(v) for k, v in nums.items()},
                  losses=drv.readings["losses"], ref_losses=ref["losses"],
                  program_s=t_prog, reference_s=t_ref)
            if i < args.control:
                t = time.perf_counter()
                ctl = drv.reference("fp8")
                nums = check.numbers(ctl, ref)
                _line(out, workload=cell.name, seed=seed, kind="control",
                      numbers={k: list(v) for k, v in nums.items()},
                      losses=ctl["losses"], seconds=time.perf_counter() - t)
            if i < args.fault_seeds:
                for fault in args.faults:
                    bad = cls(cell.config, cell.traffic, seed, "cuda",
                              fault)
                    bad.setup(warmup=False)
                    bad.release()
                    bad._ref_batches = drv.reference_batches()
                    nums = check.numbers(bad.readings, ref)
                    _line(out, workload=cell.name, seed=seed,
                          kind=f"fault:{fault}",
                          batch_mismatch=bad.batch_mismatch(),
                          numbers={k: list(v) for k, v in nums.items()},
                          losses=bad.readings["losses"])
            del drv
    finally:
        if out is not None:
            out.close()
    found = devmod.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
