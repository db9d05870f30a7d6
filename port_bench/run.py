"""Run one cell of the benchmark of ``mamba_unet_torch`` once.

    python3 port_bench/run.py --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; its last key, ``checks``, holds
each number the correctness check compared with its limit, which also
end standard error. Without the CUDA devices the cell asks for it exits
with code 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from port_bench.bench import device as devmod
    from port_bench.bench.cell import resolve

    cell = resolve(ROOT, args.workload)
    devmod.set_cache_dirs(ROOT)
    devmod.require_chips(cell.chips)
    import torch

    # one intra-op thread: the run's host work is the training loop and
    # the loader's thread, and no torch operation on the host needs a pool
    torch.set_num_threads(1)
    from port_bench.bench.runner import execute

    code, result = execute(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    raise SystemExit(main())
