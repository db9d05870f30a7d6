#!/usr/bin/env python3
"""Time two versions of the grouped and folded scan kernels on one card, in
turns.

    python3 scripts/compare_scan.py OLD_ROOT [NEW_ROOT]

OLD_ROOT and NEW_ROOT each hold a copy of the repository (its
``mamba_unet_torch`` package and ``chip_smoke.py``; NEW_ROOT defaults to
this one); for another commit, unpack it with ``git archive <rev> | tar -x
-C <dir>`` into a directory that ``.gitignore`` lists. Each version runs in
a process of its own, in the order old, new, new, old, and times its own
wrappers on the same seeded inputs (fp32): the grouped serving forward
(``selective_scan_grouped``), state-saving forward and backward (G = 4) and
the folded ones (bidirectional) at the four stage shapes of the 224² model
at bs24, and the grouped ones at mamba-130m's shape (batch 8, L = 1024,
dg = 1536; the serving forward there is a scoring call). Prints each
turn's ms per call, then per version and kernel the mean ms per stage-0
call, per forward or train step (14 calls) and per mamba-130m call. Needs
a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KINDS = ("serve", "fwd_states", "bwd")

# run in each version's root: its chip_smoke's inputs and timer, its
# wrappers; prints {"kernel L dg": ms per call}
TIMING = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from mamba_unet_torch.ops import selective_scan_folded as sf
from mamba_unet_torch.ops import selective_scan_grouped as sg

dev = torch.device("cuda", 0)
out = {}

def cotangent(shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(1)
                       ).to(dev)

def time_all(tag, serve, fwd_states, bwd, a, gy_shape, bsz, L, dg):
    out[f"{tag}_serve {bsz} {L} {dg}"] = cs.device_ms(
        torch, lambda: serve(*a), 20)[0]
    out[f"{tag}_fwd_states {bsz} {L} {dg}"] = cs.device_ms(
        torch, lambda: fwd_states(*a), 20)[0]
    _, c = fwd_states(*a)
    gy = cotangent(gy_shape)
    out[f"{tag}_bwd {bsz} {L} {dg}"] = cs.device_ms(
        torch, lambda: bwd(*a, c, gy), 20)[0]

shapes = [(cs.TRAIN_BATCH, L, 4, dg) for L, dg, _ in cs.STAGES]
for bsz, L, G, dg in shapes + [(8, 1024, 1, cs.LM_DINNER)]:
    a = cs.grouped_args(torch, bsz, L, G, dg, torch.float32, dev, 0)
    time_all("grouped", sg.selective_scan_grouped,
             sg.selective_scan_grouped_fwd_states,
             sg.selective_scan_grouped_bwd, a, a[0].shape, bsz, L, dg)
    del a
for bsz, L, _, dg in shapes:
    a = cs.folded_args(torch, bsz, L, dg, torch.float32, dev, 0)
    time_all("folded", sf.selective_scan_folded_fwd,
             sf.selective_scan_folded_fwd_states,
             sf.selective_scan_folded_bwd, a, a[1].shape, bsz, L, dg)
    del a
torch.cuda.empty_cache()
print(json.dumps(out))
"""


def run(root: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", TIMING], cwd=root,
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"timing in {root} failed:\n{proc.stdout}\n"
                         f"{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("compare_scan: needs a CUDA card")
    if len(argv) not in (2, 3):
        raise SystemExit(__doc__)
    roots = {"old": Path(argv[1]).resolve(),
             "new": Path(argv[2]).resolve() if len(argv) == 3 else ROOT}
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs = {"old": [], "new": []}
    for turn, tag in enumerate(("old", "new", "new", "old")):
        times = run(roots[tag])
        runs[tag].append(times)
        print(f"[compare] turn={turn} version={tag} " + " ".join(
            f"{k.replace(' ', '_')}={v:.4f}" for k, v in times.items()),
            flush=True)
    calls = {(chip_smoke.TRAIN_BATCH, L, dg): n
             for L, dg, n in chip_smoke.STAGES}
    lm = f"8 1024 {chip_smoke.LM_DINNER}"
    for tag, turns in runs.items():
        mean = {k: sum(t[k] for t in turns) / len(turns) for k in turns[0]}
        fields = {}
        for kernel in (f"{layout}_{kind}" for layout in ("grouped", "folded")
                       for kind in KINDS):
            per_step = 0.0
            for key, ms in mean.items():
                name, bsz, L, dg = key.split()
                shape = (int(bsz), int(L), int(dg))
                if name == kernel and shape in calls:
                    per_step += calls[shape] * ms
            stage0 = f"{kernel} {chip_smoke.TRAIN_BATCH} 3136 192"
            fields[f"{kernel}_stage0_ms"] = f"{mean[stage0]:.4f}"
            fields[f"{kernel}_per_14_ms"] = f"{per_step:.4f}"
            if f"{kernel} {lm}" in mean:
                fields[f"{kernel}_lm_ms"] = f"{mean[f'{kernel} {lm}']:.4f}"
        print(f"[compare] version={tag} root={roots[tag]} " + " ".join(
            f"{k}={v}" for k, v in fields.items()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
