"""The inputs a run makes from its seed and hands to the program and to
the reference alike.

:func:`phantom_slices` - the training set: cardiac-like phantom slices
(after the phantom of the program's ``data/synthetic.py``: an LV-like disk
(class 3) inside a myocardium-like ring (class 2), an RV-like crescent
(class 1) beside them, class intensities over a noisy background),
drawn for all slices at once in chunks.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_CHUNK = 128


def stream_seed(seed: int, *stream: int) -> int:
    """63 bits of SeedSequence([seed, *stream])."""
    return int(np.random.SeedSequence([seed, *stream]).generate_state(
        1, np.uint64)[0]) >> 1


def phantom_slices(n: int, h: int, w: int, seed: int, device="cpu"
                   ) -> Dict[str, np.ndarray]:
    """``image`` (n, h, w) float32 in [0, 1], ``label`` (n, h, w) int64,
    drawn on ``device`` in chunks and returned on the host."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, 2))

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)

    size = min(h, w)
    cy = h / 2 + uniform(-h / 8, h / 8)
    cx = w / 2 + uniform(-w / 8, w / 8)
    r_lv = size * uniform(0.06, 0.10)
    r_myo = r_lv + size * uniform(0.04, 0.07)
    rv_cx = cx - r_myo * uniform(1.1, 1.5)
    r_rv = r_myo * uniform(0.7, 1.0)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    image = np.empty((n, h, w), np.float32)
    label = np.empty((n, h, w), np.int64)
    for s in range(0, n, _CHUNK):
        e = min(n, s + _CHUNK)

        def col(a):
            return a[s:e, None, None]

        r = torch.hypot(yy - col(cy), xx - col(cx))
        lab = torch.zeros((e - s, h, w), dtype=torch.long, device=device)
        lab[r < col(r_myo)] = 2
        lab[r < col(r_lv)] = 3
        rv = torch.hypot(yy - col(cy), xx - col(rv_cx)) < col(r_rv)
        lab[rv & (lab == 0)] = 1
        img = 0.2 + 0.15 * torch.randn((e - s, h, w), generator=gen,
                                       device=device)
        img = img + 0.3 * (lab == 1) + 0.5 * (lab == 2) + 0.9 * (lab == 3)
        image[s:e] = img.clamp(0, 1).cpu().numpy()
        label[s:e] = lab.cpu().numpy()
    return {"image": image, "label": label}
