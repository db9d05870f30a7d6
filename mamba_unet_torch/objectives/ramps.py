"""Consistency-weight ramp schedules (host-side scalars).

Copied from ``mamba_unet_tpu/objectives/ramps.py`` (the reference's
``utils/ramps.py``). The semi-supervised methods weight their consistency
term by ``0.1 * sigmoid_rampup(iter // 150, 200)``.
"""

from __future__ import annotations

import math


def sigmoid_rampup(current: float, rampup_length: float) -> float:
    """exp(-5 (1 - t)²) ramp from the mean-teacher paper."""
    if rampup_length == 0:
        return 1.0
    t = min(max(current, 0.0), rampup_length) / rampup_length
    return float(math.exp(-5.0 * (1.0 - t) ** 2))


def linear_rampup(current: float, rampup_length: float) -> float:
    if current >= rampup_length:
        return 1.0
    return max(current, 0.0) / rampup_length


def cosine_rampdown(current: float, rampdown_length: float) -> float:
    assert 0 <= current <= rampdown_length
    return float(0.5 * (math.cos(math.pi * current / rampdown_length) + 1))
