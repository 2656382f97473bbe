"""The benchmark's arithmetic on what a run measured."""

from __future__ import annotations

import math
from typing import Sequence


def rate(count: int, seconds: float) -> float:
    """Work a second over the whole window: every unit done, all the time."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return count / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between order
    statistics (numpy's default), over every sample and not over chunks."""
    v = sorted(values)
    if not v:
        raise ValueError("no samples")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def idle_share_pct(busy_s: float, window_s: float) -> float:
    """Share of the window in which the device ran nothing, in percent."""
    return 100.0 * (1.0 - busy_s / window_s)


def roofline_pct(flops: float, bytes_moved: float, device_s: float, peak_flops: float,
                 peak_bytes_s: float) -> float:
    """The least time the work could take on the chip (the larger of its
    operations over the peak rate and its bytes over the peak bandwidth)
    over the device time it took, in percent."""
    return 100.0 * max(flops / peak_flops, bytes_moved / peak_bytes_s) / device_s


def mfu_pct(flops_per_unit: float, units_per_s: float, peak_flops: float) -> float:
    """Achieved share of the chip's peak operation rate, in percent."""
    return 100.0 * flops_per_unit * units_per_s / peak_flops
