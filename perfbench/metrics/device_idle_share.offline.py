"""device_idle_share.offline: the share of a whole profiled window of 2
steps (pose_from_crops) in which the card ran no kernel and no copy, in percent:
1 - (union of the device intervals) / (the window's host wall)."""

from perfbench import stats, trace


def read(rec):
    win = rec.get("idle")
    if win is None or not win.whole:
        return None
    busy = trace.union_seconds([(s, e) for _, s, e in win.kernels + win.copies])
    return stats.idle_share_pct(busy, win.wall_s)
