"""What a traced run records: spans by CUDA events, profiler windows, syncs.

Spans are the benchmark's own, around calls into the program's layers.
A profiler window is judged whole when it kept at least one device kernel
for each kernel launch the host made in it: torch.profiler has been seen
to drop device records, and a window that lost some would under-count
device time. Each try holds its window open a little longer after the
synchronize; a window no try keeps whole is reported as missing.
"""

from __future__ import annotations

import bisect
import statistics
import time
import warnings
from typing import Callable, Dict, List

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")
PADS = (0.2, 0.5, 1.0, 2.0, 3.0, 5.0)
SYNC_WARNING = "called a synchronizing CUDA operation"


def span_ms(fn: Callable[[], object], reps: int) -> float:
    """Milliseconds of one call of `fn`: the median of `reps` calls, each
    between two CUDA events (after one untimed call)."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Window:
    """One whole profiler window: device intervals (kernels and copies, in
    seconds on the profiler's clock), host launch calls, the harness spans
    (record_function) on the host, and the host wall of the calls."""

    def __init__(self, events, wall_s: float):
        from torch.autograd import DeviceType

        self.wall_s = wall_s
        # record_function ranges also appear on the device's timeline.
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("perfbench.")]
        self.kernels = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
                        for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
        self.copies = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
                       for e in dev if e.name.startswith(("Memcpy", "Memset"))]
        self.launches = sum(1 for e in events if e.device_type == DeviceType.CPU
                            and e.name.startswith(LAUNCH_CALLS))
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        self.spans = [(e.name[len("perfbench."):], e.time_range.start / 1e6,
                       e.time_range.end / 1e6) for e in cpu if e.name.startswith("perfbench.")]
        self.ops = sorted((e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
                          for e in cpu if e.name.startswith("aten::"))

    @property
    def whole(self) -> bool:
        return len(self.kernels) >= self.launches > 0

    @property
    def kept(self) -> float:
        """Device kernels kept per host launch call."""
        return len(self.kernels) / max(self.launches, 1)


def profile(fn: Callable[[], object], calls: int = 1) -> Window:
    """`calls` calls of `fn` under torch.profiler, after one unprofiled
    call: the first whole try of len(PADS), else the try that kept the
    largest share of its kernels (its `whole` is False, and readers of
    whole windows leave it alone)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    best = None
    for pad in PADS:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(pad)
        win = Window(prof.events(), wall)
        if win.whole:
            return win
        if best is None or win.kept > best.kept:
            best = win
    return best


def labelled(name: str):
    """A harness span the profiler records (torch.profiler.record_function)."""
    return torch.profiler.record_function("perfbench." + name)


def count_syncs(fn: Callable[[], object]) -> int:
    """Host syncs in one call of `fn` under the CUDA sync debug mode
    "warn", which warns once at each sync (the program's sync counter,
    copied)."""
    count = [0]

    def record(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            count[0] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return count[0]


def guarded(name: str, fn: Callable[[], object], errors: List[str]):
    """fn() or None, the failure noted: a reading that finds nothing to
    read leaves its metric out, it never stops the run."""
    try:
        return fn()
    except (AttributeError, TypeError, RuntimeError, ValueError) as e:
        errors.append(f"{name}: {type(e).__name__}: {e}"[:300])
        return None


def union_seconds(intervals: List[tuple]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _host_at(win: Window, t: float) -> str:
    """"<harness span>/<innermost aten op>" the host was in at time t."""
    span = [n for n, s, e in win.spans if s <= t <= e]
    name = span[-1] if span else "outside spans"
    i = bisect.bisect_right(win.ops, (t, float("inf"), ""))
    for s, e, op in reversed(win.ops[max(0, i - 64) : i]):
        if e >= t:
            return f"{name}/{op}"
    return name


def idle_gaps(win: Window) -> List[tuple]:
    """(what the host was doing, seconds) of each gap between device
    intervals inside the window: the harness span and the innermost aten
    op the host was in when the device resumed."""
    iv = sorted((s, e) for _, s, e in win.kernels + win.copies)
    gaps, end = [], None
    for s, e in iv:
        if end is not None and s > end:
            gaps.append((_host_at(win, s), s - end))
        end = e if end is None else max(end, e)
    return gaps


def breakdown(win: Window, top: int = 10) -> Dict[str, list]:
    """The device ops that took most time and the idle time by host span."""
    by_op: Dict[str, float] = {}
    for name, s, e in win.kernels + win.copies:
        by_op[name[:120]] = by_op.get(name[:120], 0.0) + (e - s)
    by_span: Dict[str, float] = {}
    for name, sec in idle_gaps(win):
        by_span[name] = by_span.get(name, 0.0) + sec
    order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
    return {"device_ops": order(by_op), "idle_gaps": order(by_span)}
