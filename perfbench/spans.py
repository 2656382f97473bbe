"""The program's own spans and op counts, read for the benchmark.

The program opens a span at each layer boundary of the step, the solve and
the engine (`foundpose_torch.utils.profiling.span`); the spans record only
while a caller holds `profiling.record()` open, and each also opens the
profiler range "foundpose/<path>" while a profiler is active. A kind's three
readings with the recorder on (`READINGS[kind](s, errors)`, after every
reading taken with the recorder off, so those keep their values):

- `spans`: a recording with device times over 8 steps through the kind's
  own window (offline: 4 batches in flight, as the measured window runs
  them) or 8 requests through `estimate()`;
- `span_ops`: one step or request recorded with `count_ops`;
- `span_idle`: a whole profiled window (`Window`) of 2 steps or requests
  with the recorder on.

The per-layer metrics these feed are in `METRICS` (name -> reader of the
traced run's record); `report` prints each span path's median host and
device milliseconds. A program without the recorder gives no readings, and
every reader then returns None.
"""

from __future__ import annotations

import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from perfbench import trace

RANGE = "foundpose/"  # the profiler ranges of the program's spans
OUTSIDE = "outside program spans"
WINDOW_CALLS = 8  # steps or requests of the recording with device times
IDLE_CALLS = 2  # steps or requests of the profiled window


class Window(trace.Window):
    """A profiler window with the program's spans: `ranges`, (start, end,
    path) on the host in seconds on the profiler's clock. Like the harness's
    own ranges, the program's also appear on the device's timeline; they
    are left out of the device intervals."""

    def __init__(self, events, wall_s: float):
        from torch.autograd import DeviceType

        ours = [e for e in events if e.name.startswith(RANGE)]
        super().__init__([e for e in events if not (e.device_type == DeviceType.CUDA
                                                    and e.name.startswith(RANGE))], wall_s)
        self.ranges = sorted((e.time_range.start / 1e6, e.time_range.end / 1e6,
                              e.name[len(RANGE):])
                             for e in ours if e.device_type == DeviceType.CPU)


def profile(fn: Callable[[], object], calls: int = 1) -> Window:
    """trace.profile, keeping the program's spans (`Window`): `calls`
    calls of `fn` under torch.profiler after one unprofiled call, the
    first whole try of trace.PADS, else the try that kept the most."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    best = None
    for pad in trace.PADS:
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


def _innermost(ranges, t: float) -> Optional[str]:
    """The deepest program span open on the host at time t."""
    inside = [(path.count("/"), s, path) for s, e, path in ranges if s <= t <= e]
    return max(inside)[2] if inside else None


def idle_by_span(win: Window) -> Dict[str, float]:
    """Seconds of the device's idle time from the first root span's start
    to the last one's end, gap by gap: a gap before a device interval goes
    to the innermost program span the host was in when the device resumed
    (the rule of trace.idle_gaps), the idle time after the last interval to
    the one it was in when the device went idle; gaps outside every span
    under OUTSIDE."""
    roots = [(s, e) for s, e, path in win.ranges if "/" not in path]
    if not roots:
        return {}
    out: Dict[str, float] = {}

    def add(t, seconds):
        key = _innermost(win.ranges, t) or OUTSIDE
        out[key] = out.get(key, 0.0) + seconds

    end = min(s for s, _ in roots)
    for s, e in sorted((s, e) for _, s, e in win.kernels + win.copies):
        if s > end:
            add(s, s - end)
        end = max(end, e)
    last = max(e for _, e in roots)
    if last > end:
        add(end, last - end)
    return out


def _recorded(fn, errors: List[str]):
    """The records of a recording with device times around `fn()`, or None."""
    from foundpose_torch.utils import profiling

    def run():
        with profiling.record() as rec:
            fn()
        return rec.spans()

    return trace.guarded("span window", run, errors)


def _counted(fn, errors: List[str]):
    """The records of a counting recording around `fn()`, or None."""
    from foundpose_torch.utils import profiling

    def run():
        with profiling.record(count_ops=True) as rec:
            fn()
        return rec.spans()

    return trace.guarded("span ops", run, errors)


def _profiled(fn, errors: List[str]):
    """A profiled window (`profile`) of IDLE_CALLS calls of `fn` with the
    recorder on, or None."""
    from foundpose_torch.utils import profiling

    def run():
        with profiling.record(device_time=False):
            return profile(fn, calls=IDLE_CALLS)

    return trace.guarded("span idle window", run, errors)


def offline_readings(s, errors: List[str]) -> dict:
    """The three readings of an offline cell."""
    from perfbench.traffic import offline

    system = s.system
    idx = system.traffic.indices(0)
    return {
        "spans": _recorded(lambda: offline.window(system, float("inf"),
                                                  max_steps=WINDOW_CALLS), errors),
        "span_ops": _counted(lambda: system.step(idx), errors),
        "span_idle": _profiled(lambda: system.step(idx), errors),
    }


def serve_readings(s, errors: List[str]) -> dict:
    """The three readings of a serving cell."""
    system, order = s.system, s.traffic.order
    k0 = int(order[0])

    def requests():
        for i in range(WINDOW_CALLS):
            system.estimate(int(order[i]))

    out = {
        "spans": _recorded(requests, errors),
        "span_ops": _counted(lambda: system.estimate(k0), errors),
        "span_idle": _profiled(lambda: system.estimate(k0), errors),
    }
    system.calls.clear()
    return out


READINGS = {"offline": offline_readings, "serve": serve_readings}


def median_ms(rec, path: str, clock: str) -> Optional[float]:
    """The median over the steps or requests of `rec["spans"]` of the
    span `path`'s `clock` ("host_ms", "device_ms" or "self_host_ms"),
    summed within each step or request."""
    per: Dict[int, float] = {}
    for r in rec.get("spans") or ():
        if r.path == path:
            value = getattr(r, clock)
            if value is None:
                return None
            per[r.request] = per.get(r.request, 0.0) + value
    return statistics.median(per.values()) if per else None


def ops(rec, path: str) -> Optional[int]:
    """The device ops dispatched in span `path` (and its children) in the
    one counted step or request."""
    found = [r.ops for r in rec.get("span_ops") or () if r.path == path]
    return sum(found) if found and None not in found else None


def idle_ms(rec, path: str) -> Optional[float]:
    """Device idle time a step or request put down to span `path` and the
    spans under it, from a whole profiled window that holds program spans."""
    win = rec.get("span_idle")
    if win is None or not win.whole or not win.ranges:
        return None
    by = idle_by_span(win)
    return 1e3 * sum(v for k, v in by.items()
                     if k == path or k.startswith(path + "/")) / IDLE_CALLS


METRICS: Dict[str, Callable[[dict], Optional[float]]] = {
    "vit_span_ms.offline": lambda rec: median_ms(rec, "step/vit", "device_ms"),
    "retrieval_span_ms.offline": lambda rec: median_ms(rec, "step/retrieval", "device_ms"),
    "match_span_ms.offline": lambda rec: median_ms(rec, "step/match", "device_ms"),
    "solve_span_ms.offline": lambda rec: median_ms(rec, "step/solve", "device_ms"),
    "ransac_ms.offline": lambda rec: median_ms(rec, "step/solve/ransac", "device_ms"),
    "refine_ms.offline": lambda rec: median_ms(rec, "step/solve/refine", "device_ms"),
    "solve_ops_per_step.offline": lambda rec: ops(rec, "step/solve"),
    "solve_idle_ms.offline": lambda rec: idle_ms(rec, "step/solve"),
    "step_span_ms.serve": lambda rec: median_ms(rec, "estimate/step", "device_ms"),
    "prepare_ms.serve": lambda rec: median_ms(rec, "estimate/prepare", "host_ms"),
    "warp_ms.serve": lambda rec: median_ms(rec, "estimate/warp", "device_ms"),
    "fetch_wait_ms.serve": lambda rec: median_ms(rec, "estimate/fetch", "host_ms"),
    "engine_self_ms.serve": lambda rec: median_ms(rec, "estimate", "self_host_ms"),
    "ops_per_request.serve": lambda rec: ops(rec, "estimate"),
    "solve_idle_ms.serve": lambda rec: idle_ms(rec, "estimate/step/solve"),
}


def summary(rec) -> dict:
    """Each span path's median host, self and device ms, its op count, the
    idle time a call by span, and the window's idle time against the
    idle time the gaps account for (seconds)."""
    paths = sorted({r.path for r in rec.get("spans") or ()})
    out = {"paths": {p: {c: median_ms(rec, p, c)
                         for c in ("host_ms", "self_host_ms", "device_ms")}
                     for p in paths},
           "ops": {r.path: r.ops for r in rec.get("span_ops") or ()}}
    win = rec.get("span_idle")
    if win is not None and win.whole:
        by = idle_by_span(win)
        busy = trace.union_seconds([(a, b) for _, a, b in win.kernels + win.copies])
        out["idle_ms_per_call"] = {k: 1e3 * v / IDLE_CALLS
                                   for k, v in sorted(by.items(), key=lambda kv: -kv[1])}
        out["idle_check_s"] = {"gaps": sum(by.values()), "window": win.wall_s - busy}
    return out


def report(rec, file=sys.stderr) -> None:
    """Prints each span path's median host and device ms, as the set-up
    split is printed."""
    for path, ms in summary(rec)["paths"].items():
        dev = "none" if ms["device_ms"] is None else f"{ms['device_ms']:.3f}"
        print(f"[perfbench] span {path}: host {ms['host_ms']:.3f} ms, device {dev} ms "
              f"(medians of {WINDOW_CALLS})", file=file)
