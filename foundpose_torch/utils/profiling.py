"""Spans and op counts of the program's layers, profiler traces
(counterpart of foundpose_tpu/utils/profiling.trace) and a guard against
host syncs.

The JAX module's device-timing helpers (`device_time*`, `force_execution`)
defend against deferred execution and dead-code elimination in XLA; PyTorch
runs eagerly, and device time comes from CUDA events or torch.profiler.

Spans: the program opens `span(name)` at each layer boundary of the step,
the solve and the engine. While no recording is open (the default) a span
is one shared null context and does nothing else: no CUDA event, no
profiler range, no allocation, no launch, no host sync. Inside
`record()` each span keeps its name, its path from the root span of its
thread (e.g. "estimate/step/solve/ransac"), its parent, a request id taken
anew at each root span, its host start and end (time.perf_counter_ns), its
device time from a pair of CUDA events on the current stream, and, with
`count_ops`, the device ops dispatched inside it. While a torch.profiler
is active each span also opens the profiler range "foundpose/<path>", so
the program's spans lie on the profiler's clock beside the kernels.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

TRACE_FILE = "trace.json"
RANGE_PREFIX = "foundpose/"  # the profiler ranges of the program's spans

_NULL = contextlib.nullcontext()
_active: Optional["Recording"] = None  # the open recording, if any
_local = threading.local()  # .stack: this thread's open spans, [(recording, index)]


def kernel_counters() -> Dict[str, Callable]:
    """The main path's hand-written kernel wrappers by kernel name. Each
    counts its launches in its `launches` attribute: the launches go
    through ctypes, which PyTorch's dispatcher does not see."""
    from foundpose_torch.ops.attention import fused_attention_bhtd
    from foundpose_torch.ops.buddies_kernel import cycle_distances
    from foundpose_torch.ops.vit_block import fused_vit_block
    from foundpose_torch.pose import pnp

    return {
        "vit_block": fused_vit_block, "buddies": cycle_distances,
        "ransac_dlt": pnp.dlt_hypotheses, "ransac_score": pnp.score_hypotheses,
        "attention": fused_attention_bhtd, "refine": pnp.refine_lo_lm,
    }


def _launch_total() -> int:
    return sum(int(fn.launches) for fn in kernel_counters().values())


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


@dataclasses.dataclass
class SpanRecord:
    """One closed span. Times in milliseconds; `parent` indexes the list
    `Recording.spans()` returns (None for a root); `self_host_ms` is
    `host_ms` less the host time of the span's children; `device_ms` is
    None without CUDA events; `ops` (None unless counting) counts the
    device ops dispatched in the span and its children: each aten op whose
    output is a tensor on the device that is not a view, and each launch of
    the wrappers in `kernel_counters()`."""

    name: str
    path: str
    parent: Optional[int]
    request: int
    start_ns: int
    end_ns: int
    host_ms: float
    self_host_ms: float
    device_ms: Optional[float]
    ops: Optional[int]


class _Raw:
    """A span as it is recorded; `Recording.spans()` turns it into a SpanRecord."""

    __slots__ = ("name", "path", "parent", "request", "start_ns", "end_ns", "events", "aten",
                 "launches")

    def __init__(self, name, path, parent, request):
        self.name, self.path, self.parent, self.request = name, path, parent, request
        self.start_ns = self.end_ns = None
        self.events = None
        self.aten = self.launches = 0


class Recording:
    """The spans recorded while `record()` is open, in the order they opened."""

    def __init__(self, device_time: bool, count_ops: bool):
        self.device_time = device_time and torch.cuda.is_available()
        self.count_ops = count_ops
        self._raw: List[_Raw] = []
        self._requests = itertools.count()
        self._lock = threading.Lock()

    def _open(self, name: str):
        stack = _stack()
        top = stack[-1] if stack else None
        if top is not None and top[0] is self:
            parent = top[1]
            up = self._raw[parent]
            raw = _Raw(name, up.path + "/" + name, parent, up.request)
        else:
            raw = _Raw(name, name, None, next(self._requests))
        with self._lock:
            index = len(self._raw)
            self._raw.append(raw)
        stack.append((self, index))
        return raw

    def spans(self) -> List[SpanRecord]:
        """The records, once every span has closed, after one synchronize
        when there are device times."""
        raws = list(self._raw)
        if any(r.end_ns is None for r in raws):
            raise ValueError("a span of this recording is still open")
        if any(r.events is not None for r in raws):
            torch.cuda.synchronize()
        n = len(raws)
        child_ms, aten = [0.0] * n, [r.aten for r in raws]
        host = [(r.end_ns - r.start_ns) / 1e6 for r in raws]
        for i in reversed(range(n)):  # a child opens after its parent
            p = raws[i].parent
            if p is not None:
                child_ms[p] += host[i]
                aten[p] += aten[i]
        return [SpanRecord(r.name, r.path, r.parent, r.request, r.start_ns, r.end_ns, host[i],
                           host[i] - child_ms[i],
                           r.events[0].elapsed_time(r.events[1]) if r.events else None,
                           aten[i] + r.launches if self.count_ops else None)
                for i, r in enumerate(raws)]


class _Span:
    """A span of an open recording."""

    __slots__ = ("rec", "name", "raw", "range")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name, self.raw, self.range = rec, name, None, None

    def __enter__(self):
        rec = self.rec
        raw = self.raw = rec._open(self.name)
        if rec.count_ops:
            raw.launches = -_launch_total()
        if rec.device_time:
            raw.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            raw.events[0].record()
        if torch._C._autograd._profiler_enabled():
            self.range = record_function(RANGE_PREFIX + raw.path)
            self.range.__enter__()
        raw.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        raw = self.raw
        raw.end_ns = time.perf_counter_ns()
        if raw.events is not None:
            raw.events[1].record()
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.rec.count_ops:
            raw.launches += _launch_total()
        _stack().pop()
        return False


def span(name: str):
    """A span of the program's layer `name` (see the module docstring): the
    shared null context unless a recording is open."""
    rec = _active
    if rec is None:
        return _NULL
    return _Span(rec, name)


class _OpCounter(TorchDispatchMode):
    """Adds one to the innermost open span of `rec` for each aten op whose
    output is a tensor on `device_type` that is not a view."""

    def __init__(self, rec: Recording, device_type: str):
        super().__init__()
        self.rec, self.device_type = rec, device_type

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        stack = _stack()
        if stack and stack[-1][0] is self.rec and any(
                isinstance(t, torch.Tensor) and t.device.type == self.device_type
                and not t._is_view() for t in tree_leaves(out)):
            self.rec._raw[stack[-1][1]].aten += 1
        return out


@contextlib.contextmanager
def record(device_time: bool = True, count_ops: bool = False):
    """Opens a recording of the program's spans and yields it; its
    `spans()` returns the records. Spans stay in memory.

    device_time: a pair of CUDA events around each span, where CUDA is
    available (read by `spans()` after one synchronize). count_ops: counts
    the device ops dispatched in each span (the device is CUDA where it is
    available, else the CPU) through a dispatch mode pushed for the
    recording's length; counting slows the host, so a counting recording's
    times measure the counting too."""
    global _active
    rec = Recording(device_time, count_ops)
    prev, _active = _active, rec
    try:
        if count_ops:
            with _OpCounter(rec, "cuda" if torch.cuda.is_available() else "cpu"):
                yield rec
        else:
            yield rec
    finally:
        _active = prev


@contextlib.contextmanager
def trace(log_dir: str):
    """Context manager capturing a torch.profiler trace of its body (host
    ops, and the card's kernels where CUDA is available) into
    `log_dir`/trace.json, in the Chrome trace format that Perfetto and
    chrome://tracing read. The program's spans are in it as the ranges
    "foundpose/<path>": the body runs inside a recording (the caller's, if
    one is open). Yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    spans_on = record(device_time=False) if _active is None else contextlib.nullcontext()
    with profile(activities=activities) as prof, spans_on:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def no_host_sync(device):
    """Runs its body under the CUDA sync debug mode "error" when `device`
    is a CUDA device: a call that makes the host wait for the card (a copy
    from pageable memory, `.item()`, a fetch) raises; the caller's mode is
    restored on exit. A no-op elsewhere."""
    if torch.device(device).type != "cuda":
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)
