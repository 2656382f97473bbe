"""Profiler traces (counterpart of foundpose_tpu/utils/profiling.trace) and
a guard against host syncs.

The JAX module's device-timing helpers (`device_time*`, `force_execution`)
defend against deferred execution and dead-code elimination in XLA; PyTorch
runs eagerly, and device time comes from CUDA events or torch.profiler.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Context manager capturing a torch.profiler trace of its body (host
    ops, and the card's kernels where CUDA is available) into
    `log_dir`/trace.json, in the Chrome trace format that Perfetto and
    chrome://tracing read. Yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
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
