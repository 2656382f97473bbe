"""The readers of the program's spans (perfbench.spans) on the tiny cells,
on a profiler window made by hand, and against a program without the
recorder."""

from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, spans, trace
from perfbench.tests import tiny

CELLS = {"vits14reg_offline_b128": "offline", "vits14reg_serve_16box": "serve"}
DEVICE_CLOCK = {"vit_span_ms.offline", "retrieval_span_ms.offline", "match_span_ms.offline",
                "solve_span_ms.offline", "ransac_ms.offline", "refine_ms.offline",
                "step_span_ms.serve", "warp_ms.serve"}
IDLE = {"solve_idle_ms.offline", "solve_idle_ms.serve"}


def readings(cell, monkeypatch):
    monkeypatch.setattr(trace, "PADS", (0.0,))
    s = tiny.setup(cell)
    errors = []
    with tiny.on_the_cpu():
        harness.warm(s, torch.device("cpu"))
        rec = spans.READINGS[CELLS[cell]](s, errors)
    return rec, errors


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_readings_on_the_tiny_cells(cell, monkeypatch):
    rec, errors = readings(cell, monkeypatch)
    assert errors == []
    root = "step" if CELLS[cell] == "offline" else "estimate"
    assert len({r.request for r in rec["spans"] if r.parent is None}) == spans.WINDOW_CALLS
    assert all(r.path.split("/")[0] == root for r in rec["spans"])
    for name, read in spans.METRICS.items():
        if not name.endswith("." + CELLS[cell]):
            continue
        value = read(rec)
        if name in DEVICE_CLOCK:
            assert value is None, name  # the CPU has no device times
        elif name in IDLE:
            assert value is None, name  # nor a whole profiler window
        else:
            assert value is not None and value > 0, name
    assert rec["span_idle"].ranges  # the program's ranges, on the profiler's clock
    ransac = "step/solve/ransac" if root == "step" else "estimate/step/solve/ransac"
    assert spans.summary(rec)["paths"][ransac]["host_ms"] > 0


def test_readings_of_a_program_without_the_recorder(monkeypatch):
    from foundpose_torch.utils import profiling

    monkeypatch.delattr(profiling, "record")
    rec, errors = readings("vits14reg_offline_b128", monkeypatch)
    assert rec == {"spans": None, "span_ops": None, "span_idle": None}
    assert len(errors) == 3
    assert all(read(rec) is None for read in spans.METRICS.values())
    spans.report(rec)


def _event(name, cuda, start_us, end_us):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
                           time_range=SimpleNamespace(start=start_us, end=end_us))


def test_idle_goes_to_the_innermost_span_when_the_device_resumes():
    """Kernels at 5-10, 30-40, 45-50, 70-100 us; the host in step (0-110),
    step/solve (20-90) and its child ransac (25-42): the idle time before
    5 and after 100 goes to step, the gap ending at 30 to ransac, those
    ending at 45 and 70 to solve; the program's ranges on the device's
    timeline are no kernels."""
    events = [_event("cudaLaunchKernel", False, 0, 1) for _ in range(4)] + [
        _event("k", True, 5, 10), _event("k", True, 30, 40), _event("k", True, 45, 50),
        _event("k", True, 70, 100),
        _event("foundpose/step", False, 0, 110), _event("foundpose/step", True, 0, 110),
        _event("foundpose/step/solve", False, 20, 90),
        _event("foundpose/step/solve/ransac", False, 25, 42),
    ]
    win = spans.Window(events, wall_s=110e-6)
    assert win.whole and len(win.kernels) == 4
    by = spans.idle_by_span(win)
    assert by == pytest.approx({"step": 15e-6, "step/solve/ransac": 20e-6, "step/solve": 25e-6})
    busy = trace.union_seconds([(a, b) for _, a, b in win.kernels])
    assert sum(by.values()) == pytest.approx(win.wall_s - busy)
    rec = {"span_idle": win}
    assert spans.idle_ms(rec, "step/solve") == pytest.approx(1e3 * 45e-6 / spans.IDLE_CALLS)
    assert spans.idle_ms(rec, "step/solve/ransac") == pytest.approx(1e3 * 20e-6 / 2)
    assert spans.idle_ms(rec, "step") == pytest.approx(1e3 * 60e-6 / 2)
