"""`correct` at a tiny size on the CPU: true for the program as it is,
false with the timed path broken underneath (a step that returns its state
unchanged, half of the batch left out and filled from the rest, an answer
altered where it is produced; when serving, a warp shifted by a pixel or
filtered otherwise) and false for the control, the reference in the
program's place one precision below, with every stage lowered and with
each stage alone. The cells' own limits files judge. The exchange between
chips does not exist in these one-chip cells."""

import copy

import pytest
import torch

from perfbench import harness, judge
from perfbench.tests import tiny

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def _rotated(out, deg=3.0):
    a = torch.deg2rad(torch.tensor(deg))
    rz = torch.tensor([[torch.cos(a), -torch.sin(a), 0], [torch.sin(a), torch.cos(a), 0],
                       [0, 0, 1]], dtype=out.R_m2c.dtype)
    out = copy.copy(out)
    out.R_m2c, out.R_m2w = out.R_m2c @ rz, out.R_m2w @ rz
    return out


def _half(out):
    out = copy.copy(out)
    b = out.success.shape[0]
    h = b // 2
    for f in vars(out):
        v = getattr(out, f)
        if torch.is_tensor(v) and v.dim() and v.shape[0] == b:
            v = v.clone()
            v[h:] = v[: b - h]
            setattr(out, f, v)
    return out


class _Stale:
    def __init__(self, step):
        self.step, self.last = step, None

    def __call__(self, *a, **k):
        out = self.step(*a, **k)
        prev, self.last = self.last, out
        return out if prev is None else prev


FAULTS = {
    "state_unchanged": lambda step: _Stale(step),
    "half_batch": lambda step: lambda *a, **k: _half(step(*a, **k)),
    "answer_altered": lambda step: lambda *a, **k: _rotated(step(*a, **k)),
}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = tiny.run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_not_correct(cell, fault, monkeypatch):
    from foundpose_torch.pipeline import inference

    monkeypatch.setattr(inference, "pose_from_crops", FAULTS[fault](inference.pose_from_crops))
    res = tiny.run(cell)
    assert not res["correct"], res["checks"]


def _shifted(warp):
    def shifted(*args, **kwargs):
        crops, masks = warp(*args, **kwargs)
        return torch.roll(crops, 1, dims=2), masks
    return shifted


def _nearest(warp):
    """The crops resampled by the nearest of each 2x2 block (no area filter)."""
    def nearest(*args, **kwargs):
        crops, masks = warp(*args, **kwargs)
        near = crops[:, ::2, ::2].repeat_interleave(2, 1).repeat_interleave(2, 2)
        return near[:, : crops.shape[1], : crops.shape[2]], masks
    return nearest


WARP_FAULTS = {"warp_shifted": _shifted, "warp_nearest": _nearest}
SERVE = [c for c in CELLS if harness.cell_parts(harness.manifest(), c)[2]["kind"] == "serve"]


@pytest.mark.parametrize("fault", sorted(WARP_FAULTS))
@pytest.mark.parametrize("cell", SERVE)
def test_broken_warp_is_not_correct(cell, fault, monkeypatch):
    from foundpose_torch import engine

    make = engine.make_single_image_warp
    monkeypatch.setattr(engine, "make_single_image_warp",
                        lambda *a, **k: WARP_FAULTS[fault](make(*a, **k)))
    res = tiny.run(cell)
    assert not res["correct"], res["checks"]


def _stages(cell):
    return tiny.setup(cell).kind.CONTROL_STAGES


CONTROLS = [(c, True) for c in CELLS] + [(c, (stage,)) for c in CELLS for stage in _stages(c)]


@pytest.mark.parametrize("cell,control", CONTROLS, ids=lambda x: "all" if x is True else (
    x[0] if isinstance(x, tuple) else x))
def test_control_is_not_correct(cell, control):
    limits = harness.cell_parts(harness.manifest(), cell)[3]
    ok, checks = judge.verdict(tiny.control_numbers(cell, control), limits)
    assert not ok, checks
