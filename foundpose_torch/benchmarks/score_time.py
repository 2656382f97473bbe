"""Device time of the RANSAC scoring kernel on the card.

    python3 foundpose_torch/benchmarks/score_time.py [--root DIR]   # needs a CUDA GPU

Times `pose/pnp.score_hypotheses` at the shapes of the two shipped
configurations: 80 correspondence sets (16 crops x 5 templates) x 300
points x 200 hypotheses (configs/infer/lmo.json) and x 400 hypotheses
(configs/infer/lmo_exact.json). `device_ms` is the kernel's own time under
torch.profiler, the mean over `calls` launches; `event_ms` is the CUDA-event
time of whole wrapper calls, 20 back to back, which for a kernel this small
can read the host's issue rate rather than the device.

`--root` imports foundpose_torch from another checkout (for example a parent
commit unpacked into the ignored `_parent/`). A checkout whose scorer takes
the folded operands (pts4, duv, valid, A) is timed on operands folded once by
its own `_score_inputs`, so its times leave the folding out. The script
prints one JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

import numpy as np
import torch

THRESH = 10.0
SHAPES = {"lmo.json": (80, 300, 200), "lmo_exact.json": (80, 300, 400)}


def score_operands(s, n, h, seed=5, device="cuda"):
    """Raw scorer operands for s sets of n points near a pose at 0.5 m
    (f 600, c 209.5, 1 px noise, 30% outliers, 85% valid) and h hypotheses
    scattered around it, as a dict of f32 tensors on `device`."""
    rng = np.random.default_rng(seed)
    pts3d = rng.uniform(-0.05, 0.05, (s, n, 3)).astype(np.float32)
    t_gt = np.array([0.0, 0.0, 0.5], np.float32)
    uv = pts3d[..., :2] / (pts3d[..., 2:] + t_gt[2]) * 600.0 + 209.5
    uv += rng.normal(0, 1.0, uv.shape)
    out = rng.uniform(size=(s, n)) < 0.3
    uv[out] = rng.uniform(0, 420, (int(out.sum()), 2))
    valid = rng.uniform(size=(s, n)) < 0.85
    rs = np.stack([np.eye(3, dtype=np.float32)] * (s * h)).reshape(s, h, 3, 3)
    rs = rs + rng.normal(0, 0.02, rs.shape).astype(np.float32)
    ts = t_gt + rng.normal(0, 0.004, (s, h, 3)).astype(np.float32)

    def tt(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return dict(pts2d=tt(uv), pts3d=tt(pts3d), validf=tt(valid), rs=tt(rs), ts=tt(ts),
                k_f=torch.full((s, 2), 600.0, device=device),
                k_c=torch.full((s, 2), 209.5, device=device))


def scorer_call(pnp, ops):
    """A no-argument call of `pnp.score_hypotheses` on `ops`, in the form the
    module takes: the raw operands, or operands folded once beforehand."""
    if len(inspect.signature(pnp.score_hypotheses).parameters) == 4:
        folded = pnp._score_inputs(*ops.values(), THRESH)
        return lambda: pnp.score_hypotheses(*folded)
    return lambda: pnp.score_hypotheses(**ops, inlier_thresh=THRESH)


def cuda_ms(fn, reps=20, warm=3):
    """Mean milliseconds per call of `fn` by CUDA events, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, calls=20, kernel="score_kernel", sessions=3):
    """Mean device ms of the `kernel` launches of `calls` calls of `fn` under
    torch.profiler; each call must launch it exactly once. A profiler session
    now and then loses device records (on the H100 it has recorded none, or
    19 of 20 launches); such a session is run again, at most `sessions`
    times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        evs = [e for e in dev if kernel in e.name]
        if len(evs) == calls:
            break
    else:
        seen = sorted({e.name[:60] for e in dev})
        raise RuntimeError(f"{len(evs)} {kernel} launches in {calls} calls; device events: {seen}")
    return sum(e.time_range.elapsed_us() for e in evs) / calls / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="checkout whose foundpose_torch is timed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("score_time: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from foundpose_torch.pose import pnp

    res = dict(root=os.path.abspath(args.root), card=torch.cuda.get_device_name(0))
    for config, (s, n, h) in SHAPES.items():
        fn = scorer_call(pnp, score_operands(s, n, h))
        res[config] = dict(shape=[s, n, h], device_ms=device_ms(fn), event_ms=cuda_ms(fn))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
