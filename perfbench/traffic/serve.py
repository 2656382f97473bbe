"""Serving traffic: one client calling `PoseEngine.estimate` back to back.

Parameters (a mix's JSON file): `images`, distinct camera frames made in
set-up (uniform uint8 noise of `image_hw`); `boxes`, detections per frame,
each side drawn from `box_side_px` and placed inside the frame;
`solvable_share`, the share of each frame's boxes whose crops are the
representation's own templates (true detections that should solve), the
rest clutter; `K`, the camera's intrinsics; `batch`, the engine's chunk.
Frames come in a new seeded order each pass over them. The frames live on
the host, as a camera's do; the engine copies each to the card, builds the
crop cameras, warps, runs the step and fetches the poses.

Latency is the host clock around each `estimate()`, which ends in its
fetch; the tail is over every request of the window.

For the check, the window keeps a uniform sample of its requests, drawn
from the seed as they come (a reservoir): for each kept request, the crops
as the engine warped them and the step's template scores and
correspondences, as `inference.pose_from_crops` returned them to the
engine, copied into buffers made in set-up.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from perfbench.reference import camera
from perfbench.traffic.offline import fields, pack, unpack

# The reference's stages that this kind's control can lower (precision.STAGES).
CONTROL_STAGES = ("features", "warp", "solve")
SAMPLE = 8  # requests a run checks
STEP_FIELDS = ("template_ids", "template_scores", "best_template", "corr_q", "corr_3d",
               "corr_valid")


class Traffic:
    """Frames, boxes and the order of requests, made from the seed."""

    def __init__(self, params, seed: int, crop_px: int, device):
        g = torch.Generator(device=device).manual_seed(seed)
        n, nb = int(params["images"]), int(params["boxes"])
        h, w = params["image_hw"]
        self.seed, self.crop_px, self.device = seed, crop_px, device
        self.batch = int(params["batch"])
        self.K = np.asarray(params["K"], dtype=np.float64)
        self.images_dev = torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8, generator=g,
                                        device=device)
        self.images = self.images_dev.cpu().numpy()
        lo, hi = params["box_side_px"]
        side = lo + (hi - lo) * torch.rand(n, nb, 2, generator=g, device=device)
        corner = torch.rand(n, nb, 2, generator=g, device=device) * (
            torch.tensor([w, h], device=device) - side)
        self.boxes = torch.cat([corner, corner + side], -1).cpu().numpy().astype(np.float32)
        n_solv = round(nb * params["solvable_share"])
        pick = torch.argsort(torch.rand(n, nb, generator=g, device=device), dim=1)[:, :n_solv]
        self.own = np.full((n, nb), -1, dtype=np.int64)
        self.own[np.arange(n)[:, None], pick.cpu().numpy()] = np.arange(n * n_solv).reshape(
            n, n_solv)
        self.order = torch.argsort(torch.rand(int(params.get("passes", 256)), n, generator=g,
                                              device=device), dim=1).reshape(-1).cpu().numpy()

    def crop_cameras(self, k: int):
        """The reference's crop cameras of frame k's boxes (float64)."""
        return camera.crop_cameras(self.K, self.boxes[k], self.crop_px)

    def warp(self, k: int, boxes_idx=None, prec=None):
        """The reference's crops (float in [0, 1]), masks, f, c and rotations
        of frame k, at `prec` (the reference's own by default)."""
        f, c, rot = self.crop_cameras(k)
        if boxes_idx is not None:
            f, c, rot = f[boxes_idx], c[boxes_idx], rot[boxes_idx]
        crops, masks = camera.warp(self.images_dev[k], self.K, f, c, rot, self.crop_px, prec)
        return crops, masks.float(), f.float().to(self.device), c.float().to(self.device), rot

    def templates(self):
        """(crops, masks, f, c) of the solvable boxes, template k first."""
        parts = []
        for k in range(len(self.images)):
            sel = np.flatnonzero(self.own[k] >= 0)
            sel = sel[np.argsort(self.own[k][sel])]
            parts.append(self.warp(k, torch.as_tensor(sel))[:4])
        return tuple(torch.cat([p[i] for p in parts]) for i in range(4))


def _crops(vit, crops, *args, **kwargs):
    """The crops argument of a `pose_from_crops` call."""
    return crops


class Reservoir:
    """A uniform sample of `size` items of a stream of unknown length,
    drawn from the seed: `slot(j)` is where item j goes, None if nowhere."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng = size, np.random.default_rng(seed)

    def slot(self, j: int):
        if j < self.size:
            return j
        r = int(self.rng.integers(0, j + 1))
        return r if r < self.size else None


class System:
    """The program under test for this kind: a PoseEngine with one object.
    While it exists, `inference.pose_from_crops` also hands each call's
    crops and outputs to `calls`, for the check's sample."""

    def __init__(self, model, repre, config, traffic: Traffic, extractor, overrides):
        from foundpose_torch.engine import PoseEngine
        from foundpose_torch.pipeline import inference

        self.traffic, self.config = traffic, config
        self.engine = PoseEngine(extractor_name=extractor, config=config,
                                 batch_size=traffic.batch, extractor_overrides=overrides,
                                 device=traffic.device, model=model)
        self.engine.register_object(1, repre)
        self.model, self.repre = model, repre.cast_banks(config.compute_dtype)
        self.gen = torch.Generator(device=traffic.device).manual_seed(0)

        self.spec = [(n, w) for n, w in fields(config.top_n_templates, config.top_k_buddies)
                     if n in STEP_FIELDS]
        nb, px = traffic.boxes.shape[1], traffic.crop_px
        rows = -(-nb // traffic.batch) * traffic.batch
        self.kept_crops = torch.empty(SAMPLE, rows, px, px, 3, device=traffic.device)
        self.kept_out = torch.empty(SAMPLE, rows, sum(w for _, w in self.spec),
                                    device=traffic.device)
        self.kept = [None] * SAMPLE  # the request each slot holds
        self.calls = []
        self.inference, self.pose_from_crops = inference, inference.pose_from_crops

        def recorded(*args, **kwargs):
            out = self.pose_from_crops(*args, **kwargs)
            self.calls.append((_crops(*args, **kwargs), out))
            return out

        inference.pose_from_crops = recorded

    def estimate(self, k: int):
        t = self.traffic
        self.calls.clear()
        return self.engine.estimate(1, t.images[k], list(t.boxes[k]), t.K)

    def keep(self, slot: int, request: int) -> None:
        """Copies the last request's crops and step outputs into `slot`."""
        if not self.calls:
            return
        row = 0
        for crops, out in self.calls:
            n = crops.shape[0]
            self.kept_crops[slot, row : row + n].copy_(crops)
            self.kept_out[slot, row : row + n].copy_(pack(out, [n for n, _ in self.spec]))
            row += n
        self.kept[slot] = request

    def close(self):
        self.inference.pose_from_crops = self.pose_from_crops
        self.calls.clear()
        self.engine = self.model = self.repre = None


def window(system: System, seconds: float, first_request: int = 0):
    """Requests for `seconds`, keeping a sample of them in `system`.
    Returns (requests, latencies in seconds, the window's seconds,
    {request: (frame, answers)})."""
    order = system.traffic.order
    sample = Reservoir(SAMPLE, system.traffic.seed + 3)
    lat, answers = [], {}
    start = time.perf_counter()
    deadline, i = start + seconds, first_request
    while time.perf_counter() < deadline:
        k = int(order[i % len(order)])
        t0 = time.perf_counter()
        res = system.estimate(k)
        lat.append(time.perf_counter() - t0)
        answers[i] = (k, res)
        slot = sample.slot(i - first_request)
        if slot is not None:
            system.keep(slot, i)
        system.calls.clear()
        i += 1
    return i - first_request, lat, time.perf_counter() - start, answers


def warm(system: System, requests: int) -> None:
    for i in range(requests):
        system.estimate(int(system.traffic.order[i]))
    system.calls.clear()


def measure(system: System, seconds: float, first: int):
    """(requests attempted, {"estimate_ms_p95"}, answers) of the measured
    window. The median is printed beside it: across runs it spreads about
    twice as wide as the tail, so it is no end-to-end metric."""
    from perfbench import stats

    n, lat, elapsed, answers = window(system, seconds, first)
    print(f"[perfbench] {n} requests in {elapsed:.3f} s; median "
          f"{stats.percentile(lat, 50) * 1e3:.3f} ms", file=sys.stderr)
    return n, {"estimate_ms_p95": stats.percentile(lat, 95) * 1e3}, answers


def check(s, answers, seed: int, control=False) -> dict:
    """The judge's numbers over the requests the window kept (with
    `control`, True or some of CONTROL_STAGES, the answers of the reference
    lowered there, on the same frames and boxes), and the requests with
    non-finite answers over the whole window. Served poses are in the
    frame's camera: the crop's pose turned by the crop camera's rotation."""
    from perfbench import judge
    from perfbench.reference import pipeline
    from perfbench.reference.precision import Precision

    t, system = s.traffic, s.system
    parts = []
    for slot, i in enumerate(system.kept):
        if i is None:
            continue
        k, res = answers[i]
        nb = len(res)
        ref_crops, ref_masks, _, _, rot = t.warp(k)
        ana = pipeline.analyse(s.ref_vit, s.world, ref_crops, ref_masks, s.cell_px, Precision())
        r_true, t_true = judge.true_poses(s.world, t.own[k])
        r_true, t_true = rot.numpy() @ r_true, (rot.numpy() @ t_true[..., None])[..., 0]
        if control:
            prec = Precision(lowp=control)
            crops, masks, f, c, _ = t.warp(k, prec=prec)
            out = judge.control_answers(s, crops, masks, f, c, prec)
            R = (rot.to(out["R"].device) @ out["R"].reshape(-1, 3, 3).double()).cpu().numpy()
            tt = (rot.to(out["t"].device) @ out["t"].double()[..., None])[..., 0].cpu().numpy()
            out = {name: v.float().cpu().numpy() for name, v in out.items()}
            succ, best = out["success"], out["best_template"]
        else:
            crops = system.kept_crops[slot, :nb]
            out = unpack(system.kept_out[slot, :nb].cpu().numpy(), system.spec)
            R = np.stack([r["R_m2c"] for r in res])
            tt = np.stack([r["t_m2c"] for r in res])
            succ = np.array([float(r["success"]) for r in res])
            best = np.array([r["best_template"] for r in res])
        numbers = {"warp_err": float((crops.float() - ref_crops).abs().amax()) * 255.0}
        numbers.update(judge.feature_numbers(out, ana, s.world))
        numbers.update(judge.pose_numbers(succ, best, R, tt, t.own[k], r_true, t_true))
        parts.append(numbers)
    numbers = judge.merge(parts)
    numbers["nonfinite"] = sum(judge.nonfinite([np.stack(
        [np.concatenate([np.ravel(r["R_m2c"]), np.ravel(r["t_m2c"]), [r["quality"], r["score"]]])
         for r in res])]) > 0 for _, res in answers.values())
    return numbers


def traced(s, e2e, errors) -> dict:
    """The traced run's readings after the window: the step on one
    request's crops between CUDA events, one profiled `estimate()`, its
    host syncs under the CUDA sync debug mode, and a profiled window of 2
    requests."""
    from foundpose_torch.structs import PinholeCamera

    from perfbench import trace

    system, t = s.system, s.traffic
    k0 = int(t.order[0])
    crops, masks, f, c, rot = t.warp(k0)
    n = len(crops)
    T = torch.eye(4, device=t.device).repeat(n, 1, 1)
    T[:, :3, :3] = rot.float().to(t.device)
    cams = PinholeCamera(f=f, c=c, T_world_from_eye=T, width=t.crop_px, height=t.crop_px)
    rec = {"kind": "serve", "stage_ms": {}}

    def step():
        return system.pose_from_crops(system.model, crops, masks, cams, system.repre,
                                      system.config, generator=system.gen)

    ms = trace.guarded("step span", lambda: trace.span_ms(step, reps=10), errors)
    if ms is not None:
        rec["stage_ms"]["step"] = ms
    rec["request_window"] = trace.guarded("request window",
                                          lambda: trace.profile(lambda: system.estimate(k0)),
                                          errors)
    rec["syncs"] = trace.guarded("syncs", lambda: trace.count_syncs(lambda: system.estimate(k0)),
                                 errors)

    def requests():
        for i in range(2):
            with trace.labelled("estimate"):
                system.estimate(int(t.order[i]))

    rec["idle"] = trace.guarded("idle window", lambda: trace.profile(requests), errors)
    system.calls.clear()
    return rec
