"""Offline traffic: batches of detection crops back to back, as a BOP evaluation runs.

Parameters (a mix's JSON file): `batch`, crops a step; `pool`, distinct
crops made in set-up, which the batches cycle through in a new seeded
order each pass, so a crop never repeats step after step; `solvable_share`,
the share of the pool that are the representation's own templates (true
detections that should solve), the rest clutter (false positives);
`mask_box`, the mask's square as fractions of the crop side, filled at
`mask_density`; `focal_px`, the crop cameras' focal length; `in_flight`,
batches launched before the oldest is fetched (the CLI's BatchRunner keeps
up to 4). Crops are uniform uint8 noise; cameras have identity extrinsics.

The window runs `pose_from_crops` over one batch after another and fetches
each batch's answers to the host in one copy; the rate is every crop whose
answers reached the host over the time from the first launch to the last
fetch.
"""

from __future__ import annotations

import collections
import sys
import time

import numpy as np
import torch


# The reference's stages that this kind's control can lower (precision.STAGES).
CONTROL_STAGES = ("features", "solve")


def fields(top_n: int, top_k: int):
    """The answers fetched per crop: (name, width in floats)."""
    return (("success", 1), ("quality", 1), ("score", 1), ("best_template", 1), ("R", 9),
            ("t", 3), ("template_ids", top_n), ("template_scores", top_n),
            ("corr_q", top_k), ("corr_3d", 3 * top_k), ("corr_valid", top_k))


class Traffic:
    """The crop pool and its schedule, made on the device from the seed."""

    def __init__(self, params, seed: int, crop_px: int, device):
        g = torch.Generator(device=device).manual_seed(seed)
        p, self.batch = int(params["pool"]), int(params["batch"])
        if p % self.batch:
            raise ValueError("the pool holds whole batches")
        self.in_flight = int(params.get("in_flight", 4))
        self.crops = torch.randint(0, 256, (p, crop_px, crop_px, 3), dtype=torch.uint8,
                                   generator=g, device=device)
        lo, hi = (round(crop_px * x) for x in params["mask_box"])
        inner = torch.rand(p, hi - lo, hi - lo, generator=g, device=device)
        self.masks = torch.zeros(p, crop_px, crop_px, device=device)
        self.masks[:, lo:hi, lo:hi] = (inner < params["mask_density"]).float()
        self.f = torch.full((p, 2), float(params["focal_px"]), device=device)
        self.c = torch.full((p, 2), crop_px / 2.0 - 0.5, device=device)
        n_solv = round(p * params["solvable_share"])
        self.solvable = torch.randperm(p, generator=g, device=device)[:n_solv]
        self.own = torch.full((p,), -1, dtype=torch.long, device=device)
        self.own[self.solvable] = torch.arange(n_solv, device=device)
        # One pass over the pool a row; enough rows for the longest window.
        self.order = torch.argsort(torch.rand(int(params.get("passes", 512)), p, generator=g,
                                              device=device), dim=1)

    def templates(self):
        """(crops, masks, f, c) of the solvable crops, template k first."""
        s = self.solvable
        return self.crops[s], self.masks[s], self.f[s], self.c[s]

    def indices(self, step: int) -> torch.Tensor:
        per_pass = self.order.shape[1] // self.batch
        row = (step // per_pass) % self.order.shape[0]
        k = step % per_pass
        return self.order[row, k * self.batch : (k + 1) * self.batch]

    def cameras(self, idx):
        from foundpose_torch.structs import PinholeCamera

        n, px = len(idx), self.crops.shape[1]
        return PinholeCamera(f=self.f[idx], c=self.c[idx],
                             T_world_from_eye=torch.eye(4, device=idx.device).expand(n, 4, 4),
                             width=px, height=px)


def pack(out, names) -> torch.Tensor:
    """The fetched answers of one step as one [B, width] float32 tensor."""
    get = {"R": out.R_m2c, "t": out.t_m2c, "corr_q": out.best_corresp_2d_ids,
           "corr_3d": out.best_corresp_3d, "corr_valid": out.best_corresp_valid}
    b = out.success.shape[0]
    return torch.cat([get.get(n, getattr(out, n, None)).float().reshape(b, -1) for n in names], 1)


def unpack(host: np.ndarray, spec) -> dict:
    out, col = {}, 0
    for name, width in spec:
        out[name] = host[:, col : col + width]
        col += width
    return out


class System:
    """The program under test for this kind: the step on a batch, against
    the representation with its banks in the compute dtype (as the engine
    and the CLI keep them). The extractor and its overrides are in `model`."""

    def __init__(self, model, repre, config, traffic: Traffic, extractor=None, overrides=None):
        from foundpose_torch.pipeline import inference

        self.inference, self.model, self.config = inference, model, config
        self.repre = repre.cast_banks(config.compute_dtype)
        self.traffic = traffic
        self.gen = torch.Generator(device=traffic.crops.device).manual_seed(0)
        self.spec = fields(config.top_n_templates, config.top_k_buddies)

    def step(self, idx):
        t = self.traffic
        return self.inference.pose_from_crops(self.model, t.crops[idx], t.masks[idx],
                                              t.cameras(idx), self.repre, self.config,
                                              generator=self.gen)

    def close(self):
        self.model = self.repre = None


def window(system: System, seconds: float, first_step: int = 0, max_steps=None):
    """Steps for `seconds` (or `max_steps` steps), then drains. Returns
    (steps, crops done, the seconds from the first launch to the last
    fetch, {step: answers})."""
    t = system.traffic
    names = [n for n, _ in system.spec]
    width = sum(w for _, w in system.spec)
    ring = [torch.empty((t.batch, width), pin_memory=True) for _ in range(t.in_flight)]
    pending, answers = collections.deque(), {}

    def fetch():
        step, host, ev = pending.popleft()
        ev.synchronize()
        answers[step] = host.numpy().copy()

    start = time.perf_counter()
    deadline, step = start + seconds, first_step
    while time.perf_counter() < deadline and (max_steps is None
                                               or step - first_step < max_steps):
        if len(pending) == t.in_flight:
            fetch()
        host = ring[step % t.in_flight]
        host.copy_(pack(system.step(t.indices(step)), names), non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        pending.append((step, host, ev))
        step += 1
    while pending:
        fetch()
    elapsed = time.perf_counter() - start
    return step - first_step, (step - first_step) * t.batch, elapsed, answers


def warm(system: System, steps: int) -> None:
    window(system, float("inf"), max_steps=steps)


def measure(system: System, seconds: float, first: int):
    """(crops attempted, {"crops_per_s"}, answers) of the measured window."""
    from perfbench import stats

    n, crops, elapsed, answers = window(system, seconds, first)
    print(f"[perfbench] {n} steps, {crops} crops in {elapsed:.3f} s", file=sys.stderr)
    return crops, {"crops_per_s": stats.rate(crops, elapsed)}, answers


def check(s, answers, seed: int, control=False, sample: int = 2) -> dict:
    """The judge's numbers over `sample` batches of the window drawn from
    the seed (with `control`, True or some of CONTROL_STAGES, the answers of
    the reference lowered there, on the same crops), and the crops with
    non-finite answers over the whole window."""
    from perfbench import judge
    from perfbench.reference import pipeline
    from perfbench.reference.precision import Precision

    t = s.traffic
    steps = sorted(answers)
    pick = np.random.default_rng(seed + 4).choice(steps, size=min(sample, len(steps)),
                                                  replace=False)
    parts = []
    for step in pick:
        idx = t.indices(int(step))
        crops, masks = t.crops[idx], t.masks[idx]
        if control:
            out = {k: v.float().cpu().numpy() for k, v in judge.control_answers(
                s, crops, masks, t.f[idx], t.c[idx], Precision(lowp=control)).items()}
        else:
            out = unpack(answers[int(step)], s.system.spec)
        ana = pipeline.analyse(s.ref_vit, s.world, crops, masks, s.cell_px, Precision())
        parts.append(judge.offline_numbers(out, ana, s.world, t.own[idx].cpu().numpy()))
    numbers = judge.merge(parts)
    numbers["nonfinite"] = sum(judge.nonfinite([answers[k]]) for k in steps)
    return numbers


def port_launches() -> dict:
    """The port's launch counters of the kernels on this path, by name."""
    from foundpose_torch.ops.buddies_kernel import cycle_distances
    from foundpose_torch.ops.vit_block import fused_vit_block
    from foundpose_torch.pose.pnp import score_hypotheses

    return {"vit_block": fused_vit_block.launches, "buddies": cycle_distances.launches,
            "ransac_score": score_hypotheses.launches}


def traced(s, e2e, errors) -> dict:
    """The traced run's readings after the window: stage spans (CUDA events
    around each stage of the step, called one after another on inputs made
    once), a profiled ViT stage, a profiled step with the port's launch
    counters beside it, and a profiled window of 2 steps."""
    from perfbench import models, trace

    system, t, cfg = s.system, s.traffic, s.config
    inf, model, repre, gen = system.inference, system.model, system.repre, system.gen
    idx = t.indices(0)
    crops, masks, cams = t.crops[idx], t.masks[idx], t.cameras(idx)
    extract = models.family(s.family).extract

    def vit():
        return extract(model, inf.preprocess_crops(crops, cfg)).float()

    rec = {"kind": "offline", "crops_per_s": e2e["crops_per_s"], "batch": t.batch,
           "family": s.family, "shape": s.shape, "config": cfg, "cell_px": s.cell_px,
           "crop_px": int(t.crops.shape[1]),
           "repre": {"feat_dim": s.world["bank_feats"].shape[2],
                     "num_words": s.world["words"].shape[0],
                     "fmax": s.world["bank_feats"].shape[1]},
           "device_name": torch.cuda.get_device_name(t.crops.device), "stage_ms": {}}
    fm = trace.guarded("vit", vit, errors)
    staged = None
    if fm is not None:
        feats, valid, tids, tsc = inf.retrieve_batch(fm, masks.float(), repre, cfg)
        cors = inf.match_batch(feats, valid, tids, tsc, repre, cfg)
        staged = {
            "vit": vit,
            "retrieval": lambda: inf.retrieve_batch(fm, masks.float(), repre, cfg),
            "match": lambda: inf.match_batch(feats, valid, tids, tsc, repre, cfg),
            "solve": lambda: inf.solve_batch(fm, valid, tids, tsc, cors, cams, repre, cfg,
                                             generator=gen),
        }
    for name, call in (staged or {}).items():
        ms = trace.guarded(f"{name} span", lambda: trace.span_ms(call, reps=5), errors)
        if ms is not None:
            rec["stage_ms"][name] = ms
    step = lambda: system.step(idx)
    rec["vit_window"] = trace.guarded("vit window", lambda: trace.profile(vit), errors)
    before = trace.guarded("launch counters", port_launches, errors)
    rec["step_window"] = trace.guarded("step window", lambda: trace.profile(step), errors)
    after = trace.guarded("launch counters", port_launches, errors)
    if before is not None and after is not None:
        # One unprofiled call and the profiled one.
        rec["port_launches"] = {k: (after[k] - before[k]) / 2 for k in before}

    def labelled_step():
        with trace.labelled("step"):
            step()

    rec["idle"] = trace.guarded("idle window", lambda: trace.profile(labelled_step, calls=2),
                                errors)
    return rec
