"""BOP19 Average Recall evaluation (MSSD / MSPD / VSD): a copy of the
numpy-only foundpose_tpu/eval/bop_ar.py, which the port may not import.

In-house evaluator for the reference's north-star metric
(reference README.md:173-181 reports BOP AR computed with the external
bop_toolkit evaluation server/scripts; the submodule is not vendored there).
Implements the BOP19 protocol as defined by bop_toolkit's
eval_calc_errors/eval_calc_scores/pose_matching flow:

- Per (scene, image, object): estimates sorted by score descending,
  truncated to the top-n (n = number of GT instances with
  visib_fract >= 0.1 — BOP19's targets `inst_count`).
- Matching is GREEDY PER ERROR TYPE AND PER THRESHOLD: at each correctness
  threshold, each estimate (in score order) claims the not-yet-matched
  valid GT with the lowest error, provided that error is BELOW the
  threshold; otherwise the GT stays available for lower-scored estimates.
  (bop_toolkit pose_matching.match_poses: an estimate with error above the
  threshold matches nothing at that threshold.)
- MSSD recall over thresholds {0.05..0.5} x object diameter.
- MSPD recall over thresholds {5..50} x r px, r = image_width / 640, with
  ONE image_width for the whole call, as in the JAX package: images of
  another width are scored at the caller's width (ROADMAP.md Queue 3, fault
  (b); a port adds no feature).
- VSD (optional, needs scene depth + the object mesh): BOP19 visible
  surface discrepancy on DISTANCE images (z-depth converted via K, as in
  bop_toolkit misc.depth_im_to_dist_im_fast), bop19-mode visibility masks,
  tau in {0.05..0.5} x diameter, delta = 15 mm, correctness threshold
  theta in {0.05..0.5}; AR_VSD averages recall over all (tau, theta)
  combinations.
- AR_x = mean recall over that error type's threshold grid;
  BOP AR = mean(AR_VSD, AR_MSSD, AR_MSPD) (mean of the available ones).

The protocol layer is pinned by a literal numpy restatement oracle in
tests/test_bop_ar.py, and this copy against the JAX module in
tests/test_torch_eval.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from foundpose_torch.renderer.base import RenderType


@dataclasses.dataclass
class Estimate:
    scene_id: int
    im_id: int
    obj_id: int
    score: float
    R: np.ndarray  # [3, 3] model -> camera
    t: np.ndarray  # [3]


@dataclasses.dataclass
class GroundTruth:
    scene_id: int
    im_id: int
    obj_id: int
    R: np.ndarray
    t: np.ndarray
    visib_fract: float = 1.0


def _mssd_np(r_est, t_est, r_gt, t_gt, pts, syms) -> float:
    pts_est = pts @ r_est.T + t_est
    best = np.inf
    for sr, st in syms:
        r_sym = r_gt @ sr
        t_sym = r_gt @ st + t_gt
        err = np.linalg.norm(pts @ r_sym.T + t_sym - pts_est, axis=1).max()
        best = min(best, err)
    return float(best)


def _mspd_np(r_est, t_est, r_gt, t_gt, k, pts, syms) -> float:
    def proj(r, t):
        cam = pts @ r.T + t
        uvw = cam @ k.T
        return uvw[:, :2] / uvw[:, 2:3]

    p_est = proj(r_est, t_est)
    best = np.inf
    for sr, st in syms:
        r_sym = r_gt @ sr
        t_sym = r_gt @ st + t_gt
        err = np.linalg.norm(proj(r_sym, t_sym) - p_est, axis=1).max()
        best = min(best, err)
    return float(best)


def depth_to_dist(depth: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Z-depth image -> euclidean-distance-from-center image.

    bop_toolkit computes VSD on distance images
    (misc.depth_im_to_dist_im_fast), not raw z-depth.
    """
    h, w = depth.shape
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    d = depth.astype(np.float64)
    xc = (xs - k[0, 2]) * d / k[0, 0]
    yc = (ys - k[1, 2]) * d / k[1, 1]
    return np.sqrt(xc**2 + yc**2 + d**2)


def _visib_mask_bop19(dist_test: np.ndarray, dist_model: np.ndarray,
                      delta: float) -> np.ndarray:
    """bop_toolkit visibility.'bop19' mode: the model surface is visible
    where it is rendered AND (it is within delta in front of the test
    depth OR the test depth is missing)."""
    d_diff = dist_model - dist_test
    return np.logical_and(
        np.logical_or(d_diff <= delta, dist_test == 0), dist_model > 0
    )


def vsd_errors(
    dist_est: np.ndarray,
    dist_gt: np.ndarray,
    dist_test: np.ndarray,
    taus_abs: Sequence[float],
    delta: float,
) -> List[float]:
    """BOP19 VSD errors (one per absolute tau) from distance images.

    Follows bop_toolkit pose_error.vsd with cost_type='step':
      visib_gt  = bop19 mask of the GT render vs the test depth
      visib_est = bop19 mask of the est render, OR'd with
                  (visib_gt & est rendered) — est pixels occluded in the
                  test image still count where the GT is visible
      e(tau) = (#{inter pixels with |dist diff| > tau} + #union - #inter)
               / #union,  or 1.0 when the union is empty.
    """
    visib_gt = _visib_mask_bop19(dist_test, dist_gt, delta)
    visib_est = _visib_mask_bop19(dist_test, dist_est, delta)
    visib_est = np.logical_or(visib_est, np.logical_and(visib_gt, dist_est > 0))
    inter = np.logical_and(visib_gt, visib_est)
    union = np.logical_or(visib_gt, visib_est)
    n_union = int(union.sum())
    n_comp = n_union - int(inter.sum())
    if n_union == 0:
        return [1.0] * len(taus_abs)
    diff = np.abs(dist_est - dist_gt)[inter]
    return [float(((diff > tau).sum() + n_comp) / n_union) for tau in taus_abs]


def match_count(errs: np.ndarray, th: float) -> int:
    """Greedy per-threshold matching (bop_toolkit pose_matching.match_poses).

    `errs` is an [n_est, n_gt] error matrix with rows already in
    score-descending order. Each estimate claims the unmatched GT with the
    lowest error, PROVIDED that error < th. Returns the number of matches.
    """
    if errs.size == 0:
        return 0
    n_gt = errs.shape[1]
    matched = np.zeros(n_gt, dtype=bool)
    count = 0
    for row in errs:
        ok = np.where(~matched & (row < th))[0]
        if ok.size:
            gi = ok[np.argmin(row[ok])]
            matched[gi] = True
            count += 1
    return count


def evaluate_ar(
    estimates: Sequence[Estimate],
    gts: Sequence[GroundTruth],
    model_points: Dict[int, np.ndarray],
    diameters: Dict[int, float],
    symmetries: Dict[int, List[Tuple[np.ndarray, np.ndarray]]],
    intrinsics: Dict[Tuple[int, int], np.ndarray],
    image_width: int = 640,
    min_visib: float = 0.1,
    depth_images: Optional[Dict[Tuple[int, int], np.ndarray]] = None,
    renderer=None,
    cameras: Optional[Dict[Tuple[int, int], object]] = None,
    vsd_delta: float = 15.0,
) -> Dict[str, float]:
    """Returns {"ar_mssd", "ar_mspd", ["ar_vsd",] "bop_ar"}.

    VSD is evaluated only when depth_images + renderer + cameras are given.
    `renderer.render_object_model(obj_id, camera, T_model_to_world=...)`
    returns a mapping whose RenderType.DEPTH entry is the depth image (the
    port has no renderer yet; any object with that method serves).
    MSPD's thresholds scale with the one `image_width` of the call for
    every image (fault (b) kept, see the module docstring).
    """
    mssd_taus = np.arange(0.05, 0.51, 0.05)
    mspd_taus = np.arange(5, 51, 5) * (image_width / 640.0)
    vsd_taus = np.arange(0.05, 0.51, 0.05)  # x diameter
    vsd_ths = np.arange(0.05, 0.51, 0.05)

    by_key_est: Dict[Tuple[int, int, int], List[Estimate]] = {}
    for e in estimates:
        by_key_est.setdefault((e.scene_id, e.im_id, e.obj_id), []).append(e)
    by_key_gt: Dict[Tuple[int, int, int], List[GroundTruth]] = {}
    for g in gts:
        if g.visib_fract < min_visib:
            continue
        by_key_gt.setdefault((g.scene_id, g.im_id, g.obj_id), []).append(g)

    mssd_hits = np.zeros(len(mssd_taus))
    mspd_hits = np.zeros(len(mspd_taus))
    vsd_hits = np.zeros((len(vsd_taus), len(vsd_ths)))
    total = 0
    do_vsd = depth_images is not None and renderer is not None and cameras is not None

    for key, gt_list in by_key_gt.items():
        scene_id, im_id, obj_id = key
        total += len(gt_list)
        # Top-n by score, n = #valid GTs (BOP19 n_top=-1 via inst_count).
        ests = sorted(by_key_est.get(key, []), key=lambda e: -e.score)[: len(gt_list)]
        if not ests:
            continue
        pts = model_points[obj_id]
        dia = diameters[obj_id]
        syms = symmetries.get(obj_id, [(np.eye(3), np.zeros(3))])
        k = intrinsics[(scene_id, im_id)]

        # Error matrices [n_est, n_gt], rows in score order.
        em = np.array(
            [[_mssd_np(e.R, e.t, g.R, g.t, pts, syms) for g in gt_list] for e in ests]
        )
        ep = np.array(
            [[_mspd_np(e.R, e.t, g.R, g.t, k, pts, syms) for g in gt_list] for e in ests]
        )
        for ti, th in enumerate(mssd_taus):
            mssd_hits[ti] += match_count(em, th * dia)
        for ti, th in enumerate(mspd_taus):
            mspd_hits[ti] += match_count(ep, th)

        if do_vsd:
            cam = cameras[(scene_id, im_id)]
            dist_test = depth_to_dist(
                np.asarray(depth_images[(scene_id, im_id)], dtype=np.float64), k
            )

            def render_dist(r, t):
                t_m2w = np.eye(4)
                t_m2w[:3, :3] = r
                t_m2w[:3, 3] = t
                out = renderer.render_object_model(
                    obj_id, cam,
                    T_model_to_world=np.asarray(cam.T_world_from_eye) @ t_m2w,
                )
                return depth_to_dist(
                    np.asarray(out[RenderType.DEPTH], dtype=np.float64), k
                )

            dist_gts = [render_dist(g.R, g.t) for g in gt_list]
            taus_abs = vsd_taus * dia
            # [n_est, n_gt, n_tau] error tensor.
            ev = np.empty((len(ests), len(gt_list), len(vsd_taus)))
            for ei, e in enumerate(ests):
                dist_est = render_dist(e.R, e.t)
                for gi in range(len(gt_list)):
                    ev[ei, gi] = vsd_errors(
                        dist_est, dist_gts[gi], dist_test, taus_abs, vsd_delta
                    )
            for ti in range(len(vsd_taus)):
                for hi, th in enumerate(vsd_ths):
                    vsd_hits[ti, hi] += match_count(ev[:, :, ti], th)

    if total == 0:
        return {"ar_mssd": 0.0, "ar_mspd": 0.0, "bop_ar": 0.0}
    out = {
        "ar_mssd": float(mssd_hits.mean() / total),
        "ar_mspd": float(mspd_hits.mean() / total),
    }
    if do_vsd:
        out["ar_vsd"] = float(vsd_hits.mean() / total)
        out["bop_ar"] = float(np.mean([out["ar_vsd"], out["ar_mssd"], out["ar_mspd"]]))
    else:
        out["bop_ar"] = float(np.mean([out["ar_mssd"], out["ar_mspd"]]))
    return out


def load_estimates_from_csv(path: str) -> List[Estimate]:
    """Reads a BOP19 submission CSV (as written by write_bop_submission)."""
    out = []
    with open(path) as f:
        header = f.readline()
        assert header.startswith("scene_id")
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 7:
                continue
            r = np.asarray([float(x) for x in parts[4].split()]).reshape(3, 3)
            t = np.asarray([float(x) for x in parts[5].split()])
            out.append(
                Estimate(
                    scene_id=int(parts[0]), im_id=int(parts[1]),
                    obj_id=int(parts[2]), score=float(parts[3]), R=r, t=t,
                )
            )
    return out
