"""Whether what the timed path produced is correct: numbers against limits.

Each number is the worst case over a sample of the window's answers,
drawn from the seed once the window has closed:

- score_err: |template score the program reports - the reference's tf-idf
  similarity of that template|, over the top templates of every sampled
  crop: the ViT (kernel 1), the query grid, PCA and tf-idf retrieval.
- buddy_gap: for every valid correspondence of the winning template, how
  much farther (squared L2, in the reference's float32 features, over the
  query feature's squared norm) the template feature it was matched to lies
  than the nearest one: cyclic-buddy matching (kernel 3).
- rot_err_deg, t_err_mm: the pose of every sampled solvable crop against
  the pose it was built with: the solve (RANSAC scored by kernel 2, LO,
  LM) and, when serving, the crop cameras and the frame's pose.
- warp_err (serving): the largest gap, in levels of 255, between a crop as
  the program warped it and the reference's warp of the same box
  (`ops/warp`). When serving, score_err and buddy_gap judge the step's own
  template scores and correspondences against the reference's analysis of
  the reference's warp, so they cover the warp too.
- own_miss: solvable crops that did not succeed with their own template as
  the winner; nonfinite: answers that are not finite. Both exact: limit 0.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from perfbench.reference import pipeline, retrieval
from perfbench.reference.pose import rotation_error_deg
from perfbench.reference.precision import Precision, exact_f32

EXACT = ("own_miss", "nonfinite")


def merge(parts) -> Dict[str, float]:
    """Worst case over samples: the largest gap, the sum of counts."""
    out: Dict[str, float] = {}
    for p in parts:
        for k, v in p.items():
            out[k] = out.get(k, 0) + v if k in EXACT else max(out.get(k, 0.0), v)
    return out


def nonfinite(arrays) -> int:
    """Rows with any non-finite value, over arrays with a leading row axis."""
    bad = np.zeros(len(arrays[0]), dtype=bool)
    for a in arrays:
        bad |= ~np.isfinite(np.asarray(a, dtype=np.float64).reshape(len(a), -1)).all(1)
    return int(bad.sum())


def pose_numbers(success, best, R, t, own, R_true, t_true) -> Dict[str, float]:
    """rot_err_deg, t_err_mm and own_miss of the solvable rows (own >= 0)
    against their true poses (rows of R_true, t_true)."""
    s = own >= 0
    if not s.any():
        return {"own_miss": 0}
    rot = rotation_error_deg(torch.as_tensor(R[s]).reshape(-1, 3, 3),
                             torch.as_tensor(R_true[s]).reshape(-1, 3, 3))
    t_mm = np.linalg.norm(np.asarray(t[s], dtype=np.float64).reshape(-1, 3)
                          - np.asarray(t_true[s], dtype=np.float64).reshape(-1, 3), axis=1) * 1e3
    miss = (~(np.asarray(success[s]).reshape(-1) > 0.5)) | (
        np.asarray(best[s]).reshape(-1).round() != own[s])
    return {"rot_err_deg": float(np.nan_to_num(rot.numpy(), nan=180.0).max()),
            "t_err_mm": float(np.nan_to_num(t_mm, nan=1e9).max()), "own_miss": int(miss.sum())}


@torch.no_grad()
def feature_numbers(out, ana, world) -> Dict[str, float]:
    """score_err and buddy_gap of one sampled batch. out: the step's
    template ids and scores, best template and correspondences as fetched
    (per crop); ana: the reference's analysis of the same crops
    (pipeline.analyse)."""
    dev = ana["sims"].device
    ids = torch.as_tensor(out["template_ids"], device=dev).round().long()
    sims = ana["sims"]
    at = torch.gather(sims, 1, ids)
    score_err = (torch.as_tensor(out["template_scores"], device=dev) - at).abs().amax()

    best = torch.as_tensor(out["best_template"], device=dev).round().long().reshape(-1)
    q_ids = torch.as_tensor(out["corr_q"], device=dev).round().long()
    c3d = torch.as_tensor(out["corr_3d"], device=dev).reshape(len(best), -1, 3)
    cvalid = torch.as_tensor(out["corr_valid"], device=dev) > 0.5
    bank_v, bank_f = world["bank_vertices"][best], world["bank_feats"][best]
    bank_m = world["bank_mask"][best]
    with exact_f32():
        prec = Precision()
        # The bank row each correspondence's 3D point came from.
        dv = retrieval.sqdist(c3d, bank_v, prec)
        v_ids = torch.where(bank_m[:, None, :], dv, torch.inf).argmin(-1)
        d = retrieval.sqdist(ana["q"], bank_f, prec)  # [B, Q, F]
        d = torch.where(bank_m[:, None, :], d, torch.inf)
        dq = torch.gather(d, 1, q_ids[..., None].expand(-1, -1, d.shape[2]))  # [B, K, F]
        chosen = torch.gather(dq, 2, v_ids[..., None])[..., 0]
        norm = torch.gather((ana["q"] ** 2).sum(-1), 1, q_ids).clamp_min(1e-12)
        gap = torch.where(cvalid, (chosen - dq.amin(-1)) / norm, 0.0)
    return {"score_err": float(score_err),
            "buddy_gap": float(gap.amax()) if cvalid.any() else 0.0}


def offline_numbers(out, ana, world, own) -> Dict[str, float]:
    """The numbers of one sampled batch: `feature_numbers` and the pose
    numbers of its solvable crops (own: each crop's own template or -1)."""
    numbers = feature_numbers(out, ana, world)
    r_true, t_true = true_poses(world, own)
    numbers.update(pose_numbers(out["success"], out["best_template"], out["R"], out["t"], own,
                                r_true, t_true))
    return numbers


def true_poses(world, own):
    """The crop-camera poses [n, 3, 3], [n, 3] (numpy) the solvable crops
    were built with (identity for the others, which are not judged)."""
    r = np.broadcast_to(np.eye(3), (len(own), 3, 3)).copy()
    t = np.zeros((len(own), 3))
    s = own >= 0
    r[s] = world["pose_R"][torch.as_tensor(own[s])].double().cpu().numpy()
    t[s] = world["pose_t"][torch.as_tensor(own[s])].double().cpu().numpy()
    return r, t


def verdict(numbers: Dict[str, float], limits: Dict[str, dict]):
    """(correct, checks): every limited number at or under its limit, and
    each number beside its limit. A number the run could not read counts as
    failed."""
    checks, ok = {}, True
    for name, spec in limits.items():
        if name.startswith("_"):
            continue
        value = numbers.get(name)
        checks[name] = {"value": value, "limit": spec["limit"]}
        if value is None or not np.isfinite(value) or value > spec["limit"]:
            ok = False
    return ok, checks


def control_answers(s, crops, masks, f, c, prec: Precision):
    """The reference in the program's place at `prec` (the control), on the
    crops of a harness.Setup `s`: answers named as the judge reads the
    program's."""
    ana = pipeline.analyse(s.ref_vit, s.world, crops, masks, s.cell_px, prec)
    out = pipeline.outputs(ana, s.world, f, c, s.config.top_n_templates,
                           s.config.top_k_buddies, prec)
    n = len(crops)
    return {"template_ids": out["template_ids"], "template_scores": out["template_scores"],
            "best_template": out["best_template"], "success": out["success"].float(),
            "corr_q": out["corr_q"], "corr_3d": out["corr_3d"].reshape(n, -1),
            "corr_valid": out["corr_valid"].float(), "R": out["R"].reshape(n, 9), "t": out["t"]}
