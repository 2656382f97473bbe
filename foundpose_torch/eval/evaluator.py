"""Pose-estimate accumulation, scoring, and BOP-format result export
(counterpart of foundpose_tpu/eval/evaluator.py).

Host-side re-design of the reference `EvaluatorPose`
(reference: utils/eval_util.py:26-590). The MSSD/MSPD errors run as torch
ops on the CPU via `eval/errors.py`; this module accumulates
per-estimate records and writes `estimated-poses.json` files with the same
field names as the reference (so `prepare_bop_submission` consumers are
interchangeable), the per-object TSV metric tables
(reference: utils/eval_util.py:400-516), plus the BOP19 submission CSV
(reference: scripts/prepare_bop_submission.py:64-99).

Per-estimate accumulators (reference: utils/eval_util.py:26-229):
MSSD, MSPD, diameter-normalized MSSD, inlier counts and many-to-many-aware
inlier ratios vs GT and vs estimate, per-vertex point errors, rotation /
translation errors, detection mask IoU, retrieved-template orientation error.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from foundpose_torch.eval import errors as err_mod
from foundpose_torch.structs import PinholeCamera


def _tolist(x):
    return np.asarray(x).tolist()


def _np(x) -> np.ndarray:
    """A host copy of a tensor (on any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _j(x, dtype=torch.float32):
    return torch.as_tensor(_np(x), dtype=dtype)


def _project_points(r: np.ndarray, t: np.ndarray, pts: np.ndarray,
                    f: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Pinhole projection of model points under [R|t] (numpy, host-side)."""
    cam = pts @ r.T + t
    z = np.where(np.abs(cam[:, 2:3]) < 1e-9, 1e-9, cam[:, 2:3])
    return cam[:, :2] / z * f + c


def many_to_many_inlier_ratio(
    dist: np.ndarray, coord_2d_ids: np.ndarray, valid: np.ndarray,
    inlier_radius: float,
) -> float:
    """Fraction of unique query points with >=1 correspondence within the
    radius — the reference's many-to-many-aware inlier ratio
    (reference: utils/eval_util.py:126-150, vectorized)."""
    ids = coord_2d_ids[valid].astype(np.int64)
    if ids.size == 0:
        return 0.0
    d = dist[valid]
    n = int(ids.max()) + 1
    present = np.zeros(n, bool)
    present[ids] = True
    hit = np.zeros(n, bool)
    hit[ids[d <= inlier_radius]] = True
    return float(hit.sum() / max(present.sum(), 1))


@dataclasses.dataclass
class PoseRecord:
    scene_id: int
    im_id: int
    obj_id: int
    inst_id: int
    hypothesis_id: int
    score: float
    R_m2c_orig: np.ndarray  # model -> original camera
    t_m2c_orig: np.ndarray
    time: Dict[str, float]
    mssd: Optional[float] = None
    mspd: Optional[float] = None
    mssd_n: Optional[float] = None  # MSSD / object diameter
    rotation_err_deg: Optional[float] = None
    translation_err: Optional[float] = None
    inliers_est: Optional[int] = None
    inliers_gt: Optional[int] = None
    inliers_est_err: Optional[Dict[str, float]] = None  # many-to-many ratio
    inliers_gt_err: Optional[Dict[str, float]] = None
    mask_iou: Optional[float] = None
    template_ori_err_deg: Optional[float] = None
    point_errors: Optional[np.ndarray] = None  # per-vertex distances


class EvaluatorPose:
    """Accumulates pose estimates for one or more objects across a test split."""

    def __init__(self, obj_ids: Sequence[int]):
        self.obj_ids = list(obj_ids)
        self.records: List[PoseRecord] = []
        self.detection_times: Dict[Tuple[int, int], float] = {}

    # -- updates -------------------------------------------------------------

    def update(
        self,
        scene_id: int,
        im_id: int,
        inst_id: int,
        hypothesis_id: int,
        obj_id: int,
        R_m2w: np.ndarray,
        t_m2w: np.ndarray,
        orig_camera_c2w: PinholeCamera,
        score: float,
        time_per_inst: Dict[str, float],
        R_gt_m2c: Optional[np.ndarray] = None,
        t_gt_m2c: Optional[np.ndarray] = None,
        model_pts: Optional[np.ndarray] = None,
        sym_r: Optional[np.ndarray] = None,
        sym_t: Optional[np.ndarray] = None,
        K: Optional[np.ndarray] = None,
        camera_c2w: Optional[PinholeCamera] = None,
        corresp: Optional[Dict[str, np.ndarray]] = None,
        pred_mask: Optional[np.ndarray] = None,
        gt_mask: Optional[np.ndarray] = None,
        object_diameter: Optional[float] = None,
        retrieved_template_R_m2c: Optional[np.ndarray] = None,
        mask_iou: Optional[float] = None,
        inlier_radius: float = 10.0,
    ) -> PoseRecord:
        """Registers one estimate; computes GT errors when GT is provided.

        The world-frame pose is re-expressed in the original camera (the frame
        BOP expects), reference: utils/eval_util.py:247-255. When `camera_c2w`
        (the crop camera) and `corresp` (coord_2d [K,2], coord_2d_ids [K],
        coord_3d [K,3], valid [K]) are given, inlier counts and many-to-many
        inlier ratios vs the estimate (and vs GT if available) are computed in
        the crop camera, matching reference: utils/eval_util.py:107-150.
        """
        t_w2oc = np.linalg.inv(_np(orig_camera_c2w.T_world_from_eye))
        m2w = np.eye(4)
        m2w[:3, :3] = _np(R_m2w)
        m2w[:3, 3] = _np(t_m2w).flatten()
        m2oc = t_w2oc @ m2w
        r_est = m2oc[:3, :3]
        t_est = m2oc[:3, 3]

        rec = PoseRecord(
            scene_id=scene_id,
            im_id=im_id,
            obj_id=obj_id,
            inst_id=inst_id,
            hypothesis_id=hypothesis_id,
            score=float(score),
            R_m2c_orig=r_est,
            t_m2c_orig=t_est,
            time=dict(time_per_inst),
        )

        have_gt = R_gt_m2c is not None
        t_gt_flat = np.asarray(t_gt_m2c).flatten() if have_gt else None
        rkey = str(int(inlier_radius))

        # -- correspondence-space inliers in the crop camera ------------------
        if camera_c2w is not None and corresp is not None:
            t_w2c = np.linalg.inv(_np(camera_c2w.T_world_from_eye))
            m2c = t_w2c @ m2w
            f = _np(camera_c2w.f).astype(np.float64)
            c = _np(camera_c2w.c).astype(np.float64)
            c2d = np.asarray(corresp["coord_2d"], dtype=np.float64)
            c3d = np.asarray(corresp["coord_3d"], dtype=np.float64)
            ids = np.asarray(corresp["coord_2d_ids"])
            valid = np.asarray(corresp["valid"]).astype(bool)

            proj_est = _project_points(m2c[:3, :3], m2c[:3, 3], c3d, f, c)
            dist_est = np.linalg.norm(proj_est - c2d, axis=1)
            rec.inliers_est = int(np.sum((dist_est <= inlier_radius) & valid))
            rec.inliers_est_err = {
                rkey: many_to_many_inlier_ratio(dist_est, ids, valid, inlier_radius)
            }
            if have_gt:
                proj_gt = _project_points(
                    np.asarray(R_gt_m2c, dtype=np.float64), t_gt_flat, c3d, f, c
                )
                dist_gt = np.linalg.norm(proj_gt - c2d, axis=1)
                rec.inliers_gt = int(np.sum((dist_gt <= inlier_radius) & valid))
                rec.inliers_gt_err = {
                    rkey: many_to_many_inlier_ratio(dist_gt, ids, valid, inlier_radius)
                }

        # -- GT pose errors ----------------------------------------------------
        if have_gt and model_pts is not None:
            sr = sym_r if sym_r is not None else np.eye(3)[None]
            st = sym_t if sym_t is not None else np.zeros((1, 3))
            # GT errors compare poses in the crop camera in the reference
            # (eval_util.py:99-105); both poses transform by the same rigid
            # w2c, under which MSSD/point/rotation/translation errors are
            # invariant, so the original-camera frame is used throughout.
            rec.mssd = float(
                err_mod.mssd(
                    _j(r_est), _j(t_est), _j(R_gt_m2c), _j(t_gt_flat),
                    _j(model_pts), _j(sr), _j(st),
                )[0]
            )
            if object_diameter:
                rec.mssd_n = rec.mssd / float(object_diameter)
            if K is not None:
                rec.mspd = float(
                    err_mod.mspd(
                        _j(r_est), _j(t_est), _j(R_gt_m2c), _j(t_gt_flat),
                        _j(K), _j(model_pts), _j(sr), _j(st),
                    )[0]
                )
            rec.rotation_err_deg = float(
                err_mod.rotation_error_deg(_j(r_est), _j(R_gt_m2c))
            )
            rec.translation_err = float(np.linalg.norm(t_est - t_gt_flat))
            # Per-vertex point errors (frame-invariant; reference
            # eval_util.py:164-167 "Object DPE metrics").
            pts = np.asarray(model_pts, dtype=np.float64)
            pe = np.linalg.norm(
                (pts @ r_est.T + t_est)
                - (pts @ np.asarray(R_gt_m2c, dtype=np.float64).T + t_gt_flat),
                axis=-1,
            )
            rec.point_errors = pe.astype(np.float32)
            # Orientation error of the best retrieved template
            # (reference: eval_util.py:175-188).
            if retrieved_template_R_m2c is not None:
                r_gt = np.asarray(R_gt_m2c, dtype=np.float64)
                errs = []
                for r_tpl in np.asarray(retrieved_template_R_m2c).reshape(-1, 3, 3):
                    for s_i in np.asarray(sr).reshape(-1, 3, 3):
                        r_gt_sym = r_gt @ s_i
                        cosang = np.clip(
                            (np.trace(r_tpl @ r_gt_sym.T) - 1) / 2, -1, 1
                        )
                        errs.append(np.degrees(np.arccos(cosang)))
                rec.template_ori_err_deg = float(min(errs))

        if mask_iou is not None:
            rec.mask_iou = float(mask_iou)
        elif pred_mask is not None and gt_mask is not None:
            rec.mask_iou = float(
                err_mod.mask_iou(_j(pred_mask), _j(gt_mask))
            )

        self.records.append(rec)
        return rec

    # -- export ---------------------------------------------------------------

    def save_results_json(self, path: str) -> None:
        """Writes `estimated-poses.json` with reference-compatible fields
        (reference: utils/eval_util.py:302-355)."""
        out = []
        for rec in self.records:
            cnos_time = self.detection_times.get((rec.scene_id, rec.im_id), 0.0)
            item = {
                "scene_id": str(rec.scene_id),
                "img_id": str(rec.im_id),
                "obj_id": str(rec.obj_id),
                "inst_id": str(rec.inst_id),
                "hypothesis_id": str(rec.hypothesis_id),
                "score": str(rec.score),
                "R": _tolist(rec.R_m2c_orig),
                "t": _tolist(rec.t_m2c_orig.reshape(3, 1)),
                "time": rec.time,
                "cnos_time": cnos_time,
            }
            # Reference field names (eval_util.py:336-352).
            if rec.mssd is not None:
                item["mssd"] = rec.mssd
            if rec.mspd is not None:
                item["mspd"] = rec.mspd
            if rec.mssd_n is not None:
                item["mssd_n"] = rec.mssd_n
            if rec.inliers_gt is not None:
                item["inliers_gt"] = rec.inliers_gt
            if rec.inliers_est is not None:
                item["inliers_est"] = rec.inliers_est
            if rec.inliers_gt_err is not None:
                item["inliers_gt_err"] = rec.inliers_gt_err
            if rec.inliers_est_err is not None:
                item["inliers_est_err"] = rec.inliers_est_err
            if rec.mask_iou is not None:
                item["mask_iou"] = rec.mask_iou
            if rec.template_ori_err_deg is not None:
                item["template_ori_err_deg"] = rec.template_ori_err_deg
            out.append(item)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f)

    def summary(self) -> Dict[str, float]:
        """Aggregate metric dict (mean/median per metric)."""
        recs = self.records
        out: Dict[str, float] = {"num_estimates": float(len(recs))}
        for field in [
            "mssd", "mspd", "mssd_n", "rotation_err_deg", "translation_err",
            "score", "mask_iou", "template_ori_err_deg",
        ]:
            vals = [getattr(r, field) for r in recs if getattr(r, field) is not None]
            if vals:
                out[f"{field}_mean"] = float(np.mean(vals))
                out[f"{field}_median"] = float(np.median(vals))
        for field in ["inliers_est_err", "inliers_gt_err"]:
            vals = [
                list(getattr(r, field).values())[0]
                for r in recs
                if getattr(r, field) is not None
            ]
            if vals:
                out[f"{field}_mean"] = float(np.mean(vals))
        return out

    def save_metrics(self, path: str, inlier_thresh: float = 10.0) -> None:
        """Writes the run-level TSV metric table with per-object columns and
        p50/p95 error percentiles, mirroring the reference table layout
        (reference: utils/eval_util.py:400-516):

        rows = mssd, mssd_n, mspd, inliers_gt, inliers_est, Point_p50/p95,
        Rot_p50/p95, Trans_p50/p95, Tpl_ori_err, mask_iou, num_obj;
        columns = overall, pmean (per-class mean), one column per object.
        """
        from tabulate import tabulate

        rkey = str(int(inlier_thresh))
        recs = self.records

        def col(r_list, fn):
            vals = [fn(r) for r in r_list]
            vals = [v for v in vals if v is not None]
            return vals

        def agg(vals, how="mean", q=None):
            if not vals:
                return float("nan")
            arr = (
                np.concatenate([np.atleast_1d(np.asarray(v)) for v in vals])
                if isinstance(vals[0], np.ndarray)
                else np.asarray(vals, dtype=np.float64)
            )
            # Drop NaNs up front: nanmean/nanpercentile on an all-NaN slice
            # emits RuntimeWarnings on legitimate paths (e.g. no-GT runs).
            arr = arr[~np.isnan(arr)]
            if arr.size == 0:
                return float("nan")
            if how == "pct":
                return float(np.percentile(arr, q))
            return float(np.mean(arr))

        metrics = [
            ("mssd", lambda r: r.mssd, "mean", None),
            ("mssd_n", lambda r: r.mssd_n, "mean", None),
            ("mspd", lambda r: r.mspd, "mean", None),
            ("inliers_gt", lambda r: (r.inliers_gt_err or {}).get(rkey), "mean", None),
            ("inliers_est", lambda r: (r.inliers_est_err or {}).get(rkey), "mean", None),
            ("Point_p50", lambda r: r.point_errors, "pct", 50),
            ("Point_p95", lambda r: r.point_errors, "pct", 95),
            ("Rot_p50", lambda r: r.rotation_err_deg, "pct", 50),
            ("Rot_p95", lambda r: r.rotation_err_deg, "pct", 95),
            ("Trans_p50", lambda r: r.translation_err, "pct", 50),
            ("Trans_p95", lambda r: r.translation_err, "pct", 95),
            ("Tpl_ori_err", lambda r: r.template_ori_err_deg, "mean", None),
            ("mask_iou", lambda r: r.mask_iou, "mean", None),
        ]

        per_obj_recs = {o: [r for r in recs if r.obj_id == o] for o in self.obj_ids}
        header = ["", "overall", "pmean"] + [str(o) for o in self.obj_ids]
        table = []
        for name, fn, how, q in metrics:
            per_class = [agg(col(per_obj_recs[o], fn), how, q) for o in self.obj_ids]
            overall = agg(col(recs, fn), how, q)
            pc_valid = [v for v in per_class if not np.isnan(v)]
            pmean = float(np.mean(pc_valid)) if pc_valid else float("nan")
            table.append([name, overall, pmean] + per_class)
        table.append(
            ["num_obj", len(recs), float(np.mean([len(v) for v in per_obj_recs.values()]))]
            + [len(per_obj_recs[o]) for o in self.obj_ids]
        )

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(
                tabulate(
                    table, headers=header, tablefmt="tsv", floatfmt=".2f",
                    numalign=None, stralign=None,
                )
            )

    def save_metrics_tsv(self, path: str) -> None:
        """Writes the aggregate summary() dict as a two-column TSV."""
        from tabulate import tabulate

        s = self.summary()
        rows = [[k, f"{v:.4f}"] for k, v in sorted(s.items())]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(tabulate(rows, headers=["metric", "value"], tablefmt="tsv"))


def write_bop_submission(
    output_path: str,
    per_object_results: Dict[int, List[Dict[str, Any]]],
    detection_times: Optional[Dict[Tuple[int, int], float]] = None,
) -> None:
    """Writes the BOP19 CSV `scene_id,im_id,obj_id,score,R,t,time`.

    Each object's entries come from its `estimated-poses.json` records. Total
    per-image time = pipeline stage times + detection time, matching the
    reference flattening (reference: scripts/prepare_bop_submission.py:33-99).
    """
    detection_times = detection_times or {}

    # Accumulate total runtime per image across all objects.
    run_time: Dict[Tuple[int, int], float] = {}
    for recs in per_object_results.values():
        for r in recs:
            key = (int(r["scene_id"]), int(r["img_id"]))
            t = sum(float(v) for v in r.get("time", {}).values())
            run_time[key] = run_time.get(key, 0.0) + t
    for key, cnos_t in detection_times.items():
        if key in run_time:
            run_time[key] += float(cnos_t)

    lines = ["scene_id,im_id,obj_id,score,R,t,time"]
    for obj_id in sorted(per_object_results):
        for r in per_object_results[obj_id]:
            key = (int(r["scene_id"]), int(r["img_id"]))
            rr = " ".join(map(str, np.asarray(r["R"], dtype=float).flatten().tolist()))
            tt = " ".join(map(str, np.asarray(r["t"], dtype=float).flatten().tolist()))
            lines.append(
                f'{r["scene_id"]},{r["img_id"]},{r["obj_id"]},{r["score"]},'
                f"{rr},{tt},{run_time.get(key, 0.0)}"
            )
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "wb") as f:
        f.write("\n".join(lines).encode("utf-8"))
