"""CLI: BOP19 AR evaluation of a submission CSV against dataset ground truth
(counterpart of foundpose_tpu/pipeline/eval_ar.py; host-side numpy).

    python -m foundpose_torch.pipeline.eval_ar --submission-path <csv> \\
        --bop-root <root> --object-dataset lmo [--output-path ar.json]

Replaces the reference's dependency on the external bop_toolkit evaluation
scripts (reference README.md:173-181): loads the submission CSV, dataset GT,
models and symmetries, and reports AR_MSSD / AR_MSPD (and AR_VSD when depth
is available) via eval/bop_ar.py.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Tuple

import numpy as np

from foundpose_torch.data import bop
from foundpose_torch.eval import bop_ar
from foundpose_torch.utils import config as config_util
from foundpose_torch.utils.logging_util import get_logger

logger = get_logger()


@dataclasses.dataclass(frozen=True)
class EvalArOpts:
    object_dataset: str = "lmo"
    submission_path: str = ""
    bop_root: str = ""
    max_sym_disc_step: float = 0.01
    use_vsd: bool = False
    model_points_cap: int = 1000
    output_path: str = ""


def evaluate(opts: EvalArOpts) -> Dict[str, float]:
    estimates = bop_ar.load_estimates_from_csv(opts.submission_path)
    models_info = bop.load_models_info(opts.bop_root, opts.object_dataset)

    obj_ids = sorted({e.obj_id for e in estimates})
    model_points, diameters, symmetries = {}, {}, {}
    for oid in obj_ids:
        mesh = bop.load_object_model(opts.bop_root, opts.object_dataset, oid)
        pts = mesh.vertices
        if len(pts) > opts.model_points_cap:
            pts = pts[np.linspace(0, len(pts) - 1, opts.model_points_cap).astype(int)]
        model_points[oid] = pts
        info = models_info.get(oid, {})
        diameters[oid] = float(info.get("diameter", 100.0))
        syms = bop.get_symmetry_transformations(info, opts.max_sym_disc_step)
        symmetries[oid] = [
            (np.asarray(s["R"]), np.asarray(s["t"]).flatten()) for s in syms
        ]

    # Ground truth + intrinsics for every image referenced by the estimates.
    image_keys = sorted({(e.scene_id, e.im_id) for e in estimates})
    gts: List[bop_ar.GroundTruth] = []
    intrinsics: Dict[Tuple[int, int], np.ndarray] = {}
    image_width = 640
    for scene_id in sorted({s for s, _ in image_keys}):
        scene_dir = os.path.join(
            bop.split_dir(opts.bop_root, opts.object_dataset), f"{scene_id:06d}"
        )
        cams = bop.load_scene_camera(scene_dir)
        scene_gt = bop.load_scene_gt(scene_dir)
        infos = bop.load_scene_gt_info(scene_dir)
        for s, im_id in image_keys:
            if s != scene_id:
                continue
            intrinsics[(scene_id, im_id)] = cams[im_id]["K"]
            for g, info in zip(
                scene_gt.get(im_id, []), infos.get(im_id, [{}] * 99)
            ):
                if g["obj_id"] not in obj_ids:
                    continue
                gts.append(
                    bop_ar.GroundTruth(
                        scene_id=scene_id,
                        im_id=im_id,
                        obj_id=g["obj_id"],
                        R=g["R"],
                        t=g["t"],
                        visib_fract=float(info.get("visib_fract", 1.0)),
                    )
                )

    out = bop_ar.evaluate_ar(
        estimates, gts, model_points, diameters, symmetries, intrinsics,
        image_width=image_width,
    )
    logger.info(f"AR results for {opts.object_dataset}: {out}")
    if opts.output_path:
        with open(opts.output_path, "w") as f:
            json.dump(out, f, indent=2)
    return out


def main() -> None:
    evaluate(config_util.load_opts(EvalArOpts))


if __name__ == "__main__":
    main()
