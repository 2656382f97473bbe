"""Multi-dataset BOP sweep: runs the full inference over several datasets
(counterpart of foundpose_tpu/pipeline/sweep.py).

Scale-out entry point with no reference counterpart (the reference is launched per
dataset by hand; SURVEY.md §2.4). One process sweeps datasets sequentially;
each (dataset, object) writes its own `estimated-poses.json` and the sweep
finishes with one BOP19 CSV per dataset. Resumable at (dataset, object)
granularity via InferOpts.resume. Runs on `device` ("cuda" unless the
caller asks for "cpu").
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from foundpose_torch.parallel import host_shard
from foundpose_torch.pipeline import infer as infer_mod
from foundpose_torch.pipeline import prepare_bop_submission as sub_mod
from foundpose_torch.utils import config as config_util
from foundpose_torch.utils.logging_util import get_logger, log_heading

logger = get_logger()


@dataclasses.dataclass(frozen=True)
class SweepOpts:
    datasets: List[str] = dataclasses.field(
        default_factory=lambda: ["lmo", "tudl", "ycbv", "tless"]
    )
    version: str = "v1"
    repre_version: str = "v1"
    extractor_name: str = (
        "dinov2_version=vits14-reg_stride=14_facet=token_layer=9_norm=1"
    )
    weights_path: Optional[str] = None
    batch_size: int = 16
    resume: bool = True

    # Multi-host dataset sharding (parallel/host_shard.py): each host runs
    # the sweep with its own shard_index; shard_count=0 resolves from
    # torch.distributed. Sharded sweeps skip the per-dataset
    # submission CSV (it needs ALL shards' artifacts) — run
    # prepare_bop_submission once afterwards; it merges the shard files.
    shard_index: int = 0
    shard_count: int = 1

    bop_root: str = ""
    repre_dir: str = ""
    detections_dir: str = ""  # expects <dir>/<dataset>.json
    output_dir: str = ""
    device: str = "cuda"


def sweep(opts: SweepOpts) -> Dict[str, str]:
    """Runs all datasets; returns {dataset: submission_csv_path}."""
    out = {}
    for ds in opts.datasets:
        log_heading(logger, f"Sweep: dataset {ds}")
        infer_opts = infer_mod.InferOpts(
            version=opts.version,
            repre_version=opts.repre_version,
            object_dataset=ds,
            extractor_name=opts.extractor_name,
            weights_path=opts.weights_path,
            batch_size=opts.batch_size,
            resume=opts.resume,
            bop_root=opts.bop_root,
            repre_dir=opts.repre_dir,
            detections_path=os.path.join(opts.detections_dir, f"{ds}.json"),
            output_dir=opts.output_dir,
            shard_index=opts.shard_index,
            shard_count=opts.shard_count,
            device=opts.device,
        )
        infer_mod.infer(infer_opts)
        # Branch on the RESOLVED count: shard_count=0 on a single-process
        # runtime resolves to (0, 1) and the artifacts ARE complete.
        _, resolved_count = host_shard.shard_of(opts)
        if resolved_count != 1:
            # The BOP19 CSV needs every shard's artifacts; this host only
            # wrote its own. prepare_bop_submission (run once, afterwards)
            # merges the shard-suffixed files.
            logger.info(
                f"Sharded sweep: skipping submission CSV for {ds}; run "
                "prepare_bop_submission after all shards finish."
            )
            out[ds] = os.path.join(opts.output_dir, ds, opts.version)
            continue
        csv = sub_mod.prepare(
            sub_mod.PrepareBopSubmissionOpts(
                object_dataset=ds,
                version=opts.version,
                results_dir=opts.output_dir,
            )
        )
        out[ds] = csv
    return out


def main() -> None:
    sweep(config_util.load_opts(SweepOpts))


if __name__ == "__main__":
    main()
