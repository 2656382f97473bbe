"""Flattens per-object `estimated-poses.json` files into a BOP19 CSV
(counterpart of foundpose_tpu/pipeline/prepare_bop_submission.py).

    python -m foundpose_torch.pipeline.prepare_bop_submission \\
        --results-dir <infer output_dir> --object-dataset lmo

Re-design of the reference submission script
(reference: scripts/prepare_bop_submission.py:33-99); the CSV writer lives in
eval/evaluator.py and is shared with tests. Per-object records are gathered
through `parallel/host_shard.load_object_estimates`, which also merges the
shard-suffixed files written by multi-host runs (InferOpts.shard_count > 1).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

from foundpose_torch.eval.evaluator import write_bop_submission
from foundpose_torch.parallel import host_shard
from foundpose_torch.utils import config as config_util
from foundpose_torch.utils.logging_util import get_logger

logger = get_logger()


@dataclasses.dataclass(frozen=True)
class PrepareBopSubmissionOpts:
    object_dataset: str = "lmo"
    version: str = "v1"
    object_lids: Optional[List[int]] = None
    results_dir: str = ""
    output_path: str = ""


def prepare(opts: PrepareBopSubmissionOpts) -> str:
    base = os.path.join(opts.results_dir, opts.object_dataset, opts.version)
    lids = opts.object_lids
    if lids is None:
        lids = sorted(int(d) for d in os.listdir(base) if d.isdigit())

    per_object = {}
    detection_times = {}
    for lid in lids:
        records, paths = host_shard.load_object_estimates(
            os.path.join(base, str(lid))
        )
        if not paths:
            raise FileNotFoundError(
                f"no estimated-poses[.json|_shard*of*.json] under "
                f"{os.path.join(base, str(lid))}"
            )
        logger.info(
            f"Object {lid}: {len(records)} records from {len(paths)} file(s)"
        )
        per_object[lid] = records
        for r in records:
            key = (int(r["scene_id"]), int(r["img_id"]))
            detection_times[key] = float(r.get("cnos_time", 0.0))

    out_path = opts.output_path or os.path.join(
        base, f"coarse_{opts.object_dataset}-estimated-poses.csv"
    )
    write_bop_submission(out_path, per_object, detection_times)
    logger.info(f"Wrote BOP submission: {out_path}")
    return out_path


def main() -> None:
    prepare(config_util.load_opts(PrepareBopSubmissionOpts))


if __name__ == "__main__":
    main()
