"""Multi-host dataset sharding for full-BOP runs (a copy of
foundpose_tpu/parallel/host_shard.py, which the port may not import).

The reference pipeline is strictly single-process — one Python loop over all
test images of a dataset (reference: scripts/infer.py:368-733). Scaling a
full-BOP sweep across hosts therefore needs no collective: work is
partitioned deterministically at the HOST level on top of the artifact flow:

- each process takes every ``shard_count``-th (scene, image) key of the
  ordered per-object key list (round-robin, so shards stay balanced even
  when scenes vary in size),
- writes shard-suffixed artifacts (``estimated-poses_shard0of4.json`` …) so
  shards on a shared filesystem never collide,
- and ``prepare_bop_submission`` merges the unsharded file plus all shard
  files per object into one BOP19 CSV.

``shard_count=0`` resolves from ``torch.distributed`` (rank and world size
of an initialized process group, else one process), so a multi-process
launch needs no per-process flag plumbing; explicit values support other
launchers (SLURM array jobs, indexed jobs).
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, List, Sequence, Tuple

POSES_BASENAME = "estimated-poses.json"


def resolve_shard(shard_index: int, shard_count: int) -> Tuple[int, int]:
    """Validates (index, count); count=0 means auto from torch.distributed."""
    if shard_count == 0:
        # An explicit index alongside auto-count is a contradiction (e.g. a
        # SLURM array passing shard_index=$TASK_ID but forgetting the count):
        # silently resolving would make every task process the FULL dataset.
        if shard_index != 0:
            raise ValueError(
                f"shard_index={shard_index} with shard_count=0 (auto): pass "
                "an explicit shard_count, or leave shard_index at 0 to take "
                "it from torch.distributed"
            )
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
        return 0, 1
    if shard_count < 1:
        raise ValueError(f"shard_count must be >= 1 (or 0 for auto), got {shard_count}")
    if not 0 <= shard_index < shard_count:
        raise ValueError(
            f"shard_index {shard_index} out of range for shard_count {shard_count}"
        )
    return shard_index, shard_count


def shard_of(opts: Any) -> Tuple[int, int]:
    """resolve_shard over any opts dataclass carrying shard_index/shard_count
    — the single seam every pipeline entry point goes through."""
    return resolve_shard(opts.shard_index, opts.shard_count)


def shard_keys(
    keys: Sequence[Any], shard_index: int, shard_count: int
) -> List[Any]:
    """Deterministic round-robin partition of an ORDERED key list.

    Callers must pass the same ordering on every host (the pipelines use
    sorted (scene, image) keys); round-robin keeps shards balanced to within
    one key regardless of how work clusters within scenes.
    """
    if shard_count == 1:
        return list(keys)
    return list(keys)[shard_index::shard_count]


def shard_suffix(shard_index: int, shard_count: int) -> str:
    return "" if shard_count == 1 else f"_shard{shard_index}of{shard_count}"


def sharded_name(basename: str, shard_index: int, shard_count: int) -> str:
    """Inserts the shard suffix before the extension: a_shard0of2.json."""
    stem, ext = os.path.splitext(basename)
    return f"{stem}{shard_suffix(shard_index, shard_count)}{ext}"


def write_empty_shard_sentinel(
    object_dir: str, shard_index: int, shard_count: int
) -> str:
    """Marks an EMPTY shard completed: writes the `[]` estimated-poses file
    that load_object_estimates below counts toward shard-set completeness
    (and that resume=True treats as done). Writer and reader live in this
    module so the sentinel contract cannot drift between the two infer
    entry points. Returns the path written."""
    path = os.path.join(
        object_dir, sharded_name(POSES_BASENAME, shard_index, shard_count)
    )
    os.makedirs(object_dir, exist_ok=True)
    with open(path, "w") as f:
        f.write("[]")
    return path


def load_object_estimates(object_dir: str) -> Tuple[List[Dict[str, Any]], List[str]]:
    """Loads an object's pose records: either the unsharded
    ``estimated-poses.json`` or a COMPLETE, SINGLE-count set of
    ``estimated-poses_shard{i}of{n}.json`` files (every shard writes its
    file, even when empty, exactly so completeness is checkable here).
    Returns (records, paths_read); missing dir/files -> ([], []).

    Raises ValueError on stale-artifact mixes that would silently corrupt a
    BOP submission: unsharded + shard files coexisting (e.g. an unsharded
    run rerun sharded into the same dir — poses would be double-counted),
    shard files from runs with different shard_counts, or an incomplete
    shard set (a crashed or still-running shard — the merged submission
    would silently miss its images)."""
    stem, ext = os.path.splitext(POSES_BASENAME)
    unsharded = os.path.join(object_dir, POSES_BASENAME)
    have_unsharded = os.path.exists(unsharded)
    shard_paths = sorted(glob.glob(os.path.join(object_dir, f"{stem}_shard*of*{ext}")))
    pattern = re.compile(
        re.escape(stem) + r"_shard(\d+)of(\d+)" + re.escape(ext) + r"$"
    )
    by_index: Dict[int, str] = {}
    counts = set()
    for p in shard_paths:
        m = pattern.search(os.path.basename(p))
        if not m:
            continue
        by_index[int(m.group(1))] = p
        counts.add(int(m.group(2)))

    if have_unsharded and by_index:
        raise ValueError(
            f"{object_dir} holds BOTH {POSES_BASENAME} and shard files — "
            "stale artifacts from mixing an unsharded and a sharded run; "
            "remove one set before preparing a submission"
        )
    if len(counts) > 1:
        raise ValueError(
            f"{object_dir} holds shard files from different shard_counts "
            f"{sorted(counts)} — stale artifacts from re-running with a "
            "different shard layout; remove the old set"
        )
    if by_index:
        n = counts.pop()
        missing = sorted(set(range(n)) - set(by_index))
        if missing:
            raise ValueError(
                f"{object_dir}: shard set of {n} is missing shards {missing} "
                "(crashed or still-running shard?); a merged submission "
                "would silently drop their images"
            )
        paths = [by_index[i] for i in range(n)]
    else:
        paths = [unsharded] if have_unsharded else []

    records: List[Dict[str, Any]] = []
    for p in paths:
        with open(p) as f:
            records.extend(json.load(f))
    return records, paths
