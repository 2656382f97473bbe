"""Shared harness for the AR-gated solve-budget sweeps on the cross-parity
world (counterpart of benchmarks/solve_sweep_harness.py), in four parts
that tests can take one at a time:

  build_world   a seed's world (make_world) and its queries
  oracle_ar     the replica's AR on them, at the full reference budget
  cell_ar       the port's AR on them under one cell's solve budget, on
                `device` ("cuda" by default), with the cell's wall between
                `torch.cuda.synchronize()` calls and its scorer, buddies
                and refinement launches counted from zero
  admissible    the gate: every seed's AR within 1 point of that seed's
                oracle AND of the default cell

`run_sweep` composes them as the JAX harness does (used by lm_iters_sweep
and select_iter_sweep; ransac_sweep keeps its own 2D grid). The cells run
the benched fast path: bf16, approximate top-k, with the solve budget the
only thing that varies; each cell's draws come from a torch.Generator
seeded 0 on the device, as each JAX cell uses PRNGKey(0).
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Callable, Dict, Hashable, List, Optional, Sequence

import numpy as np
import torch

from foundpose_torch.benchmarks import bench
from foundpose_torch.benchmarks.cross_parity import (
    ar_recall,
    host_threads,
    make_world,
    port_poses,
    render_queries,
    replica_for,
    replica_poses,
)

# The JAX harness's world and fast-path base configuration.
HARNESS_WORLD = dict(pts_per_template=200, feat_dim=64, num_words=512, n_points=2000)
FAST = dict(compute_dtype=torch.bfloat16, approx_topk=True, pnp_ransac_iter=200,
            pnp_lo_iters=2)
GATE_PTS = 0.01


@dataclasses.dataclass
class SweepWorld:
    world: tuple  # make_world's (repre, obj_points, obj_feats, tpl_point_ids)
    fmaps: np.ndarray
    masks: np.ndarray
    rs_gt: List[np.ndarray]
    ts_gt: List[np.ndarray]
    key: tuple = ()  # build_world's arguments, which fix everything above


def build_world(seed: int, crops: int, templates: int, device, world_kw=HARNESS_WORLD,
                pose_seed_base: Optional[int] = None) -> SweepWorld:
    """Seed `seed`'s world of `templates` templates (`world_kw` the other
    make_world sizes) and `crops` queries, crop i with pose seed
    pose_seed_base + i (the JAX harness's 3000 * (seed + 1) by default)."""
    if pose_seed_base is None:
        pose_seed_base = 3000 * (seed + 1)
    rng = np.random.default_rng(seed)
    world = make_world(rng, num_templates=templates, device=device, **world_kw)
    key = (seed, crops, templates, tuple(sorted(world_kw.items())), pose_seed_base)
    return SweepWorld(world, *render_queries(rng, world, crops, pose_seed_base), key=key)


# oracle_ar's results by (SweepWorld.key, pnp_ransac_iter).
_ORACLE_MEMO: Dict[tuple, tuple] = {}


def oracle_ar(sw: SweepWorld, pnp_ransac_iter: int = 400):
    """(AR, seconds) of the independent replica at the full reference
    budget (5 templates, 300 buddies, `pnp_ransac_iter` iterations): the
    sweep must not move the yardstick. Kept by the world's build_world
    arguments, so a second sweep of the same worlds in one process
    (lm_iters_sweep's and select_iter_sweep's) reuses the AR and the
    seconds of the replica's one run on them."""
    key = (sw.key, pnp_ransac_iter)
    if sw.key and key in _ORACLE_MEMO:
        return _ORACLE_MEMO[key]
    replica = replica_for(sw.world, top_n_templates=5, top_k_buddies=300,
                          pnp_ransac_iter=pnp_ransac_iter)
    _, rs, ts, succ, seconds = replica_poses(replica, sw.fmaps, sw.masks)
    res = ar_recall(rs, ts, succ, sw.rs_gt, sw.ts_gt)[0], seconds
    if sw.key:
        _ORACLE_MEMO[key] = res
    return res


def cell_ar(sw: SweepWorld, overrides: dict, device, draws=None, full_draws=None) -> dict:
    """One cell: the port's fast path with `overrides` on every crop.
    Returns {"ar", "wall_ms", "launches"}; `draws` / `full_draws` replace
    the generator's draws (pose_from_features)."""
    from foundpose_torch.pipeline import inference

    config = inference.InferenceConfig(**{**FAST, **overrides})
    rs, ts, succ, _, wall, launches = port_poses(
        sw.fmaps, sw.masks, sw.world[0], config, torch.device(device), seed=0, draws=draws,
        full_draws=full_draws)
    return {"ar": ar_recall(rs, ts, succ, sw.rs_gt, sw.ts_gt)[0], "wall_ms": wall * 1e3,
            "launches": launches}


def admissible(cells: Dict[Hashable, Sequence[float]], oracle_ars: Sequence[float],
               default_cell: Hashable) -> List[Hashable]:
    """The cells whose AR, on every seed, is within GATE_PTS of that seed's
    oracle and no more than GATE_PTS below the default cell's."""
    default = cells[default_cell]
    return [
        cell for cell, ars in cells.items()
        if all(abs(a - o) <= GATE_PTS + 1e-9 and a >= d - GATE_PTS - 1e-9
               for a, o, d in zip(ars, oracle_ars, default))
    ]


def run_sweep(metric: str, config_overrides_by_cell: dict, default_cell: str, crops: int = 200,
              seeds: int = 2, templates: int = 96, pick_rule: Callable = min,
              device="cuda") -> dict:
    """Every cell on `seeds` worlds against the full-budget replica oracle;
    the report the JAX harness prints, plus the device and each cell's wall
    ms and launches per seed."""
    device = bench.require_device(device)
    cells: Dict[str, List[float]] = {}
    walls: Dict[str, List[float]] = {}
    launches: Dict[str, List[dict]] = {}
    oracle_ars, oracle_s = [], []
    for seed in range(seeds):
        sw = build_world(seed, crops, templates, device)
        ar_rep, rep_s = oracle_ar(sw)
        oracle_ars.append(ar_rep)
        oracle_s.append(rep_s)
        print(f"[sweep] seed {seed}: replica oracle AR={ar_rep:.3f} ({rep_s:.1f}s)",
              file=sys.stderr)
        for cell, overrides in config_overrides_by_cell.items():
            res = cell_ar(sw, overrides, device)
            cells.setdefault(cell, []).append(res["ar"])
            walls.setdefault(cell, []).append(res["wall_ms"])
            launches.setdefault(cell, []).append(res["launches"])
            print(f"[sweep] seed {seed} {cell}: AR={res['ar']:.3f} (delta vs replica "
                  f"{abs(res['ar'] - ar_rep):.3f}) [{res['wall_ms']:.1f} ms, {res['launches']}]",
                  file=sys.stderr)
    ok = admissible(cells, oracle_ars, default_cell)
    return {
        "metric": metric,
        "device": bench.card(device),
        "n_crops": crops,
        "seeds": seeds,
        "ar_replica_oracle": [round(a, 4) for a in oracle_ars],
        "replica_threads": host_threads(),
        "replica_sec_per_crop": [round(t / crops, 4) for t in oracle_s],
        "cells": {str(cell): [round(a, 4) for a in ars] for cell, ars in cells.items()},
        "gate": "all seeds: AR within 1 pt of replica AND of the default",
        "admissible": sorted(str(c) for c in ok),
        "picked": str(pick_rule(ok) if ok else default_cell),
        "cell_wall_ms": walls,
        "cell_launches": launches,
    }


def emit(report) -> int:
    print(json.dumps(report))
    return 0
