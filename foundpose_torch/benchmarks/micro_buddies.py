"""The matching stage's substages on one NVIDIA GPU at LM-O scale
(counterpart of benchmarks/micro_buddies.py).

    python -m foundpose_torch.benchmarks.micro_buddies  # needs a CUDA GPU

Splits `pipeline/inference.match_batch` over B = 64 crops of Q = 900 query
cells (256-d bf16 features) against the top-n = 5 retrieved templates of a
798 x 512 bf16 bank, on the JAX script's inputs (normal features, 70% of
queries and bank rows valid, random template ids):

  bank_gather           the retrieved templates' banks, gathered
  gather+dist+argmin    plus squared distances and both argmins, plain torch
  no_topk(gathers only) plus the cycle gather and cycle distances; a slice
                        in place of the top-k
  smallest_k only       ops/selection.compact_smallest_k on stand-in
                        distances (the JAX script's approx_min_k)
  full_match_stage      the plain chain with the top-k
  real_match_batch      pose/corresp.establish_correspondences_batch with
                        approx_topk=True: kernel 3 on the card

Each substage reports bench.substage_times' three numbers (CUDA-event ms a
call, device ms a call under torch.profiler, host launch calls a call).
Prints one line per substage and one JSON line. `run(device="cpu")` runs
it on the CPU (host clock; no device numbers).
"""

from __future__ import annotations

import json
import sys
from typing import Any, Callable, Dict

import torch

from foundpose_torch.benchmarks import bench
from foundpose_torch.ops.knn import pairwise_sqdist
from foundpose_torch.ops.sampling import grid_points
from foundpose_torch.ops.selection import compact_smallest_k
from foundpose_torch.pose import corresp

B, Q, DIM, T, FMAX, TOP_N, TOP_K = 64, 900, 256, 798, 512, 5, 300
CROP = (420, 420)
CELL = 14.0


def problem(device, b: int = B, dim: int = DIM, t: int = T, fmax: int = FMAX,
            top_n: int = TOP_N, crop=CROP, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The micro's inputs, made on `device` from one generator; the query
    grid of `crop` px at 14 px cells gives Q."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qpts = grid_points(crop, CELL, device=device)
    q = qpts.shape[0]
    return dict(
        qpts=qpts,
        feats=torch.randn(b, q, dim, generator=gen, device=device).to(torch.bfloat16),
        qmask=torch.rand(b, q, generator=gen, device=device) > 0.3,
        bank=torch.randn(t, fmax, dim, generator=gen, device=device).to(torch.bfloat16),
        bmask=torch.rand(t, fmax, generator=gen, device=device) > 0.3,
        verts=-0.05 + 0.1 * torch.rand(t, fmax, 3, generator=gen, device=device),
        tids=torch.randint(0, t, (b, top_n), generator=gen, device=device),
    )


def _argmins(p):
    """q2o [B, N, Q] and o2q [B, N, F] of the masked squared distances."""
    sel, selm = p["bank"][p["tids"]], p["bmask"][p["tids"]]
    d = pairwise_sqdist(p["feats"][:, None], sel)  # [B, N, Q, F]
    d = torch.where(p["qmask"][:, None, :, None], d, torch.inf)
    d = torch.where(selm[:, :, None, :], d, torch.inf)
    return torch.argmin(d, dim=-1), torch.argmin(d, dim=-2)


def _cycle(p):
    """Cycle distances [B, N, Q] (inf off the query mask) and q2o."""
    q2o, o2q = _argmins(p)
    back = torch.gather(o2q, -1, q2o)
    diff = p["qpts"] - p["qpts"][back]
    cd = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
    return torch.where(p["qmask"][:, None, :], cd, torch.inf), q2o


def substages(p: Dict[str, torch.Tensor], top_k: int = TOP_K,
              approx_topk: bool = True) -> Dict[str, Callable[[], Any]]:
    """The six substages on the problem `p`, each returning its outputs;
    `approx_topk` is real_match_batch's switch (False: the exact path)."""
    n = p["tids"].shape[1]
    stand_in = p["feats"][..., 0].float().abs()[:, None].expand(-1, n, -1)

    def no_topk():
        cd, q2o = _cycle(p)
        return cd[..., :top_k], q2o[..., :top_k]

    def full():
        cd, q2o = _cycle(p)
        ids = compact_smallest_k(cd, top_k)
        return torch.gather(cd, -1, ids), ids

    def real():
        tids = p["tids"]
        return corresp.establish_correspondences_batch(
            p["qpts"], p["feats"], p["qmask"], tids, torch.ones(tids.shape, device=tids.device),
            p["bank"], p["verts"], p["bmask"], top_k=top_k, approx_topk=approx_topk)

    return {
        "bank_gather": lambda: p["bank"][p["tids"]].float().sum(dim=(2, 3)),
        "gather+dist+argmin": lambda: _argmins(p),
        "no_topk(gathers only)": no_topk,
        "smallest_k only": lambda: compact_smallest_k(stand_in, top_k),
        "full_match_stage": full,
        "real_match_batch": real,
    }


def run(device="cuda", b: int = B, dim: int = DIM, t: int = T, fmax: int = FMAX,
        top_n: int = TOP_N, top_k: int = TOP_K, crop=CROP) -> Dict[str, Any]:
    """The micro at its sizes (smaller ones for tests) on `device`."""
    device = bench.require_device(device)
    with torch.no_grad():
        p = problem(device, b, dim, t, fmax, top_n, crop)
        subs = substages(p, top_k)
    return dict(batch=b, queries=p["qpts"].shape[0], templates=t, bank_width=fmax, top_k=top_k,
                card=bench.card(device),
                substages=bench.substage_report(subs, device, "micro_buddies", b))


def main() -> int:
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
