"""Cycle distances for cyclic-buddy matching: the hand-written CUDA kernel
(csrc/buddies.cu) and its plain PyTorch twin.

Counterpart of foundpose_tpu/ops/buddies_kernel.py. For every (crop,
retrieved template) pair: masked squared-L2 distances [Q, F] (bf16 product,
f32 accumulation; a masked query or bank row adds 1e30), q2o and o2q by
int32 keyed minimum (ties within a key bucket go to the lowest index), the
cycle's landing point qpts[o2q[q2o[q]]], and the per-query cycle distance
with INVALID_SENTINEL at masked queries.
"""

from __future__ import annotations

from typing import Tuple

import torch

from foundpose_torch import _kernels
from foundpose_torch.ops.selection import INVALID_SENTINEL

_BIG = 1e30


def _bits(n: int) -> int:
    return max(1, (n - 1).bit_length())


def cycle_distances_plain(
    query_feats: torch.Tensor,
    query_mask: torch.Tensor,
    query_points: torch.Tensor,
    sel_feats: torch.Tensor,
    sel_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch cycle distances; shapes as `cycle_distances`."""
    q = query_feats.shape[1]
    f = sel_feats.shape[2]
    f_bits, q_bits = _bits(f), _bits(q)
    qf = query_feats.float()
    bf = sel_feats.float()
    q2 = torch.sum(qf * qf, dim=-1)[:, None, :, None]  # [B, 1, Q, 1]
    b2 = torch.sum(bf * bf, dim=-1)[:, :, None, :]  # [B, T', 1, F]
    cross = torch.einsum("bqd,btfd->btqf", qf, bf)
    d = torch.clamp_min(q2 + b2 - 2.0 * cross, 0.0)
    qm = query_mask.float()[:, None, :, None]
    bm = sel_mask.float()[:, :, None, :]
    d = d + (1.0 - qm) * _BIG + (1.0 - bm) * _BIG

    di = d.contiguous().view(torch.int32)
    lane = torch.arange(f, dtype=torch.int32, device=d.device)
    sub = torch.arange(q, dtype=torch.int32, device=d.device)[:, None]
    q2o = torch.amin((di & -(1 << f_bits)) | lane, dim=-1) & ((1 << f_bits) - 1)
    o2q = torch.amin((di & -(1 << q_bits)) | sub, dim=-2) & ((1 << q_bits) - 1)
    landing = torch.gather(o2q, -1, q2o.long()).long()  # [B, T', Q]
    qpts = query_points.float()
    diff = qpts - qpts[landing]
    cd = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
    cd = torch.where(query_mask[:, None, :], cd, torch.full_like(cd, INVALID_SENTINEL))
    return cd, q2o


def cycle_distances(
    query_feats: torch.Tensor,
    query_mask: torch.Tensor,
    query_points: torch.Tensor,
    sel_feats: torch.Tensor,
    sel_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cycle distances + q2o ids for all (crop, template) pairs.

    Args:
        query_feats: [B, Q, D]; query_mask: [B, Q] bool.
        query_points: [Q, 2] shared grid.
        sel_feats: [B, T', F, D] retrieved templates' banks;
        sel_mask: [B, T', F] bool.
    Returns (cycle_dists [B, T', Q] f32, q2o [B, T', Q] int32). CPU tensors
    take the plain twin; CUDA tensors the kernel (bf16 features).
    """
    if query_feats.device.type == "cpu":
        return cycle_distances_plain(
            query_feats, query_mask, query_points, sel_feats, sel_mask
        )
    b, q, dim = query_feats.shape
    _, tn, f, _ = sel_feats.shape
    if query_feats.dtype != torch.bfloat16 or sel_feats.dtype != torch.bfloat16:
        raise ValueError("cycle_distances: the CUDA kernel takes bfloat16 features")
    if dim % 16 or sel_feats.shape[0] != b or sel_feats.shape[3] != dim:
        raise ValueError(f"cycle_distances: bad shapes {query_feats.shape} {sel_feats.shape}")
    if query_mask.shape != (b, q) or sel_mask.shape != (b, tn, f) or query_points.shape != (q, 2):
        raise ValueError("cycle_distances: mask or point shapes do not match")
    qmask = query_mask.float().contiguous()
    bmask = sel_mask.float().contiguous()
    qpts = query_points.float().contiguous()
    qf = query_feats.contiguous()
    bf = sel_feats.contiguous()
    dev = _kernels.require_cuda("cycle_distances", qf, bf, qmask, bmask, qpts)
    cd = torch.empty(b, tn, q, dtype=torch.float32, device=dev)
    q2o = torch.empty(b, tn, q, dtype=torch.int32, device=dev)
    rc = _kernels.library().fp_cycle_distances(
        qf.data_ptr(), bf.data_ptr(), qmask.data_ptr(), bmask.data_ptr(),
        qpts.data_ptr(), cd.data_ptr(), q2o.data_ptr(),
        b, tn, q, f, dim, _bits(f), _bits(q), _kernels.stream_ptr(dev),
    )
    _kernels.check(rc, "fp_cycle_distances")
    cycle_distances.launches += 1
    return cd, q2o


cycle_distances.launches = 0
