"""Batched RANSAC-PnP with LO refits and Levenberg-Marquardt refinement
(counterpart of foundpose_tpu/pose/pnp.py).

Every function takes a leading batch of correspondence sets [S, ...] where
the JAX package vmaps one set at a time. Hypotheses are scored by
`score_hypotheses`: the hand-written CUDA kernel (csrc/score.cu) on a GPU,
its plain twin on a CPU, chosen by the tensors' device.

The minimal solves keep the JAX package's lane-major unrolled Cholesky (its
floor at 1e-30 turns degenerate minimal sets into finite garbage that the
sanitizer below replaces, where torch.linalg.cholesky would raise), the
4-step inverse iteration and the Newton polar rotation.

RANSAC draws: jax.random cannot be reproduced in torch, so `ransac_pnp`
takes optional raw draws [S, H, 6] in [0, N) (reduced modulo the valid
count inside, as the JAX package does), defaulting to torch.randint from an
explicit generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from foundpose_torch import _kernels, geometry

_SQRT3 = math.sqrt(3.0)


# ---------------------------------------------------------------------------
# Hypothesis scoring kernel
# ---------------------------------------------------------------------------


def _score_inputs(pts2d, pts3d, validf, rs, ts, k_f, k_c, inlier_thresh):
    """Operands with focal and threshold folded in, as the JAX wrapper folds
    them: pts4 [S, N, 4], duv [S, N, 2], valid [S, N], A [S, 12, H].

    The threshold is a 0-d f32 tensor on the operands' device, so that both
    divisions are IEEE divisions on the card too (PyTorch multiplies by the
    reciprocal when it divides a CUDA tensor by a Python number)."""
    ones = torch.ones_like(pts3d[..., :1])
    pts4 = torch.cat([pts3d, ones], dim=-1).float()
    thr = torch.full((), float(inlier_thresh), dtype=torch.float32, device=pts2d.device)
    duv = ((k_c[:, None, :] - pts2d) / thr).float()
    a = torch.cat([rs, ts[..., None]], dim=-1)  # [S, H, 3, 4]
    a = torch.cat(
        [
            a[:, :, 0] * (k_f[:, None, 0:1] / thr),
            a[:, :, 1] * (k_f[:, None, 1:2] / thr),
            a[:, :, 2],
        ],
        dim=-1,
    )  # [S, H, 12]
    return pts4, duv, validf.float(), a.transpose(1, 2).float()


def score_hypotheses_plain(pts2d, pts3d, validf, rs, ts, k_f, k_c, inlier_thresh) -> torch.Tensor:
    """Masked inlier counts [S, H] in plain PyTorch: `_score_inputs`, then
    the test evaluated term by term in the order the CUDA kernel rounds it."""
    pts4, duv, valid, a = _score_inputs(pts2d, pts3d, validf, rs, ts, k_f, k_c, inlier_thresh)

    def dot(rows):
        p = [pts4[..., i, None] * a[:, None, rows.start + i, :] for i in range(4)]
        return ((p[0] + p[1]) + p[2]) + p[3]  # [S, N, H]

    camx, camy, camz = dot(slice(0, 4)), dot(slice(4, 8)), dot(slice(8, 12))
    ex = camx + duv[..., 0, None] * camz
    ey = camy + duv[..., 1, None] * camz
    inl = (ex * ex + ey * ey < camz * camz) & (camz > 0)
    return torch.sum(torch.where(inl, valid[..., None], 0.0), dim=1)


def score_hypotheses(pts2d, pts3d, validf, rs, ts, k_f, k_c, inlier_thresh: float) -> torch.Tensor:
    """Masked inlier count per hypothesis: the JAX package's
    `score_hypotheses_fused`, batched over S correspondence sets.

    pts2d [S, N, 2] pixels, pts3d [S, N, 3], validf [S, N] a 0/1 mask,
    rs [S, H, 3, 3], ts [S, H, 3], k_f / k_c [S, 2], all f32 -> counts
    [S, H] f32. CPU tensors take the plain twin; CUDA tensors one launch of
    the kernel, which folds focal length and threshold itself. The kernel
    skips the points whose mask is 0 and adds the others' mask values in no
    fixed order, so its counts equal the twin's only for a 0/1 mask, which
    is what `ransac_pnp` passes.
    """
    if pts2d.device.type == "cpu":
        return score_hypotheses_plain(pts2d, pts3d, validf, rs, ts, k_f, k_c, inlier_thresh)
    s, n, _ = pts2d.shape
    h = rs.shape[1]
    if (pts3d.shape != (s, n, 3) or validf.shape != (s, n) or rs.shape != (s, h, 3, 3)
            or ts.shape != (s, h, 3) or k_f.shape != (s, 2) or k_c.shape != (s, 2)):
        raise ValueError("score_hypotheses: operand shapes do not match")
    pts2d, pts3d, validf, k_f, k_c = (t.float().contiguous()
                                      for t in (pts2d, pts3d, validf, k_f, k_c))
    rs, ts = rs.float(), ts.float()  # strided: the DLT leaves them lane-major
    dev = _kernels.require_cuda("score_hypotheses", pts2d, pts3d, validf, k_f, k_c)
    if rs.device != dev or ts.device != dev:
        raise ValueError("score_hypotheses: all inputs must be on one CUDA device")
    counts = torch.empty(s, h, dtype=torch.float32, device=dev)
    rc = _kernels.library().fp_score_hypotheses(
        pts2d.data_ptr(), pts3d.data_ptr(), validf.data_ptr(), rs.data_ptr(), ts.data_ptr(),
        k_f.data_ptr(), k_c.data_ptr(), float(inlier_thresh), counts.data_ptr(), s, n, h,
        *rs.stride(), *ts.stride(), _kernels.stream_ptr(dev),
    )
    _kernels.check(rc, "fp_score_hypotheses")
    score_hypotheses.launches += 1
    return counts


score_hypotheses.launches = 0


# ---------------------------------------------------------------------------
# Small dense linear algebra, batch trailing ("lane-major")
# ---------------------------------------------------------------------------


def _cholesky_lane_major(a: torch.Tensor) -> torch.Tensor:
    """Cholesky of [n, n, *batch] PSD matrices, unrolled over columns, with
    the pivot floored at 1e-30."""
    n = a.shape[0]
    l = torch.zeros_like(a)
    for j in range(n):
        s = a[j:, j] - torch.sum(l[j:, :j] * l[j, :j][None], dim=1)
        d = torch.sqrt(torch.clamp_min(s[0], 1e-30))
        l[j:, j] = s / d[None]
    return l


def _cho_solve_lane_major(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solves (L L^T) x = b for [n, *batch] right-hand sides."""
    n = l.shape[0]
    y = torch.zeros_like(b)
    for i in range(n):
        y[i] = (b[i] - torch.sum(l[i, :i] * y[:i], dim=0)) / l[i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        x[i] = (y[i] - torch.sum(l[i + 1 :, i] * x[i + 1 :], dim=0)) / l[i, i]
    return x


def _inverse_3x3_lane_major(m: torch.Tensor) -> torch.Tensor:
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    adj = torch.stack(
        [
            torch.stack([co_a, -(b * i - c * h), b * f - c * e]),
            torch.stack([co_b, a * i - c * g, -(a * f - c * d)]),
            torch.stack([co_c, -(a * h - b * g), a * e - b * d]),
        ]
    )
    return adj * inv_det[None, None]


def _polar_rotation_lane_major(m: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Newton polar iteration for [3, 3, *batch] matrices."""
    norm = torch.sqrt(torch.sum(m * m, dim=(0, 1), keepdim=True))
    x = m * (_SQRT3 / torch.clamp_min(norm, 1e-30))
    for _ in range(iters):
        x = 0.5 * (x + _inverse_3x3_lane_major(x).transpose(0, 1))
    return x


# ---------------------------------------------------------------------------
# DLT
# ---------------------------------------------------------------------------


def _dlt_pose_many(pts3d, rays, validf, counts):
    """Solves H weighted point sets of each of S correspondence sets.

    pts3d [S, N, 3], rays [S, N, 2] (normalized), validf [S, N] for the
    global Hartley statistics, counts [S, H, N] sample multiplicities.
    Returns (R [S, H, 3, 3], t [S, H, 3]).
    """
    s_, n, _ = pts3d.shape
    h = counts.shape[1]
    cnt = torch.clamp_min(torch.sum(validf, dim=-1), 1.0)  # [S]
    mu = torch.sum(pts3d * validf[..., None], dim=1) / cnt[:, None]  # [S, 3]
    dev = pts3d - mu[:, None]
    spread = torch.sum(torch.sqrt(torch.sum(dev * dev, dim=-1)) * validf, dim=-1) / cnt
    s = _SQRT3 / torch.clamp_min(spread, 1e-12)  # [S]
    xn = dev * s[:, None, None]
    xh = torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)  # [S, N, 4]
    u = rays[..., 0]
    v = rays[..., 1]
    outer = (xh[..., :, None] * xh[..., None, :]).reshape(s_, n, 16)
    feats = torch.cat(
        [outer, outer * u[..., None], outer * v[..., None], outer * (u * u + v * v)[..., None]],
        dim=-1,
    )  # [S, N, 64]
    blocks = torch.einsum("shn,snf->fsh", counts, feats)  # [64, S, H]
    S = blocks[0:16].reshape(4, 4, s_, h)
    Su = blocks[16:32].reshape(4, 4, s_, h)
    Sv = blocks[32:48].reshape(4, 4, s_, h)
    Sw = blocks[48:64].reshape(4, 4, s_, h)
    Z = torch.zeros_like(S)
    m = torch.cat(
        [
            torch.cat([S, Z, -Su], dim=1),
            torch.cat([Z, S, -Sv], dim=1),
            torch.cat([-Su, -Sv, Sw], dim=1),
        ],
        dim=0,
    )  # [12, 12, S, H]
    trace = 2.0 * (S[0, 0] + S[1, 1] + S[2, 2] + S[3, 3]) + Sw[0, 0] + Sw[1, 1] + Sw[2, 2] + Sw[3, 3]
    m = m / torch.clamp_min(trace, 1e-30)[None, None]
    eye = torch.eye(12, dtype=m.dtype, device=m.device)[..., None, None]
    m = m + 1e-9 * eye
    l = _cholesky_lane_major(m)
    v0 = torch.cos(torch.arange(12, dtype=m.dtype, device=m.device) * 0.7 + 0.3)
    v0 = v0 / torch.sqrt(torch.sum(v0 * v0))
    vec = v0[:, None, None].expand(12, s_, h).clone()
    for _ in range(4):
        w = _cho_solve_lane_major(l, vec)
        vec = w / torch.clamp_min(torch.sqrt(torch.sum(w * w, dim=0)), 1e-30)[None]

    p = vec.reshape(3, 4, s_, h)
    r_raw = p[:, :3]
    det = (
        r_raw[0, 0] * (r_raw[1, 1] * r_raw[2, 2] - r_raw[1, 2] * r_raw[2, 1])
        - r_raw[0, 1] * (r_raw[1, 0] * r_raw[2, 2] - r_raw[1, 2] * r_raw[2, 0])
        + r_raw[0, 2] * (r_raw[1, 0] * r_raw[2, 1] - r_raw[1, 1] * r_raw[2, 0])
    )
    sign = torch.where(det < 0, -1.0, 1.0)
    scale = sign / torch.pow(torch.abs(det) + 1e-30, 1.0 / 3.0)
    rot = _polar_rotation_lane_major(r_raw * scale[None, None])  # [3, 3, S, H]
    t_n = p[:, 3] * scale[None]  # [3, S, H]
    r_mu = torch.einsum("ijsh,sj->ish", rot, mu)
    t = t_n / s[None, :, None] - r_mu
    return rot.permute(2, 3, 0, 1), t.permute(1, 2, 0)


def _project(r, t, pts3d, k_f, k_c):
    """Pixels [S, N, 2] of model points [S, N, 3] under [S, 3, 3] / [S, 3]."""
    cam = torch.einsum("sij,snj->sni", r, pts3d) + t[:, None]
    z = cam[..., 2:3]
    z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    return cam[..., :2] / z * k_f[:, None] + k_c[:, None]


def _inliers(r, t, pts2d, pts3d, valid, k_f, k_c, thresh):
    proj = _project(r, t, pts3d, k_f, k_c)
    err2 = torch.sum(torch.square(proj - pts2d), dim=-1)
    cam_z = (torch.einsum("sij,snj->sni", r, pts3d) + t[:, None])[..., 2]
    inl = (err2 < thresh**2) & valid & (cam_z > 0)
    return inl, torch.sum(inl.float(), dim=-1)


@dataclasses.dataclass
class PnPResult:
    success: torch.Tensor  # [S] bool
    R: torch.Tensor  # [S, 3, 3] model-to-camera
    t: torch.Tensor  # [S, 3]
    inliers: torch.Tensor  # [S, N] bool
    quality: torch.Tensor  # [S] inlier count


def ransac_pnp(
    coord_2d: torch.Tensor,
    coord_3d: torch.Tensor,
    valid: torch.Tensor,
    k_f: torch.Tensor,
    k_c: torch.Tensor,
    num_hypotheses: int = 400,
    inlier_thresh: float = 10.0,
    refine_lm: bool = True,
    lm_iters: int = 10,
    lo_iters: int = 2,
    draws: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> PnPResult:
    """RANSAC-PnP on S masked correspondence sets.

    coord_2d [S, N, 2] pixels, coord_3d [S, N, 3], valid [S, N] bool,
    k_f / k_c [S, 2]. `draws` [S, H, 6] raw integers in [0, N); each is
    taken modulo the set's valid count and picks the valid point of that
    rank. quality = inlier count; success needs >= 6 inliers.
    """
    s_, n, _ = coord_2d.shape
    h = num_hypotheses
    pts2d = coord_2d.float()
    pts3d = coord_3d.float()
    validf = valid.float()
    k_f = k_f.float()
    k_c = k_c.float()
    rays = (pts2d - k_c[:, None]) / k_f[:, None]

    validi = valid.int()
    rank = torch.cumsum(validi, dim=-1) - validi
    count = torch.clamp_min(torch.sum(validi, dim=-1), 1)  # [S]
    if draws is None:
        draws = torch.randint(0, n, (s_, h, 6), generator=generator, device=pts2d.device)
    u = draws.to(pts2d.device).long() % count[:, None, None]
    rank_valid = torch.where(valid, rank, -1)[:, None, :]  # [S, 1, N]
    counts = torch.zeros(s_, h, n, device=pts2d.device)
    for j in range(6):
        counts = counts + (u[..., j : j + 1] == rank_valid).float()

    rs, ts = _dlt_pose_many(pts3d, rays, validf, counts)
    finite = torch.isfinite(rs).all(-1).all(-1) & torch.isfinite(ts).all(-1)
    eye = torch.eye(3, device=rs.device)
    rs = torch.where(finite[..., None, None], rs, eye)
    ts = torch.where(finite[..., None], ts, eye[2])

    hyp_counts = score_hypotheses(pts2d, pts3d, validf, rs, ts, k_f, k_c, inlier_thresh)
    best = torch.argmax(hyp_counts, dim=-1)  # first maximum
    ar = torch.arange(s_, device=best.device)
    r_best, t_best = rs[ar, best], ts[ar, best]
    inliers, _ = _inliers(r_best, t_best, pts2d, pts3d, valid, k_f, k_c, inlier_thresh)
    quality = hyp_counts[ar, best]

    if lo_iters > 0:
        r_best, t_best, inliers, quality = lo_refine(
            r_best, t_best, pts2d, pts3d, valid, k_f, k_c,
            inlier_thresh=inlier_thresh, iters=lo_iters, inliers=inliers, count=quality,
        )
    if refine_lm:
        r_best, t_best = refine_pose_lm_guarded(
            r_best, t_best, pts2d, pts3d, inliers, k_f, k_c, iters=lm_iters
        )
    return PnPResult(success=quality >= 6.0, R=r_best, t=t_best, inliers=inliers, quality=quality)


def lo_refine(
    r, t, pts2d, pts3d, valid, k_f, k_c,
    inlier_thresh: float = 10.0,
    iters: int = 2,
    inliers: Optional[torch.Tensor] = None,
    count: Optional[torch.Tensor] = None,
):
    """LO-RANSAC: overdetermined DLT refits on the current pose's inliers
    at a threshold annealed 2x -> 1x, accepted by base-threshold count
    (monotone). Returns (R, t, inliers, count), batched over sets."""
    pts2d = pts2d.float()
    pts3d = pts3d.float()
    validf = valid.float()
    rays = (pts2d - k_c[:, None]) / k_f[:, None]
    r_best, t_best = r, t
    if inliers is None or count is None:
        inliers, count = _inliers(r_best, t_best, pts2d, pts3d, valid, k_f, k_c, inlier_thresh)
    for li in range(iters):
        widen = 2.0 if li == 0 else 1.0
        fit_mask, _ = _inliers(
            r_best, t_best, pts2d, pts3d, valid, k_f, k_c, inlier_thresh * widen
        )
        r_lo, t_lo = _dlt_pose_many(pts3d, rays, validf, fit_mask.float()[:, None, :])
        r_lo, t_lo = r_lo[:, 0], t_lo[:, 0]
        finite = torch.isfinite(r_lo).all(-1).all(-1) & torch.isfinite(t_lo).all(-1)
        r_lo = torch.where(finite[:, None, None], r_lo, r_best)
        t_lo = torch.where(finite[:, None], t_lo, t_best)
        inl_lo, cnt_lo = _inliers(r_lo, t_lo, pts2d, pts3d, valid, k_f, k_c, inlier_thresh)
        better = finite & (cnt_lo >= count)
        r_best = torch.where(better[:, None, None], r_lo, r_best)
        t_best = torch.where(better[:, None], t_lo, t_best)
        inliers = torch.where(better[:, None], inl_lo, inliers)
        count = torch.where(better, cnt_lo, count)
    return r_best, t_best, inliers, count


def refine_pose_lm(r, t, pts2d, pts3d, weight_mask, k_f, k_c, iters: int = 10):
    """Damped Gauss-Newton (LM) on the masked reprojection error, with
    left-multiplied SE(3) increments and a closed-form Jacobian; batched
    over sets [S]. Returns (R [S, 3, 3], t [S, 3])."""
    w = weight_mask.float()
    pts2d = pts2d.float()
    pts3d = pts3d.float()
    fx, fy = k_f[:, 0:1], k_f[:, 1:2]
    eye6 = torch.eye(6, device=w.device)

    def cost_at(rot, tv):
        cam = torch.einsum("sij,snj->sni", rot, pts3d) + tv[:, None]
        z = torch.where(torch.abs(cam[..., 2]) < 1e-9, 1e-9, cam[..., 2])
        proj = cam[..., :2] / z[..., None] * k_f[:, None] + k_c[:, None]
        res = (proj - pts2d) * w[..., None]
        return cam, z, res, torch.sum(res * res, dim=(-2, -1))

    rot, tv = r.float(), t.float()
    lam = torch.full((r.shape[0],), 1e-3, device=w.device)
    for _ in range(iters):
        cam, z, res, cost = cost_at(rot, tv)
        iz = 1.0 / z
        a = cam[..., 0] * iz
        b = cam[..., 1] * iz
        wfx = w * fx
        wfy = w * fy
        zero = torch.zeros_like(a)
        ju = torch.stack(
            [-wfx * a * b, wfx * (1.0 + a * a), -wfx * b, wfx * iz, zero, -wfx * a * iz], dim=-1
        )
        jv = torch.stack(
            [-wfy * (1.0 + b * b), wfy * a * b, wfy * a, zero, wfy * iz, -wfy * b * iz], dim=-1
        )
        jtj = torch.einsum("sni,snj->sij", ju, ju) + torch.einsum("sni,snj->sij", jv, jv)
        jtr = torch.einsum("sni,sn->si", ju, res[..., 0]) + torch.einsum(
            "sni,sn->si", jv, res[..., 1]
        )
        damped = jtj + lam[:, None, None] * eye6
        l = _cholesky_lane_major(damped.permute(1, 2, 0))
        delta = _cho_solve_lane_major(l, jtr.t()).t()  # [S, 6]
        dw, dt = -delta[:, :3], -delta[:, 3:]
        dr = geometry.rodrigues(dw)
        rot_new = dr @ rot
        tv_new = (dr @ tv[..., None])[..., 0] + dt
        _, _, _, new_cost = cost_at(rot_new, tv_new)
        improved = new_cost < cost
        rot = torch.where(improved[:, None, None], rot_new, rot)
        tv = torch.where(improved[:, None], tv_new, tv)
        lam = torch.clamp(torch.where(improved, lam * 0.3, lam * 3.0), 1e-9, 1e6)
    return rot, tv


def refine_pose_lm_guarded(r, t, pts2d, pts3d, weight_mask, k_f, k_c, iters: int = 10):
    """refine_pose_lm, keeping a set's input pose where the refined one is
    not finite (degenerate inlier sets can blow up the normal equations)."""
    r_ref, t_ref = refine_pose_lm(r, t, pts2d, pts3d, weight_mask, k_f, k_c, iters)
    ok = torch.isfinite(r_ref).all(-1).all(-1) & torch.isfinite(t_ref).all(-1)
    return (
        torch.where(ok[:, None, None], r_ref, r),
        torch.where(ok[:, None], t_ref, t),
    )
