"""Operands of `pnp.refine_lo_lm` for the tests of its kernel and its CPU
path (tests/test_torch_refine.py, tests/test_torch_cuda.py)."""

import numpy as np
import torch

THRESH = 10.0
# No valid point's reprojection error lies within this many pixels of the
# base or the widened threshold at any pose the plain twin tests it at
# (`threshold_gaps`), so kernel and twin, whose poses differ by float32
# rounding, see the same inliers.
MIN_GAP_PX = 0.1
F, C = 600.0, 209.5


def _project(r, t, p):
    cam = np.einsum("sij,snj->sni", r, p) + t[:, None]
    return cam[..., :2] / cam[..., 2:] * F + C


def _draw(rng, s, n):
    """s normal sets, in mm: model points in a 100 mm cube at 450-650 mm;
    inliers within 1.5 px of the true projection, 10% of the points 13.5-
    16.5 px away (inside the widened 20 px threshold, outside the base
    10 px one), 20% outliers 40-120 px away, 85% valid; the start pose
    0.2 deg and ~1 mm from the truth."""
    from foundpose_torch import geometry

    pts3d = rng.uniform(-50, 50, (s, n, 3))
    axis = rng.normal(size=(s, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    r_gt = geometry.rodrigues(torch.tensor(axis * rng.uniform(0, np.pi, (s, 1)))).numpy()
    t_gt = np.stack([rng.uniform(-30, 30, s), rng.uniform(-30, 30, s),
                     rng.uniform(450, 650, s)], -1)
    kind = rng.random((s, n))
    angle = rng.uniform(0, 2 * np.pi, (s, n))
    direction = np.stack([np.cos(angle), np.sin(angle)], -1)
    far = direction * rng.uniform(40, 120, (s, n, 1))
    near = direction * rng.uniform(13.5, 16.5, (s, n, 1))
    noise = np.clip(rng.normal(0, 0.7, (s, n, 2)), -1.5, 1.5)
    offset = np.where((kind < 0.2)[..., None], far, np.where((kind < 0.3)[..., None], near, noise))
    pts2d = _project(r_gt, t_gt, pts3d) + offset
    valid = rng.random((s, n)) < 0.85
    turn = rng.normal(size=(s, 3))
    turn *= np.deg2rad(0.2) / np.linalg.norm(turn, axis=-1, keepdims=True)
    r0 = geometry.rodrigues(torch.tensor(turn)).numpy() @ r_gt
    t0 = t_gt + rng.normal(0, 0.6, (s, 3))
    return dict(pts3d=pts3d, pts2d=pts2d, valid=valid, r=r0, t=t0, r_gt=r_gt, t_gt=t_gt)


def _turned(r, t, shift):
    """The pose (r, t) with the scene turned about the camera's y axis by
    the angle that moves the image centre `shift` px along x: a near-
    uniform shift of the image, which is a rigid pose."""
    a = np.arctan(shift / F)
    turn = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    return turn @ r, turn @ t


def _shifted(d, k, rng, start, groups):
    """Set k: the start pose its true pose shifted `start` px; its valid
    points seen in groups of (share, shift px): where the true pose shifted
    `shift` px puts them, plus up to 0.3 px on each axis; the rest (an
    outlier share) 40-120 px off in random directions."""
    n = d["pts3d"].shape[1]
    d["r"][k], d["t"][k] = _turned(d["r_gt"][k], d["t_gt"][k], start)
    u = rng.random(n)
    angle = rng.uniform(0, 2 * np.pi, n)
    pts2d = _project(d["r_gt"][k:k + 1], d["t_gt"][k:k + 1], d["pts3d"][k:k + 1])[0]
    pts2d += np.stack([np.cos(angle), np.sin(angle)], -1) * rng.uniform(40, 120, (n, 1))
    edge = 0.0
    for share, shift in groups:
        sel = (u >= edge) & (u < edge + share)
        r, t = _turned(d["r_gt"][k], d["t_gt"][k], shift)
        seen = _project(r[None], t[None], d["pts3d"][k:k + 1])[0]
        pts2d[sel] = (seen + rng.uniform(-0.3, 0.3, (n, 2)))[sel]
        edge += share
    d["pts2d"][k] = pts2d


# Set 4: the start pose 13 px off the truth, so no point is a base inlier
# and 90% lie inside the widened threshold; the first refit fits them and
# is accepted at a higher count. Set 5: the start pose 8 px off, 80% of
# the points true and 10% where the truth shifted 16 px puts them, all
# base inliers at the start; the refit of both groups lands near the truth
# and loses the 10%, so both refits are refused and the start pose stays.
WIDENED = (13.0, [(0.9, 0.0)])
LOSES = (8.0, [(0.8, 0.0), (0.1, 16.0)])


def _special(d, rng):
    """Sets 0-5 (see refine_operands)."""
    d["valid"][0] = False
    d["valid"][1] = False
    d["valid"][1, :4] = True
    d["pts3d"][2] = d["pts3d"][2, :1]
    d["pts2d"][2] = _project(d["r_gt"][2:3], d["t_gt"][2:3], d["pts3d"][2:3])[0]
    d["valid"][2] = True
    d["valid"][3, 0] = False
    d["pts3d"][3, 0] = np.nan
    _shifted(d, 4, rng, *WIDENED)
    _shifted(d, 5, rng, *LOSES)


def _tensors(d, device):
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    s = d["pts3d"].shape[0]
    return dict(r=f32(d["r"]), t=f32(d["t"]), pts2d=f32(d["pts2d"]), pts3d=f32(d["pts3d"]),
                valid=torch.as_tensor(d["valid"], device=device),
                k_f=torch.full((s, 2), F, device=device), k_c=torch.full((s, 2), C, device=device))


def threshold_gaps(ops, lo_iters=2):
    """[S]: each set's smallest distance in px between a valid point's
    reprojection error and the threshold it is tested against, over every
    inlier test of `refine_lo_lm`'s start and of `lo_iters` LO refits in
    the plain twin (the LM tests none). inf where a set tests no point."""
    from foundpose_torch.pose import pnp

    gaps = torch.full((ops["pts2d"].shape[0],), float("inf"), dtype=torch.float64)
    inliers = pnp._inliers

    def recording(r, t, pts2d, pts3d, valid, k_f, k_c, thresh):
        err = torch.linalg.vector_norm(pnp._project(r, t, pts3d, k_f, k_c) - pts2d, dim=-1)
        cam_z = (torch.einsum("sij,snj->sni", r, pts3d) + t[:, None])[..., 2]
        inf = float("inf")
        gap = torch.where(valid & (cam_z > 0), (err.double() - thresh).abs(), inf)
        gaps.copy_(torch.minimum(gaps, gap.nan_to_num(nan=inf, posinf=inf).amin(-1)))
        return inliers(r, t, pts2d, pts3d, valid, k_f, k_c, thresh)

    pnp._inliers = recording
    try:
        got = recording(ops["r"], ops["t"], ops["pts2d"], ops["pts3d"], ops["valid"],
                        ops["k_f"], ops["k_c"], THRESH)
        pnp.lo_refine(ops["r"], ops["t"], ops["pts2d"], ops["pts3d"], ops["valid"], ops["k_f"],
                      ops["k_c"], inlier_thresh=THRESH, iters=lo_iters, inliers=got[0],
                      count=got[1])
    finally:
        pnp._inliers = inliers
    return gaps


def first_refit(ops):
    """(R, t, inliers, count) after one LO refit in the plain twin."""
    from foundpose_torch.pose import pnp

    return pnp.lo_refine(ops["r"], ops["t"], ops["pts2d"], ops["pts3d"], ops["valid"],
                         ops["k_f"], ops["k_c"], inlier_thresh=THRESH, iters=1,
                         inliers=ops["inliers"], count=ops["count"])


def _with_inliers(ops):
    from foundpose_torch.pose import pnp

    inliers, count = pnp._inliers(ops["r"], ops["t"], ops["pts2d"], ops["pts3d"], ops["valid"],
                                  ops["k_f"], ops["k_c"], THRESH)
    return dict(ops, inliers=inliers, count=count)


def refine_operands(s, n, seed=0, device="cpu", special=True):
    """`refine_lo_lm`'s operands (r, t, pts2d, pts3d, valid, k_f, k_c,
    inliers, count) for s sets of n points, with f 600 and c 209.5, the
    inliers and count at THRESH; normal sets as `_draw` makes them. No
    valid point lies within MIN_GAP_PX of a threshold at any pose the twin
    tests it at: a set that has one is drawn again. With `special` and
    s >= 6: set 0 has no valid point, set 1 four, set 2 is degenerate
    (every point one 3D point, seen where the true pose puts it), set 3
    holds a NaN in an invalid entry's model point; sets 4 and 5 have
    points between the base and the widened threshold, set 4 a first refit
    accepted at a higher count and set 5 a refit that loses inliers and is
    refused (WIDENED, LOSES); either is drawn again until it does."""
    rng = np.random.default_rng(seed)
    d = _draw(rng, s, n)
    special = special and s >= 6
    if special:
        _special(d, rng)
    for _ in range(50):
        ops = _with_inliers(_tensors(d, "cpu"))
        bad = threshold_gaps(ops) < MIN_GAP_PX
        if special:
            bad[:4] = False
            r, _, _, count = first_refit(ops)
            bad[4] |= not bool(count[4] > ops["count"][4])
            bad[5] |= not torch.equal(r[5], ops["r"][5])
        redraw = np.nonzero(bad.numpy())[0]
        if not len(redraw):
            return _with_inliers(_tensors(d, device))
        fresh = _draw(rng, len(redraw), n)
        for key in d:
            d[key][redraw] = fresh[key]
        for k, design in ((4, WIDENED), (5, LOSES)):
            if special and bad[k]:
                _shifted(d, k, rng, *design)
    raise RuntimeError("refine_operands: no set far enough from the thresholds")
