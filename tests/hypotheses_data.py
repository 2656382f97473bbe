"""Operands of `pnp.dlt_hypotheses` for the tests of its kernel and its CPU
path (tests/test_torch_hypotheses.py, tests/test_torch_cuda.py)."""

import numpy as np
import torch

F, C = 600.0, 209.5


def hypothesis_operands(s, n, h, seed=0, device="cpu", special=True):
    """(pts2d, pts3d, valid, k_f, k_c, draws) for s sets of n points and h
    hypotheses, with f 600 and c 209.5: model points in a 100 mm cube at
    450-650 mm under a random rotation; 75% of the points seen where the
    pose puts them (0.05 px noise: near exact, as a solvable crop's
    correspondences with its own template are) and the rest 40-120 px away,
    so that a set's best hypotheses count every valid inlier at a 10 px
    threshold and float32 rounding cannot move that count; 85% valid; draws
    uniform in [0, n). With `special` and s >= 4: set 0 has no valid point,
    set 1 four, set 2 a NaN in an invalid entry's model point and set 3 one
    in an invalid entry's pixel (each poisons every hypothesis of its set in
    the twin); the last set's draws span +-2**40, so that they are reduced
    modulo its valid count from far outside [0, n) and from below zero."""
    from foundpose_torch import geometry

    rng = np.random.default_rng(seed)
    pts3d = rng.uniform(-50, 50, (s, n, 3))
    axis = rng.normal(size=(s, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    r = geometry.rodrigues(torch.tensor(axis * rng.uniform(0, np.pi, (s, 1)))).numpy()
    t = np.stack([rng.uniform(-30, 30, s), rng.uniform(-30, 30, s),
                  rng.uniform(450, 650, s)], -1)
    cam = np.einsum("sij,snj->sni", r, pts3d) + t[:, None]
    pts2d = cam[..., :2] / cam[..., 2:] * F + C
    angle = rng.uniform(0, 2 * np.pi, (s, n))
    far = np.stack([np.cos(angle), np.sin(angle)], -1) * rng.uniform(40, 120, (s, n, 1))
    noise = rng.normal(0, 0.05, (s, n, 2))
    pts2d += np.where((rng.random((s, n)) < 0.25)[..., None], far, noise)
    valid = rng.random((s, n)) < 0.85
    draws = rng.integers(0, n, (s, h, 6))
    if special and s >= 4:
        valid[0] = False
        valid[1] = False
        valid[1, :4] = True
        valid[2:4, 0] = False
        pts3d[2, 0, 1] = np.nan
        pts2d[3, 0, 0] = np.nan
        draws[-1] = rng.integers(-2**40, 2**40, (h, 6))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return dict(pts2d=f32(pts2d), pts3d=f32(pts3d), valid=torch.as_tensor(valid, device=device),
                k_f=torch.full((s, 2), F, device=device), k_c=torch.full((s, 2), C, device=device),
                draws=torch.as_tensor(draws, dtype=torch.int64, device=device))


def dlt_hypotheses_f64(ops):
    """The plain twin's samples and minimal solves in float64 (no finite
    fix): the reference the kernel and the float32 twin are held to."""
    from foundpose_torch.pose import pnp

    pts2d, pts3d, k_f, k_c = (ops[k].double() for k in ("pts2d", "pts3d", "k_f", "k_c"))
    rays = (pts2d - k_c[:, None]) / k_f[:, None]
    counts = pnp.sample_counts(ops["valid"], ops["draws"]).double()
    return pnp._dlt_pose_many(pts3d, rays, ops["valid"].double(), counts)
