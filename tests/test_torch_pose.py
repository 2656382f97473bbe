"""Parity of the port's matching and PnP (with the buddies and scoring
kernels' twins) with the JAX package, in f32 on the CPU. Where the JAX
function reaches a Pallas kernel it runs in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)
from jax.experimental.pallas import tpu as pltpu
from scipy.spatial.transform import Rotation

from foundpose_torch.ops.buddies_kernel import cycle_distances
from foundpose_torch.pose import corresp as t_corresp
from foundpose_torch.pose import pnp as t_pnp
from foundpose_tpu.ops.buddies_kernel import cycle_distances_fused
from foundpose_tpu.pose import corresp as j_corresp
from foundpose_tpu.pose import pnp as j_pnp


def T(a):
    return torch.from_numpy(np.array(a))


def buddies_inputs(rng):
    """The shapes of tests/test_selection.py's buddies-kernel test."""
    b, tn, q, f, d = 2, 3, 64, 48, 16
    return dict(
        qpts=rng.uniform(0, 400, size=(q, 2)).astype(np.float32),
        qf=rng.normal(size=(b, q, d)).astype(np.float32),
        qmask=rng.uniform(size=(b, q)) > 0.2,
        bank=rng.normal(size=(f, 32, d)).astype(np.float32),
        verts=rng.normal(size=(f, 32, 3)).astype(np.float32),
        bmask=rng.uniform(size=(f, 32)) > 0.2,
        tids=rng.integers(0, f, size=(b, tn)).astype(np.int32),
        tscores=np.ones((b, tn), np.float32),
    )


def test_buddies_twin_matches_pallas_kernel(rng):
    """cycle distances atol 1e-5, q2o equal at valid queries."""
    x = buddies_inputs(rng)
    sel = x["bank"][x["tids"]]
    smask = x["bmask"][x["tids"]]
    with pltpu.force_tpu_interpret_mode():
        cd_j, q2o_j = cycle_distances_fused(
            jnp.asarray(x["qf"]), jnp.asarray(x["qmask"]), jnp.asarray(x["qpts"]),
            jnp.asarray(sel), jnp.asarray(smask),
        )
    cd_t, q2o_t = cycle_distances(T(x["qf"]), T(x["qmask"]), T(x["qpts"]), T(sel), T(smask))
    valid = np.broadcast_to(x["qmask"][:, None, :], cd_t.shape)
    np.testing.assert_allclose(cd_t.numpy(), np.asarray(cd_j), atol=1e-5)
    np.testing.assert_array_equal(q2o_t.numpy()[valid], np.asarray(q2o_j)[valid])


def test_buddies_twin_matches_pallas_kernel_mostly_masked(rng):
    """About 80% of queries masked (as the bench's crop masks leave them)
    and Q = 150, not a multiple of 64 or 128: q2o equal at every valid
    query, cycle distances (INVALID_SENTINEL at masked ones) everywhere,
    atol 1e-5."""
    b, tn, q, f, d = 2, 3, 150, 40, 16
    bank = rng.normal(size=(b, tn, f, d)).astype(np.float32)
    rows = rng.integers(0, f, size=(b, q))
    qf = bank[np.arange(b)[:, None], 0, rows] + 0.3 * rng.normal(size=(b, q, d)).astype(np.float32)
    qmask = rng.uniform(size=(b, q)) > 0.8
    smask = rng.uniform(size=(b, tn, f)) > 0.2
    qpts = rng.uniform(0, 400, size=(q, 2)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        cd_j, q2o_j = cycle_distances_fused(
            jnp.asarray(qf), jnp.asarray(qmask), jnp.asarray(qpts), jnp.asarray(bank),
            jnp.asarray(smask),
        )
    cd_t, q2o_t = cycle_distances(T(qf), T(qmask), T(qpts), T(bank), T(smask))
    valid = np.broadcast_to(qmask[:, None, :], cd_t.shape)
    assert 0.1 < valid.mean() < 0.3
    np.testing.assert_allclose(cd_t.numpy(), np.asarray(cd_j), atol=1e-5)
    np.testing.assert_array_equal(q2o_t.numpy()[valid], np.asarray(q2o_j)[valid])


@pytest.mark.parametrize("approx", [True, False])
def test_establish_correspondences_batch(rng, approx):
    """Approx path (vs the JAX kernel path in interpret mode) and exact
    path: same valid slots, same ids there, same distances and 3D points."""
    x = buddies_inputs(rng)
    args_j = [jnp.asarray(x[k]) for k in
              ("qpts", "qf", "qmask", "tids", "tscores", "bank", "verts", "bmask")]
    if approx:
        with pltpu.force_tpu_interpret_mode():
            ref = j_corresp.establish_correspondences_batch(
                *args_j, top_k=20, approx_topk=True, use_kernel=True
            )
    else:
        ref = j_corresp.establish_correspondences_batch(*args_j, top_k=20, approx_topk=False)
    got = t_corresp.establish_correspondences_batch(
        *[T(x[k]) for k in ("qpts", "qf", "qmask", "tids", "tscores", "bank", "verts", "bmask")],
        top_k=20, approx_topk=approx,
    )
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.coord_2d_ids.numpy()[v], np.asarray(ref.coord_2d_ids)[v])
    np.testing.assert_array_equal(got.nn_vertex_ids.numpy()[v], np.asarray(ref.nn_vertex_ids)[v])
    np.testing.assert_allclose(got.cycle_dists.numpy()[v], np.asarray(ref.cycle_dists)[v],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.coord_3d.numpy()[v], np.asarray(ref.coord_3d)[v], atol=1e-6)
    np.testing.assert_allclose(got.coord_2d.numpy()[v], np.asarray(ref.coord_2d)[v], atol=1e-6)
    np.testing.assert_allclose(got.coord_conf.numpy(), np.asarray(ref.coord_conf), atol=1e-5)


def pnp_problem(rng, n, noise=0.5, outlier_frac=0.3, sets=1):
    """Sets of 2D-3D correspondences under random poses (f=600, c=209.5)."""
    k_f = np.array([600.0, 600.0], np.float32)
    k_c = np.array([209.5, 209.5], np.float32)
    p2, p3, rs, ts = [], [], [], []
    for _ in range(sets):
        r = Rotation.from_rotvec(rng.normal(0, 0.3, 3)).as_matrix().astype(np.float32)
        t = np.array([rng.normal(0, 0.02), rng.normal(0, 0.02), 0.5], np.float32)
        pts = rng.uniform(-0.06, 0.06, (n, 3)).astype(np.float32)
        cam = pts @ r.T + t
        uv = cam[:, :2] / cam[:, 2:] * k_f + k_c + rng.normal(0, noise, (n, 2))
        out = rng.uniform(size=n) < outlier_frac
        uv[out] = rng.uniform(0, 420, (int(out.sum()), 2))
        p2.append(uv.astype(np.float32))
        p3.append(pts)
        rs.append(r)
        ts.append(t)
    return np.stack(p2), np.stack(p3), np.stack(rs), np.stack(ts), k_f, k_c


@pytest.mark.parametrize("case", ["h64", "h37", "behind_camera", "no_valid_point"])
def test_score_twin_matches_pallas_kernel(rng, case):
    """Inlier counts equal for every hypothesis, from the raw operands, on
    three sets scored in one call and held set by set against the Pallas
    kernel. H 37 is a ragged hypothesis tile; the last set's hypotheses sit
    behind the camera (cam_z < 0) or its mask is empty, and count 0."""
    sets, n = 3, 80
    h = 37 if case == "h37" else 64
    p2, p3, r, t, k_f, k_c = pnp_problem(rng, n, sets=sets)
    rs = (r[:, None] + rng.normal(0, 0.02, (sets, h, 3, 3))).astype(np.float32)
    ts = (t[:, None] + rng.normal(0, 0.004, (sets, h, 3))).astype(np.float32)
    valid = rng.uniform(size=(sets, n)) > 0.1
    if case == "behind_camera":
        ts[-1, :, 2] = -0.5
    if case == "no_valid_point":
        valid[-1] = False
    validf = valid.astype(np.float32)
    thr = 10.0
    got = t_pnp.score_hypotheses(
        T(p2), T(p3), T(validf), T(rs), T(ts), T(np.tile(k_f, (sets, 1))),
        T(np.tile(k_c, (sets, 1))), thr,
    )
    assert got.shape == (sets, h)
    for i in range(sets):
        with pltpu.force_tpu_interpret_mode():
            ref = j_pnp.score_hypotheses_fused(
                jnp.asarray(p2[i]), jnp.asarray(p3[i]), jnp.asarray(validf[i]),
                jnp.asarray(rs[i]), jnp.asarray(ts[i]), jnp.asarray(k_f), jnp.asarray(k_c), thr,
            )
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref))
    assert 0 < float(got[0].max()) <= valid[0].sum()
    if case in ("behind_camera", "no_valid_point"):
        assert float(got[-1].abs().max()) == 0.0


def jax_draws(key, h, n):
    return np.asarray(jax.random.randint(key, (h, 6), 0, n))


def test_ransac_pnp_with_jax_draws(rng):
    """Given the JAX draws: same quality and inliers, R/t atol 1e-4 (with
    LO and LM), on three sets with one padded."""
    n, h, sets = 120, 100, 3
    p2, p3, _, _, k_f, k_c = pnp_problem(rng, n, sets=sets)
    valid = np.ones((sets, n), bool)
    valid[2, 90:] = False
    keys = jax.random.split(jax.random.PRNGKey(3), sets)
    draws = np.stack([jax_draws(keys[i], h, n) for i in range(sets)])
    got = t_pnp.ransac_pnp(
        T(p2), T(p3), T(valid), T(np.tile(k_f, (sets, 1))), T(np.tile(k_c, (sets, 1))),
        num_hypotheses=h, draws=T(draws),
    )
    for i in range(sets):
        ref = j_pnp.ransac_pnp(
            jnp.asarray(p2[i]), jnp.asarray(p3[i]), jnp.asarray(valid[i]),
            jnp.asarray(k_f), jnp.asarray(k_c), keys[i], num_hypotheses=h,
        )
        assert float(got.quality[i]) == float(ref.quality)
        assert bool(got.success[i]) == bool(ref.success)
        np.testing.assert_array_equal(got.inliers[i].numpy(), np.asarray(ref.inliers))
        np.testing.assert_allclose(got.R[i].numpy(), np.asarray(ref.R), atol=1e-4)
        np.testing.assert_allclose(got.t[i].numpy(), np.asarray(ref.t), atol=1e-4)


def test_lo_refine_and_lm_match_jax(rng):
    """From a perturbed pose: lo_refine counts/inliers equal and poses
    atol 1e-4; refine_pose_lm poses atol 1e-4."""
    p2, p3, r, t, k_f, k_c = pnp_problem(rng, 150, noise=1.0, sets=1)
    dr = Rotation.from_rotvec([0.03, -0.02, 0.015]).as_matrix().astype(np.float32)
    r0 = (dr @ r[0]).astype(np.float32)
    t0 = (t[0] + np.array([0.004, -0.003, 0.008], np.float32)).astype(np.float32)
    valid = np.ones(150, bool)
    jargs = (jnp.asarray(p2[0]), jnp.asarray(p3[0]), jnp.asarray(valid),
             jnp.asarray(k_f), jnp.asarray(k_c))
    targs = (T(p2), T(p3), T(valid[None]), T(k_f[None]), T(k_c[None]))
    rj, tj, ij, cj = j_pnp.lo_refine(jnp.asarray(r0), jnp.asarray(t0), *jargs, iters=2)
    rt, tt, it, ct = t_pnp.lo_refine(T(r0[None]), T(t0[None]), *targs, iters=2)
    assert float(ct[0]) == float(cj)
    np.testing.assert_array_equal(it[0].numpy(), np.asarray(ij))
    np.testing.assert_allclose(rt[0].numpy(), np.asarray(rj), atol=1e-4)
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(tj), atol=1e-4)

    rl_j, tl_j = j_pnp.refine_pose_lm(
        rj, tj, jnp.asarray(p2[0]), jnp.asarray(p3[0]), ij, jnp.asarray(k_f), jnp.asarray(k_c)
    )
    rl_t, tl_t = t_pnp.refine_pose_lm(rt, tt, T(p2), T(p3), it, T(k_f[None]), T(k_c[None]))
    np.testing.assert_allclose(rl_t[0].numpy(), np.asarray(rl_j), atol=1e-4)
    np.testing.assert_allclose(tl_t[0].numpy(), np.asarray(tl_j), atol=1e-4)


def test_two_phase_solve_keeps_the_better_pose(rng):
    """pnp_select_iter > 0: selection at the small budget, the full budget
    on the winner, kept only where it does not lose inliers."""
    from foundpose_torch.pipeline.inference import InferenceConfig, full_budget_winner

    p2, p3, _, _, k_f, k_c = pnp_problem(rng, 100, sets=4)
    args = (T(p2), T(p3), T(np.ones((4, 100), bool)), T(np.tile(k_f, (4, 1))),
            T(np.tile(k_c, (4, 1))))
    sel = t_pnp.ransac_pnp(*args, num_hypotheses=8, refine_lm=False, lo_iters=0,
                           generator=torch.Generator().manual_seed(0))
    cfg = InferenceConfig(pnp_ransac_iter=200, pnp_select_iter=8)
    r, t, inl, q = full_budget_winner(sel.R, sel.t, sel.inliers, sel.quality, *args, cfg,
                                      torch.Generator().manual_seed(1))
    assert bool((q >= sel.quality).all()) and bool((q > sel.quality).any())
    np.testing.assert_array_equal(inl.sum(-1).numpy(), q.numpy())
    with pytest.raises(ValueError):
        InferenceConfig(pnp_ransac_iter=200, pnp_select_iter=200)
