"""The port's evaluation layer against the JAX package's, on the CPU:
pose errors, the evaluator's records and files, the BOP19 AR protocol
(with the restatement oracle of test_bop_ar.py), and the cross-parity
world's poses from the JAX step and the port's step scored alike."""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)
from scipy.spatial.transform import Rotation
from test_bop_ar import make_multi_instance_world, make_world, oracle_evaluate
from test_torch_pipeline import T, jax_pipeline_draws, torch_camera, torch_config, torch_repre

from foundpose_torch.eval import bop_ar as t_ar
from foundpose_torch.eval import errors as t_err
from foundpose_torch.eval import evaluator as t_ev
from foundpose_torch.pipeline import inference as t_inf
from foundpose_torch.structs import PinholeCamera as TCamera
from foundpose_tpu.eval import bop_ar as j_ar
from foundpose_tpu.eval import errors as j_err
from foundpose_tpu.eval import evaluator as j_ev
from foundpose_tpu.pipeline import inference as j_inf
from foundpose_tpu.renderer.base import RenderType as JRenderType
from foundpose_tpu.structs import PinholeCamera as JCamera

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks"))

from cross_parity import CROP, make_world as parity_world, render_query  # noqa: E402


def error_inputs(rng):
    """test_eval.py's inputs: points, a perturbed pose, a 180-degree
    symmetric object, LM-O-like intrinsics."""
    pts = rng.uniform(-50, 50, size=(100, 3)).astype(np.float32)
    r_gt = Rotation.random(random_state=0).as_matrix().astype(np.float32)
    t_gt = np.array([10.0, -5.0, 700.0], np.float32)
    r_est = (r_gt @ Rotation.from_rotvec([0.02, 0, 0.3]).as_matrix()).astype(np.float32)
    t_est = t_gt + np.array([1.0, 0, 2.0], np.float32)
    flip = Rotation.from_rotvec([0, 0, np.pi]).as_matrix().astype(np.float32)
    sym_r = np.stack([np.eye(3, dtype=np.float32), flip])
    sym_t = np.zeros((2, 3), np.float32)
    k = np.array([[600, 0, 320], [0, 600, 240], [0, 0, 1]], np.float32)
    return pts, r_gt, t_gt, r_est, t_est, sym_r, sym_t, k


def test_errors_match_jax(rng):
    """MSSD and MSPD (value within 1e-4 relative, argmax vertex equal),
    with and without the symmetry; rotation and translation errors; mask
    IoU; vertex error percentiles."""
    pts, r_gt, t_gt, r_est, t_est, sym_r, sym_t, k = error_inputs(rng)
    for syms in ((sym_r, sym_t), (sym_r[:1], sym_t[:1])):
        for fn, args in (("mssd", (r_est, t_est, r_gt, t_gt, pts)),
                         ("mspd", (r_est, t_est, r_gt, t_gt, k, pts))):
            got = getattr(t_err, fn)(*(T(a) for a in args + syms))
            ref = getattr(j_err, fn)(*(jnp.asarray(a) for a in args + syms))
            np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-4)
            assert int(got[1]) == int(ref[1])
    np.testing.assert_allclose(float(t_err.rotation_error_deg(T(r_est), T(r_gt))),
                               float(j_err.rotation_error_deg(jnp.asarray(r_est), jnp.asarray(r_gt))),
                               atol=1e-3)
    np.testing.assert_allclose(float(t_err.translation_error(T(t_est), T(t_gt))),
                               float(j_err.translation_error(jnp.asarray(t_est), jnp.asarray(t_gt))),
                               rtol=1e-6)
    m1, m2 = rng.uniform(size=(2, 20, 30)) > 0.5
    for a, b in ((m1, m2), (np.zeros_like(m1), np.zeros_like(m2))):
        assert float(t_err.mask_iou(T(a), T(b))) == float(j_err.mask_iou(jnp.asarray(a), jnp.asarray(b)))
    got = t_err.vertex_error_percentiles(T(r_est), T(t_est), T(r_gt), T(t_gt), T(pts))
    ref = j_err.vertex_error_percentiles(*(jnp.asarray(a) for a in (r_est, t_est, r_gt, t_gt, pts)))
    for key in ("mean", "p50", "p90", "max"):
        np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=1e-4)


def evaluator_updates(rng):
    """test_eval.py's full-accumulator and GT-less updates, as keyword
    dicts without the cameras."""
    pts = rng.uniform(-30, 30, size=(40, 3)).astype(np.float32)
    r_gt, t_gt = np.eye(3), np.array([0, 0, 500.0])
    c3d = rng.uniform(-20, 20, size=(50, 3))
    cam_pts = c3d @ r_gt.T + t_gt
    c2d = cam_pts[:, :2] / cam_pts[:, 2:3] * 600.0 + np.array([320.0, 240.0])
    valid = np.ones(50, bool)
    valid[45:] = False
    corresp = {"coord_2d": c2d, "coord_2d_ids": rng.integers(0, 30, size=50), "coord_3d": c3d,
               "valid": valid}
    k = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]], np.float32)
    common = dict(scene_id=2, inst_id=0, hypothesis_id=0, obj_id=5, R_gt_m2c=r_gt, t_gt_m2c=t_gt,
                  model_pts=pts, K=k, corresp=corresp, object_diameter=100.0, inlier_radius=10.0)
    return [
        dict(common, im_id=3, R_m2w=r_gt, t_m2w=t_gt, score=0.8, time_per_inst={"feat": 0.01},
             retrieved_template_R_m2c=np.stack([r_gt, r_gt @ np.diag([1, -1, -1.0])]), mask_iou=0.75),
        dict(common, im_id=4, R_m2w=Rotation.from_rotvec([0.05, 0, 0]).as_matrix(),
             t_m2w=t_gt + np.array([5.0, 0, 0]), score=0.4, time_per_inst={"feat": 0.01},
             pred_mask=rng.uniform(size=(12, 16)) > 0.3, gt_mask=rng.uniform(size=(12, 16)) > 0.5),
        dict(scene_id=1, im_id=2, inst_id=0, hypothesis_id=0, obj_id=4, R_m2w=np.eye(3),
             t_m2w=t_gt, score=0.9, time_per_inst={"t": 0.01}, corresp=corresp, inlier_radius=10.0),
    ]


def test_evaluator_matches_jax(rng, tmp_path):
    """The same updates through both evaluators: every record field within
    1e-5 relative (errors run in f32), the estimated-poses JSON equal up to
    those errors, the metric tables and the summary equal."""
    jcam = JCamera.create(f=(600.0, 600.0), c=(320.0, 240.0), width=640, height=480)
    tcam = TCamera.from_intrinsic_matrix(np.array(jcam.K), width=640, height=480)
    evs = {"jax": j_ev.EvaluatorPose([4, 5]), "torch": t_ev.EvaluatorPose([4, 5])}
    for upd in evaluator_updates(rng):
        for name, cam in (("jax", jcam), ("torch", tcam)):
            evs[name].update(orig_camera_c2w=cam, camera_c2w=cam, **upd)
    for r_j, r_t in zip(evs["jax"].records, evs["torch"].records):
        for f in dataclasses.fields(r_j):
            a, b = getattr(r_j, f.name), getattr(r_t, f.name)
            if isinstance(a, (float, np.ndarray)):
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=f.name)
            else:
                assert a == b, f.name
    files = {}
    for name, ev in evs.items():
        ev.detection_times[(2, 3)] = 0.1
        base = tmp_path / name
        ev.save_results_json(str(base / "estimated-poses.json"))
        ev.save_metrics(str(base / "metrics-table.tsv"))
        ev.save_metrics_tsv(str(base / "metrics.tsv"))
        files[name] = [json.load(open(base / "estimated-poses.json")),
                       open(base / "metrics-table.tsv").read(), open(base / "metrics.tsv").read()]
    for a, b in zip(files["jax"][0], files["torch"][0]):
        assert a.keys() == b.keys()
        for key in a:
            if isinstance(a[key], float):
                np.testing.assert_allclose(b[key], a[key], rtol=1e-5, atol=1e-6)
            else:
                assert a[key] == b[key], key
    assert files["torch"][1:] == files["jax"][1:]
    ref_summary, got_summary = evs["jax"].summary(), evs["torch"].summary()
    assert got_summary.keys() == ref_summary.keys()
    for key, val in ref_summary.items():
        np.testing.assert_allclose(got_summary[key], val, rtol=1e-5, atol=1e-6, err_msg=key)


def test_write_bop_submission_is_byte_equal_to_jax(tmp_path):
    """The BOP19 CSV from the same records, two objects, times summed with
    the detection time: the same bytes; the port's reader reads it back."""
    results = {
        5: [{"scene_id": "2", "img_id": "3", "obj_id": "5", "score": "0.8",
             "R": Rotation.from_rotvec([0.1, 0.2, 0.3]).as_matrix().tolist(),
             "t": [[1.0], [2.5], [3.125]], "time": {"feat": 0.01, "pnp": 0.02}}],
        1: [{"scene_id": "2", "img_id": "3", "obj_id": "1", "score": "0.5",
             "R": np.eye(3).tolist(), "t": [[0.1], [0.2], [0.3]], "time": {"feat": 1.0 / 3}},
            {"scene_id": "4", "img_id": "7", "obj_id": "1", "score": "0.25",
             "R": np.eye(3).tolist(), "t": [[7.0], [8.0], [9.0]], "time": {}}],
    }
    paths = {n: str(tmp_path / n / "sub.csv") for n in ("jax", "torch")}
    j_ev.write_bop_submission(paths["jax"], results, detection_times={(2, 3): 0.5, (9, 9): 1.0})
    t_ev.write_bop_submission(paths["torch"], results, detection_times={(2, 3): 0.5, (9, 9): 1.0})
    assert open(paths["torch"], "rb").read() == open(paths["jax"], "rb").read()
    got, ref = t_ar.load_estimates_from_csv(paths["torch"]), j_ar.load_estimates_from_csv(paths["jax"])
    assert [vars(g).keys() for g in got] == [vars(r).keys() for r in ref]
    for g, r in zip(got, ref):
        for key, val in vars(r).items():
            np.testing.assert_array_equal(getattr(g, key), val)


def port_estimates(ests, gts):
    return ([t_ar.Estimate(**vars(e)) for e in ests], [t_ar.GroundTruth(**vars(g)) for g in gts])


def test_bop_ar_matches_jax_and_the_restatement_oracle(rng):
    """The multi-instance worlds of test_bop_ar.py (seeds 0-2) and its
    noisy and missing-estimate worlds: the port's AR equals the JAX
    module's exactly and the oracle's within 1e-12."""
    worlds = [make_multi_instance_world(seed) for seed in (0, 1, 2)]
    for kw in (dict(noise_rot_deg=8.0), dict(miss_frac=0.5)):
        pts, dia, _, gts, ests, intr = make_world(rng, **kw)
        worlds.append(({7: pts}, {7: dia}, {7: [(np.eye(3), np.zeros(3))]}, intr, gts, ests))
    for pts, dia, syms, intr, gts, ests in worlds:
        ref = j_ar.evaluate_ar(ests, gts, pts, dia, syms, intr)
        got = t_ar.evaluate_ar(*port_estimates(ests, gts), pts, dia, syms, intr)
        assert got == ref
        want = oracle_evaluate(ests, gts, pts, dia, syms, intr)
        for key in ("ar_mssd", "ar_mspd", "bop_ar"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-12)


def test_bop_ar_keeps_one_global_image_width():
    """Fault (b) of the JAX module, kept on purpose: MSPD thresholds scale
    with the call's one image_width, also for an image of another width.
    Both images' estimates are 7 px off (a planar model under a 7 mm shift
    at 1000 mm, f = 1000): at width 640 the thresholds are 5..50 px, so each
    image scores 0.9; a per-image width of 1280 for the second image would
    have given it 1.0 (thresholds 10..100) and AR_MSPD 0.95."""
    pts = {7: np.array([[x, y, 0.0] for x in (-50, 0, 50) for y in (-50, 0, 50)])}
    dia = {7: float(np.linalg.norm([100.0, 100.0]))}
    syms = {7: [(np.eye(3), np.zeros(3))]}
    k = np.array([[1000.0, 0, 320], [0, 1000.0, 240], [0, 0, 1]])
    intr = {(1, 0): k, (1, 1): k}
    t = np.array([0, 0, 1000.0])
    gts = [j_ar.GroundTruth(1, i, 7, np.eye(3), t) for i in (0, 1)]
    ests = [j_ar.Estimate(1, i, 7, 0.9, np.eye(3), t + np.array([7.0, 0, 0])) for i in (0, 1)]
    got = t_ar.evaluate_ar(*port_estimates(ests, gts), pts, dia, syms, intr, image_width=640)
    ref = j_ar.evaluate_ar(ests, gts, pts, dia, syms, intr, image_width=640)
    assert got == ref
    np.testing.assert_allclose(got["ar_mspd"], 0.9, atol=1e-12)
    per_image = np.mean([t_ar.evaluate_ar(*port_estimates(ests[i:i + 1], gts[i:i + 1]), pts, dia, syms,
                                          intr, image_width=w)["ar_mspd"]
                         for i, w in ((0, 640), (1, 1280))])
    np.testing.assert_allclose(per_image, 0.95, atol=1e-12)


class StubRenderer:
    """Renders the known depth image of a 60 x 60 mm square at the pose's
    depth: the square's projected box filled with t_z, zero elsewhere (on a
    128 x 128 image); the output maps both packages' DEPTH keys to it."""

    def __init__(self, k):
        self.k = k

    def render_object_model(self, obj_id, cam, T_model_to_world):
        t = np.asarray(T_model_to_world)[:3, 3]
        corners = np.array([[-30, -30], [30, 30]]) + t[:2]
        box = corners / t[2] * self.k[0, 0] + self.k[:2, 2]
        depth = np.zeros((128, 128))
        x0, y0 = np.floor(box[0]).astype(int)
        x1, y1 = np.ceil(box[1]).astype(int)
        depth[max(y0, 0):y1, max(x0, 0):x1] = t[2]
        return {JRenderType.DEPTH: depth, t_ar.RenderType.DEPTH: depth}


def test_vsd_with_a_stub_renderer_matches_jax():
    """VSD from a renderer that returns a known depth image: the exact
    estimate scores AR_VSD 1, a 9 mm deeper one partial, an 80 mm deeper
    one 0; the port equals the JAX module on all three."""
    k = np.array([[300.0, 0, 63.5], [0, 300.0, 63.5], [0, 0, 1]])
    cam = TCamera.from_intrinsic_matrix(k, width=128, height=128)
    renderer = StubRenderer(k)
    t_gt = np.array([0, 0, 400.0])
    depth = renderer.render_object_model(7, cam, np.eye(4) + np.pad(t_gt[:, None], ((0, 1), (3, 0))))[
        t_ar.RenderType.DEPTH]
    v = np.array([[-30, -30, 0], [30, -30, 0], [30, 30, 0], [-30, 30, 0]], np.float64)
    gts = [j_ar.GroundTruth(1, 0, 7, np.eye(3), t_gt)]
    args = ({7: v}, {7: 85.0}, {7: [(np.eye(3), np.zeros(3))]}, {(1, 0): k})
    kw = dict(depth_images={(1, 0): depth}, renderer=renderer, cameras={(1, 0): cam})
    out = {}
    for dz in (0.0, 9.0, 80.0):
        ests = [j_ar.Estimate(1, 0, 7, 0.9, np.eye(3), t_gt + np.array([0, 0, dz]))]
        got = t_ar.evaluate_ar(*port_estimates(ests, gts), *args, **kw)
        assert got == j_ar.evaluate_ar(ests, gts, *args, **kw)
        out[dz] = got["ar_vsd"]
    assert out[0.0] == 1.0 and 0.0 < out[9.0] < 1.0 and out[80.0] == 0.0


def port_bop_ar(rs, ts, succ, rs_gt, ts_gt, model_points, k):
    """benchmarks/cross_parity.bop_ar_score through the port's bop_ar: each
    crop one single-instance image, AR = mean(AR_MSSD, AR_MSPD)."""
    pts = np.asarray(model_points[:: max(1, len(model_points) // 400)])
    dia = float(np.linalg.norm(pts.max(0) - pts.min(0)))
    gts, ests, intr = [], [], {}
    for i in range(len(rs_gt)):
        gts.append(t_ar.GroundTruth(1, i, 7, np.asarray(rs_gt[i]), np.asarray(ts_gt[i])))
        intr[(1, i)] = np.asarray(k, np.float64)
        if bool(succ[i]):
            ests.append(t_ar.Estimate(1, i, 7, 1.0, np.asarray(rs[i]), np.asarray(ts[i])))
    return t_ar.evaluate_ar(ests, gts, {7: pts}, {7: dia}, {7: [(np.eye(3), np.zeros(3))]}, intr,
                            image_width=CROP)["bop_ar"]


def cross_parity_ar(num_templates, pts_per_template, feat_dim, num_words, n_points, n_crops,
                    top_n, top_k, ransac):
    """The cross-parity world of benchmarks/cross_parity.py: the JAX step
    (PRNGKey 0) and the port's step with the JAX draws, exact f32; both
    sets of poses scored by the port's bop_ar."""
    rng = np.random.default_rng(0)
    repre, obj_points, obj_feats, tpl_ids = parity_world(
        rng, num_templates, pts_per_template, feat_dim, num_words, n_points)
    fmaps, masks, rs_gt, ts_gt = [], [], [], []
    for i in range(n_crops):
        fmap, mask, r_gt, t_gt = render_query(rng, obj_points, obj_feats, tpl_ids,
                                              target_tpl=i % num_templates, pose_seed=1000 + i)
        fmaps.append(fmap)
        masks.append(mask)
        rs_gt.append(r_gt)
        ts_gt.append(t_gt)
    cams = JCamera(f=jnp.tile(jnp.asarray([[600.0, 600.0]]), (n_crops, 1)),
                   c=jnp.tile(jnp.asarray([[209.5, 209.5]]), (n_crops, 1)),
                   T_world_from_eye=jnp.tile(jnp.eye(4)[None], (n_crops, 1, 1)), width=CROP, height=CROP)
    jcfg = j_inf.InferenceConfig(top_n_templates=top_n, top_k_buddies=top_k, pnp_ransac_iter=ransac)
    key = jax.random.PRNGKey(0)
    fmaps, masks = np.stack(fmaps), np.stack(masks)
    ref = j_inf.pose_from_features(jnp.asarray(fmaps), jnp.asarray(masks), cams, repre, key, jcfg)
    got = t_inf.pose_from_features(
        T(fmaps), T(masks), torch_camera(cams), torch_repre(repre), torch_config(jcfg),
        draws=T(jax_pipeline_draws(key, n_crops, top_n, ransac, top_k)))
    k = np.array([[600.0, 0, 209.5], [0, 600.0, 209.5], [0, 0, 1]])
    ar_j = port_bop_ar(np.asarray(ref.R_m2c), np.asarray(ref.t_m2c), np.asarray(ref.success),
                       rs_gt, ts_gt, obj_points, k)
    ar_t = port_bop_ar(got.R_m2c.numpy(), got.t_m2c.numpy(), got.success.numpy(), rs_gt, ts_gt,
                       obj_points, k)
    return ar_j, ar_t


def test_cross_parity_world_scores_alike_from_jax_and_port():
    """The test owed since the port's first slice, small: 12 templates, 12
    crops, 3 templates / 60 buddies / 400 hypotheses (test_cross_parity.py's
    scale). The two ARs are within 2 points; the world is not degenerate."""
    ar_j, ar_t = cross_parity_ar(12, 80, 48, 200, 200, 12, 3, 60, 400)
    assert ar_j > 0.5
    assert abs(ar_j - ar_t) <= 0.02


@pytest.mark.slow
def test_cross_parity_world_scores_alike_at_lmo_scale():
    """The same at benchmarks/cross_parity.py's full size: 798 templates of
    400 features, 256 dims, 2048 words, 100 crops, lmo_exact's 5 / 300 /
    400."""
    ar_j, ar_t = cross_parity_ar(798, 400, 256, 2048, 4000, 100, 5, 300, 400)
    assert ar_j > 0.5
    assert abs(ar_j - ar_t) <= 0.02
