"""The plain reference held to the program at a tiny size on the CPU, each
stage fed the same inputs: the ViT (the program's unfused f32 path, the
same weights), retrieval, exact cyclic buddies, the crop cameras and the
warp."""

import numpy as np
import pytest
import torch

from perfbench import judge, world
from perfbench.models import dinov2 as fam
from perfbench.reference import camera, dinov2 as vit, pipeline, pose, retrieval
from perfbench.reference.precision import Precision, fp8
from perfbench.tests import tiny

P = Precision()
TINY = dict(embed_dim=128, num_heads=2, depth=3, pos_grid=6)


@pytest.fixture(scope="module")
def tiny_setup():
    return tiny.setup("vits14reg_offline_b128")


@pytest.mark.parametrize("facet", ["token", "key"])
def test_vit_matches_the_program(facet):
    from foundpose_torch.models import dinov2

    opts = {"extractor_name": f"dinov2_version=vits14-reg_stride=14_facet={facet}_layer=1_norm=1",
            "approx_gelu": True, "vit_overrides": TINY}
    s = fam.shape(opts)
    w = fam.make_weights(s, 5, "cpu")
    model, extractor, overrides = fam.program(w, opts, torch.device("cpu"))
    assert extractor == opts["extractor_name"]
    assert overrides == dict(TINY, approx_gelu=True)
    images = torch.rand(3, 84, 84, 3, generator=torch.Generator().manual_seed(1))
    ours = vit.feature_maps(w, s, images, P)
    theirs = fam.extract(model, dinov2.normalize_images(images))
    assert ours.shape == theirs.shape
    assert (ours - theirs).abs().max() < 1e-4 * theirs.abs().max()


def test_calibrated_logits():
    s = vit.parse_extractor("dinov2_version=vits14-reg_stride=14_facet=token_layer=1_norm=1",
                            **TINY)
    maxima = fam.calibrate(fam.init(s, torch.Generator().manual_seed(0), "cpu"), s,
                           torch.Generator().manual_seed(1))
    np.testing.assert_allclose(maxima, fam.TARGET_LOGIT, rtol=1e-4)


def test_retrieval_matches_the_program(tiny_setup):
    from foundpose_torch.ops.tfidf import tfidf_retrieve

    s = tiny_setup
    t = s.traffic
    ana = pipeline.analyse(s.ref_vit, s.world, t.crops[:8], t.masks[:8], s.cell_px, P)
    repre = world.program_repre(s.world, "x")
    ids, scores = tfidf_retrieve(ana["q"], repre.word_centroids, repre.word_idfs,
                                 repre.template_descs, 5, repre.tfidf_config,
                                 query_mask=ana["valid"])
    ref_scores, ref_ids = torch.sort(ana["sims"], dim=1, descending=True, stable=True)
    assert torch.equal(ids, ref_ids[:, :5])
    assert (scores - ref_scores[:, :5]).abs().max() < 1e-5


def test_buddies_match_the_program_exact_path(tiny_setup):
    from foundpose_torch.pose.corresp import establish_correspondences_batch

    s = tiny_setup
    t = s.traffic
    ana = pipeline.analyse(s.ref_vit, s.world, t.crops[:8], t.masks[:8], s.cell_px, P)
    best = torch.argmax(ana["sims"], 1)
    q_ids, o_ids, ok = retrieval.cyclic_buddies(
        ana["points"], ana["q"], ana["valid"], s.world["bank_feats"][best],
        s.world["bank_mask"][best], 20, P)
    c = establish_correspondences_batch(
        ana["points"], ana["q"], ana["valid"], best[:, None], torch.ones(8, 1),
        s.world["bank_feats"], s.world["bank_vertices"], s.world["bank_mask"], top_k=20)
    assert torch.equal(ok, c.valid[:, 0])
    assert torch.equal(torch.where(ok, q_ids, -1), torch.where(ok, c.coord_2d_ids[:, 0], -1))
    assert torch.equal(torch.where(ok, o_ids, -1), torch.where(ok, c.nn_vertex_ids[:, 0], -1))


def test_solvable_crops_give_their_own_pose(tiny_setup):
    s = tiny_setup
    t = s.traffic
    sol = t.solvable[:4]
    ana = pipeline.analyse(s.ref_vit, s.world, t.crops[sol], t.masks[sol], s.cell_px, P)
    out = pipeline.outputs(ana, s.world, t.f[sol], t.c[sol], 5, 20, P)
    assert torch.equal(out["best_template"], t.own[sol])
    r_true, t_true = judge.true_poses(s.world, t.own[sol].numpy())
    assert pose.rotation_error_deg(out["R"], torch.as_tensor(r_true)).max() < 0.05
    assert (out["t"] - torch.as_tensor(t_true)).norm(dim=-1).max() < 1e-4


def test_crop_cameras_and_warp_match_the_program():
    from foundpose_torch.cameras import build_crop_cameras
    from foundpose_torch.ops.warp import make_single_image_warp
    from foundpose_torch.structs import PinholeCamera

    K = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1]])
    g = torch.Generator().manual_seed(3)
    image = torch.randint(0, 256, (96, 128, 3), dtype=torch.uint8, generator=g)
    boxes = torch.tensor([[10.0, 12.0, 50.0, 40.0], [70.0, 30.0, 127.0, 95.0]])
    f, c, rot = camera.crop_cameras(K, boxes, 84)
    src = PinholeCamera.from_intrinsic_matrix(K.astype(np.float32), 128, 96)
    cams = build_crop_cameras(src, boxes, viewport_size=(84, 84), viewport_rel_pad=0.2)
    np.testing.assert_allclose(f.numpy(), cams.f.numpy(), rtol=1e-5)
    np.testing.assert_allclose(c.numpy(), cams.c.numpy(), rtol=1e-6)
    np.testing.assert_allclose(rot.numpy(), cams.T_world_from_eye[:, :3, :3].numpy(), atol=1e-6)
    crops, masks = camera.warp(image, K, f, c, rot, 84)
    warp = make_single_image_warp((84, 84))
    theirs, their_masks = warp(image, torch.ones(2, 96, 128), src, cams)
    diff = (torch.round(crops.double() * 255).int() - theirs.int()).abs()
    assert diff.max() <= 1 and (diff > 0).float().mean() < 1e-3
    assert (masks != their_masks).float().mean() < 1e-3
    # The engine warps the frame divided by 255 and keeps the crops unrounded.
    theirs_f, _ = warp(image.float() / 255.0, torch.ones(2, 96, 128), src, cams)
    assert (crops - theirs_f).abs().max() * 255 < 0.05


def test_lowered_warp_misses():
    K = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1]])
    image = torch.randint(0, 256, (96, 128, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(4))
    f, c, rot = camera.crop_cameras(K, torch.tensor([[70.0, 30.0, 127.0, 95.0]]), 84)
    exact, _ = camera.warp(image, K, f, c, rot, 84)
    low, _ = camera.warp(image, K, f, c, rot, 84, Precision(lowp=("warp",)))
    assert (exact - low).abs().max() * 255 > 10


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.linspace(1.0, 2.0, 1001)
    err = (fp8(x) - x).abs() / x
    assert 0.02 < err.max() <= 1 / 16 + 1e-6
