"""BASELINE.json config 5's datasets through the port's CLI against the JAX
package's, on the CPU in f32 with exact top-k (test_torch_infer's split
builder, draws and comparisons):

- a T-LESS-like split (720x540 images under test_primesense/, the Primesense
  camera's kind, center-cropped to 630x532 as data/bop.DEFAULT_CROP_SIZES
  says) with 6 objects: `infer` over 3 of them through object_lids, and
  `infer_multi_object` over all 6 (batches that mix objects);
- pipeline/sweep over ["tudl"] with the first block of ViT-S/14-reg, and
  the pin that the sweep runs InferOpts' defaults, not
  configs/infer/<dataset>.json (ROADMAP.md Queue 3, quirk (h));
- the mixed-object load (pipeline/infer.load_stacked): banks cast as each
  object is loaded equal the cast of the f32 stack bit for bit.
"""

import dataclasses
import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)
from test_torch_infer import (assert_decisions_match, assert_submission_matches, build_split,
                              jax_draws, run_both)

from foundpose_torch.pipeline import eval_ar as t_eval_ar
from foundpose_torch.pipeline import infer as t_infer
from foundpose_torch.pipeline import sweep as t_sweep
from foundpose_torch.repre import load_repre, save_repre, stack_repres
from foundpose_torch.synthetic import realistic_repre
from foundpose_tpu.pipeline import eval_ar as j_eval_ar
from foundpose_tpu.pipeline import sweep as j_sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# R within 1e-4, t within 1e-5 m (the splits are in metres).
R_ATOL, T_ATOL = 1e-4, 1e-5
TLESS_K = np.array([[1075.65091572, 0.0, 360.0], [0.0, 1073.90347929, 270.0], [0.0, 0.0, 1.0]])
TUDL_K = np.array([[515.0, 0.0, 321.566], [0.0, 515.0, 214.08], [0.0, 0.0, 1.0]])


def boxes_for(lids, per_image, seed, area=((80, 600), (40, 440))):
    """{image: {lid: [(x, y, w, h)] * per_image[image]}} inside `area`
    (x and y ranges of the box corner), which the datasets' center crops
    keep whole."""
    rng = np.random.default_rng(seed)
    (x0, x1), (y0, y1) = area
    return {im: {lid: [(int(rng.integers(x0, x1)), int(rng.integers(y0, y1)),
                        int(rng.integers(60, 90)), int(rng.integers(60, 90))) for _ in range(n)]
                 for lid in lids} for im, n in enumerate(per_image)}


@pytest.fixture(scope="module")
def tless(tmp_path_factory):
    """The T-LESS-like split; both packages' infer over objects 1-3 and
    infer_multi_object over objects 1-6."""
    root = str(tmp_path_factory.mktemp("tless"))
    fields = build_split(root, np.random.default_rng(1), dataset="tless",
                         boxes=boxes_for(range(1, 7), (2, 1), seed=2), size=(720, 540),
                         k=TLESS_K, dataset_crop_size=None)
    return {"single": run_both(dict(fields, object_lids=[1, 2, 3]), root, "single"),
            "multi": run_both(fields, root, "multi")}


@pytest.mark.parametrize("mode,lids", [("single", [1, 2, 3]), ("multi", list(range(1, 7)))])
def test_tless_decisions_and_poses_match_jax(tless, mode, lids):
    """720x540 test_primesense images through the center crop: every
    detection's template ids, best template and success equal, poses within
    R_ATOL / T_ATOL; image 0's crops are templates, so they solve."""
    j, t = tless[mode]["jax"], tless[mode]["torch"]
    assert t["counts"] == j["counts"] == {lid: 3 for lid in lids}
    assert assert_decisions_match(j, t, lids, R_ATOL, T_ATOL) >= 2 * len(lids)


@pytest.mark.parametrize("mode", ["single", "multi"])
def test_tless_submission_and_ar_match_jax(tless, mode):
    """The BOP19 CSVs row by row (time aside) and eval_ar's results."""
    assert_submission_matches(tless[mode]["jax"], tless[mode]["torch"], R_ATOL, T_ATOL)


SWEEP_BATCH = 4
SWEEP_EXTRACTOR = "dinov2_version=vits14-reg_stride=14_facet=token_layer=0_norm=1"


def test_sweep_over_tudl_matches_jax(tmp_path, monkeypatch):
    """The real sweep over ["tudl"] (InferOpts' defaults: 420 px crops,
    top-5 templates, 300 buddies, RANSAC 200) with ViT-S/14-reg's first
    block, on one image with 4 detections of each object (each a template
    of its object, so all solve), the port taking the JAX draws: the same
    CSV and AR."""
    root = str(tmp_path)
    fields = build_split(root, np.random.default_rng(3), dataset="tudl",
                         boxes=boxes_for((1, 2, 3), (4,), seed=4), k=TUDL_K,
                         dataset_crop_size=None, crop=(420, 420), extractor=SWEEP_EXTRACTOR,
                         vit_overrides=None)
    os.makedirs(tmp_path / "dets")
    shutil.copy(fields["detections_path"], tmp_path / "dets" / "tudl.json")
    defaults = t_infer.InferOpts()
    draws = jax_draws(dict(batch_size=SWEEP_BATCH,
                           match_top_n_templates=defaults.match_top_n_templates,
                           pnp_ransac_iter=defaults.pnp_ransac_iter,
                           match_top_k_buddies=defaults.match_top_k_buddies))
    monkeypatch.setattr(t_sweep.infer_mod, "infer",
                        functools.partial(t_sweep.infer_mod.infer, draws_fn=draws))
    out = {}
    for pkg, mod, eval_ar, extra in (("jax", j_sweep, j_eval_ar, {}),
                                     ("torch", t_sweep, t_eval_ar, {"device": "cpu"})):
        out_dir = str(tmp_path / f"out_{pkg}")
        csvs = mod.sweep(mod.SweepOpts(
            datasets=["tudl"], extractor_name=SWEEP_EXTRACTOR, weights_path=fields["weights_path"],
            batch_size=SWEEP_BATCH, bop_root=fields["bop_root"], repre_dir=fields["repre_dir"],
            detections_dir=str(tmp_path / "dets"), output_dir=out_dir, **extra))
        ar = eval_ar.evaluate(eval_ar.EvalArOpts(
            object_dataset="tudl", submission_path=csvs["tudl"], bop_root=fields["bop_root"]))
        out[pkg] = dict(csv=csvs["tudl"], ar=ar)
    with open(out["torch"]["csv"]) as f:
        assert len(f.read().strip().split("\n")) - 1 == 12
    assert_submission_matches(out["jax"], out["torch"], R_ATOL, T_ATOL)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_sweep_runs_the_inferopts_defaults(tmp_path, monkeypatch, pkg):
    """Quirk (h) of the reference, kept by the port: pipeline/sweep builds
    InferOpts from its own fields, so configs/infer/tudl.json's switches
    (fused bf16 block, tanh GELU, approximate top-k, the capped softmax)
    do not reach the run."""
    mod = j_sweep if pkg == "jax" else t_sweep
    seen = []
    monkeypatch.setattr(mod.infer_mod, "infer", lambda opts: seen.append(opts))
    monkeypatch.setattr(mod.sub_mod, "prepare", lambda opts: "")
    mod.sweep(mod.SweepOpts(datasets=["tudl"], output_dir=str(tmp_path)))
    with open(os.path.join(ROOT, "configs", "infer", "tudl.json")) as f:
        config = json.load(f)["infer_opts"]
    (opts,) = seen
    defaults = mod.infer_mod.InferOpts()
    for key in ("use_fused_block", "approx_gelu", "approx_topk", "compute_dtype",
                "vit_overrides"):
        assert getattr(opts, key) == getattr(defaults, key) != config[key], key
    assert opts.object_dataset == "tudl"


def test_load_stacked_equals_the_cast_of_the_f32_stack(tmp_path):
    """Three ragged representations (5, 7 and 6 templates; banks 128, 256
    and 128 wide): load_stacked's banks, cast object by object, equal
    stack_repres of the f32 loads cast afterwards bit for bit, in every
    field; the template cameras kept for finalize are each object's own."""
    shapes = ((5, 128), (7, 256), (6, 128))
    for lid, (t, fmax) in enumerate(shapes, start=1):
        save_repre(realistic_repre(lid, num_templates=t, fmax=fmax, feat_dim=16, num_words=32,
                                   raw_dim=24, n_points=256),
                   str(tmp_path / "lmo" / "v1" / str(lid)))
    opts = t_infer.InferOpts(repre_dir=str(tmp_path), device="cpu")
    lids = [1, 2, 3]
    singles = [load_repre(str(tmp_path / "lmo" / "v1" / str(lid)), device="cpu") for lid in lids]
    for dtype in (torch.bfloat16, torch.float32):
        got, views = t_infer.load_stacked(opts, lids, "cpu", dtype)
        want = stack_repres(singles)
        want = want if dtype == torch.float32 else want.cast_banks(dtype)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype and a.shape == b.shape, f.name
                assert torch.equal(a.contiguous().view(torch.uint8),
                                   b.contiguous().view(torch.uint8)), f.name  # bit for bit
        assert got.bank_feats.dtype == dtype and got.bank_feats.shape[:3] == (3, 7, 256)
        for lid, r in zip(lids, singles):
            assert torch.equal(views[lid].template_cameras.f, r.template_cameras.f)
            assert views[lid].templates is r.templates
