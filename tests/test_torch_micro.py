"""The port's measurement entry points of benchmarks/ (the micro-benches,
vit_stage_bench, cli_throughput, builder_full_scale) on the CPU: each
micro-bench's substages on small inputs against the JAX package's
functions they wrap (RANSAC-PnP with injected draws, the exact buddy path,
kNN word assignment and tf-idf, extract_facet), each entry point's report
at a tiny size with device="cpu", and the refusal of every entry point to
run without a card unless the caller asks for the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)
from test_torch_bench import short_timing  # noqa: F401 (a fixture)
from test_torch_pose import buddies_inputs, jax_draws, pnp_problem

from foundpose_torch.benchmarks import (bench, builder_full_scale, cli_throughput, micro_buddies,
                                        micro_pnp, micro_retrieval, vit_stage_bench)
from foundpose_torch.models import bench_weights
from foundpose_torch.pipeline import gen_repre
from foundpose_tpu.models import dinov2 as j_dinov2
from foundpose_tpu.ops import tfidf as j_tfidf
from foundpose_tpu.ops.knn import knn_search as j_knn_search
from foundpose_tpu.pipeline.inference import estimate_score as j_estimate_score
from foundpose_tpu.pose import corresp as j_corresp
from foundpose_tpu.pose import pnp as j_pnp

T = torch.from_numpy
# A ViT small enough for the CPU that keeps the layer-9 token facet.
TINY_VIT = {"embed_dim": 64, "depth": 10, "num_heads": 1, "pos_grid": 10}


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("refine_lm", [False, True])
def test_micro_pnp_ransac_matches_jax(rng, refine_lm):
    """ransac_no_lm / ransac_full(+lm) (lo_iters=0, 10 LM steps) on three
    sets of 60 points with the JAX draws: quality, success and inliers
    equal; R and t within 1e-4 after LM, within 1e-3 without it (the raw
    DLT pose of a 6-point sample carries the two f32 solves' rounding,
    which LM polishes away); estimate_score(best) within 1e-6."""
    sets, n, h = 3, 60, 32
    p2, p3, _, _, k_f, k_c = pnp_problem(rng, n, sets=sets)
    valid = rng.uniform(size=(sets, n)) > 0.1
    ids = rng.integers(0, micro_pnp.NUM_QUERY_POINTS, size=(sets, n))
    keys = jax.random.split(jax.random.PRNGKey(5), sets)
    draws = np.stack([jax_draws(keys[i], h, n) for i in range(sets)])
    p = dict(c2d=T(p2), c3d=T(p3), valid=T(valid), ids=T(ids), kf=T(np.tile(k_f, (sets, 1))),
             kc=T(np.tile(k_c, (sets, 1))), draws=T(draws))
    subs = micro_pnp.substages(p, b=sets)
    got = subs["ransac_full(+lm)" if refine_lm else "ransac_no_lm"]()
    for i in range(sets):
        ref = j_pnp.ransac_pnp(jnp.asarray(p2[i]), jnp.asarray(p3[i]), jnp.asarray(valid[i]),
                               jnp.asarray(k_f), jnp.asarray(k_c), keys[i], num_hypotheses=h,
                               refine_lm=refine_lm, lm_iters=micro_pnp.LM_ITERS, lo_iters=0)
        assert float(got.quality[i]) == float(ref.quality)
        assert bool(got.success[i]) == bool(ref.success)
        np.testing.assert_array_equal(got.inliers[i].numpy(), np.asarray(ref.inliers))
        atol = 1e-4 if refine_lm else 1e-3
        np.testing.assert_allclose(got.R[i].numpy(), np.asarray(ref.R), atol=atol)
        np.testing.assert_allclose(got.t[i].numpy(), np.asarray(ref.t), atol=atol)
    score = subs["estimate_score(best)"]()
    ref = jax.vmap(lambda *a: j_estimate_score(*a, num_query_points=micro_pnp.NUM_QUERY_POINTS))(
        jnp.tile(jnp.eye(3), (sets, 1, 1)), jnp.tile(jnp.asarray([0.0, 0.0, 0.5]), (sets, 1)),
        jnp.asarray(p2), jnp.asarray(ids), jnp.asarray(p3), jnp.asarray(valid),
        jnp.asarray(np.tile(k_f, (sets, 1))), jnp.asarray(np.tile(k_c, (sets, 1))))
    np.testing.assert_allclose(score.numpy(), np.asarray(ref), atol=1e-6)


def test_micro_buddies_exact_path_matches_jax(rng):
    """real_match_batch on the exact path (approx_topk=False) against the
    JAX package's establish_correspondences_batch: the same valid slots and
    ids there, cycle distances, 3D points and scores within f32 rounding
    (tests/test_torch_pose.py's bounds)."""
    x = buddies_inputs(rng)
    p = dict(qpts=T(x["qpts"]), feats=T(x["qf"]), qmask=T(x["qmask"]), bank=T(x["bank"]),
             bmask=T(x["bmask"]), verts=T(x["verts"]), tids=T(x["tids"]))
    got = micro_buddies.substages(p, top_k=20, approx_topk=False)["real_match_batch"]()
    ref = j_corresp.establish_correspondences_batch(
        *[jnp.asarray(x[k]) for k in ("qpts", "qf", "qmask", "tids", "tscores", "bank", "verts",
                                      "bmask")], top_k=20, approx_topk=False)
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.coord_2d_ids.numpy()[v], np.asarray(ref.coord_2d_ids)[v])
    np.testing.assert_array_equal(got.nn_vertex_ids.numpy()[v], np.asarray(ref.nn_vertex_ids)[v])
    np.testing.assert_allclose(got.cycle_dists.numpy()[v], np.asarray(ref.cycle_dists)[v],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.coord_3d.numpy()[v], np.asarray(ref.coord_3d)[v], atol=1e-6)
    np.testing.assert_allclose(got.coord_conf.numpy(), np.asarray(ref.coord_conf), atol=1e-5)


def test_micro_retrieval_matches_jax(rng):
    """assign_words against the JAX knn_search (ids equal, distances within
    1e-5), tfidf_segment_sum against the JAX calc_tfidf, and the one-hot
    product against the segment sum (both within 1e-6), in f32."""
    b, q, dim, w, t = 2, 40, 16, 24, 10
    feats = rng.normal(size=(b, q, dim)).astype(np.float32)
    words = rng.normal(size=(w, dim)).astype(np.float32)
    idfs = np.abs(rng.normal(size=w)).astype(np.float32)
    qmask = (rng.uniform(size=(b, q)) > 0.3).astype(np.float32)
    p = dict(feats=T(feats), words=T(words), idfs=T(idfs), qmask=T(qmask),
             descs=T(np.abs(rng.normal(size=(t, w))).astype(np.float32)))
    subs, err = micro_retrieval.substages(p)
    dists, ids = subs["assign_words"]()
    d2, jids = jax.vmap(lambda f: j_knn_search(f, jnp.asarray(words), k=micro_retrieval.KNN_K,
                                               metric="l2"))(jnp.asarray(feats))
    jd = np.sqrt(np.maximum(np.asarray(d2), 0.0))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(dists.numpy(), jd, atol=1e-5)
    tv = subs["tfidf_segment_sum"]()
    ref = jax.vmap(lambda i, d, m: j_tfidf.calc_tfidf(i, d, jnp.asarray(idfs), feature_mask=m))(
        jnp.asarray(ids.numpy()), jnp.asarray(dists.numpy()), jnp.asarray(qmask))
    np.testing.assert_allclose(tv.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(subs["tfidf_onehot_matmul"]().numpy(), tv.numpy(), atol=1e-6)
    assert err <= 1e-6
    scores, tids = subs["cosine_topk"]()
    assert tids.shape == (b, micro_retrieval.TOP_N) and bool(torch.isfinite(scores.float()).all())


def test_vit_stage_matches_jax_extract_facet():
    """vit_stage_bench's stage (the unfused block, bf16 images, tanh GELU,
    capped softmax) on its own crops and calibrated weights against the JAX
    package's extract_facet with the same weights and switches: feature
    maps within 0.5% relative L2 and every cell's cosine above 0.9999 (two
    bf16 ViTs that round in other places; 5.3e-4 and 0.999996 measured)."""
    name = "dinov2_version=vits14-reg_stride=14_facet=token_layer=1_norm=1"
    tiny = {"embed_dim": 64, "depth": 2, "num_heads": 1, "pos_grid": 10}
    stage, info = vit_stage_bench.prepare(batch=1, model_name=name, fused=False, device="cpu",
                                          vit_overrides=tiny)
    got = stage().numpy()
    jcfg = dataclasses.replace(j_dinov2.parse_model_name(name), approx_gelu=True,
                               use_fused_block=False, softmax_stabilizer="capped", **tiny)
    tcfg = dataclasses.replace(vit_stage_bench.dinov2.parse_model_name(name), approx_gelu=True,
                               use_fused_block=False, softmax_stabilizer="capped", **tiny)
    params = jax.tree.map(jnp.asarray, bench_weights.realistic_params(0, tcfg))
    crops = torch.rand(1, bench.CROP_PX, bench.CROP_PX, 3,
                       generator=torch.Generator().manual_seed(7)).numpy()
    ref = np.asarray(j_dinov2.extract_facet(
        params, jcfg, j_dinov2.normalize_images(jnp.asarray(crops)).astype(jnp.bfloat16)
    )["feature_maps"].astype(jnp.float32))
    assert got.shape == ref.shape == (1, 30, 30, 64)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 5e-3
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() > 0.9999
    assert info["attn_logit_max"] < bench.LOGIT_WINDOW


def test_vit_stage_bench_reads_the_jax_scripts_environment():
    """VIT_MODEL, VIT_FUSED, VIT_STABILIZER and BENCH_BATCH are read; the
    TPU tiling knobs raise unless unset or at their defaults."""
    assert vit_stage_bench.options_from_env({}) == dict(
        batch=64, model_name=vit_stage_bench.DEFAULT_MODEL, fused=True, stabilizer="capped")
    env = {"VIT_MODEL": "m", "VIT_FUSED": "0", "VIT_STABILIZER": "column", "BENCH_BATCH": "16",
           "VIT_IMG_PER_STEP": "1", "VIT_PAIRED": "0"}
    assert vit_stage_bench.options_from_env(env) == dict(batch=16, model_name="m", fused=False,
                                                         stabilizer="column")
    for key, value in (("VIT_IMG_PER_STEP", "2"), ("VIT_PAIRED", "1")):
        with pytest.raises(ValueError, match=key):
            vit_stage_bench.options_from_env({key: value})


@pytest.mark.parametrize("name", ["micro_pnp", "micro_buddies", "micro_retrieval"])
def test_micro_bench_reports_every_substage_on_the_cpu(short_timing, name):
    """run(device="cpu") at a small size: every substage of the JAX script
    (micro_buddies names its top-k after the port's selection) with its
    time, the port's kernel launches of one call, and no device figure."""
    run, subs = {
        "micro_pnp": (lambda: micro_pnp.run("cpu", b=2, k=40, h=16),
                      ["hypothesis_sampling", "sampling+dlt", "ransac_no_lm", "ransac_full(+lm)",
                       "estimate_score(best)"]),
        "micro_buddies": (lambda: micro_buddies.run("cpu", b=2, t=20, fmax=64, crop=(84, 84),
                                                    top_k=20),
                          ["bank_gather", "gather+dist+argmin", "no_topk(gathers only)",
                           "smallest_k only", "full_match_stage", "real_match_batch"]),
        "micro_retrieval": (lambda: micro_retrieval.run("cpu", b=2, q=50, w=64, t=20),
                            ["assign_words", "tfidf_segment_sum", "tfidf_onehot_matmul",
                             "cosine_topk"]),
    }[name]
    r = run()
    assert list(r["substages"]) == subs and r["card"] == "cpu"
    for v in r["substages"].values():
        assert np.isfinite(v["ms"]) and v["ms"] > 0
        assert v["device_ms"] is None and v["host_launches"] is None
        assert set(v["kernel_launches"]) == set(bench.kernel_counters())


@pytest.fixture
def small_codebook(monkeypatch):
    """gen_repre with 64 visual words in place of the scripts' 2,048: the
    k-means over a few thousand features is most of a CPU build."""
    orig = gen_repre.GenRepreOpts
    monkeypatch.setattr(gen_repre, "GenRepreOpts", lambda **kw: orig(**dict(kw, cluster_num=64)))


def test_builder_full_scale_reports_on_the_cpu(tmp_path, small_codebook):
    """run(device="cpu") with 4 x 2 templates, a tiny ViT and 64 words:
    the JAX script's keys, rates from the stage walls."""
    r = builder_full_scale.run(str(tmp_path / "b"), viewpoints=4, rotations=2, device="cpu",
                               vit_overrides=TINY_VIT)
    assert set(r) == {
        "metric", "value", "unit", "render_templates_per_s", "registration_templates_per_s",
        "repre_build_s_per_object", "gen_templates_s_per_object", "gen_repre_stage_s",
        "gen_repre_untimed_s", "num_templates", "vs_baseline", "vs_baseline_gen_templates",
        "vs_baseline_gen_repre", "baseline_s_per_object", "card"}
    n = r["num_templates"]
    assert n >= 8 and r["value"] == pytest.approx(
        n / (r["gen_templates_s_per_object"] + r["repre_build_s_per_object"]))
    assert {"Feature registration", "PCA", "k-means", "k-means init",
            "k-means Lloyd"} <= set(r["gen_repre_stage_s"])


def test_cli_throughput_reports_on_the_cpu(tmp_path, small_codebook):
    """run(device="cpu") on 2 images with 2 rendered instances each, 4 x 2
    templates, a tiny ViT and 64 words: the JAX script's keys, every crop
    counted, a second run in the same workdir reuses the split."""
    kw = dict(images=2, dets=2, batch=2, workdir=str(tmp_path / "w"), device="cpu",
              vit_overrides=TINY_VIT, viewpoints=4, rotations=2)
    r = cli_throughput.run(**kw)
    assert set(r) == {"metric", "value", "unit", "crops", "success_rate", "wall_s",
                      "warmup_wall_s", "setup_s", "images", "batch", "stage_median_s", "card"}
    assert r["metric"] == "cli_crops_per_sec" and r["crops"] >= 2 and r["setup_s"] > 0
    assert r["value"] == pytest.approx(r["crops"] / r["wall_s"])
    assert cli_throughput.run(**kw)["setup_s"] == 0.0


@pytest.mark.parametrize("entry", ["micro_pnp", "micro_buddies", "micro_retrieval",
                                   "vit_stage_bench", "cli_throughput", "builder_full_scale"])
def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch, entry):
    """Without a card each entry point raises before any work (no CPU
    fallback under a device's name); device="cpu" is the caller's choice."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"micro_pnp": micro_pnp, "micro_buddies": micro_buddies,
           "micro_retrieval": micro_retrieval, "vit_stage_bench": vit_stage_bench,
           "cli_throughput": cli_throughput, "builder_full_scale": builder_full_scale}[entry]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        mod.run()
