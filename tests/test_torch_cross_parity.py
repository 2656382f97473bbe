"""The port's cross-parity oracle and solve-budget sweeps
(foundpose_torch/benchmarks/{cross_parity,solve_sweep_harness,ransac_sweep,
lm_iters_sweep,select_iter_sweep}.py) on the CPU, against the JAX
package's scripts in benchmarks/ on the same inputs made from numpy seeds:

- the sklearn-free replica against the sklearn replica (offline tf-idf,
  neighbour ids, every crop's pose);
- the world against the JAX world, and the worlds chip_smoke.py's phases 4
  and 8 draw, bit for bit as before make_world moved into the module;
- run_parity with the JAX draws against the JAX run_parity, both legs;
- one cell of each sweep with the JAX draws against the JAX harness's cell;
- the gate and the pick rules.

The JAX step runs under jax.jit (one XLA program per configuration; eager,
it compiles some 500 small programs per shape).
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)
from test_torch_pipeline import jax_pipeline_draws

import chip_smoke
from foundpose_torch.benchmarks import cross_parity as tp
from foundpose_torch.benchmarks import lm_iters_sweep, ransac_sweep, select_iter_sweep
from foundpose_torch.benchmarks import solve_sweep_harness as harness
from foundpose_tpu.pipeline import inference as j_inf
from foundpose_tpu.structs import PinholeCamera as JCamera

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

import cross_parity as jp  # noqa: E402

# tests/test_cross_parity.py's world and matching parameters.
SMALL = dict(num_templates=12, pts_per_template=80, feat_dim=48, num_words=200, n_points=200)
SMALL_MATCH = dict(top_n_templates=3, top_k_buddies=60, pnp_ransac_iter=400)
SMALL_CROPS = 12


JAX_POSE_FROM_FEATURES = j_inf.pose_from_features


@functools.lru_cache(maxsize=None)
def jitted_step(config):
    return jax.jit(functools.partial(JAX_POSE_FROM_FEATURES, config=config))


def jax_step(fmaps, masks, cameras, repre, key, config):
    """The JAX package's pose_from_features, jitted per configuration."""
    return jitted_step(config)(fmaps, masks, cameras, repre, key)


def jax_full_draws(key, b, top_n, h, k):
    """The two-phase solve's second-pass draws the JAX step makes: each
    crop key's last split, randint((H, 6), 0, K)."""
    crop_keys = jax.random.split(key, 2 * b)[b:]
    return np.stack([
        np.asarray(jax.random.randint(jax.random.split(ck, top_n + 1)[top_n], (h, 6), 0, k))
        for ck in crop_keys
    ])


def small_world():
    rng = np.random.default_rng(0)
    return rng, tp.make_world(rng, device="cpu", **SMALL)


# --------------------------------------------------------------------------
# The replica: numpy kNN against sklearn's NearestNeighbors
# --------------------------------------------------------------------------

def test_replica_matches_the_sklearn_replica():
    rng, world = small_world()
    fmaps, masks, _, _ = tp.render_queries(rng, world, SMALL_CROPS, 1000)
    _, obj_points, obj_feats, tpl_ids = world
    banks = [np.asarray(obj_feats[i], np.float32) for i in tpl_ids]
    verts = [np.asarray(obj_points[i], np.float32) for i in tpl_ids]
    words = world[0].word_centroids.numpy()
    ours = tp.ReferenceReplica(banks, verts, words, **SMALL_MATCH)
    ref = jp.ReferenceReplica(banks, verts, words, **SMALL_MATCH)

    assert np.array_equal(np.isfinite(ours.word_idfs), np.isfinite(ref.word_idfs))
    finite = np.isfinite(ref.word_idfs)
    np.testing.assert_allclose(ours.word_idfs[finite], ref.word_idfs[finite], atol=1e-6)
    np.testing.assert_allclose(ours.template_descs, ref.template_descs, atol=1e-6)

    # Neighbour ids: the words of every bank feature and every query
    # feature (k = 3), and each crop's nearest features in the bank of the
    # template it views (k = 1).
    c = int(tp.CELL)
    queries = [f[m[c // 2 :: c, c // 2 :: c] > 0.5] for f, m in zip(fmaps, masks)]
    rows = equal = 0
    for q in (np.concatenate(banks), np.concatenate(queries)):
        same = (tp.knn(q, words, 3)[1] == ref.words_nn.kneighbors(q)[1]).all(1)
        rows, equal = rows + len(same), equal + int(same.sum())
    for i, q in enumerate(queries):
        t = i % len(banks)
        same = tp.knn(q, banks[t], 1)[1][:, 0] == ref.tpl_nn[t].kneighbors(q)[1][:, 0]
        rows, equal = rows + len(same), equal + int(same.sum())
    assert equal / rows >= 0.999, (equal, rows)

    threaded = tp.replica_poses(ours, fmaps, masks, threads=4)[0]
    for f, m, c in zip(fmaps, masks, threaded):
        a, b = ours.infer_one(f, m), ref.infer_one(f, m, tp.K)
        assert a.keys() == c.keys() and all(np.array_equal(a[k], c[k]) for k in a)
        assert a["success"] == b["success"]
        if b["success"]:
            assert (a["template"], a["quality"]) == (b["template"], b["quality"])
            np.testing.assert_allclose(a["R"], b["R"], atol=1e-6)
            np.testing.assert_allclose(a["t"], b["t"], atol=1e-6)


def test_knn_orders_ties_by_index():
    points = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0], [3.0, 3.0]])
    d, ids = tp.knn(np.zeros((1, 2)), points, 3)
    assert ids.tolist() == [[0, 1, 2]]
    np.testing.assert_allclose(d, 1.0)
    assert tp.knn(np.zeros((1, 2)), points, 1)[1].tolist() == [[0]]


# --------------------------------------------------------------------------
# The world
# --------------------------------------------------------------------------

def test_world_matches_jax():
    rng_j = np.random.default_rng(0)
    j_repre, j_pts, j_feats, j_ids = jp.make_world(rng_j, **SMALL)
    _, (t_repre, t_pts, t_feats, t_ids) = small_world()
    assert np.array_equal(t_pts, j_pts) and np.array_equal(t_feats, j_feats)
    assert all(np.array_equal(a, b) for a, b in zip(t_ids, j_ids))
    for name in ("feat_vectors", "vertices", "feat_to_template_ids", "word_centroids"):
        assert np.array_equal(getattr(t_repre, name).numpy(), np.asarray(getattr(j_repre, name)))
    ti, ji = t_repre.word_idfs.numpy(), np.asarray(j_repre.word_idfs)
    assert np.array_equal(np.isfinite(ti), np.isfinite(ji))
    np.testing.assert_allclose(ti[np.isfinite(ji)], ji[np.isfinite(ji)], atol=1e-5)
    td, jd = t_repre.template_descs.numpy(), np.asarray(j_repre.template_descs)
    cos = (td * jd).sum(1) / np.maximum(np.linalg.norm(td, axis=1) * np.linalg.norm(jd, axis=1),
                                        1e-12)
    assert cos.min() >= 0.9999
    # The queries too: each rng stands where its world left it.
    rng_t, _ = small_world()
    q_t = tp.render_query(rng_t, t_pts, t_feats, t_ids, 3, 1003)
    q_j = jp.render_query(rng_j, j_pts, j_feats, j_ids, target_tpl=3, pose_seed=1003)
    for a, b in zip(q_t, q_j):
        assert np.array_equal(a, b)
    s_t = tp.render_query_smooth(np.random.default_rng(1), t_pts, t_feats, t_ids, 2, 2002)
    s_j = jp.render_query_smooth(np.random.default_rng(1), j_pts, j_feats, j_ids, 2, 2002)
    for a, b in zip(s_t, s_j):
        assert np.array_equal(a, b)


def _smoke_world_before_move(torch, rng, num_templates=8, pts_per_template=64, feat_dim=32,
                             n_points=200, num_words=None):
    """chip_smoke.make_world as it stood before it moved into
    foundpose_torch/benchmarks/cross_parity.py (kept verbatim as the
    reference of the move)."""
    from foundpose_torch.ops import tfidf
    from foundpose_torch.repre import make_repre
    from foundpose_torch.structs import PinholeCamera

    obj_points = rng.uniform(-0.08, 0.08, size=(n_points, 3)).astype(np.float32)
    obj_feats = rng.normal(size=(n_points, feat_dim)).astype(np.float32) * 3.0
    tpl_point_ids = [rng.choice(n_points, size=pts_per_template, replace=False)
                     for _ in range(num_templates)]
    feat_vectors = np.concatenate([obj_feats[s] for s in tpl_point_ids])
    vertices = np.concatenate([obj_points[s] for s in tpl_point_ids])
    tpl_ids = np.repeat(np.arange(num_templates), pts_per_template).astype(np.int32)
    words = obj_feats[rng.choice(n_points, size=num_words or n_points, replace=False)]
    words = (words + 0.01 * rng.normal(size=words.shape)).astype(np.float32)
    cfg = tfidf.TfidfConfig(knn_k=3)
    descs, idfs = tfidf.calc_template_tfidf_descriptors(
        torch.as_tensor(feat_vectors), torch.as_tensor(tpl_ids), torch.as_tensor(words),
        num_templates, cfg,
    )
    cams = PinholeCamera(
        f=torch.full((num_templates, 2), 600.0), c=torch.full((num_templates, 2), 209.5),
        T_world_from_eye=torch.eye(4).expand(num_templates, 4, 4).contiguous(),
        width=420, height=420,
    )
    repre = make_repre(feat_vectors, vertices, tpl_ids, words, idfs.numpy(), descs.numpy(),
                       cams, tfidf_config=cfg, device="cpu")
    return repre, obj_points, obj_feats, tpl_point_ids


@pytest.mark.parametrize("phase, old_kw", [
    ("PHASE4_WORLD", {}),
    ("PHASE8_WORLD", dict(num_templates=24, pts_per_template=120, feat_dim=48, n_points=800,
                          num_words=256)),
])
def test_smoke_worlds_are_unchanged_by_the_move(phase, old_kw):
    """Phase 4's world (the old defaults, as many words as points) and
    phase 8's, from the module with chip_smoke's sizes, bit for bit."""
    new = tp.make_world(np.random.default_rng(0), device="cpu", **getattr(chip_smoke, phase))
    old = _smoke_world_before_move(torch, np.random.default_rng(0), **old_kw)
    for a, b in zip(new[1:3], old[1:3]):
        assert np.array_equal(a, b)
    assert all(np.array_equal(a, b) for a, b in zip(new[3], old[3]))
    for name in ("feat_vectors", "vertices", "feat_to_template_ids", "word_centroids",
                 "word_idfs", "template_descs", "bank_feats", "bank_vertices", "bank_mask"):
        assert torch.equal(getattr(new[0], name), getattr(old[0], name)), name
    for name in ("f", "c", "T_world_from_eye"):
        assert torch.equal(getattr(new[0].template_cameras, name),
                           getattr(old[0].template_cameras, name))


# --------------------------------------------------------------------------
# run_parity against the JAX run_parity
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_parity():
    """The JAX run_parity at test_cross_parity.py's scale (its step jitted)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(j_inf, "pose_from_features", jax_step)
    try:
        return jp.run_parity(**SMALL, n_crops=SMALL_CROPS, **SMALL_MATCH, verbose=False)
    finally:
        mp.undo()


def test_run_parity_matches_jax(jax_parity):
    """The same AR as the JAX run_parity on both legs, fed the JAX draws
    (PRNGKey 0 for both legs, as the JAX script), and the same replica AR."""
    draws = jax_pipeline_draws(jax.random.PRNGKey(0), SMALL_CROPS, 3, 400, 60)
    got = tp.run_parity(**SMALL, n_crops=SMALL_CROPS, **SMALL_MATCH, device="cpu", draws=draws,
                        verbose=False)
    ref = jax_parity
    assert ref["ar_replica"] > 0.5
    for key in ("n_crops", "num_templates", "num_words", "ar_replica", "bop_ar_replica"):
        assert got[key] == ref[key], key
    for leg in ("exact", "fast"):
        assert got[f"ar_port_{leg}"] == ref[f"ar_jax_{leg}"], leg
        assert got[f"ar_delta_{leg}"] == ref[f"ar_delta_{leg}"], leg
        assert got[f"both_succeeded_{leg}"] == ref[f"both_succeeded_{leg}"], leg
        # CPU: the twins, which count no launch
        assert got[f"launches_{leg}"] == {"buddies": 0, "ransac_dlt": 0, "ransac_score": 0,
                                             "refine": 0}
    assert got["idf_max_delta"] < 1e-5 and got["template_desc_cosine_min"] > 0.999
    assert not tp.ar_gate_failed(got)
    assert set(got) >= {k.replace("_jax_", "_port_") for k in ref}


# --------------------------------------------------------------------------
# One cell of each sweep against the JAX harness's cell
# --------------------------------------------------------------------------

CELL_CROPS, CELL_TEMPLATES = 8, 12


@functools.lru_cache(maxsize=None)
def jax_cell_world(world_kw, seed, pose_seed_base):
    """The JAX harness's world and queries from rng(seed) (the lm and
    select cells share seed 0's)."""
    rng = np.random.default_rng(seed)
    repre, pts, feats, ids = jp.make_world(rng, num_templates=CELL_TEMPLATES, **dict(world_kw))
    return repre, [jp.render_query(rng, pts, feats, ids, target_tpl=i % CELL_TEMPLATES,
                                   pose_seed=pose_seed_base + i) for i in range(CELL_CROPS)]


def jax_cell_ar(world_kw, seed, pose_seed_base, overrides):
    """The JAX harness's cell: the fast path with `overrides` at
    PRNGKey(0) on its world's queries, scored by its ar_recall."""
    repre, q = jax_cell_world(tuple(world_kw.items()), seed, pose_seed_base)
    b = CELL_CROPS
    cams = JCamera(f=jnp.tile(jnp.asarray([[600.0, 600.0]]), (b, 1)),
                   c=jnp.tile(jnp.asarray([[209.5, 209.5]]), (b, 1)),
                   T_world_from_eye=jnp.tile(jnp.eye(4)[None], (b, 1, 1)),
                   width=jp.CROP, height=jp.CROP)
    config = j_inf.InferenceConfig(**{**dict(compute_dtype=jnp.bfloat16, approx_topk=True,
                                             pnp_ransac_iter=200, pnp_lo_iters=2), **overrides})
    out = jax_step(jnp.asarray(np.stack([x[0] for x in q])), jnp.asarray(np.stack([x[1] for x in q])),
                   cams, repre, jax.random.PRNGKey(0), config)
    ar, _ = jp.ar_recall(np.asarray(out.R_m2c), np.asarray(out.t_m2c), np.asarray(out.success),
                         [x[2] for x in q], [x[3] for x in q])
    return ar, np.stack([x[0] for x in q])


@pytest.mark.parametrize("sweep, cell", [
    ("ransac", (200, 2)), ("lm", "lm2"), ("select", "select100"),
])
def test_sweep_cell_matches_jax(sweep, cell):
    if sweep == "ransac":
        world_kw, seed, base = ransac_sweep.WORLD, 0, 1000
        overrides = ransac_sweep.overrides(cell)
    else:
        world_kw, seed, base = harness.HARNESS_WORLD, 0, 3000
        overrides = (lm_iters_sweep if sweep == "lm" else select_iter_sweep).CELLS[cell]
    ar_j, fmaps_j = jax_cell_ar(world_kw, seed, base, overrides)

    sw = harness.build_world(seed, CELL_CROPS, CELL_TEMPLATES, "cpu", world_kw=world_kw,
                             pose_seed_base=base)
    assert np.array_equal(sw.fmaps, fmaps_j)
    key = jax.random.PRNGKey(0)
    select = overrides.get("pnp_select_iter", 0)
    draws = jax_pipeline_draws(key, CELL_CROPS, 5, select or overrides.get("pnp_ransac_iter", 200),
                               300)
    full = jax_full_draws(key, CELL_CROPS, 5, 200, 300) if select else None
    got = harness.cell_ar(sw, overrides, "cpu", draws=draws, full_draws=full)
    assert ar_j >= 0.5
    assert got["ar"] == ar_j
    assert got["launches"] == {"buddies": 0, "ransac_dlt": 0, "ransac_score": 0,
                               "refine": 0} and got["wall_ms"] > 0


# --------------------------------------------------------------------------
# The gate and the pick rules
# --------------------------------------------------------------------------

def test_gate_and_picks_reproduce_the_recorded_jax_verdicts():
    """The JAX runs' recorded cells (benchmarks/results/) through the
    port's gate and picks give the JAX runs' verdicts."""
    import json

    res = os.path.join(ROOT, "benchmarks", "results")
    for seed in (0, 1):
        with open(os.path.join(res, f"ransac_sweep_r04_seed{seed}.json")) as f:
            rec = json.load(f)
        cells = {(int(k[6:].split("_")[0]), int(k.split("_lo")[1])): [v]
                 for k, v in rec["cells"].items()}
        ok = sorted(harness.admissible(cells, [rec["ar_replica_oracle"]],
                                       ransac_sweep.DEFAULT_CELL))
        assert [ransac_sweep.name(c) for c in ok] == rec["admissible"]
        picked = ransac_sweep.pick(ok)
        assert {"pnp_ransac_iter": picked[0], "pnp_lo_iters": picked[1]} == rec["picked"]
    with open(os.path.join(res, "select_iter_sweep_r05.json")) as f:
        rec = json.load(f)
    ok = harness.admissible(rec["cells"], rec["ar_replica_oracle"], select_iter_sweep.DEFAULT_CELL)
    assert ok == [f"select{n}" for n in rec["admissible"]]
    assert select_iter_sweep.pick(ok) == f"select{rec['picked_select_iter']}"
    with open(os.path.join(res, "lm_iters_sweep_r05.json")) as f:
        rec = json.load(f)
    ok = harness.admissible(rec["cells"], rec["ar_replica_oracle"], lm_iters_sweep.DEFAULT_CELL)
    assert ok == rec["admissible"] == []


def test_picks_are_numeric_not_lexicographic():
    """The trap the JAX files document: string cell keys under a bare min()
    sort "lm10" before "lm2" and "select100" before "select25"."""
    assert min(["lm10", "lm2", "lm4"]) == "lm10"
    assert lm_iters_sweep.pick(["lm10", "lm2", "lm4"]) == "lm2"
    assert min(["select100", "select25", "select50"]) == "select100"
    assert select_iter_sweep.pick(["select0", "select100", "select25"]) == "select25"
    assert select_iter_sweep.pick(["select0"]) == "select0"
    assert ransac_sweep.pick([(400, 2), (200, 1), (100, 2), (200, 2)]) == (100, 2)
    assert ransac_sweep.pick([]) == ransac_sweep.DEFAULT_CELL
    # The gate: within 1 point of the oracle AND of the default, on every seed.
    cells = {"a": [0.99, 1.0], "b": [1.0, 0.985], "default": [1.0, 1.0], "c": [0.995, 0.99]}
    assert harness.admissible(cells, [1.0, 1.0], "default") == ["a", "default", "c"]
    assert harness.admissible({"d": [0.9], "x": [0.905]}, [0.9], "d") == ["d", "x"]
    assert harness.admissible({"d": [0.91], "x": [0.895]}, [0.9], "d") == ["d"]


def test_oracle_is_kept_per_world(monkeypatch):
    """oracle_ar runs the replica once per world: a second sweep of the
    same build_world arguments reuses its AR and seconds; another seed, or
    another budget, runs it again."""
    monkeypatch.setattr(harness, "_ORACLE_MEMO", {})
    runs = []

    def counted(*args, **kwargs):
        runs.append(1)
        return tp.replica_poses(*args, **kwargs)

    monkeypatch.setattr(harness, "replica_poses", counted)
    build = functools.partial(harness.build_world, crops=4, templates=CELL_TEMPLATES,
                              device="cpu")
    first = harness.oracle_ar(build(0))
    assert len(runs) == 1 and np.isfinite(first[0]) and first[1] > 0
    assert harness.oracle_ar(build(0)) == first and len(runs) == 1
    harness.oracle_ar(build(1))
    assert len(runs) == 2
    harness.oracle_ar(build(0), pnp_ransac_iter=200)
    assert len(runs) == 3
