"""The port's multi-device step (foundpose_torch/parallel/{mesh,
sharded_inference}) against the port's single-device step and the JAX
package's shard_map functions, in f32 on the CPU.

The port's ranks are gloo processes (parallel/launch), spawned once for the
module: every rank computes every case and writes what it got; the tests
compare. The JAX side runs on the 8-device virtual CPU mesh of conftest.py.
This module imports JAX only inside its fixtures and tests: the ranks import
it to find their function and must not load JAX.

The world: template i of an object is the tiny ViT's feature map of crop i,
each cell lifted to 3D in that crop's camera at a random depth (so crop i's
pose is the identity), plus one random distractor template; the crops' own
features keep each crop's retrieval scores well apart.
"""

import dataclasses
import datetime
import multiprocessing
import os
import pickle
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)

from foundpose_torch.models import dinov2 as t_dinov2
from foundpose_torch.parallel import launch
from foundpose_torch.parallel import mesh as mesh_mod
from foundpose_torch.parallel import sharded_inference as t_sharded
from foundpose_torch.pipeline import inference as t_inf
from foundpose_torch.pipeline import multi_object as t_multi
from foundpose_torch.repre import pad_templates, stack_repres

VIT = dict(variant="vits14", embed_dim=32, depth=2, num_heads=2, mlp_ratio=4.0, swiglu=False,
           patch_size=14, num_register_tokens=4, pos_grid=6, stride=14, facet="token",
           layer=1, apply_norm=True)
B, HW = 8, 84
STEP = dict(crop_size=(HW, HW), top_n_templates=3, top_k_buddies=16, pnp_ransac_iter=50)
SHAPES = ((2, 2), (4, 1), (1, 4))
WORLD = 4


def crop_world(rng, fmaps, members, cams):
    """A JAX ObjectRepre whose template i is crop members[i] (see the
    module docstring)."""
    import jax.numpy as jnp

    from foundpose_tpu.ops.tfidf import TfidfConfig, calc_template_tfidf_descriptors
    from foundpose_tpu.repre import make_repre
    from foundpose_tpu.structs import PinholeCamera as JCamera

    _, gh, gw, d = fmaps.shape
    uv = np.stack(np.meshgrid(np.arange(gw) * 14.0 + 7.0, np.arange(gh) * 14.0 + 7.0), -1)
    uv = uv.reshape(-1, 2)
    feats, verts = [], []
    for i in members:
        rays = (uv - cams["c"][i]) / cams["f"][i]
        depth = rng.uniform(0.4, 0.6, size=(len(uv), 1))
        feats.append(fmaps[i].reshape(-1, d))
        verts.append(np.concatenate([rays, np.ones_like(depth)], -1) * depth)
    feats.append(rng.normal(size=(gh * gw, d)))
    verts.append(rng.uniform(-0.1, 0.1, size=(gh * gw, 3)))
    feats = np.concatenate(feats).astype(np.float32)
    nt = len(members) + 1
    ids = np.repeat(np.arange(nt), gh * gw).astype(np.int32)
    words = feats[rng.choice(len(feats), 40, replace=False)] + 0.01 * rng.normal(size=(40, d))
    cfg = TfidfConfig(knn_k=3)
    descs, idfs = calc_template_tfidf_descriptors(
        jnp.asarray(feats), jnp.asarray(ids), jnp.asarray(words, jnp.float32), nt, cfg)
    tcams = JCamera(f=jnp.full((nt, 2), 100.0), c=jnp.full((nt, 2), 41.5),
                    T_world_from_eye=jnp.tile(jnp.eye(4)[None], (nt, 1, 1)), width=HW, height=HW)
    return make_repre(feats, np.concatenate(verts).astype(np.float32), ids,
                      np.asarray(words, np.float32), np.asarray(idfs), np.asarray(descs), tcams,
                      tfidf_config=cfg)


def build_world(seed=0):
    """The JAX side's inputs and the port's, as one dict."""
    import jax
    import jax.numpy as jnp
    from test_torch_pipeline import T, jax_pipeline_draws, torch_config, torch_repre

    from foundpose_torch.models.weights import state_dict_from_jax_params
    from foundpose_tpu.models import dinov2 as j_dinov2
    from foundpose_tpu.pipeline import inference as j_inf

    rng = np.random.default_rng(seed)
    jvit = j_dinov2.DinoV2Config(**VIT)
    params = jax.tree.map(np.asarray, j_dinov2.init_params(jax.random.PRNGKey(0), jvit))
    crops = rng.uniform(size=(B, HW, HW, 3)).astype(np.float32)
    masks = np.ones((B, HW, HW), np.float32)
    masks[1, :20] = 0.0  # one crop with fewer valid cells
    cams = {"f": np.full((B, 2), 100.0, np.float32), "c": np.full((B, 2), 41.5, np.float32),
            "T": np.tile(np.eye(4, dtype=np.float32)[None], (B, 1, 1))}
    fmaps = np.asarray(j_dinov2.extract_facet(
        params, jvit, j_dinov2.normalize_images(jnp.asarray(crops)))["feature_maps"])
    jrepre = crop_world(rng, fmaps, range(B), cams)
    jobjs = [crop_world(rng, fmaps, range(0, B, 2), cams),
             crop_world(rng, fmaps, range(1, B, 2), cams)]
    key = jax.random.PRNGKey(3)
    jcfg = j_inf.InferenceConfig(**STEP)
    k = STEP["top_k_buddies"]
    return dict(
        params=params, jvit=jvit, jcfg=jcfg, jrepre=jrepre, jobjs=jobjs, key=key,
        crops=crops, masks=masks, cams=cams, fmaps=fmaps,
        obj_idx=np.arange(B) % 2,
        draws=jax_pipeline_draws(key, B, STEP["top_n_templates"], STEP["pnp_ransac_iter"], k),
        port=dict(
            state=state_dict_from_jax_params(params, t_dinov2.DinoV2Config(**VIT)),
            config=torch_config(jcfg),
            # Query subsampling and the two-phase solve: every draw of the step.
            drawn_config=dataclasses.replace(torch_config(jcfg), max_num_queries=30,
                                             pnp_select_iter=20),
            refine_config=dataclasses.replace(torch_config(jcfg), refine_featuremetric=True,
                                              featuremetric_iters=3),
            repre=torch_repre(jrepre), objs=[torch_repre(r) for r in jobjs],
            # Vertices 2 mm off: coarse poses the refinement then moves.
            noisy_repre=dataclasses.replace(
                torch_repre(jrepre), bank_vertices=T(
                    np.asarray(jrepre.bank_vertices)
                    + rng.normal(0, 0.002, jrepre.bank_vertices.shape).astype(np.float32))),
            crops=T(crops), masks=T(masks),
            cams=(T(cams["f"]), T(cams["c"]), T(cams["T"])),
            obj_idx=torch.arange(B) % 2,
        ),
    )


def port_model(state):
    model = t_dinov2.DinoV2(t_dinov2.DinoV2Config(**VIT))
    model.load_state_dict(state)
    return model.eval()


def port_cameras(cams):
    from foundpose_torch.structs import PinholeCamera

    f, c, t = cams
    return PinholeCamera(f=f, c=c, T_world_from_eye=t, width=HW, height=HW)


def as_numpy(out):
    return {f.name: getattr(out, f.name).numpy() for f in dataclasses.fields(out)}


def _rank(rank, world, in_path, out_dir):
    """Every case of the module on one rank; writes rank{rank}.pkl."""
    with open(in_path, "rb") as f:
        p = pickle.load(f)
    model, cams = port_model(p["state"]), port_cameras(p["cams"])
    draws = torch.as_tensor(p["draws"])
    res = {"steps": {}, "jax_loaded": "jax" in sys.modules}

    res["default_shape"] = tuple(mesh_mod.make_mesh().shape)
    mesh = mesh_mod.make_mesh((2, 2))
    res["coords"] = {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}
    # Retrieval and the bank fetch on the crops' query features.
    rows = mesh_mod.data_slice(mesh, B)
    repre = pad_templates(p["repre"], 2)
    local = mesh_mod.shard_repre(repre, mesh)
    tids, scores = t_sharded._retrieve_sharded(
        p["feats"][rows], p["valid"][rows], local.word_centroids, local.word_idfs,
        local.template_descs, 3, local.tfidf_config, mesh, local.template_mask)
    fetched = t_sharded._fetch_banks(tids, local.bank_feats, local.bank_vertices,
                                     local.bank_mask, mesh)
    res["retrieval"] = dict(rows=(rows.start, rows.stop), ids=tids.numpy(),
                            scores=scores.numpy(), fetched=[a.numpy() for a in fetched])

    for shape in SHAPES:
        mesh = mesh_mod.make_mesh(shape)
        step = t_sharded.make_object_mesh_step(mesh, p["config"], p["repre"])
        res["steps"][shape] = as_numpy(step(model, p["crops"], p["masks"], cams, draws=draws))
    mesh = mesh_mod.make_mesh((2, 2))
    step = t_sharded.make_object_mesh_step(mesh, p["drawn_config"], p["repre"])
    gen = torch.Generator().manual_seed(5)
    res["drawn"] = as_numpy(step(model, p["crops"], p["masks"], cams, generator=gen))
    step = t_sharded.make_object_mesh_step(mesh, p["refine_config"], p["noisy_repre"])
    res["refined"] = as_numpy(step(model, p["crops"], p["masks"], cams, draws=draws))
    multi_step, _ = t_sharded.make_multi_object_mesh_step(mesh, p["config"],
                                                          stack_repres(p["objs"]))
    res["multi"] = as_numpy(multi_step(model, p["crops"], p["masks"], cams, p["obj_idx"],
                                       draws=draws))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


# Seconds one launch of ranks may take. launch.run bounds each collective,
# not a rank stuck outside one, and waits for every rank.
RANKS_DEADLINE = 600


def run_ranks(fn, world, *args, **kwargs):
    """launch.run(fn, world, *args, **kwargs), its exception re-raised; past
    RANKS_DEADLINE the ranks are killed and the test fails."""
    failed = []

    def launch_ranks():
        try:
            launch.run(fn, world, *args, **kwargs)
        except BaseException as e:
            failed.append(e)

    thread = threading.Thread(target=launch_ranks, daemon=True)
    thread.start()
    thread.join(RANKS_DEADLINE)
    if thread.is_alive():
        for p in multiprocessing.active_children():
            p.kill()
        thread.join(60)
        pytest.fail(f"{world} ranks of {fn.__name__} did not finish in {RANKS_DEADLINE} s")
    if failed:
        raise failed[0]


def read_ranks(d, world):
    """The results every rank pickled as rank{r}.pkl under `d`, by rank."""
    out = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def world():
    return build_world()


@pytest.fixture(scope="module")
def ranks(world, tmp_path_factory):
    """The rank results, by rank; also the port's inputs."""
    d = tmp_path_factory.mktemp("ranks")
    _, feats, valid = t_inf.query_features_from_map(
        torch.from_numpy(np.array(world["fmaps"])), world["port"]["masks"], (HW, HW), 14.0)
    valid = valid & (torch.from_numpy(np.random.default_rng(1).uniform(size=valid.shape)) > 0.2)
    inputs = dict(world["port"], draws=world["draws"], feats=feats, valid=valid)
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    run_ranks(_rank, WORLD, str(d / "inputs.pkl"), str(d))
    return read_ranks(d, WORLD), inputs


def assert_same_outputs(got, ref):
    """Template ids, winner, success and inlier count equal; R within 1e-4,
    t within 1e-5 (got: a dict of arrays; ref: PoseOutputs of either
    package, or such a dict)."""
    ref = ref if isinstance(ref, dict) else {k: getattr(ref, k) for k in got}
    for name in ("template_ids", "best_template", "success", "quality"):
        np.testing.assert_array_equal(got[name], np.asarray(ref[name]), name)
    for name, atol in (("R_m2c", 1e-4), ("R_m2w", 1e-4), ("t_m2c", 1e-5), ("t_m2w", 1e-5)):
        np.testing.assert_allclose(got[name], np.asarray(ref[name]), atol=atol, err_msg=name)


def test_default_mesh_shape_follows_jax(ranks):
    """Worlds of 1, 2, 4 and 8 ranks split as foundpose_tpu's make_mesh
    splits as many devices; make_mesh() on the 4 ranks takes that shape."""
    import jax

    from foundpose_tpu.parallel import mesh as j_mesh

    for n in (1, 2, 4, 8):
        assert mesh_mod.default_shape(n) == j_mesh.make_mesh(devices=jax.devices()[:n]).devices.shape
    assert all(r["default_shape"] == mesh_mod.default_shape(WORLD) == (1, 4) for r in ranks[0])


def test_mesh_needs_a_process_group():
    with pytest.raises(ValueError, match="torchrun"):
        mesh_mod.make_mesh((2, 2))


def test_repre_shards_match_jax_placement(world):
    """At (4, 2) each bank shard of the padded repre, single and stacked,
    holds what the JAX package places on that bank's devices."""
    from foundpose_tpu.parallel import mesh as j_mesh
    from foundpose_tpu.repre import pad_templates as j_pad, stack_repres as j_stack

    m = j_mesh.make_mesh(shape=(4, 2))
    cases = ((world["jrepre"], world["port"]["repre"], j_mesh.shard_repre, 2),
             (j_stack(world["jobjs"]), stack_repres(world["port"]["objs"]),
              j_mesh.shard_repre_multi, 3))
    for jrep, trep, shard, ndim in cases:
        placed = shard(j_pad(jrep, 2), m)
        assert placed.template_descs.ndim == ndim
        for j in range(2):
            local = mesh_mod.repre_shard(pad_templates(trep, 2), j, 2)
            dev = m.devices[0, j]
            for name in ("template_descs", "template_mask", "bank_feats", "bank_vertices",
                         "bank_mask"):
                arr = getattr(placed, name)
                shard_data = next(s.data for s in arr.addressable_shards if s.device == dev)
                np.testing.assert_array_equal(getattr(local, name).numpy(),
                                              np.asarray(shard_data), name)
            np.testing.assert_array_equal(local.word_centroids.numpy(),
                                          np.asarray(placed.word_centroids))


def test_retrieve_and_fetch_match_single_device_and_jax(ranks, world):
    """(2, 2): every rank's retrieval equals ops/tfidf on the whole bank
    and the JAX package's _retrieve_sharded under shard_map at (4, 2) (ids
    equal, scores within 1e-6); the fetched banks are bit-equal to the
    whole bank's rows."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from foundpose_torch.ops.tfidf import tfidf_retrieve
    from foundpose_tpu.parallel import mesh as j_mesh
    from foundpose_tpu.parallel.sharded_inference import _fetch_banks, _retrieve_sharded
    from foundpose_tpu.repre import pad_templates as j_pad

    out, inputs = ranks
    repre = pad_templates(inputs["repre"], 2)
    ref_ids, ref_scores = tfidf_retrieve(
        inputs["feats"], repre.word_centroids, repre.word_idfs, repre.template_descs, 3,
        repre.tfidf_config, query_mask=inputs["valid"], template_mask=repre.template_mask)

    m = j_mesh.make_mesh(shape=(4, 2))
    jrep = j_mesh.shard_repre(j_pad(world["jrepre"], 2), m)

    def inner(feats, valid, descs, tmask, bf, bv, bm, words, idfs):
        def one(f, v):
            ids, sc = _retrieve_sharded(f, v.astype(f.dtype), words, idfs, descs, 3,
                                        jrep.tfidf_config, template_mask_local=tmask)
            return (ids, sc) + _fetch_banks(ids, bf, bv, bm)
        return jax.vmap(one)(feats, valid)

    fn = shard_map(inner, mesh=m, in_specs=(P("data"), P("data")) + (P("bank"),) * 5
                   + (P(), P()), out_specs=P("data"), check_vma=False)
    j_ids, j_scores, jf, jv, jm = jax.jit(fn)(
        jnp.asarray(inputs["feats"].numpy()), jnp.asarray(inputs["valid"].numpy()),
        jrep.template_descs, jrep.template_mask, jrep.bank_feats, jrep.bank_vertices,
        jrep.bank_mask, jrep.word_centroids, jrep.word_idfs)
    for r in out:
        got = r["retrieval"]
        rows = slice(*got["rows"])
        np.testing.assert_array_equal(got["ids"], ref_ids[rows].numpy())
        np.testing.assert_array_equal(got["ids"], np.asarray(j_ids)[rows])
        np.testing.assert_allclose(got["scores"], ref_scores[rows].numpy(), atol=1e-6)
        np.testing.assert_allclose(got["scores"], np.asarray(j_scores)[rows], atol=1e-6)
        tids = torch.as_tensor(got["ids"])
        for a, whole in zip(got["fetched"], (repre.bank_feats, repre.bank_vertices,
                                             repre.bank_mask)):
            assert a.dtype == whole.numpy().dtype
            np.testing.assert_array_equal(a.view(np.uint8), whole[tids].numpy().view(np.uint8))
        np.testing.assert_array_equal(got["fetched"][2], np.asarray(jm)[rows])
        np.testing.assert_array_equal(got["fetched"][0], np.asarray(jf)[rows])
    # Every crop retrieves its own template first.
    np.testing.assert_array_equal(ref_ids[:, 0].numpy(), np.arange(B))


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_step_matches_single_device(ranks, shape):
    """make_object_mesh_step at (2, 2), (4, 1) and (1, 4) (9 templates
    padded to 10 and 12): on every rank the global outputs of the port's
    single-device step with the same draws."""
    out, p = ranks
    ref = t_inf.pose_from_crops(port_model(p["state"]), p["crops"], p["masks"],
                                port_cameras(p["cams"]), p["repre"], p["config"],
                                draws=torch.as_tensor(p["draws"]))
    assert bool(ref.success.all())
    for r in out:
        assert_same_outputs(r["steps"][shape], as_numpy(ref))


def test_sharded_step_matches_jax(ranks, world):
    """(2, 2): the JAX package's make_sharded_step on its (2, 2) mesh, with
    its draws fed to the port."""
    import jax.numpy as jnp

    from foundpose_tpu.parallel import mesh as j_mesh
    from foundpose_tpu.parallel.sharded_inference import make_object_mesh_step
    from foundpose_tpu.structs import PinholeCamera as JCamera

    out, _ = ranks
    m = j_mesh.make_mesh(shape=(2, 2))
    c = world["cams"]
    cams = JCamera(f=jnp.asarray(c["f"]), c=jnp.asarray(c["c"]),
                   T_world_from_eye=jnp.asarray(c["T"]), width=HW, height=HW)
    step = make_object_mesh_step(m, world["jvit"], world["jcfg"], world["jrepre"])
    ref = step(world["params"], jnp.asarray(world["crops"]), jnp.asarray(world["masks"]), cams,
               world["key"])
    got = out[0]["steps"][(2, 2)]
    assert got["success"].all()
    assert_same_outputs(got, ref)


def test_generator_draws_match_single_device(ranks):
    """With query subsampling and the two-phase solve, the (2, 2) step
    drawing from a generator every rank seeds alike makes the single-device
    step's draws: the same outputs."""
    out, p = ranks
    ref = t_inf.pose_from_crops(port_model(p["state"]), p["crops"], p["masks"],
                                port_cameras(p["cams"]), p["repre"], p["drawn_config"],
                                generator=torch.Generator().manual_seed(5))
    for r in out:
        assert_same_outputs(r["drawn"], as_numpy(ref))
        np.testing.assert_array_equal(r["drawn"]["num_queries"], ref.num_queries.numpy())
    assert (ref.num_queries.numpy() <= 30).all()


def test_featuremetric_refinement_takes_the_fetched_winner_bank(ranks):
    """With featuremetric refinement on, the (2, 2) step refines against the
    winner's bank from the fetched banks (the rank's shard may not hold
    it): the single-device step's refined poses."""
    out, p = ranks
    args = (port_model(p["state"]), p["crops"], p["masks"], port_cameras(p["cams"]),
            p["noisy_repre"])
    ref = t_inf.pose_from_crops(*args, p["refine_config"], draws=torch.as_tensor(p["draws"]))
    coarse = t_inf.pose_from_crops(*args, p["config"], draws=torch.as_tensor(p["draws"]))
    assert np.abs(ref.t_m2c.numpy() - coarse.t_m2c.numpy()).max() > 1e-4  # refinement moved
    for r in out:
        assert_same_outputs(r["refined"], as_numpy(ref))


def test_sharded_step_multi_matches_single_device_and_jax(ranks, world):
    """make_multi_object_mesh_step at (2, 2) over two stacked objects (4
    crops each): the port's pose_from_crops_multi and the JAX package's
    mixed-object mesh step with its draws."""
    import jax.numpy as jnp

    from foundpose_tpu.parallel import mesh as j_mesh
    from foundpose_tpu.parallel.sharded_inference import make_multi_object_mesh_step
    from foundpose_tpu.repre import stack_repres as j_stack
    from foundpose_tpu.structs import PinholeCamera as JCamera

    out, p = ranks
    ref = t_multi.pose_from_crops_multi(
        port_model(p["state"]), p["crops"], p["masks"], port_cameras(p["cams"]), p["obj_idx"],
        stack_repres(p["objs"]), p["config"], draws=torch.as_tensor(p["draws"]))
    assert bool(ref.success.all())
    m = j_mesh.make_mesh(shape=(2, 2))
    c = world["cams"]
    cams = JCamera(f=jnp.asarray(c["f"]), c=jnp.asarray(c["c"]),
                   T_world_from_eye=jnp.asarray(c["T"]), width=HW, height=HW)
    step, _ = make_multi_object_mesh_step(m, world["jvit"], world["jcfg"], j_stack(world["jobjs"]))
    jref = step(world["params"], jnp.asarray(world["crops"]), jnp.asarray(world["masks"]), cams,
                jnp.asarray(world["obj_idx"], jnp.int32), world["key"])
    for r in out:
        assert_same_outputs(r["multi"], as_numpy(ref))
    assert_same_outputs(out[0]["multi"], jref)
    # Crop i retrieves its own template: index i // 2 of its object.
    np.testing.assert_array_equal(out[0]["multi"]["best_template"], np.arange(B) // 2)


def test_ranks_hold_their_mesh_coordinates(ranks):
    """Rank r of the (2, 2) mesh sits at (r // 2, r % 2), as JAX's row-major
    device grid; no rank loaded JAX."""
    out, _ = ranks
    assert [(r["coords"]["data"], r["coords"]["bank"]) for r in out] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert not any(r["jax_loaded"] for r in out)


def _stuck_rank(rank, world):
    """Rank 0 all-reduces; rank 1 never joins it."""
    if rank == 0:
        torch.distributed.all_reduce(torch.zeros(1))
    else:
        time.sleep(120)


def test_launch_deadline_stops_a_stuck_collective():
    """A collective that a rank never joins fails its rank at launch.run's
    deadline (here 3 s), and run raises then, instead of waiting for
    gloo's own 30 minutes."""
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="(?i)timed out|timeout"):
        run_ranks(_stuck_rank, 2, timeout=datetime.timedelta(seconds=3))
    assert time.perf_counter() - t0 < 60
    assert launch.DEFAULT_TIMEOUT == datetime.timedelta(seconds=300)
