"""The port's tensor-parallel ViT (foundpose_torch/parallel/tp_vit.py)
against the port's single-device extract_facet and the JAX package's
make_tp_extractor, in f32 on the CPU; and the composed (data, bank, model)
step against the (data, bank) step.

As in tests/test_torch_parallel.py, the ranks are gloo processes spawned
once per world size for the module, and JAX is imported only inside the
fixtures and tests.
"""

import os
import pickle

import numpy as np
import pytest
import torch
from test_torch_parallel import (
    as_numpy,
    assert_same_outputs,
    port_cameras,
    port_model,
    read_ranks,
)

from foundpose_torch.models import dinov2 as t_dinov2
from foundpose_torch.parallel import launch
from foundpose_torch.parallel import mesh as mesh_mod
from foundpose_torch.parallel import sharded_inference as t_sharded
from foundpose_torch.parallel import tp_vit

# The JAX package's tests/test_tp_vit.py tiny_cfg: 4 heads, 3 blocks, layer 2.
TP_VIT = dict(variant="vits14", embed_dim=64, depth=3, num_heads=4, mlp_ratio=4.0,
              swiglu=False, patch_size=14, num_register_tokens=4, pos_grid=6, stride=14,
              layer=2, apply_norm=True)
FACETS = ("token", "key")
# World size -> the TP meshes run on it.
MESHES = {2: ((1, 1, 2),), 4: ((2, 1, 2),)}
REL_L2 = 1e-5


def tp_model(state, facet):
    model = t_dinov2.DinoV2(t_dinov2.DinoV2Config(facet=facet, **TP_VIT))
    model.load_state_dict(state)
    return model.eval()


def _rank(rank, world, in_path, out_dir):
    with open(in_path, "rb") as f:
        p = pickle.load(f)
    res = {"extract": {}, "psums": {}}
    for shape in MESHES[world]:
        mesh = mesh_mod.make_mesh(shape)
        for facet in FACETS:
            model = tp_model(p["state"], facet)
            params = t_sharded.prepare_mesh_vit_params(mesh, model)
            extract = tp_vit.make_tp_extractor(mesh, model.cfg)
            calls = []
            psum = mesh_mod._psum
            mesh_mod._psum = lambda x, m, axis: calls.append(axis) or psum(x, m, axis)
            try:
                out = extract(params, p["images"])
            finally:
                mesh_mod._psum = psum
            res["extract"][shape, facet] = {k: v.numpy() for k, v in out.items()}
            res["psums"][shape, facet] = calls.count(mesh_mod.MODEL_AXIS)
    if world == 4:
        # The composed (1, 2, 2) step and the (2, 2) step on one world.
        w = p["world"]
        model, cams = port_model(w["state"]), port_cameras(w["cams"])
        draws = torch.as_tensor(w["draws"])
        for shape in ((1, 2, 2), (2, 2)):
            mesh = mesh_mod.make_mesh(shape)
            step = t_sharded.make_object_mesh_step(mesh, w["config"], w["repre"])
            params = t_sharded.prepare_mesh_vit_params(mesh, model)
            res[shape] = as_numpy(step(params, w["crops"], w["masks"], cams, draws=draws))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """(JAX params, images, {world: [rank results]})."""
    import jax
    from test_torch_parallel import build_world

    from foundpose_torch.models.weights import state_dict_from_jax_params
    from foundpose_tpu.models import dinov2 as j_dinov2

    jcfg = j_dinov2.DinoV2Config(**TP_VIT)
    params = jax.tree.map(np.asarray, j_dinov2.init_params(jax.random.PRNGKey(0), jcfg))
    images = np.random.default_rng(0).uniform(size=(4, 84, 84, 3)).astype(np.float32)
    w = build_world()
    inputs = dict(state=state_dict_from_jax_params(params, t_dinov2.DinoV2Config(**TP_VIT)),
                  images=torch.from_numpy(images), world=dict(w["port"], draws=w["draws"]))
    d = tmp_path_factory.mktemp("tp")
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ranks = {}
    for world in MESHES:
        out = d / f"world{world}"
        out.mkdir()
        launch.run(_rank, world, str(d / "inputs.pkl"), str(out))
        ranks[world] = read_ranks(out, world)
    return params, images, inputs, ranks


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("facet", FACETS)
@pytest.mark.parametrize("world,shape", [(2, (1, 1, 2)), (4, (2, 1, 2))])
def test_tp_extractor_matches_single_device_and_jax(tp, world, shape, facet):
    """The TP extractor's facet maps and class tokens on every rank: the
    port's extract_facet and the JAX package's make_tp_extractor on its
    own mesh of the same shape, relative L2 <= 1e-5."""
    import jax
    import jax.numpy as jnp

    from foundpose_tpu.models import dinov2 as j_dinov2
    from foundpose_tpu.parallel import mesh as j_mesh
    from foundpose_tpu.parallel import tp_vit as j_tp

    params, images, inputs, ranks = tp
    model = tp_model(inputs["state"], facet)
    ref = t_dinov2.extract_facet(model, t_dinov2.normalize_images(inputs["images"]))
    jcfg = j_dinov2.DinoV2Config(facet=facet, **TP_VIT)
    m = j_mesh.make_mesh(shape=shape)
    params_tp = j_tp.shard_tp_params(j_tp.prepare_tp_params(params, jcfg), m)
    jout = jax.jit(j_tp.make_tp_extractor(m, jcfg))(params_tp, jnp.asarray(images))
    for r in ranks[world]:
        got = r["extract"][shape, facet]
        for k in ("feature_maps", "cls_tokens"):
            assert got[k].shape == tuple(ref[k].shape)
            assert rel_l2(got[k], ref[k].numpy()) <= REL_L2, k
            assert rel_l2(got[k], np.asarray(jout[k])) <= REL_L2, k


@pytest.mark.parametrize("facet", FACETS)
def test_tp_layer_makes_two_psums(tp, facet):
    """Exactly two _psums over `model` a layer: layer + 1 TP blocks for the
    token facet; for the key facet `layer` blocks and one _all_gather (one
    _psum) of the last layer's key heads."""
    want = 2 * (TP_VIT["layer"] + 1) if facet == "token" else 2 * TP_VIT["layer"] + 1
    for world, shapes in MESHES.items():
        for r in tp[3][world]:
            assert r["psums"][shapes[0], facet] == want


def test_composed_step_matches_bank_sharded_step(tp):
    """The (1, 2, 2) step (TP ViT, bank-sharded retrieval) equals the
    (2, 2) step on the same inputs on every rank: the TP split only
    reassociates each layer's sums."""
    ranks = tp[3][4]
    assert ranks[0][(2, 2)]["success"].all()
    for r in ranks:
        assert_same_outputs(r[(1, 2, 2)], ranks[0][(2, 2)])
        np.testing.assert_allclose(r[(1, 2, 2)]["score"], ranks[0][(2, 2)]["score"], atol=1e-6)


def test_prepare_tp_params_matches_jax_shards():
    """Each rank's weights are the JAX package's factored layouts cut at
    _BLOCK_SPECS' axes: qkv and its bias on heads, proj on its input
    heads, fc1 on hidden units, fc2 on its input hidden units."""
    import jax

    from foundpose_torch.models.weights import state_dict_from_jax_params
    from foundpose_tpu.models import dinov2 as j_dinov2
    from foundpose_tpu.parallel import tp_vit as j_tp

    jcfg = j_dinov2.DinoV2Config(**TP_VIT)
    params = jax.tree.map(np.asarray, j_dinov2.init_params(jax.random.PRNGKey(1), jcfg))
    blocks = j_tp.prepare_tp_params(params, jcfg)["blocks"]
    model = tp_model(state_dict_from_jax_params(params, t_dinov2.DinoV2Config(**TP_VIT)), "token")
    n, nl, hd, d = 2, 2, 16, 64
    hl = model.cfg.mlp_hidden // n
    for j in range(n):
        shard = tp_vit.prepare_tp_params(model, n, j)
        heads, hidden = slice(j * nl, (j + 1) * nl), slice(j * hl, (j + 1) * hl)
        for layer, p in enumerate(shard.blocks):
            want = {
                "qkv_weight": np.asarray(blocks["qkv_kernel"][layer])[:, :, heads],
                "qkv_bias": np.asarray(blocks["qkv_bias"][layer])[:, heads],
                "proj_weight": np.asarray(blocks["proj_kernel"][layer])[heads],
                "fc1_weight": np.asarray(blocks["fc1_kernel"][layer])[:, hidden],
                "fc1_bias": np.asarray(blocks["fc1_bias"][layer])[hidden],
                "fc2_weight": np.asarray(blocks["fc2_kernel"][layer])[hidden],
            }
            got = {
                "qkv_weight": p["qkv_weight"].reshape(3, nl, hd, d).permute(3, 0, 1, 2),
                "qkv_bias": p["qkv_bias"].reshape(3, nl, hd),
                "proj_weight": p["proj_weight"].reshape(d, nl, hd).permute(1, 2, 0),
                "fc1_weight": p["fc1_weight"].t(), "fc1_bias": p["fc1_bias"],
                "fc2_weight": p["fc2_weight"].t(),
            }
            for k, v in want.items():
                np.testing.assert_array_equal(got[k].numpy(), v, k)
            np.testing.assert_array_equal(p["proj_bias"].numpy(),
                                          np.asarray(blocks["proj_bias"][layer]))


def test_tp_validation_rejects_bad_widths():
    """A model axis that divides neither the heads nor the MLP width
    raises, as the JAX package's validate_tp; SwiGLU is not ported."""
    cfg = t_dinov2.DinoV2Config(**dict(TP_VIT, num_heads=6))
    with pytest.raises(ValueError):
        tp_vit.validate_tp(cfg, 4)
    with pytest.raises(ValueError):
        tp_vit.validate_tp(t_dinov2.DinoV2Config(**dict(TP_VIT, mlp_ratio=4.25)), 3)
    with pytest.raises(NotImplementedError):
        tp_vit.validate_tp(t_dinov2.DinoV2Config(**dict(TP_VIT, swiglu=True)), 2)
