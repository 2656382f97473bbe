"""DINOv3 on the port's normal path, on the CPU at a tiny width (256, 2
heads of 128, 4 storage tokens, patch 16): the rotary tables and the
twins' rotation against the independent reference
(`benchmarks/reference_dinov3`), the whole facet against the reference on
seeded random weights, the model through `models.backbone` into
`pose_from_crops`, `PoseEngine.estimate`, the infer CLI's `load_model` and
`gen_repre`, the model-name DSL, and the mesh path's refusal."""

import dataclasses

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)

from foundpose_torch import models
from foundpose_torch.benchmarks import reference_dinov3 as ref
from foundpose_torch.engine import PoseEngine
from foundpose_torch.models import dinov2, dinov3
from foundpose_torch.models.weights import load_or_init
from foundpose_torch.ops.vit_block import apply_rope, fused_vit_block_plain
from foundpose_torch.parallel import sharded_inference
from foundpose_torch.pipeline import gen_repre, infer, inference
from foundpose_torch.structs import PinholeCamera
from foundpose_torch.synthetic import realistic_repre

NAME = "dinov3_version=vit7b16_stride=16_facet={facet}_layer={layer}_norm=1"
TINY = dict(embed_dim=256, num_heads=2, depth=3)
CROP = 96


def _cfg(facet="token", layer=1, **kw):
    return dataclasses.replace(dinov3.parse_model_name(NAME.format(facet=facet, layer=layer)),
                               **TINY, **kw)


def _hub_state_dict(model: dinov3.DinoV3):
    """The module's weights under the hub's names: mlp.w12 split into w1
    (gate) and w2 (value); no qkv bias."""
    sd = {k: v.detach().float().clone() for k, v in model.state_dict().items()}
    h = model.cfg.mlp_hidden
    for i in range(model.cfg.depth):
        pre = f"blocks.{i}.mlp."
        for kind in ("weight", "bias"):
            w12 = sd.pop(f"{pre}w12.{kind}")
            sd[f"{pre}w1.{kind}"], sd[f"{pre}w2.{kind}"] = w12[:h].clone(), w12[h:].clone()
    return sd


def _ref_shape(cfg):
    return ref.Dinov3Shape(embed_dim=cfg.embed_dim, depth=cfg.depth, num_heads=cfg.num_heads,
                           layer=cfg.layer, facet=cfg.facet, apply_norm=cfg.apply_norm)


@pytest.fixture(scope="module")
def tiny_model():
    """Random weights with larger layer scales and biases than the init's,
    so that each block moves the tokens."""
    model = load_or_init(_cfg(), seed=3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("gamma", "bias")) or "token" in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    return model


def test_rope_tables_are_the_references_untiled_half():
    cos, sin = dinov3.rope_tables(5, 7, "cpu")
    rcos, rsin = ref.rope_tables(5, 7, 128, 100.0, "cpu")
    assert cos.shape == (35, 64) and cos.dtype == torch.float32
    for ours, theirs in ((cos, rcos), (sin, rsin)):
        assert torch.equal(ours, theirs[:, :64]) and torch.equal(ours, theirs[:, 64:])


def test_twin_rotation_is_the_references_product_for_product():
    """ops/vit_block's rotation of q and k (tokens past the prefix) equals
    the reference's x cos + rotate_half(x) sin bit for bit; the prefix
    tokens pass unchanged."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(2, 5 + 12, 3, 128, generator=g)
    cos, sin = dinov3.rope_tables(3, 4, "cpu")
    got = apply_rope(a, (cos, sin, 5))
    rcos, rsin = ref.rope_tables(3, 4, 128, 100.0, "cpu")
    want = ref.rope_apply(a[:, 5:], rcos[None, :, None], rsin[None, :, None])
    assert torch.equal(got[:, :5], a[:, :5]) and torch.equal(got[:, 5:], want)


def test_twin_block_with_rope_matches_the_reference_block(tiny_model):
    """One block of the fused twin with rotary tables, in f32, against the
    reference's block on the same weights (f32 reassociation only: the
    twin's base-2 softmax with q pre-scaled, F.linear's fused bias)."""
    cfg = tiny_model.cfg
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5 + 36, cfg.embed_dim, generator=g)
    cos, sin = dinov3.rope_tables(6, 6, "cpu")
    p = tiny_model.blocks[0].kernel_params(torch.float32)
    assert torch.equal(p["qkv_bias"], torch.zeros(3 * cfg.embed_dim))
    got = fused_vit_block_plain(x, p, num_heads=2, head_dim=128, eps=cfg.layer_norm_eps,
                                rope=(cos, sin, 5))
    want = ref._block(x, _hub_state_dict(tiny_model), 0, _ref_shape(cfg),
                      ref.rope_tables(6, 6, 128, 100.0, "cpu"))
    assert float((got - want).abs().max()) < 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("facet", ["token", "key"])
def test_dinov3_matches_the_reference(tiny_model, facet):
    """The port's facet (the fused block's twin, in f32) against the independent reference on the same seeded weights, at 96 px
    (a 6 x 6 grid) and 112 x 80 px (7 x 5): within 1e-5 of the largest
    feature, the reassociation of f32 sums over two blocks (measured
    1e-7 to 3e-7)."""
    model = dinov3.DinoV3(_cfg(facet)).eval()
    model.load_state_dict(tiny_model.state_dict())
    sd, s = _hub_state_dict(model), _ref_shape(model.cfg)
    g = torch.Generator().manual_seed(2)
    for hw in ((CROP, CROP), (112, 80)):
        images = torch.rand(2, *hw, 3, generator=g)
        ours = dinov3.extract_facet(model, dinov3.normalize_images(images))["feature_maps"]
        theirs = ref.feature_maps(sd, s, images)
        assert ours.shape == theirs.shape == (2, hw[0] // 16, hw[1] // 16, 256)
        assert float((ours - theirs).abs().max()) < 1e-5 * float(theirs.abs().max())


@pytest.mark.parametrize("name", [
    "dinov3_version=vit7b16_stride=16_facet=token_layer=30_norm=1",
    "dinov3_version=vit7b16_stride=16_facet=key_layer=12_norm=0",
])
def test_parse_model_name_round_trips(name):
    cfg = dinov3.parse_model_name(name)
    assert (f"dinov3_version={cfg.variant}_stride={cfg.stride}_facet={cfg.facet}"
            f"_layer={cfg.layer}_norm={int(cfg.apply_norm)}") == name
    assert models.backbone(name) is dinov3 and cfg.family == "dinov3"
    assert models.backbone(name).Model is dinov3.DinoV3
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.head_dim, cfg.mlp_hidden,
            cfg.storage_tokens, cfg.patch_size) == (4096, 40, 32, 128, 8192, 4, 16)
    assert dinov3.parse_model_name("dinov3_vit7b16") == dinov3.DinoV3Config()
    for bad in ("dinov2_version=vit7b16", "dinov3_version=vitx16", "dinov3_version=vit7b16_x=1",
                "dinov3_version=vit7b16_facet=attn"):
        with pytest.raises(ValueError):
            dinov3.parse_model_name(bad)


def test_backbone_dispatch_by_family(tiny_model):
    assert models.backbone("dinov2_version=vits14-reg_stride=14") is dinov2
    assert models.backbone_of(tiny_model) is dinov3
    assert models.backbone_of(object()) is dinov2
    with pytest.raises(ValueError):
        models.backbone("dinov4_version=x")
    opts = {"extractor_name": NAME.format(facet="token", layer=1), "use_fused_block": True,
            "vit_overrides": TINY}
    assert inference.vit_config_from_opts(opts) == _cfg()
    with pytest.raises(ValueError, match="fused block only"):
        inference.vit_config_from_opts(dict(opts, use_fused_block=False))


def _world():
    repre = realistic_repre(0, num_templates=8, fmax=32, feat_dim=16, num_words=16, raw_dim=256,
                            n_points=256)
    config = inference.InferenceConfig(crop_size=(CROP, CROP), grid_cell_size=16.0,
                                       top_n_templates=2, top_k_buddies=20, pnp_ransac_iter=16)
    return repre, config


def test_pose_from_crops_and_engine_run_dinov3(tiny_model):
    """The step on DINOv3 through the dispatch, directly and inside
    PoseEngine (the engine builds its own DinoV3 from the name and the
    overrides, then is handed the fixture's)."""
    repre, config = _world()
    b = 3
    g = torch.Generator().manual_seed(5)
    crops = torch.randint(0, 256, (b, CROP, CROP, 3), dtype=torch.uint8, generator=g)
    cams = PinholeCamera(f=torch.full((b, 2), 100.0), c=torch.full((b, 2), CROP / 2 - 0.5),
                         T_world_from_eye=torch.eye(4).expand(b, 4, 4), width=CROP, height=CROP)
    before = dinov3.rope_tables.builds
    out = inference.pose_from_crops(tiny_model, crops, torch.ones(b, CROP, CROP), cams, repre,
                                    config, generator=torch.Generator().manual_seed(0))
    assert out.success.shape == (b,) and torch.isfinite(out.R_m2c).all()
    assert dinov3.rope_tables.builds <= before + 1

    name = NAME.format(facet="token", layer=1)
    built = PoseEngine(extractor_name=name, config=config, batch_size=2,
                       extractor_overrides=TINY, device="cpu")
    assert isinstance(built.model, dinov3.DinoV3) and built.model.cfg == tiny_model.cfg
    engine = PoseEngine(extractor_name=name, config=config, batch_size=2,
                        extractor_overrides=TINY, device="cpu", model=tiny_model)
    engine.register_object(1, repre)
    image = np.random.default_rng(0).integers(0, 256, (120, 160, 3), dtype=np.uint8)
    K = np.array([[100.0, 0, 79.5], [0, 100.0, 59.5], [0, 0, 1]])
    boxes = [np.array(x, np.float32) for x in ([10, 10, 60, 60], [40, 20, 120, 100])]
    res = engine.estimate(1, image, boxes, K)
    assert len(res) == 2


def test_cli_and_builder_load_and_run_dinov3():
    """The infer CLI's and gen_repre's `load_model` build a DinoV3 from the
    options through `load_or_init`, and the builder's feature registration
    runs it."""
    name = NAME.format(facet="token", layer=1)
    vit, config = infer.load_model(
        infer.InferOpts(extractor_name=name, use_fused_block=True, vit_overrides=TINY), "cpu")
    assert isinstance(vit, dinov3.DinoV3) and vit.cfg == _cfg()
    built = gen_repre.load_model(gen_repre.GenRepreOpts(
        extractor_name=name, use_fused_block=True, vit_overrides=TINY), torch.device("cpu"))
    assert isinstance(built, dinov3.DinoV3)
    assert torch.equal(built.blocks[0].attn.qkv.weight, vit.blocks[0].attn.qkv.weight)
    b = 2
    g = torch.Generator().manual_seed(6)
    images = torch.randint(0, 256, (b, CROP, CROP, 3), dtype=torch.uint8, generator=g)
    depths = torch.full((b, CROP, CROP), 5000, dtype=torch.int32).to(torch.uint16)
    feats, verts, valid = gen_repre.register_templates(
        built, 16.0, (CROP, CROP), images, depths, None, torch.full((b, 2), 100.0),
        torch.full((b, 2), CROP / 2 - 0.5), torch.eye(4).expand(b, 4, 4))
    assert feats.shape[0] == b and feats.shape[-1] == 256 and bool(valid.any())


def test_mesh_path_refuses_dinov3(tiny_model):
    """The mesh engine and the mesh CLI both take the ViT through
    `prepare_mesh_vit_params`."""
    with pytest.raises(ValueError, match="DINOv2 only"):
        sharded_inference.prepare_mesh_vit_params(None, tiny_model)


def test_load_checkpoint_packs_the_hubs_mlp(tiny_model, tmp_path):
    sd = _hub_state_dict(tiny_model)
    sd["rope_embed.periods"] = torch.zeros(32)
    path = str(tmp_path / "dinov3.pth")
    torch.save(sd, path)
    loaded = load_or_init(tiny_model.cfg, path)
    for k, v in tiny_model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
