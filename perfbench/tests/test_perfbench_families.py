"""The backbone family seam. DINOv2 gives what the harness gave before the
seam: its weights bit for bit and its counts to the last digit, pinned to
values read from the harness before its DINOv2 code moved behind the
family. A family that exists only as two modules under the names the lookup
finds runs a tiny offline cell end to end, with no harness file touched."""

import copy
import hashlib
import math
import os
import sys
import types

import pytest
import torch
import torch.nn.functional as F

from perfbench import flops, harness, models
from perfbench.reference.dinov2 import IMAGENET_MEAN, IMAGENET_STD
from perfbench.reference.precision import Precision
from perfbench.tests import tiny

TINY = dict(embed_dim=128, num_heads=2, depth=3, pos_grid=6)
# sha256 over the tensors' names, shapes, dtypes and bytes, "top" then
# "blocks", names sorted.
PINNED_WEIGHTS = {
    ("dinov2_version=vits14-reg_stride=14_facet=token_layer=1_norm=1", 3):
        "c66102eb9ca5742bf8203ff034a15fa932363950c092da6cb13a96e9dc5a337a",
    ("dinov2_version=vits14-reg_stride=14_facet=token_layer=1_norm=1", 2147483659):
        "c458d7691af43d7ff7028a2878b458868f35dbe7b2fb227c33b1d827552bbf98",
    ("dinov2_version=vitg14_stride=14_facet=key_layer=2_norm=1", 3):
        "4225c37611bff6ac834928bd85f8566c6afe31a04c03497f90053a404f538457",
    ("dinov2_version=vitg14_stride=14_facet=key_layer=2_norm=1", 2147483659):
        "902c2afa0da0db31451687419c6b3b7aa8ff56ad3b664a9f40905a3c43aee17c",
}
# tokens (the family's own `_tokens`), vit_flops_per_crop and
# pipeline_flops_per_crop at 420 px crops (grid cell 14, PCA to 256, 2,048
# words, banks of 512, top 5 templates), vit_bytes at batch 128.
PINNED_COUNTS = {
    "dinov2_version=vits14-reg_stride=14_facet=token_layer=9_norm=1":
        (905, 45014092800, 2039583744, 48494054400),
    "dinov2_version=vitl14_stride=14_facet=key_layer=18_norm=1":
        (901, 474744201216, 9335050240, 478519074816),
    "dinov2_version=vitg14_stride=14_facet=token_layer=39_norm=1":
        (901, 2241830584320, 31099502592, 2245841387520),
}


# What `perfbench/models/<family>.py` gives the harness and its tests
# (README.md, "Adding a backbone family"), and what its reference gives.
INTERFACE = ("shape", "make_weights", "program", "extract", "feat_dim", "vit_flops_per_crop",
             "vit_bytes", "tiny")
FAMILIES = sorted(f[:-3] for f in os.listdir(os.path.join(harness.HERE, "models"))
                  if f.endswith(".py") and f != "__init__.py")


def _digest(w):
    h = hashlib.sha256()
    for part in ("top", "blocks"):
        for k in sorted(w[part]):
            t = w[part][k].detach().contiguous().cpu()
            h.update(f"{part}/{k}/{tuple(t.shape)}/{t.dtype}".encode())
            h.update(t.numpy().tobytes())
    return h.hexdigest()


def test_family_is_the_extractor_names_first_field():
    for name in list(PINNED_COUNTS) + ["toyvit_width=64_patch=14"]:
        assert models.name({"extractor_name": name}) == name.split("_")[0]
    with pytest.raises(ValueError):
        models.family("dinov2.x")


@pytest.mark.parametrize("family", FAMILIES)
def test_every_family_gives_the_interface(family):
    fam = models.family(family)
    assert [f for f in INTERFACE if not callable(getattr(fam, f, None))] == []
    assert callable(models.reference(family).feature_maps)


@pytest.mark.parametrize("name", sorted(PINNED_COUNTS)[:2])
def test_dinov2_tiny_cuts_the_vit_alone(name):
    """DINOv2's `tiny`: features at block 1 of 3, 128 wide, on 84 px crops;
    the other switches kept."""
    fam = models.family("dinov2")
    opts = {"extractor_name": name, "approx_gelu": True,
            "vit_overrides": {"softmax_stabilizer": "capped"}}
    small = fam.tiny(opts)
    s = fam.shape(small)
    assert (s.layer, s.depth, s.embed_dim, s.head_dim, s.pos_grid, s.facet) == (
        1, 3, 128, 64, 6, fam.shape(opts).facet)
    assert small["vit_overrides"]["softmax_stabilizer"] == "capped" and small["approx_gelu"]
    assert opts["extractor_name"] == name  # the configuration itself is left as it was


@pytest.mark.parametrize("name,seed", sorted(PINNED_WEIGHTS))
def test_dinov2_weights_as_before_the_seam(name, seed):
    fam = models.family("dinov2")
    s = fam.shape({"extractor_name": name, "approx_gelu": True, "vit_overrides": TINY})
    assert _digest(fam.make_weights(s, seed, "cpu")) == PINNED_WEIGHTS[(name, seed)]


@pytest.mark.parametrize("name", sorted(PINNED_COUNTS))
def test_dinov2_counts_as_before_the_seam(name):
    fam = models.family("dinov2")
    s = fam.shape({"extractor_name": name, "approx_gelu": True,
                   "vit_overrides": {"softmax_stabilizer": "capped"}})
    vit_flops = fam.vit_flops_per_crop(s, 420)
    assert (fam._tokens(s, 420), vit_flops, fam.vit_bytes(s, 420, 128),
            flops.pipeline_flops_per_crop(vit_flops, fam.feat_dim(s), 420, 14.0, 256, 2048, 512,
                                          5)) == PINNED_COUNTS[name]


@pytest.mark.parametrize("name", sorted(PINNED_COUNTS)[:2])
def test_readers_count_through_the_records_family(name):
    """step_mfu.offline and vit_roofline.offline find the counts by the
    family `rec` names: on a window of 1 s of device time at 1,000 crops/s,
    the pinned counts over the H100's peaks."""
    from types import SimpleNamespace

    from perfbench import harness

    fam = models.family("dinov2")
    _, vit_flops, vit_bytes, step_flops = PINNED_COUNTS[name]
    peak = flops.peaks("NVIDIA H100 80GB HBM3")
    rec = {"family": "dinov2", "shape": fam.shape({"extractor_name": name}), "crop_px": 420,
           "cell_px": 14.0, "batch": 128, "crops_per_s": 1000.0,
           "config": SimpleNamespace(top_n_templates=5), "device_name": "NVIDIA H100 80GB HBM3",
           "repre": {"feat_dim": 256, "num_words": 2048, "fmax": 512},
           "vit_window": SimpleNamespace(whole=True, kernels=[("k", 0.0, 1.0)], copies=[])}
    assert harness.reader("step_mfu.offline")(rec) == pytest.approx(
        100.0 * step_flops * 1000.0 / peak["bf16_flops"], rel=1e-12)
    assert harness.reader("vit_roofline.offline")(rec) == pytest.approx(
        100.0 * max(vit_flops * 128 / peak["bf16_flops"], vit_bytes / peak["bytes_s"]), rel=1e-12)


# The toy family: a 2-block ViT with no class token and no registers, a
# position table per patch, one head, post-norm blocks with a ReLU MLP, and
# its weights as one list of per-block dicts. Its program is its reference.


def _toy_reference():
    def feature_maps(weights, shape, images, prec):
        b, h, w, _ = images.shape
        p, d = shape["patch"], shape["width"]
        gh, gw = h // p, w // p
        x = images[:, : gh * p, : gw * p].reshape(b, gh, p, gw, p, 3)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * 3)
        x = prec.mm(x - 0.5, weights["patch"]) + weights["pos"][: gh * gw]
        for blk in weights["blocks"]:
            q, k, v = (prec.mm(x, blk[n]) for n in "qkv")
            att = torch.softmax(prec.mm(q, k.transpose(1, 2)) / math.sqrt(d), dim=-1)
            x = F.layer_norm(x + prec.mm(att, v), (d,))
            x = F.layer_norm(x + prec.mm(torch.relu(prec.mm(x, blk["up"])), blk["down"]), (d,))
        return x.reshape(b, gh, gw, d)

    mod = types.ModuleType("perfbench.reference.toyvit")
    mod.feature_maps = feature_maps
    return mod


class ToyProgram(torch.nn.Module):
    """The toy's reference on the images the port's `preprocess_crops`
    hands its ViT (normalised, in the compute dtype); `broken`, each crop
    gets the next crop's features."""

    broken = False

    def __init__(self, ref, weights, shape):
        super().__init__()
        self.ref, self.weights, self.shape = ref, weights, shape

    def forward(self, images):
        mean, std = torch.tensor(IMAGENET_MEAN), torch.tensor(IMAGENET_STD)
        fmap = self.ref.feature_maps(self.weights, self.shape, images.float() * std + mean,
                                     Precision())
        return torch.roll(fmap, 1, dims=0) if self.broken else fmap


def _toy_family(ref):
    def shape(opts):
        fields = dict(item.split("=") for item in opts["extractor_name"].split("_")[1:])
        return {"width": int(fields["width"]), "patch": int(fields["patch"]), "blocks": 2}

    def make_weights(s, seed, device):
        g = torch.Generator(device=device).manual_seed(seed)
        d, p = s["width"], s["patch"]

        def draw(*size):
            return torch.randn(size, generator=g, device=device) / math.sqrt(size[0])

        return {"patch": draw(p * p * 3, d), "pos": 0.1 * draw(1, 64 * 64, d)[0],
                "blocks": [{"q": 0.5 * draw(d, d), "k": 0.5 * draw(d, d), "v": draw(d, d),
                            "up": draw(d, 2 * d), "down": draw(2 * d, d)}
                           for _ in range(s["blocks"])]}

    def _tokens(s, crop_px):
        return (crop_px // s["patch"]) ** 2

    def vit_flops_per_crop(s, crop_px):
        n, d = _tokens(s, crop_px), s["width"]
        return 2 * (n * s["patch"] ** 2 * 3 * d + s["blocks"] * (n * 7 * d * d + 2 * n * n * d))

    def vit_bytes(s, crop_px, batch):
        n, d = _tokens(s, crop_px), s["width"]
        return 4 * (s["blocks"] * 7 * d * d + batch * (crop_px ** 2 * 3 + 2 * s["blocks"] * n * d))

    def tiny(opts):
        return dict(opts, extractor_name=opts["extractor_name"].replace("width=256", "width=64"))

    mod = types.ModuleType("perfbench.models.toyvit")
    mod.shape, mod.make_weights, mod.tiny = shape, make_weights, tiny
    mod.vit_flops_per_crop, mod.vit_bytes = vit_flops_per_crop, vit_bytes
    mod.feat_dim = lambda s: s["width"]
    mod.program = lambda w, opts, device: (ToyProgram(ref, w, shape(opts)),
                                           opts["extractor_name"], {})
    mod.extract = lambda model, images: model(images)
    return mod


@pytest.mark.parametrize("broken", [False, True], ids=["sound", "broken"])
def test_a_family_of_files_only_runs_a_cell(broken, monkeypatch):
    from foundpose_torch.models import dinov2

    ref = _toy_reference()
    monkeypatch.setitem(sys.modules, "perfbench.reference.toyvit", ref)
    monkeypatch.setitem(sys.modules, "perfbench.models.toyvit", _toy_family(ref))
    # The port calls `dinov2.extract_facet` on the module it is handed; a
    # backbone's own dispatch there is the program's part of a new family.
    extract_facet = dinov2.extract_facet
    monkeypatch.setattr(dinov2, "extract_facet", lambda model, images: (
        {"feature_maps": model(images)} if isinstance(model, ToyProgram)
        else extract_facet(model, images)))
    monkeypatch.setattr(ToyProgram, "broken", broken)
    cell = "vits14reg_offline_b128"
    config = copy.deepcopy(harness.cell_parts(harness.manifest(), cell)[1])
    config["infer_opts"]["extractor_name"] = "toyvit_width=256_patch=14"
    del config["infer_opts"]["vit_overrides"]
    s = tiny.setup(cell, config=config)
    # 64 wide: the toy family's own `tiny` cut it, as `tiny.parts` cuts every family.
    assert s.family == "toyvit" and s.world["pca"]["mean"].shape == (64,)
    res = tiny.run(cell, config=config)
    assert res["correct"] != broken, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
