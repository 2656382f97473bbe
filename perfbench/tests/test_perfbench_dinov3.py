"""The `dinov3` family: its counts pinned to DINOv3 ViT-7B/16's equations
at 480 px, its reference bit-equal to the port's independent reference
(`foundpose_torch/benchmarks/reference_dinov3.py`) on one set of weights,
the calibration with RoPE applied, the program on the weights' own
tensors, and the two kernel readers."""

from types import SimpleNamespace

import pytest
import torch

from perfbench import flops, harness, models
from perfbench.reference.precision import Precision

NAME = "dinov3_version=vit7b16_stride=16_facet={facet}_layer={layer}_norm=1"
TINY = dict(embed_dim=256, num_heads=2, depth=3)
H100 = "NVIDIA H100 80GB HBM3"


def test_counts_are_the_7b_equations():
    """905 tokens (cls, 4 storage, 30 x 30 patches); per block the GEMMs
    2 x 905 x (4 d^2 + 3 d h) and attention 4 x 905^2 x d, d 4,096 and h
    8,192; 31 blocks plus the patch embedding (2 x 900 x 768 x d)."""
    fam = models.family("dinov3")
    s = fam.shape({"extractor_name": NAME.format(facet="token", layer=30)})
    n, d, h = 905, 4096, 8192
    assert (s.blocks_run, s.head_dim, s.mlp_hidden, fam._tokens(s, 480)) == (31, 128, 8192, n)
    attention = 31 * 4 * n * n * d
    assert fam.attention_flops_per_crop(s, 480) == attention == 415_986_073_600
    assert fam.vit_flops_per_crop(s, 480) == (2 * 900 * 768 * d + 31 * 2 * n * (4 * d * d + 3 * d * h)
                                              + attention) == 9_835_344_281_600
    assert fam.qkv_flops_per_crop(s, 480) == 31 * 2 * n * 3 * d * d
    assert flops.pipeline_flops_per_crop(fam.vit_flops_per_crop(s, 480), fam.feat_dim(s), 480,
                                         16.0, 256, 2048, 512, 5) == 9_840_534_732_800
    key = fam.shape({"extractor_name": NAME.format(facet="key", layer=30)})
    assert fam.vit_flops_per_crop(key, 480) == (2 * 900 * 768 * d + 30 * (2 * n * (
        4 * d * d + 3 * d * h) + 4 * n * n * d) + 2 * n * 3 * d * d)


def _hub(weights, s):
    """The benchmark's stacked weights under the hub's names (w12 split)."""
    sd = dict(weights["top"])
    h = s.mlp_hidden
    for k, v in weights["blocks"].items():
        for i in range(s.depth):
            if k.startswith("mlp.w12"):
                kind = k.split(".")[-1]
                sd[f"blocks.{i}.mlp.w1.{kind}"] = v[i][:h].clone()
                sd[f"blocks.{i}.mlp.w2.{kind}"] = v[i][h:].clone()
            else:
                sd[f"blocks.{i}.{k}"] = v[i]
    return sd


@pytest.mark.parametrize("facet", ["token", "key"])
def test_reference_is_the_ports_reference_bit_for_bit(facet):
    from foundpose_torch.benchmarks import reference_dinov3 as port_ref

    fam, ref = models.family("dinov3"), models.reference("dinov3")
    s = fam.shape({"extractor_name": NAME.format(facet=facet, layer=1), "vit_overrides": TINY})
    w = fam.make_weights(s, 7, "cpu")
    images = torch.rand(3, 96, 80, 3, generator=torch.Generator().manual_seed(1))
    ours = ref.feature_maps(w, s, images, Precision(), rows=2)
    shape = port_ref.Dinov3Shape(embed_dim=256, depth=3, num_heads=2, layer=1, facet=facet)
    theirs = port_ref.feature_maps(_hub(w, s), shape, images, rows=2)
    assert ours.shape == (3, 6, 5, 256) and torch.equal(ours, theirs)


def test_calibrated_logits_with_rope():
    fam = models.family("dinov3")
    s = fam.shape({"extractor_name": NAME.format(facet="token", layer=2), "vit_overrides": TINY})
    maxima = fam.calibrate(fam.init(s, torch.Generator().manual_seed(0), "cpu"), s,
                           torch.Generator().manual_seed(1))
    assert len(maxima) == 3 and all(abs(m / fam.TARGET_LOGIT - 1) < 1e-4 for m in maxima)


def test_program_holds_the_weights_own_tensors():
    """No second copy of the 26.8 GB: the module's parameters are the
    weights' storage, and its extractor's overrides are the tiny widths."""
    fam = models.family("dinov3")
    opts = {"extractor_name": NAME.format(facet="token", layer=1), "use_fused_block": True,
            "vit_overrides": TINY}
    s = fam.shape(opts)
    w = fam.make_weights(s, 3, "cpu")
    model, name, overrides = fam.program(w, opts, torch.device("cpu"))
    assert name == opts["extractor_name"] and overrides == TINY
    assert model.blocks[2].mlp.w12.weight.data_ptr() == w["blocks"]["mlp.w12.weight"][2].data_ptr()
    assert model.storage_tokens.data_ptr() == w["top"]["storage_tokens"].data_ptr()


def _rec(kernels, family="dinov3"):
    fam = models.family(family)
    name = NAME.format(facet="token", layer=30) if family == "dinov3" else (
        "dinov2_version=vitl14_stride=14_facet=key_layer=18_norm=1")
    return {"family": family, "shape": fam.shape({"extractor_name": name}), "crop_px": 480,
            "batch": 32, "device_name": H100,
            "vit_window": SimpleNamespace(whole=True, kernels=kernels, copies=[])}


def test_kernel_readers_take_their_kernels_by_symbol():
    """Each reader sums the device time of the kernels the port names
    (attention_kernel; gemm_kernel<5>, the qkv GEMM with RoPE) and nothing
    else: 1 s of each over the family's counts and the H100's peaks; None
    where nothing matches or the family has no such counts."""
    fam = models.family("dinov3")
    peak = flops.peaks(H100)
    kernels = [("void (anonymous namespace)::attention_kernel<128, true>(...)", 0.0, 0.5),
               ("void (anonymous namespace)::attention_kernel<128, true>(...)", 1.0, 1.5),
               ("void (anonymous namespace)::gemm_kernel<5>(CUtensorMap_st, ...)", 2.0, 3.0),
               ("void (anonymous namespace)::gemm_kernel<4>(CUtensorMap_st, ...)", 3.0, 9.0)]
    rec = _rec(kernels)
    s = rec["shape"]
    attention = harness.reader("attention_roofline.offline")
    qkv = harness.reader("qkv_rope_roofline.offline")
    assert attention(rec) == pytest.approx(100.0 * max(
        fam.attention_flops_per_crop(s, 480) * 32 / peak["bf16_flops"],
        fam.attention_bytes(s, 480, 32) / peak["bytes_s"]), rel=1e-12)
    assert qkv(rec) == pytest.approx(100.0 * max(
        fam.qkv_flops_per_crop(s, 480) * 32 / peak["bf16_flops"],
        fam.qkv_bytes(s, 480, 32) / peak["bytes_s"]), rel=1e-12)
    for reader in (attention, qkv):
        assert reader(_rec(kernels[3:])) is None
        assert reader(_rec(kernels, family="dinov2")) is None
        assert reader({"family": "dinov3"}) is None
