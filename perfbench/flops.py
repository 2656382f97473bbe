"""Operations, bytes and the chip's peaks: the yardstick of rooflines and MFU.

Operations are 2 x multiply-adds of the dense products and attention,
counted from the configuration's shapes (the program's `utils/flops`,
frozen here). Bytes count each weight and each activation input read once
and each output written once, in the compute dtype.
"""

from __future__ import annotations

from perfbench.reference.vit import VitShape

# NVIDIA's data sheets, dense rates at the full power limit (700 W for the
# H100 SXM), keyed by torch.cuda.get_device_name.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "bytes_s": 3.35e12},
}


def peaks(device_name: str) -> dict:
    """The card's peaks; an unknown card raises rather than report a share
    of the wrong peak."""
    if device_name not in PEAKS:
        raise KeyError(f"no peaks for {device_name!r}: add them to PEAKS")
    return PEAKS[device_name]


def tokens(s: VitShape, crop_px: int) -> int:
    grid = crop_px // s.patch
    return grid * grid + 1 + s.registers


def vit_layer_flops(s: VitShape, n_tok: int) -> int:
    """One block over n_tok tokens of one image: qkv and proj, the MLP, and
    attention's two products."""
    d, h = s.embed_dim, s.mlp_hidden
    mlp_macs = 3 * d * h if s.swiglu else 2 * d * h
    return 2 * (n_tok * (4 * d * d + mlp_macs) + 2 * n_tok * n_tok * d)


def vit_flops_per_crop(s: VitShape, crop_px: int) -> int:
    """The facet forward of one crop: the patch embedding and the blocks
    it runs (a query, key or value facet adds one qkv projection)."""
    d = s.embed_dim
    grid = crop_px // s.patch
    n_tok = tokens(s, crop_px)
    patch = 2 * grid * grid * 3 * s.patch ** 2 * d
    layer = vit_layer_flops(s, n_tok)
    if s.facet == "token":
        return patch + (s.layer + 1) * layer
    return patch + s.layer * layer + 2 * n_tok * 3 * d * d


def vit_bytes(s: VitShape, crop_px: int, batch: int, elem: int = 2) -> int:
    """Bytes the ViT stage of one batch must move at least: every weight of
    the blocks it runs read once, the images read once, and each block's
    input tokens read and output tokens written once."""
    d, h = s.embed_dim, s.mlp_hidden
    mlp = 3 * d * h if s.swiglu else 2 * d * h
    per_block = 4 * d * d + mlp
    blocks = s.blocks_run
    weights = blocks * per_block + (3 * d * d if s.facet != "token" else 0)
    weights += 3 * s.patch ** 2 * d
    n_tok = tokens(s, crop_px)
    acts = batch * (crop_px * crop_px * 3 + 2 * blocks * n_tok * d + n_tok * d)
    return elem * (weights + acts)


def pipeline_flops_per_crop(s: VitShape, crop_px: int, pca_out: int, num_words: int,
                            bank_fmax: int, top_n_templates: int) -> int:
    """The whole coarse step of one crop: the ViT, PCA and word assignment
    of every query cell, and the buddies' distance products."""
    grid = crop_px // s.patch
    q = grid * grid
    retrieval = q * s.embed_dim * pca_out + q * num_words * pca_out
    buddies = top_n_templates * 2 * q * bank_fmax * pca_out
    return vit_flops_per_crop(s, crop_px) + 2 * (retrieval + buddies)
