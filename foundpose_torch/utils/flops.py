"""Analytic FLOP model of the online pipeline (counterpart of
foundpose_tpu/utils/flops.py, copied: the port imports nothing of the JAX
package).

Operations are counted from the configuration's shapes: 2 x multiply-adds
of the dense products and attention. `chip_smoke.py` takes the ViT block's
bound from `vit_layer_flops`.
"""

from __future__ import annotations


def vit_layer_flops(vit_cfg, n_tok: int) -> int:
    """2 * MACs of one transformer block over `n_tok` tokens of one image:
    qkv and proj (4 d^2 a token), the MLP (2 d h, or 3 d h for SwiGLU's
    w12 [d, 2h] and w3 [h, d]) and attention's two products (2 n_tok^2 d)."""
    d = vit_cfg.embed_dim
    h = vit_cfg.mlp_hidden
    mlp_macs = 3 * d * h if vit_cfg.swiglu else 2 * d * h
    return 2 * (n_tok * (4 * d * d + mlp_macs) + 2 * n_tok * n_tok * d)


def vit_flops_per_crop(vit_cfg, crop_px: int) -> int:
    """2 * MACs of the truncated facet forward at `crop_px` input.

    Facet-aware: "token" runs blocks [0, layer]; q/k/v facets run
    [0, layer) plus one qkv projection (models/dinov2.extract_facet).
    """
    d = vit_cfg.embed_dim
    grid = crop_px // vit_cfg.patch_size
    n_tok = grid * grid + 1 + vit_cfg.num_register_tokens
    patch = 2 * grid * grid * 3 * vit_cfg.patch_size**2 * d
    layer = vit_layer_flops(vit_cfg, n_tok)
    if vit_cfg.facet == "token":
        return patch + (vit_cfg.layer + 1) * layer
    return patch + vit_cfg.layer * layer + 2 * n_tok * 3 * d * d


def pipeline_flops_per_crop(
    vit_cfg,
    crop_px: int,
    pca_in: int,
    pca_out: int,
    num_words: int,
    bank_fmax: int,
    top_n_templates: int,
) -> int:
    """2 * MACs of ViT + PCA/word retrieval + buddy distance matmuls."""
    grid = crop_px // vit_cfg.patch_size
    q = grid * grid
    retrieval = q * pca_in * pca_out + q * num_words * pca_out
    buddies = top_n_templates * 2 * q * bank_fmax * pca_out
    return vit_flops_per_crop(vit_cfg, crop_px) + 2 * (retrieval + buddies)
