"""Operations and the chip's peaks: the yardstick of rooflines and MFU.

Operations are 2 x multiply-adds, counted from the configuration's shapes.
The ViT's operations and bytes are its backbone family's
(`perfbench/models/<family>.py`), and come here as numbers; the retrieval
and matching terms are counted here (the program's `utils/flops`, frozen).
"""

from __future__ import annotations

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


def pipeline_flops_per_crop(vit_flops: int, feat_dim: int, crop_px: int, cell_px: float,
                            pca_out: int, num_words: int, bank_fmax: int,
                            top_n_templates: int) -> int:
    """The whole coarse step of one crop: the ViT's `vit_flops` (its
    family's count), then PCA from `feat_dim` and word assignment of every
    query cell (one a grid cell of `cell_px`, as
    `reference.retrieval.grid_points` lays them) and the buddies' distance
    products."""
    q = int(crop_px / cell_px) ** 2
    retrieval = q * feat_dim * pca_out + q * num_words * pca_out
    buddies = top_n_templates * 2 * q * bank_fmax * pca_out
    return vit_flops + 2 * (retrieval + buddies)
