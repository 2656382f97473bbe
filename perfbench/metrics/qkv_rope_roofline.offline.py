"""qkv_rope_roofline.offline: the qkv GEMMs with RoPE in their epilogue,
share of their roofline, in percent.

The kernels are those of the profiled ViT stage (`rec["vit_window"]`) that
the port names `gemm_kernel<5>` (csrc/vit_block.cu's EPI_QKV_ROPE: the qkv
projection that rotates q and k of the patch tokens; one launch a block).
Their work is the backbone family's qkv operations for the batch and least
bytes (weights, input, q, k and v, the rotary tables); the least time, the
larger of operations over the card's bf16 peak and bytes over its
bandwidth, over the kernels' summed device time. None where the window is
not whole, where no kernel of that name ran, or where the family gives no
qkv counts."""

from perfbench import flops, models, stats

SYMBOL = "gemm_kernel<5>"


def read(rec):
    win = rec.get("vit_window")
    fam = models.family(rec["family"]) if "family" in rec else None
    if win is None or not win.whole or not hasattr(fam, "qkv_flops_per_crop"):
        return None
    device_s = sum(e - s for name, s, e in win.kernels if SYMBOL in name)
    if device_s <= 0:
        return None
    peak = flops.peaks(rec["device_name"])
    s, px, b = rec["shape"], rec["crop_px"], rec["batch"]
    return stats.roofline_pct(fam.qkv_flops_per_crop(s, px) * b, fam.qkv_bytes(s, px, b),
                              device_s, peak["bf16_flops"], peak["bytes_s"])
