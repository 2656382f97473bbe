"""attention_roofline.offline: kernel 1's attention kernels' share of their
roofline, in percent.

The kernels are those of the profiled ViT stage (`rec["vit_window"]`) that
the port names `attention_kernel` (csrc/vit_block.cu; one launch a block).
Their work is the backbone family's attention operations for the batch
(q k^T and p v in every block run) and least bytes (q, k and v read and the
output written once); the least time, the larger of operations over the
card's bf16 peak and bytes over its bandwidth, over the kernels' summed
device time. None where the window is not whole, where no kernel of that
name ran, or where the family gives no attention counts."""

from perfbench import flops, models, stats

SYMBOL = "attention_kernel"


def read(rec):
    win = rec.get("vit_window")
    fam = models.family(rec["family"]) if "family" in rec else None
    if win is None or not win.whole or not hasattr(fam, "attention_flops_per_crop"):
        return None
    device_s = sum(e - s for name, s, e in win.kernels if SYMBOL in name)
    if device_s <= 0:
        return None
    peak = flops.peaks(rec["device_name"])
    s, px, b = rec["shape"], rec["crop_px"], rec["batch"]
    return stats.roofline_pct(fam.attention_flops_per_crop(s, px) * b,
                              fam.attention_bytes(s, px, b), device_s, peak["bf16_flops"],
                              peak["bytes_s"])
