"""vit_roofline.offline: the ViT stage's share of its roofline, in percent.

The work is fixed by the configuration, whatever kernels run it: the
facet forward's analytic operations for the batch and the bytes it must
move at least (its backbone family's counts). The least time is the
larger of operations over the card's bf16 peak and bytes over its
bandwidth; the share is that over the summed device time of every kernel
and copy in a whole profiled call of the ViT stage."""

from perfbench import flops, models, stats


def read(rec):
    win = rec.get("vit_window")
    if win is None or not win.whole:
        return None
    device_s = sum(e - s for _, s, e in win.kernels + win.copies)
    if device_s <= 0:
        return None
    peak = flops.peaks(rec["device_name"])
    fam, s, px, b = models.family(rec["family"]), rec["shape"], rec["crop_px"], rec["batch"]
    return stats.roofline_pct(fam.vit_flops_per_crop(s, px) * b, fam.vit_bytes(s, px, b),
                              device_s, peak["bf16_flops"], peak["bytes_s"])
