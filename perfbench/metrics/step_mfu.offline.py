"""step_mfu.offline: the whole step's share of the card's bf16 peak, in
percent: the step's analytic operations a crop (the ViT's, by its backbone
family; PCA and word assignment of every query cell, the buddies' distance
products; perfbench.flops) times the crops a second of the traced run's
untraced window, over the peak."""

from perfbench import flops, models, stats


def read(rec):
    if "crops_per_s" not in rec:
        return None
    r, cfg = rec["repre"], rec["config"]
    fam, s, px = models.family(rec["family"]), rec["shape"], rec["crop_px"]
    per_crop = flops.pipeline_flops_per_crop(fam.vit_flops_per_crop(s, px), fam.feat_dim(s), px,
                                             rec["cell_px"], r["feat_dim"], r["num_words"],
                                             r["fmax"], cfg.top_n_templates)
    return stats.mfu_pct(per_crop, rec["crops_per_s"],
                         flops.peaks(rec["device_name"])["bf16_flops"])
