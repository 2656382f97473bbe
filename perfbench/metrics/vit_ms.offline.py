"""vit_ms.offline: milliseconds of the ViT stage on one batch
(`preprocess_crops` and the backbone family's `extract`), CUDA events around
the stage's calls, the median of 5; the stages are called one after another
on inputs made once."""


def read(rec):
    return rec.get("stage_ms", {}).get("vit")
