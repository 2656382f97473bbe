"""match_ms.offline: milliseconds of the matching stage on one batch
(`inference.match_batch`: cyclic buddies, kernel 3), CUDA events around the
stage's calls, the median of 5; the stages are called one after another on
inputs made once."""


def read(rec):
    return rec.get("stage_ms", {}).get("match")
