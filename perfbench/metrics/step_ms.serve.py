"""step_ms.serve: milliseconds of `pose_from_crops` on one request's 16
crops (the reference's warp of its frame), CUDA events around each of 10
calls made back to back, the median."""


def read(rec):
    return rec.get("stage_ms", {}).get("step")
