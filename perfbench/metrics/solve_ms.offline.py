"""solve_ms.offline: milliseconds of the solve stage on one batch
(`inference.solve_batch`: RANSAC-PnP scored by kernel 2, LO, LM), CUDA
events around the stage's calls, the median of 5; the stages are called one
after another on inputs made once."""


def read(rec):
    return rec.get("stage_ms", {}).get("solve")
