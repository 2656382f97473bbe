"""retrieval_ms.offline: milliseconds of the retrieval stage on one batch
(`inference.retrieve_batch`: query grid, PCA, tf-idf), CUDA events around
the stage's calls, the median of 5; the stages are called one after another
on inputs made once."""


def read(rec):
    return rec.get("stage_ms", {}).get("retrieval")
