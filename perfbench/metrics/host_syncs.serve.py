"""host_syncs.serve: host syncs of one warm `PoseEngine.estimate` under the
CUDA sync debug mode "warn" (one warning at each sync). The fetch of the
answers is one."""


def read(rec):
    return rec.get("syncs")
