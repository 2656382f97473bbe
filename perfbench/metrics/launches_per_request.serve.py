"""launches_per_request.serve: host kernel-launch calls of one warm
`PoseEngine.estimate`, from a whole profiler window."""


def read(rec):
    win = rec.get("request_window")
    return win.launches if win is not None and win.whole else None
