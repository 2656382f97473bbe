"""launches_per_step.offline: host kernel-launch calls of one
`pose_from_crops` over one batch, from a whole profiler window. It is
left out when no window kept every kernel, or when the window recorded
fewer launches than the port's own launch counters counted in the call."""


def read(rec):
    win = rec.get("step_window")
    if win is None or not win.whole:
        return None
    port = sum(rec.get("port_launches", {}).values())
    return win.launches if win.launches >= port else None
