"""device_idle.serve: the share of the traced serving window in which no
device operation ran (one minus the union of kernel, copy and memset
intervals over the window). Moves window_p95_ms."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
