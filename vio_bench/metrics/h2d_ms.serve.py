"""h2d_ms.serve: device milliseconds of host-to-device copies per engine
step, from the profiler's memcpy records in the traced window (the
windows staged onto the card). Moves window_p95_ms."""


def read(run):
    steps = run.counts.get("steps", 0)
    if run.trace is None or not steps:
        return None
    return run.trace.device_time_s("HtoD", cat="gpu_memcpy") / steps * 1e3
