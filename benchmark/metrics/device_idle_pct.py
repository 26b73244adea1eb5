"""device_idle_pct: share of the traced window in which no kernel or copy
ran on the card, from the profiler's trace."""


def read(run):
    p = run.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
