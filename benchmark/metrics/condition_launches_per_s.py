"""condition_launches_per_s: the stream front end's kernel launches per
second of signal over the window, from the program's exact launch counter
(`ops.xlate_fir.launches`)."""


def read(run):
    n = getattr(run, "cond_launches", None)
    return n / run.signal_s if n and run.signal_s > 0 else None
