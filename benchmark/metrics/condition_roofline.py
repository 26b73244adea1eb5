"""condition_roofline: the least time of the traced segments' conditioning
work (`gnssbench.roofline_front_end`) over the device time of the front
end's kernels in the traced window (by name, from the profiler's trace),
in percent."""

from gnssbench.roofline_front_end import least_time


def read(run):
    work = getattr(run, "cond_traced", None)
    t = getattr(run, "cond_device_s", None)
    if not work or not t:
        return None
    return 100.0 * sum(least_time(w)[0] for w in work) / t
