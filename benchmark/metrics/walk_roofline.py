"""walk_roofline: the least time of the traced segments' tracking work
(`gnssbench.roofline`) over the device time of every kernel those
segments launched (the profiler's trace), in percent."""

from gnssbench.roofline import least_time


def read(run):
    p = run.profile
    if not p or not run.traced or p["kernel_s"] <= 0:
        return None
    return 100.0 * sum(least_time(w)[0] for w in run.traced) / p["kernel_s"]
