"""The traced run's device trace: torch.profiler over the window's first
segments, kept in memory and reduced to a summary.

The busy time is the union of the device's kernel and copy intervals
inside the traced window (the arithmetic of `tools/profile_torch_port.py`,
copied); the idle gaps are what is left of the window, each named by the
harness span the host was in at the gap's middle.
"""

from __future__ import annotations

import contextlib
import warnings

import torch

TOP = 10


class Tracer:
    """Profiles the window's first `n` segments (`begin` at a hand-off,
    `end` when that segment's rows are on the host)."""

    def __init__(self, enabled: bool, n: int):
        self.enabled, self.n = enabled, n
        self.ended = 0
        self.stopped = False
        self.prof = None
        self.window = None
        self.summary = None

    def warm_up(self, fn) -> None:
        """Profile `fn()` once and drop the trace: the profiler's own
        start-up (CUPTI's) belongs to set-up, not to the window."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                fn()
                torch.cuda.synchronize()

    def begin(self) -> bool:
        """At a segment's hand-off: True while the profiler runs.  A
        segment handed over before the n-th one's rows are in (the stream
        path launches k+1 before it harvests k) is traced too, so the
        work of every segment whose kernels the trace holds is counted."""
        if not self.enabled or self.stopped:
            return False
        if self.prof is None:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.window = torch.profiler.record_function("bench/window")
            self.window.__enter__()
        return True

    def span(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench/{name}")

    def end(self, traced: bool) -> None:
        """When a segment's rows are on the host: the n-th traced one
        stops the profiler once the card has finished what was launched."""
        if traced:
            self.ended += 1
            if self.ended == self.n and self.prof is not None:
                self._stop()

    def finish(self) -> None:
        if self.prof is not None:
            self._stop()

    def _stop(self) -> None:
        torch.cuda.synchronize()
        self.window.__exit__(None, None, None)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self.prof.stop()
        self.summary = summarize(self.prof)
        self.prof = None
        self.stopped = True


def _events(prof):
    """(device intervals [(start_ns, end_ns, name)], host spans).  A
    harness span shows on the device too, as an annotation over the work
    it launched: that copy is not device work."""
    evs = prof.profiler.kineto_results.events()
    dev, host = [], []
    for e in evs:
        start, dur, name = e.start_ns(), e.duration_ns(), e.name()
        if name.startswith("bench/"):
            if "CUDA" not in str(e.device_type()):
                host.append((start, start + dur, name[6:]))
        elif "CUDA" in str(e.device_type()):
            dev.append((start, start + dur, name))
    return dev, host


def union(intervals) -> list:
    """Merged [start, end) intervals of a list of (start, end, ...)."""
    out = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


# the program's tracking kernels, whose launches its counters count
TRACKING_KERNELS = ("chunk_corr_kernel", "track_chain_kernel",
                    "gather_block_kernel")


def summarize(prof) -> dict:
    dev, host = _events(prof)
    win = [h for h in host if h[2] == "window"]
    if not win:
        return None
    w0, w1 = win[0][0], win[0][1]
    spans = [h for h in host if h[2] != "window"]
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev
           if e > w0 and s < w1]
    busy = union(dev)
    busy_ns = sum(e - s for s, e in busy)
    by_name: dict[str, float] = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9
    gaps: dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        inside = [h for h in spans if h[0] <= mid < h[1]]
        name = (min(inside, key=lambda h: h[1] - h[0])[2] if inside
                else "harness")
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy_ns * 1e-9, "window_s": (w1 - w0) * 1e-9,
            "kernel_s": sum(t for n, t in by_name.items()
                            if not is_copy(n)),
            "tracking_kernels": sum(
                1 for _, _, n in dev
                if any(k in n.split("<")[0] for k in TRACKING_KERNELS)),
            "device_ops": [[n[:160], t] for n, t in top[:TOP]],
            "idle_gaps": [[n, t] for n, t in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:TOP]]}
