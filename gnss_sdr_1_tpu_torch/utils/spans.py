"""Host spans and counts at the port's layer boundaries, on the clock of
torch.profiler's trace.

A span names one piece of host work (`stream.upload`, `engine.enqueue`,
`receiver.harvest`, ...) with its start and end in
`time.perf_counter_ns`, its own id, its parent's (the span open on the
same thread when it began) and its segment: the id of the outermost span
of its call tree, or the segment a caller hands over, so that a harvest
joins the spans of the launch it completes although another launch came
in between.  A wait span (`wait`) marks a place where the host blocks on
a CUDA device.  Counts ride on the span that makes them
(`pinned_allocs=3` on `engine.read_back`, `bytes=` on
`stream.upload.stage`).

Spans record only while torch's profiler runs or inside `recording()`.
Otherwise a span site costs one flag check and allocates nothing.  They
are never profiler ranges: a `record_function` range becomes a CUDA-typed
annotation over the kernels launched inside it, which a reader of the
device trace would take for device work.

Finished spans are kept in a bounded ring (`records()`, the newest
`CAPACITY`).  `dump(path)` writes them as Chrome-trace JSON on the
profiler's clock (Unix-epoch ns, as `torch.profiler` stamps its events;
each outermost span measures the offset from `perf_counter_ns` to it), to
open beside, or merged into, `prof.export_chrome_trace`.

    with torch.profiler.profile(...) as prof:      # or spans.recording()
        rx.process(x)
    prof.export_chrome_trace("trace.json")
    spans.dump("spans.json", profiler_trace="trace.json")
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import os
import threading
import time

from torch.autograd import profiler as _profiler

CAPACITY = 1 << 14

_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()
_forced = 0                     # depth of open recording() blocks


class Span:
    """One recorded span; `count` adds to its counts."""

    __slots__ = ("name", "wait", "id", "parent", "segment", "start_ns",
                 "end_ns", "clock_ns", "tid", "counts")

    def __init__(self, name: str, segment: int | None, wait: bool):
        self.name, self.wait, self.segment = name, wait, segment
        self.counts: dict = {}

    def __enter__(self) -> "Span":
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
            _local.tid = threading.get_native_id()
        self.id, self.tid = next(_ids), _local.tid
        if stack:
            top = stack[-1]
            self.parent, self.clock_ns = top.id, top.clock_ns
            if self.segment is None:
                self.segment = top.segment
        else:
            self.parent, self.clock_ns = None, _clock_offset_ns()
            if self.segment is None:
                self.segment = self.id
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, typ, value, tb) -> bool:
        self.end_ns = time.perf_counter_ns()
        _local.stack.pop()
        _ring.append(self)
        return False

    def count(self, key: str, n: int = 1) -> None:
        self.counts[key] = self.counts.get(key, 0) + n

    @property
    def dur_ns(self) -> int:
        return self.end_ns - self.start_ns


class _Off:
    """What a span site gets while nothing records: enters, counts and
    tests false without doing anything."""

    __slots__ = ()
    segment = None

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, typ, value, tb) -> bool:
        return False

    def count(self, key: str, n: int = 1) -> None:
        pass


OFF = _Off()


def span(name: str, segment: int | None = None):
    """A span of host work named `name`, to enter with `with`; `segment`
    joins it to an earlier segment's spans."""
    if _forced or _profiler._is_profiler_enabled:
        return Span(name, segment, False)
    return OFF


def wait(name: str, segment: int | None = None):
    """A span where the host blocks on a CUDA device."""
    if _forced or _profiler._is_profiler_enabled:
        return Span(name, segment, True)
    return OFF


def traced(name: str):
    """Decorator: the function's every call is a span named `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without the profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def records() -> list:
    """The finished spans in the ring, in order of their start."""
    return sorted(_ring, key=lambda s: s.start_ns)


def clear() -> None:
    _ring.clear()


def _clock_offset_ns() -> int:
    """Unix-epoch ns (the profiler's clock) minus perf_counter_ns, read
    between two perf_counter reads."""
    a = time.perf_counter_ns()
    w = time.time_ns()
    b = time.perf_counter_ns()
    return w - (a + b) // 2


def dump(path, profiler_trace=None) -> int:
    """Write the recorded spans to `path` as Chrome-trace JSON ("X"
    events in µs on the profiler's clock); with `profiler_trace` (a file
    of `prof.export_chrome_trace`), its events and the spans together on
    its time base.  Returns the spans written."""
    if profiler_trace is None:
        doc = {"traceEvents": [], "displayTimeUnit": "ms"}
    else:
        with open(profiler_trace) as f:
            doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid, ev = os.getpid(), []
    for s in records():
        args = {"id": s.id, "parent": s.parent, "segment": s.segment}
        if s.wait:
            args["wait"] = 1
        args.update(s.counts)
        ev.append({"name": s.name, "cat": "wait" if s.wait else "host",
                   "ph": "X", "pid": pid, "tid": s.tid,
                   "ts": (s.start_ns + s.clock_ns - base) / 1e3,
                   "dur": s.dur_ns / 1e3, "args": args})
    doc["traceEvents"] = list(doc["traceEvents"]) + ev
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(ev)
