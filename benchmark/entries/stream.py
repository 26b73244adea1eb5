"""Entry `stream`: `Receiver.process_stream`'s tracking half.

The capture's raw ishort items lie in ordinary host memory, as a file or
socket source hands them over.  For each 1 s segment (25 blocks of 40 ms
and the epoch tail, as process_stream slices it) `PinnedStaging.upload`
stages the items in pinned memory and copies them to the card, and
`unpack_raw` makes them complex64 there at the receiver's ingest scale;
`TrackingEngine.launch_capture` enqueues the segment and queues its
per-epoch rows' copy to pinned memory.  Segment k+1 is launched before
segment k is harvested (`harvest_capture`), as process_stream does.  A
pass walks the capture's segments from the truth's activation state;
passes follow one another in the same pipeline until the window closes.

A segment's latency runs from its upload call to its harvest's return
(rows on the host).  Spans: ingest (upload + unpack), launch
(launch_capture), readback (harvest_capture).
"""

from __future__ import annotations

import collections
import time

import numpy as np
from gnss_sdr_1_tpu_torch.runtime.stream import PinnedStaging, unpack_raw

from gnssbench import check


def prepare(ctx) -> None:
    ctx.staging = PinnedStaging(ctx.device)
    ctx.n_items = 2 * (ctx.span + ctx.nmax)


def _ingest(ctx, k):
    a = 2 * k * ctx.span
    raw = ctx.items[a:a + ctx.n_items]
    return unpack_raw(ctx.staging.upload(raw), "ishort",
                      ctx.scale)[:ctx.span + ctx.nmax]


def warm_up(ctx) -> None:
    """The mix's `warmup_segments` segments through the pipeline (three
    fill both staging buffers and the pinned readback buffers the steady
    state reuses)."""
    eng, state, pending = ctx.engine, ctx.init_state, []
    for k in range(int(ctx.cell.mix["warmup_segments"])):
        state, rb = eng.launch_capture(_ingest(ctx, k), state, ctx.span)
        pending.append(rb)
        if len(pending) > 1:
            eng.harvest_capture(pending.pop(0))
    while pending:
        eng.harvest_capture(pending.pop(0))


def window(ctx, deadline: float, tracer) -> None:
    eng = ctx.engine
    pending = collections.deque()

    def harvest():
        rec, key, st_in, st_out, rb, traced = pending.popleft()
        t = time.perf_counter()
        with tracer.span("harvest_capture"):
            outs = eng.harvest_capture(rb)
        rec["t_rows"] = time.perf_counter()
        rec["readback_s"] = rec["t_rows"] - t
        if traced:
            ctx.traced.append(_work(ctx, outs))
        tracer.end(traced)
        if key in ctx.keep:
            ctx.kept[key] = (st_in, st_out, {
                f: np.array(getattr(outs, f)) for f in outs._fields})

    p = k = 0
    state = ctx.init_state
    while time.perf_counter() < deadline:
        if k == ctx.n_seg:
            p, k, state = p + 1, 0, ctx.init_state
        traced = tracer.begin()
        t_hand = time.perf_counter()
        with tracer.span("upload_unpack"):
            seg = _ingest(ctx, k)
        t_in = time.perf_counter()
        with tracer.span("launch_capture"):
            st, rb = eng.launch_capture(seg, state, ctx.span)
        t_l = time.perf_counter()
        rec = {"t_hand": t_hand, "ingest_s": t_in - t_hand,
               "launch_s": t_l - t_in}
        ctx.segments.append(rec)
        pending.append((rec, (p, k), state, st, rb, traced))
        state, k = st, k + 1
        if len(pending) > 1:
            harvest()
    while pending:
        harvest()
    tracer.finish()


def _work(ctx, outs) -> dict:
    """The segment's tracking work for the roofline: the valid epochs, the
    samples they correlate, the raw input and the rows read back."""
    eng = ctx.engine
    K = eng.cfg.n_taps
    n, C = outs.valid.shape
    return {"valid_epochs": int(outs.valid.sum()),
            "samples": float(outs.cur_len[outs.valid].sum()),
            "taps": K, "channels": C,
            "input_bytes": ctx.n_items * 2,
            "table_bytes": ctx.codes.size * 4,
            "state_bytes": 2 * C * 4 * (21 + 2 * K + 12),
            "out_bytes": n * C * 4 * (7 + 2 + 2 * K)}


def compare(ctx, control=None) -> check.Numbers:
    """The kept segments against the reference: the start from the truth,
    then each kept segment, walked from the reference's own state where
    it follows a kept segment of its pass (`check.walk_from`), else from
    the state the program entered it with, the reference unpacking the
    same raw items itself: every per-epoch row and the state it left.
    `control` (a rounding) puts the reference at that precision in the
    program's place."""
    ref, numbers = check.reference_for(ctx), check.Numbers()
    check.compare_start(ctx, ref, numbers)
    walkers = {"ref": None} if control is None else {"ref": None,
                                                     "low": control}
    prev = {}                           # walker -> (key, exit rows)
    for key, (st_in, st_out, outs) in sorted(ctx.kept.items()):
        a = 2 * key[1] * ctx.span
        x = check.unpack_ishort(ctx.items[a:a + ctx.n_items], ctx.scale)
        n_gap = check.gap_rows(ctx, key, prev.get("ref"))
        walked = {}
        for who, lowp in walkers.items():
            rows = check.walk_from(ctx, ref, key, st_in, prev.get(who))
            of, oi, oc, fst2, ist2 = ref.walk(x, *rows, ctx.span, lowp=lowp)
            prev[who] = (key, check.next_rows(fst2, ist2, rows[2], ctx.span))
            walked[who] = (check.rows_outputs(ref, of, oi, oc),
                           check.rows_state(fst2, ist2, ctx.span))
        want, want_state = walked["ref"]
        got, got_state = walked["low"] if control is not None else (
            outs, check.state_fields(st_out))
        check.compare_epochs(ref, got, want, numbers, n_gap)
        check.compare_exit(got_state, want_state, ref.t0_int / 2, numbers)
    return numbers
