"""Entry `symbols`: `Receiver.process`'s steady state.

The capture lies in device memory (complex64 at unit RMS, as
`Receiver.preload` keeps it).  Each 1 s segment (25 blocks of 40 ms, the
receiver's `reacq_interval_blocks`) goes through
`TrackingEngine.track_capture_symbols` with every channel's symbol
boundary, and its `SymbolOutputs` are on the host when the call returns,
before the next segment starts.  A pass walks the capture's segments from
the truth's activation state; passes repeat until the window closes.

A segment's latency runs from the call to its return (rows on the host).
The traced run times the capture entry inside the call
(`ops.track_capture.track_capture`, the enqueue of every kernel of the
segment) from a wrapper installed here, and the rest of the call (the
symbol-grid reduction and its read to the host) as the readback.
"""

from __future__ import annotations

import time

import numpy as np
from gnss_sdr_1_tpu_torch.ops import track_capture as tcap

from gnssbench import check


def _sym_off(ctx, sym_count):
    """Each channel's next symbol boundary as an epoch in [1, N] (the
    receiver's `_symbol_offsets` with the truth's bit sync)."""
    N = ctx.signal["symbol_epochs"]
    bit0 = np.array([t.bit0 for t in ctx.truth])
    return (((bit0 - sym_count - 1) % N) + 1).astype(np.int32)


def prepare(ctx) -> None:
    ctx.n_sym = int(ctx.signal["symbol_epochs"])


def _segment(ctx, state, k, sym_count):
    seg = ctx.capture[k * ctx.span:k * ctx.span + ctx.span + ctx.nmax]
    off = _sym_off(ctx, sym_count)
    return ctx.engine.track_capture_symbols(seg, state, ctx.span, off,
                                            ctx.n_sym)


def warm_up(ctx) -> None:
    """The mix's `warmup_segments` segments of the cell's own shapes
    (builds and loads the kernels), each from the start of a pass."""
    C = len(ctx.truth)
    for k in range(int(ctx.cell.mix["warmup_segments"])):
        _segment(ctx, ctx.init_state, k, np.zeros(C, np.int64))


def window(ctx, deadline: float, tracer) -> None:
    C = len(ctx.truth)
    entry_span = {}
    orig = tcap.track_capture
    if tracer.enabled:
        def timed(*a, **k):
            t = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                entry_span["t"] = (t, time.perf_counter())
        tcap.track_capture = timed
    try:
        p = k = 0
        state, sym_count = ctx.init_state, np.zeros(C, np.int64)
        while time.perf_counter() < deadline:
            if k == ctx.n_seg:
                p, k = p + 1, 0
                state, sym_count = ctx.init_state, np.zeros(C, np.int64)
            traced = tracer.begin()
            t_hand = time.perf_counter()
            with tracer.span("track_capture_symbols"):
                st, souts = _segment(ctx, state, k, sym_count)
            t_rows = time.perf_counter()
            rec = {"t_hand": t_hand, "t_rows": t_rows}
            if "t" in entry_span:
                t_a, t_b = entry_span.pop("t")
                rec["launch_s"] = t_b - t_a
                rec["readback_s"] = t_rows - t_b
            ctx.segments.append(rec)
            if traced:
                ctx.traced.append(_work(ctx, souts))
            tracer.end(traced)
            if (p, k) in ctx.keep:
                ctx.kept[(p, k)] = (state, st, souts, sym_count)
            sym_count = sym_count + souts.n_valid
            state, k = st, k + 1
        tracer.finish()
    finally:
        tcap.track_capture = orig


def _work(ctx, souts) -> dict:
    """The segment's tracking work for the roofline: valid epochs and the
    samples they correlate, the input and the rows read back."""
    eng = ctx.engine
    C = len(ctx.truth)
    n_valid = int(np.sum(souts.n_valid))
    S = souts.vcount.shape[0]
    return {"valid_epochs": n_valid,
            "samples": n_valid * float(eng.cfg.samples_per_code),
            "taps": eng.cfg.n_taps, "channels": C,
            "input_bytes": (ctx.span + ctx.nmax) * 8,
            "table_bytes": ctx.codes.size * 4,
            "state_bytes": 2 * C * 4 * (21 + 2 * eng.cfg.n_taps + 12),
            "out_bytes": S * C * 4 * 9 + C * 4 * 2}


def compare(ctx, control=None) -> check.Numbers:
    """The kept segments against the reference: the start from the truth,
    then each kept segment, walked from the reference's own state and
    symbol count where it follows a kept segment of its pass
    (`check.walk_from`), else from the state and count the program
    entered it with: its symbol-grid rows and the state it left.
    `control` (a rounding) puts the reference at that precision in the
    program's place."""
    ref, numbers = check.reference_for(ctx), check.Numbers()
    check.compare_start(ctx, ref, numbers)
    walkers = {"ref": None} if control is None else {"ref": None,
                                                     "low": control}
    prev, count = {}, {}                # walker -> (key, exit rows), symbols
    for key, (st_in, st_out, souts, sym_in) in sorted(ctx.kept.items()):
        k = key[1]
        x = ctx.capture[k * ctx.span:k * ctx.span + ctx.span + ctx.nmax].cpu()
        outs = {}
        for who, lowp in walkers.items():
            c_in = (np.zeros_like(sym_in) if key == (0, 0)
                    else count[who] if check.follows(key, prev.get(who))
                    else sym_in)
            rows = check.walk_from(ctx, ref, key, st_in, prev.get(who))
            of, oi, oc, fst2, ist2 = ref.walk(x, *rows, ctx.span, lowp=lowp)
            sym = ref.symbol_outputs(of, oi, oc, rows[0][check.tc.F_REM_CODE],
                                     _sym_off(ctx, c_in), ctx.n_sym)
            prev[who] = (key, check.next_rows(fst2, ist2, rows[2], ctx.span))
            count[who] = c_in + sym["n_valid"]
            outs[who] = (sym, check.rows_state(fst2, ist2, ctx.span))
        want, want_state = outs["ref"]
        got, got_state = outs["low"] if control is not None else (
            {f: np.asarray(getattr(souts, f)) for f in want},
            check.state_fields(st_out))
        check.compare_symbols(got, want, ctx.n_sym, numbers)
        check.compare_exit(got_state, want_state, ref.t0_int / 2, numbers)
    return numbers
