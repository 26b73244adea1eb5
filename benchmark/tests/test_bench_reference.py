"""The benchmark's reference against the port's plain path at a tiny
size: the same codes, the same activation, and the same rows, bit for bit
(both run the same float32 expressions on the CPU)."""

import numpy as np
import pytest
import torch
from conftest import CELLS, tiny_cell

from gnssbench import check, harness
from gnssbench import signal as sig
from gnssbench.reference import chain as tc


def _ctx(name):
    ctx = harness.Ctx(tiny_cell(name), 2**31 + 11, torch.device("cpu"))
    harness.build_program(ctx)
    harness.make_inputs(ctx)
    ctx.init_state = harness.program_state(ctx)
    return ctx, check.reference_for(ctx)


def test_codes_equal_the_ports_replicas():
    from gnss_sdr_1_tpu_torch.codes import tracking_replica

    for p in range(1, 13):
        assert np.array_equal(sig.gps_l1ca_code(p),
                              tracking_replica("1C", p)[0])
    for p in range(1, 9):
        assert np.array_equal(sig.galileo_e1b_sinboc(p),
                              tracking_replica("1B", p)[0])


@pytest.mark.parametrize("name", CELLS)
def test_walk_equals_the_ports_plain_walk(name):
    ctx, ref = _ctx(name)
    numbers = check.Numbers()
    check.compare_start(ctx, ref, numbers)
    assert numbers.start == 0
    if ctx.capture is not None:
        x = ctx.capture[:ctx.span + ctx.nmax]
    else:
        x = check.unpack_ishort(ctx.items[:2 * (ctx.span + ctx.nmax)],
                                ctx.scale)
    st, rb = ctx.engine.launch_capture(x, ctx.init_state, ctx.span)
    got = ctx.engine.harvest_capture(rb)
    fst, ist, slot = ref.pack(check.state_fields(ctx.init_state), ctx.span)
    of, oi, oc, fst2, ist2 = ref.walk(x, fst, ist, slot, ctx.span)
    want = check.rows_outputs(ref, of, oi, oc)
    assert want["valid"].sum() > 0
    for f, w in want.items():
        assert np.array_equal(np.asarray(getattr(got, f)), w), f
    exit_want = check.rows_state(fst2, ist2, ctx.span)
    exit_got = check.state_fields(st)
    for f, w in exit_want.items():
        assert np.array_equal(exit_got[f], w), f


def test_symbol_grid_equals_the_ports():
    ctx, ref = _ctx("gps_l1ca_8ch.symbols")
    entry = harness.load_module("entries", "symbols")
    entry.prepare(ctx)
    seg = ctx.capture[:ctx.span + ctx.nmax]
    off = entry._sym_off(ctx, np.zeros(len(ctx.truth), np.int64))
    st, souts = ctx.engine.track_capture_symbols(seg, ctx.init_state,
                                                 ctx.span, off, ctx.n_sym)
    fields = check.state_fields(ctx.init_state)
    fst, ist, slot = ref.pack(fields, ctx.span)
    of, oi, oc, _, _ = ref.walk(seg, fst, ist, slot, ctx.span)
    assert int((of[:, tc.O_VALID] > 0.5).sum()) > 0
    want = ref.symbol_outputs(
        of, oi, oc, torch.as_tensor(fields["rem_code_phase_samples"]), off,
        ctx.n_sym)
    for f, w in want.items():
        assert np.array_equal(np.asarray(getattr(souts, f)), w), f
