"""The check fails what it must: the control (the reference one precision
below the configuration's, in the program's place) and each fault a
tracking cell can have, planted under the timed path of a run cut to a CPU
test's size.  A sound run of the same size passes."""

import time

import pytest
import torch
from conftest import CELLS, tiny_cell

from gnssbench import check, harness


def state_unchanged(ctx):
    """The segment's walk hands back the state it was given."""
    orig = ctx.engine._run_capture

    def walk(samples, state, limit, n_epochs):
        _, *rows = orig(samples, state, limit, n_epochs)
        return (state, *rows)

    ctx.engine._run_capture = walk


def half_the_channels(ctx):
    """The upper half of the channels is left out of every walk."""
    orig = ctx.engine._run_capture

    def walk(samples, state, limit, n_epochs):
        act = state.active.clone()
        act[act.shape[0] // 2:] = False
        return orig(samples, state._replace(active=act), limit, n_epochs)

    ctx.engine._run_capture = walk


def one_answer_altered(ctx):
    """One data symbol of each segment comes out with its sign flipped
    where it is produced: a prompt of the per-epoch rows, or a slot mean
    of the symbol grid."""
    eng = ctx.engine
    if ctx.cell.mix["entry"] == "symbols":
        orig_sym = eng._symbol_outputs

        def reduce(*a, **k):
            s = orig_sym(*a, **k)
            mean_i = s.mean_i.copy()
            mean_i[2, 0] = -mean_i[2, 0]
            return s._replace(mean_i=mean_i)

        eng._symbol_outputs = reduce
        return
    orig = eng._run_capture
    p = eng.cfg.prompt_index

    def walk(samples, state, limit, n_epochs):
        st, out_f, out_i, out_corr = orig(samples, state, limit, n_epochs)
        out_corr = out_corr.clone()
        out_corr[5, p, 0] = -out_corr[5, p, 0]
        return st, out_f, out_i, out_corr

    eng._run_capture = walk


def one_channel_correlators_off(ctx):
    """One channel's correlators come out 1 % too large where they are
    produced: its per-epoch rows, or its slot means of the symbol grid."""
    eng = ctx.engine
    if ctx.cell.mix["entry"] == "symbols":
        orig_sym = eng._symbol_outputs

        def reduce(*a, **k):
            s = orig_sym(*a, **k)
            mean_i, mean_q = s.mean_i.copy(), s.mean_q.copy()
            mean_i[:, 1] *= 1.01
            mean_q[:, 1] *= 1.01
            return s._replace(mean_i=mean_i, mean_q=mean_q)

        eng._symbol_outputs = reduce
        return
    orig = eng._run_capture

    def walk(samples, state, limit, n_epochs):
        st, out_f, out_i, out_corr = orig(samples, state, limit, n_epochs)
        out_corr = out_corr.clone()
        out_corr[:, :, 1] *= 1.01
        return st, out_f, out_i, out_corr

    eng._run_capture = walk


def one_channel_drifts(ctx):
    """One channel's loop drifts and keeps lock: each segment's walk runs
    that channel 0.5 Hz off the carrier Doppler it was handed."""
    orig = ctx.engine._run_capture

    def walk(samples, state, limit, n_epochs):
        dop = state.carrier_doppler_hz.clone()
        dop[1] += 0.5
        return orig(samples, state._replace(carrier_doppler_hz=dop), limit,
                    n_epochs)

    ctx.engine._run_capture = walk


def _run(name, fault=None, control=False):
    return harness.run(tiny_cell(name), 2**31 + 23, 0.5, False,
                       torch.device("cpu"), time.perf_counter(),
                       fault=fault, control=control)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_control_is_not(name):
    r = _run(name, control=True)
    assert r["correct"], r["checks"]
    control, _ = check.judge(r["control_numbers"],
                             harness.load_cell(name).limits)
    assert any(c["value"] > c["limit"] for c in control.values()), control


@pytest.mark.parametrize("fault", [state_unchanged, half_the_channels,
                                   one_answer_altered,
                                   one_channel_correlators_off,
                                   one_channel_drifts])
@pytest.mark.parametrize("name", CELLS)
def test_fault_makes_the_run_incorrect(name, fault):
    r = _run(name, fault=fault)
    assert not r["correct"], r["checks"]
