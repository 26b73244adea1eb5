"""The walk's least time at a tiny shape, counted by hand."""

import pytest

from gnssbench import roofline as rl


def _work(**kw):
    w = dict(taps=3, samples=4000.0, valid_epochs=1, input_bytes=0,
             table_bytes=0, state_bytes=0, out_bytes=0)
    w.update(kw)
    return w


def test_operations_bound_one_epoch():
    t, which = rl.least_time(_work())
    # 4000 samples x (39 - 6) float32 operations + 300 for the closure,
    # 4000 x 6 tap accumulations at the TF32 rate
    want = (4000 * 33 + 300) / 67e12 + 4000 * 6 / 495e12
    assert which == "operations"
    assert t == pytest.approx(want, rel=1e-12)


def test_bytes_bound_and_veml_taps():
    w = _work(taps=5, samples=10.0, valid_epochs=0, input_bytes=8000,
              table_bytes=400, state_bytes=80, out_bytes=20)
    t, which = rl.least_time(w)
    assert which == "bytes"
    assert t == pytest.approx(8500 / 3.35e12, rel=1e-12)
    ops = (10 * (49 - 10)) / 67e12 + 10 * 10 / 495e12
    assert ops < t
