#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA receiver on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each, with times):
  1. the card (nvidia-smi name and power limit) and the kernel build;
  2. the CUDA tracking-chain kernel against its plain torch version on the
     card, at the main path's shapes (E=16, LW=68, C=12, K=3), on random
     inputs and on the inputs of a real chunk taken mid-track;
  3. batched PCPS acquisition of 12 PRNs (detections, FFTs/s);
  4. the tracking engine: 12 channels over a 15 s capture at 4.092 Msps
     (RTF, valid epochs, chain launches == chunks);
  5. the receiver end to end — the main path: 12 satellites, 30 s, live
     LNAV, PVT every 100 ms, the capture preloaded to the card (e2e RTF,
     fixes, median 3D error against the scenario truth).
Then one JSON line describing every kernel, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failed check raises: the script exits
non-zero and prints no result.  Without a CUDA device it exits non-zero at
once.  Synthetic captures are cached in chip_smoke_cache/ (git-ignored);
the full report (per-row kernel diffs, per-PRN acquisition results) goes to
`--out` (default chip_smoke_cache/) as chip_smoke_report.json.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
FS = 4.092e6
ENGINE_S = 15.0       # engine phase capture (bench.py DURATION_S)
E2E_S = 30.0          # receiver phase capture (bench.py E2E_DURATION_S)
MIN_FIXES = 140
CACHE = ROOT / "chip_smoke_cache"
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# float32 operations per (epoch, channel) of the chain: tap reads ~45,
# rotation ~20, wipe/accumulate ~12, discriminators ~60, PLL ~15, DLL ~30,
# NCO ~15, CN0/lock ~25, ledger ~10, with each transcendental counted as
# ~8 — an estimate; the chain is bound by neither bytes nor operations
OPS_PER_EPOCH_CHANNEL = 300


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=CACHE,
                    help="directory for chip_smoke_report.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    import gnss_sdr_1_tpu_torch  # noqa: F401  (sets TF32 off)
    from gnss_sdr_1_tpu_torch.ops import _build
    from gnss_sdr_1_tpu_torch.ops import track_chain as tc

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 must be off for the float32 correlations")
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # ---- 1. card + kernel build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build_all(["track_chain"])
    tc._lib()
    build_s = time.perf_counter() - t0
    log(f"[1] card: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | kernel build {build_s:.2f} s")
    log("    ptxas: " + " ".join(
        _build.BUILD_LOG.get("track_chain", {}).get("ptxas", "").split()))

    # ---- 2. kernel vs plain ----
    t0 = time.perf_counter()
    k_rep = phase_kernel(dev, tc)
    log(f"[2] chain kernel vs plain: max |diff| {k_rep['max_abs_err']:.3e} "
        f"(random {k_rep['err_random']:.3e}, mid-track "
        f"{k_rep['err_track']:.3e}), kernel {k_rep['ms']:.4f} ms/launch, "
        f"plain {k_rep['plain_ms']:.3f} ms, bound {k_rep['bound_ms']:.2e} ms "
        f"({k_rep['bound_by']}) | {time.perf_counter() - t0:.1f} s")

    # ---- 3. acquisition ----
    t0 = time.perf_counter()
    sats, x_eng = engine_capture()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    acq = phase_acquisition(dev, sats, x_eng)
    log(f"[3] acquisition: {acq['detected']}/12 at the true Doppler and "
        f"delay, {acq['ffts_per_s']:.0f} FFTs/s "
        f"({acq['ms_per_call']:.2f} ms/call, F={acq['fft_size']}) | "
        f"{time.perf_counter() - t0:.1f} s (capture made in {gen_s:.1f} s)")

    # ---- 4. engine ----
    t0 = time.perf_counter()
    eng = phase_engine(dev, tc, sats, x_eng)
    del x_eng
    log(f"[4] engine: 12 ch x {eng['signal_s']:.1f} s, RTF "
        f"{eng['rtf']:.2f} ({eng['wall_s']:.2f} s), valid "
        f"{eng['n_valid']}/{eng['expected']:.0f} epochs, chain launches {eng['launches']} == chunks "
        f"{eng['chunks']} | {time.perf_counter() - t0:.1f} s")

    # ---- 5. receiver end to end (the main path) ----
    t0 = time.perf_counter()
    e2e = phase_e2e(dev, tc)
    log(f"[5] receiver e2e: 12 sats x {E2E_S:g} s, RTF {e2e['rtf']:.2f} "
        f"({e2e['wall_s']:.1f} s), fixes {e2e['fixes']}, median 3D error "
        f"{e2e['median_3d_m']:.2f} m, chain launches {e2e['launches']} | "
        f"{time.perf_counter() - t0:.1f} s (capture made in "
        f"{e2e['gen_s']:.1f} s)")

    kernels = [{
        "name": "track_chain", "route": "cuda",
        "source": "gnss_sdr_1_tpu_torch/csrc/track_chain.cu",
        "replaces": "gnss_sdr_1_tpu/ops/pallas_chain.py:503",
        "launches": e2e["launches"], "max_abs_err": k_rep["max_abs_err"],
        "ms": k_rep["ms"], "plain_ms": k_rep["plain_ms"],
        "bound_ms": k_rep["bound_ms"], "bound_by": k_rep["bound_by"],
        "library_ms": None,
    }]
    report = {"card": smi, "build_s": build_s, "kernel": k_rep,
              "acquisition": acq, "engine": eng, "e2e": e2e,
              "total_s": time.perf_counter() - t_all}
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "chip_smoke_report.json").write_text(
        json.dumps(report, indent=1, default=float))
    log(f"    total {report['total_s']:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# phase 2: kernel against plain
# ---------------------------------------------------------------------------


def _engine(dev):
    """The engine benchmark's tracker: 12 channels, 16-epoch chunks."""
    from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine

    codes = np.stack([gps_l1ca_code(p) for p in range(1, 13)])
    cfg = TrackConfig(fs_hz=FS, code_length_chips=1023,
                      chip_rate_chips_s=1.023e6, carrier_freq_hz=1575.42e6,
                      n_channels=12, chunk_epochs=16)
    return TrackingEngine(cfg, codes, device=dev)


def _bench_sats(duration_s):
    """The engine benchmark's 12 satellites (bench.py scenario, seed 42)."""
    from gnss_sdr_1_tpu_torch.siggen import SatParams

    rng = np.random.default_rng(42)
    return [SatParams(prn=p, doppler_hz=float(rng.uniform(-4000, 4000)),
                      delay_chips=float(rng.uniform(0, 1023)), cn0_dbhz=44.0,
                      nav_bits=rng.choice([-1.0, 1.0],
                                          size=int(duration_s * 50) + 8))
            for p in range(1, 13)]


def _activate_all(eng, sats):
    st = eng.init_state()
    for ch, s in enumerate(sats):
        st = eng.activate_channel(st, ch, ch, s.delay_chips / 1.023e6 * FS,
                                  s.doppler_hz, 0, 0)
    return st


def _gen(sats, duration_s, key):
    from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_1_tpu_torch.constants import GPS_L1_CA
    from gnss_sdr_1_tpu_torch.siggen import generate_baseband

    CACHE.mkdir(exist_ok=True)
    path = CACHE / f"{key}.npy"
    if path.exists():
        return np.load(path)
    x = generate_baseband(GPS_L1_CA, sats,
                          {s.prn: gps_l1ca_code(s.prn) for s in sats}, FS,
                          duration_s, noise=True)
    np.save(path, x)
    return x


def _chain_diff(tc, got, want, rows_out=None):
    """Max |diff| of the float outputs, scaled check per row; int rows and
    flags exact.  Raises when a row is over its tolerance.  `rows_out`
    collects (output, row, |diff|, tolerance) per float row."""
    worst = 0.0
    names = ("out_f", "out_i", "out_corr", "fst", "ist")
    for name, g, w in zip(names, got, want):
        g = g.double().cpu()
        w = w.double().cpu()
        if name in ("out_i", "ist"):
            if not torch.equal(g, w):
                raise AssertionError(f"chain kernel int rows differ: {name}")
            continue
        for r in range(g.shape[-2]):
            gr, wr = g[..., r, :], w[..., r, :]
            d = float((gr - wr).abs().max())
            if name == "out_f" and r in (tc.O_VALID, tc.O_ACTIVE):
                if d != 0.0:
                    raise AssertionError(f"chain kernel flag row {r} differs")
                continue
            # float32 rows: atol 1e-4 of the row's scale (the kernel and
            # the plain version round transcendentals and sums differently)
            tol = 1e-4 * max(1.0, float(wr.abs().max()))
            if rows_out is not None:
                rows_out.append((name, r, d, tol))
            if not d <= tol:
                raise AssertionError(
                    f"chain kernel {name} row {r}: |diff| {d:.3e} > {tol:.3e}")
            worst = max(worst, d)
    return worst


def _time_cuda(fn, n):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def phase_kernel(dev, tc):
    # a real chunk taken mid-track: 0.25 s of tracking on the engine
    # benchmark's scenario, then the next chunk's chain inputs
    sats = _bench_sats(0.3)
    x = _gen(sats, 0.3, "kernel_chunk_0.3s_v1")
    eng = _engine(dev)
    spec = eng.chain_spec
    assert (spec.E, spec.LW, spec.C, spec.K) == (16, 68, 12, 3), spec
    st = _activate_all(eng, sats)
    xd = torch.as_tensor(x, device=dev)
    span = int(FS * 0.25)
    st, _ = eng.track_capture(xd[: span + eng.cfg.epoch_samples_max], st,
                              span)
    seg = eng._pad_for_chunks(xd[span:])
    fst, ist = eng._pack_rows(st, int(FS * 0.04))
    rep_t, sec_rows = eng._capture_tables(st)
    track_args = eng._chain_inputs(seg, fst, ist, rep_t, sec_rows)

    # random lag windows with the same state rows
    g = torch.Generator(device="cpu").manual_seed(7)
    zr = torch.randn(track_args[0].shape, generator=g) * 100.0
    zi = torch.randn(track_args[1].shape, generator=g) * 100.0
    rand_args = (zr.to(dev), zi.to(dev)) + track_args[2:]

    errs, rows = {}, {}
    for label, args in (("random", rand_args), ("track", track_args)):
        before = tc.launches
        got = tc.chain(spec, *args)
        torch.cuda.synchronize()
        if tc.launches != before + 1:
            raise AssertionError("chain wrapper did not launch the kernel")
        want = tc.chain_plain(spec, *args)
        rows[label] = []
        errs[label] = _chain_diff(tc, got, want, rows[label])
    ms = _time_cuda(lambda: tc.chain(spec, *track_args), 500)
    plain_ms = _time_cuda(lambda: tc.chain_plain(spec, *track_args), 5)

    # least time for the same work: bytes the function needs (the 2K lags
    # per plane each epoch reads, state and outputs once) vs operations
    E, C, K = spec.E, spec.C, spec.K
    sf, si = tc.n_frows(K), tc.N_IROWS
    n_bytes = 4 * (2 * 2 * K * E * C                 # lag reads, I and Q
                   + E * C + C + spec.sec_len * C     # s_pred, step0, sec
                   + 2 * (sf + si) * C                # state in and out
                   + E * (tc.N_OROWS + 2 + 2 * K) * C)  # per-epoch outputs
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = OPS_PER_EPOCH_CHANNEL * E * C / PEAK_F32_S * 1e3
    return {"err_random": errs["random"], "err_track": errs["track"],
            "max_abs_err": max(errs.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "E": E, "LW": spec.LW, "C": C, "K": K,
            "rows": rows}


# ---------------------------------------------------------------------------
# phases 3 and 4: acquisition and the tracking engine (bench scenario)
# ---------------------------------------------------------------------------


def engine_capture():
    sats = _bench_sats(ENGINE_S)
    return sats, _gen(sats, ENGINE_S, f"engine_{ENGINE_S:g}s_v1")


def phase_acquisition(dev, sats, x):
    from gnss_sdr_1_tpu_torch.acquire import AcqConfig, PcpsAcquisition
    from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code

    prns = [s.prn for s in sats]
    acq = PcpsAcquisition(
        AcqConfig(fs_hz=FS, samples_per_code=4092, samples_per_chip=4,
                  doppler_max_hz=5000.0, doppler_step_hz=250.0, max_dwells=2,
                  make_two_steps=False),
        {p: gps_l1ca_code(p) for p in prns}, fs_code_rate=(1.023e6, 1023),
        device=dev)
    xs = x[: acq.cfg.fft_size * 2]
    res = acq.acquire(xs)
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        acq.acquire(xs)
    wall = (time.perf_counter() - t0) / n
    ffts = len(prns) * acq.cfg.num_doppler_bins * 2 * 2
    # a detection at the truth: the code delay within 2 samples and the
    # Doppler within two 250 Hz bins (the 1 ms coherent window's main lobe
    # is +-1 kHz wide, so noise picks among neighbouring bins)
    found = []
    for k, s in enumerate(sats):
        true_delay = (s.delay_chips / 1.023e6 * FS) % 4092
        dd = abs(res.delay_samples[k] - true_delay)
        dd = min(dd, 4092 - dd)
        df = abs(res.doppler_hz[k] - s.doppler_hz)
        found.append({"prn": s.prn, "stat": float(res.test_stat[k]),
                      "doppler_err_hz": float(df), "delay_err": float(dd),
                      "hit": bool(res.positive[k] and df <= 500.0
                                  and dd <= 2.0)})
    det = sum(f["hit"] for f in found)
    if det < 10:
        raise AssertionError(f"acquisition found {det}/12 satellites: "
                             f"{found}")
    return {"detected": det, "ffts_per_s": ffts / wall,
            "ms_per_call": wall * 1e3, "fft_size": acq.cfg.fft_size,
            "per_prn": found}


def phase_engine(dev, tc, sats, x):
    eng = _engine(dev)
    st = _activate_all(eng, sats)
    nmax = eng.cfg.epoch_samples_max
    xd = torch.as_tensor(x, device=dev)
    span = len(x) - nmax
    sym_off = np.full(12, 20, dtype=np.int32)
    # first-use warm-up (cuBLAS, kernel load) on 0.1 s
    w = int(FS * 0.1)
    eng.track_capture_symbols(xd[: w + nmax], st, w, sym_off, 20)
    torch.cuda.synchronize()
    tc.launches = 0
    t0 = time.perf_counter()
    st2, souts = eng.track_capture_symbols(xd, st, span, sym_off, 20)
    n_valid = int(souts.n_valid.sum())
    wall = time.perf_counter() - t0
    launches = tc.launches
    n_epochs = span // (eng._t0_int - 2) + 2
    chunks = -(-n_epochs // eng.chain_spec.E)
    signal_s = span / FS
    expected = signal_s / 1e-3 * 12
    if not n_valid > 0.85 * expected:
        raise AssertionError(f"engine: {n_valid} valid epochs of "
                             f"{expected:.0f} expected")
    if launches != chunks:
        raise AssertionError(f"engine: {launches} chain launches for "
                             f"{chunks} chunks")
    if not bool(st2.active.all()):
        raise AssertionError("engine: a channel lost lock")
    return {"rtf": signal_s / wall, "wall_s": wall, "signal_s": signal_s,
            "n_valid": n_valid, "expected": expected, "launches": launches,
            "chunks": chunks}


# ---------------------------------------------------------------------------
# phase 5: the receiver end to end
# ---------------------------------------------------------------------------


def phase_e2e(dev, tc):
    from gnss_sdr_1_tpu_torch.pvt.geodesy import llh_to_ecef
    from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig
    from gnss_sdr_1_tpu_torch.siggen.scenario import build_scenario

    dur = E2E_S
    prns = list(range(1, 13))
    rx_ecef = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
    scen = build_scenario(rx_ecef, prns, t0_tow=345601.25, duration_s=dur,
                          cn0_dbhz=47.0, subframe_cycle=(1, 2, 3))
    t0 = time.perf_counter()
    x = _gen(scen.sats, dur, f"e2e_{FS:.0f}_{dur:.0f}_v1")
    gen_s = time.perf_counter() - t0
    rx = Receiver(ReceiverConfig(
        fs_hz=FS, signal_id="1C", n_channels=len(prns),
        prn_search=tuple(prns), reacq_interval_blocks=125,
        pvt_output_rate_ms=100), device=dev)
    rx.preload(x)
    tc.launches = 0
    t0 = time.perf_counter()
    sols = rx.process(x)
    wall = time.perf_counter() - t0
    launches = tc.launches
    if launches <= 0:
        raise AssertionError("e2e: the chain kernel was never launched")
    if len(sols) < MIN_FIXES:
        raise AssertionError(f"e2e: {len(sols)} fixes (< {MIN_FIXES})")
    e3d = np.linalg.norm(np.stack([s.rx_ecef_m for s in sols])
                         - scen.rx_ecef, axis=1)
    med = float(np.median(e3d))
    if not np.isfinite(e3d).all() or not med < 5.0:
        raise AssertionError(f"e2e: median 3D error {med:.2f} m")
    return {"rtf": dur / wall, "wall_s": wall, "fixes": len(sols),
            "median_3d_m": med, "max_3d_m": float(e3d.max()),
            "launches": launches, "gen_s": gen_s,
            "channels": list(rx.channel_prn)}


if __name__ == "__main__":
    main()
