"""Kalman-filter tracking of whole blocks: the CUDA kernel, its plain torch
version and the wrapper that picks between them by the device of its
inputs.

For every channel and every epoch of a block (`n_epochs = base //
(t0_int - 2) + 2` epochs, the epochs that start in [0, base)), in order:
the window origin `m` (the minimum start of the active channels, clipped
to `n_samp - win`) and each channel's offset from it, clamped to
`win - Nmax`; the gather multicorrelator (three taps, the carrier wiped
with `cp + cs n + (0.5 cr n) n`, the code index `floor(step n + shift -
rem) mod L`, ops.multicorrelator); the KF predict with F and Q, the
two-quadrant Costas measurement, R from the running CN0 and, with
`bayes_run`, the NIW innovation covariance, then the scalar update; the
carrier-aided IIR DLL, the next epoch's length in the split
`t0_int`/`t0_frac` precision, and the CN0 and carrier-lock supervision over
the prompt history with its lock-fail counter.  A launch may walk several
consecutive blocks of one capture segment, rebasing the epoch starts by
`base` between them, as the engine's block loop does.

The JAX package runs the same epoch step as one `lax.scan` per block
(gnss_sdr_1_tpu/track/kf.py `_track_block_impl`, :425); it is not a Pallas
kernel.  The kernel (csrc/kf_block.cu, with the correlation in
csrc/gather_corr.cuh) walks the blocks in one launch of one thread-block
cluster, one CTA per channel; `kf_geometry` computes the launch's shape
and shared memory, which the C entry checks.

State crosses the call as row-stacked matrices in the style of
ops.track_chain: `n_frows(N)` x C float32 (R_* below: the KF state and
covariance, the DLL filter, the CN0 and NIW scalars, and the prompt
history as N rows of I then N rows of Q, oldest first) and N_IROWS x C
int32 (I_*).  Per epoch the kernel writes N_OROWS x C float32 rows (O_*)
and N_OIROWS x C int32 rows (OI_*).

Signature of `kf_block` / `kf_block_plain`:
    (spec, samples [n_samp] complex64, codes [n_slots, L] f32 (+-1),
     fst [SF,C] f32, ist [SI,C] i32)
 -> (out_f [B*E, N_OROWS, C] f32, out_i [B*E, N_OIROWS, C] i32,
     fst' [SF,C] f32, ist' [SI,C] i32)
with B = spec.n_blocks blocks of E = spec.n_epochs epochs, block b reading
samples[b*base : b*base + base + Nmax] (the last block: to the end).  The
output starts are relative to their block; the state is rebased by
B * base.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from .multicorrelator import multicorrelate
from .track_chain import _f32, check_tensor, mod_floor

_TINY = float(np.finfo(np.float32).tiny)

# float32 state rows
R_REM_CODE, R_DELTA = 0, 1
R_X = 2                # 3 rows: carrier phase (rad), Doppler (Hz), rate
R_P = 5                # 9 rows: the covariance, row-major
R_DLL_IN, R_DLL_OUT = 14, 17      # 3 rows each, newest first
R_CN0 = 20
R_NIW_MU, R_NIW_KAPPA, R_NIW_NU, R_NIW_PSI, R_NIW_PSI_EST = 21, 22, 23, 24, 25
R_HIST = 26            # N rows of prompt I, then N rows of prompt Q


def n_frows(n_hist: int) -> int:
    return R_HIST + 2 * n_hist


# int32 state rows
I_ACTIVE, I_SLOT, I_START, I_CURLEN, I_HIST_COUNT, I_LOCK_FAIL, I_EPOCHS = \
    range(7)
N_IROWS = 7

# per-epoch float32 output rows (the taps: 3 rows of I, then 3 of Q)
O_DOPPLER, O_DOPPLER_RATE, O_SIGMA2, O_DELTA, O_REM_CODE, O_REM_CARR, \
    O_CN0, O_CORR = range(8)
N_OROWS = O_CORR + 6
# per-epoch int32 output rows
OI_VALID, OI_START, OI_CURLEN, OI_ACTIVE = range(4)
N_OIROWS = 4

# kernel launches made by `kf_block` on CUDA tensors (never by
# kf_block_plain)
launches = 0


@dataclasses.dataclass(frozen=True)
class KfSpec:
    """Static configuration of one KF block walk.  Every float is the
    float32 value the epoch step uses."""

    C: int                  # channels
    n_hist: int             # cn0_samples
    code_len: int           # L, chips of the 1-sample/chip table
    n_max: int              # epoch_samples_max
    win: int                # the window the offsets are clamped into
    base: int               # samples per block
    n_epochs: int
    n_blocks: int
    order: int
    bayes_run: bool
    bayes_ptrans: int
    bayes_strans: int
    max_lock_fail: int
    t0_int: int
    chip_rate: float
    fs: float
    two_pi: float
    fs2: float
    t: float                # code period
    aid: float              # chip_rate / carrier_freq
    t0_int_f: float
    t0_frac: float
    cn0_min_dbhz: float
    carrier_lock_th: float
    shifts: tuple           # [3] tap offsets (chips)
    F: tuple                # [9] row-major
    Q: tuple                # [9]
    dll_b_in: tuple         # [4]
    dll_b_out: tuple        # [3]

    @property
    def cn0_log_t(self) -> float:
        """10 log10(T), the CN0 estimator's integration-time term."""
        return _f32(10.0 * math.log10(self.t))

    # the JAX package's compiled epoch step divides by a constant as a
    # multiply by its float32 reciprocal (XLA's rewrite): so do both
    # versions here, on every device
    @property
    def inv_fs(self) -> float:
        return _recip(self.fs)

    @property
    def inv_fs2(self) -> float:
        return _recip(self.fs2)

    @property
    def inv_n_hist(self) -> float:
        return _recip(self.n_hist)


def _recip(v) -> float:
    """The float32 reciprocal of a float32 value, rounded once."""
    return float(np.float32(1.0) / np.float32(v))


_TENTH = _recip(10.0)


# ---------------------------------------------------------------------------
# plain torch version
# ---------------------------------------------------------------------------


def _phase_sigma2(cn0_dbhz, t: float):
    """Phase-detector variance from CN0 (gps_l1_ca_kf_tracking_cc.cc:755-758):
    sigma2 = 1/(2*CN0*T) * (1 + 1/(2*CN0*T))   [rad^2]."""
    cn_lin = torch.pow(10.0, cn0_dbhz * _TENTH)
    a = 1.0 / (2.0 * cn_lin * t)
    return a * (1.0 + a)


def _epoch(spec: KfSpec, x, codes, shifts, Fm, Qm, f, i, limit: int,
           n_idx):
    """One epoch of every channel over the state rows `f` [SF, C] and `i`
    [SI, C]; returns (f', i', out_f rows [N_OROWS, C], out_i rows
    [N_OIROWS, C])."""
    dev = x.device
    f32, i32 = torch.float32, torch.int32
    N = spec.n_hist
    zero = torch.zeros((), dtype=f32, device=dev)
    active = i[I_ACTIVE] != 0
    start, cur_len = i[I_START], i[I_CURLEN]
    valid = active & (start < limit)

    # window origin m and per-channel offsets, clamped as the reference's
    # dynamic_slice clamps
    n_samp = x.shape[0]
    win = min(spec.win, n_samp)
    m = torch.min(torch.where(active, start,
                              torch.full_like(start, 1 << 29)))
    m = torch.clamp(m, 0, n_samp - win)
    off = torch.clamp(start - m, 0, win - spec.n_max)
    segs = x[(m + off).to(torch.int64)[:, None] + n_idx]

    rem, delta = f[R_REM_CODE], f[R_DELTA]
    x0, x1, x2 = f[R_X], f[R_X + 1], f[R_X + 2]
    code_freq = spec.chip_rate + delta
    code_step = code_freq * spec.inv_fs
    rem_code_chips = code_freq * rem * spec.inv_fs
    carr_step = spec.two_pi * x1 * spec.inv_fs
    # the phase state is the NCO phase at epoch start (d_rem_carr_phase_rad
    # = kf_x(0), :786); order 3 feeds the Doppler-rate state into the
    # correlator's quadratic phase term
    carr_rate = (spec.two_pi * x2 * spec.inv_fs2 if spec.order == 3
                 else torch.zeros_like(carr_step))
    corr = multicorrelate(segs, codes[i[I_SLOT].long()], shifts, code_step,
                          rem_code_chips, x0, carr_step, carr_rate,
                          cur_len.to(f32))                  # [C, 3] complex
    pr, pi_ = corr[:, 1].real, corr[:, 1].imag

    # --- KF predict (:748-749): x_pre = F x, P_pre = F P F' + Q, each
    # three-term sum left to right ---
    X = f[R_X:R_X + 3]                                      # [3, C]
    x_pre = (Fm[:, 0, None] * X[0] + Fm[:, 1, None] * X[1]) \
        + Fm[:, 2, None] * X[2]                             # [3, C]
    P = f[R_P:R_P + 9].reshape(3, 3, -1)
    A = (Fm[:, 0, None, None] * P[0] + Fm[:, 1, None, None] * P[1]) \
        + Fm[:, 2, None, None] * P[2]                       # F P
    P_pre = ((A[:, None, 0] * Fm[None, :, 0, None]
              + A[:, None, 1] * Fm[None, :, 1, None])
             + A[:, None, 2] * Fm[None, :, 2, None]) + Qm[:, :, None]

    # --- measurement (:752-760): two-quadrant Costas atan ---
    y = torch.where(pr != 0.0, torch.atan2(pi_ * torch.sign(pr),
                                           torch.abs(pr)), zero)
    r = _phase_sigma2(f[R_CN0], spec.t)

    # --- NIW innovation-covariance estimate (bayesian_estimation.cc,
    # sequential K=1 scalar update) ---
    epochs0 = i[I_EPOCHS]
    niw = f[R_NIW_MU:R_NIW_PSI_EST + 1]
    if spec.bayes_run:
        upd = valid & (epochs0 >= spec.bayes_ptrans)
        mu, kap, nu, psi, psi_est0 = niw
        mu_post = (kap * mu + y) / (kap + 1.0)
        kap_post = kap + 1.0
        nu_post = nu + 1.0
        psi_post = psi + kap / (kap + 1.0) * (y - mu) ** 2
        psi_est = torch.where(nu_post - 2.0 > 0.0, psi_post / (nu_post - 2.0),
                              psi_post / (nu_post + 2.0))
        niw = torch.stack([torch.where(upd, n, o) for n, o in zip(
            (mu_post, kap_post, nu_post, psi_post, psi_est), niw)])
        use_bayes = epochs0 >= (spec.bayes_ptrans + spec.bayes_strans)
        p_y = torch.where(use_bayes, niw[4], P_pre[0, 0] + r)
        r_est = torch.where(use_bayes, niw[4] - P_pre[0, 0], r)
    else:
        p_y = P_pre[0, 0] + r
        r_est = r

    # --- scalar-measurement update (:779-782), H = [1, 0, 0] ---
    K = P_pre[:, 0] / p_y                                   # [3, C]
    x_new = x_pre + K * y
    P_new = P_pre - K[:, None] * P_pre[None, 0]

    # --- DLL with carrier aiding (:795-805): normalised E-L envelope and
    # the IIR filter, each sum left to right ---
    e = torch.abs(corr[:, 0])
    l_ = torch.abs(corr[:, 2])
    s = e + l_
    code_err = torch.where(s > 0.0, 0.5 * (e - l_) / s, zero)
    bi, bo = spec.dll_b_in, spec.dll_b_out
    din, dout = f[R_DLL_IN:R_DLL_IN + 3], f[R_DLL_OUT:R_DLL_OUT + 3]
    code_err_filt = (((bo[0] * dout[0] + bo[1] * dout[1]) + bo[2] * dout[2])
                     + bi[0] * code_err) \
        + ((bi[1] * din[0] + bi[2] * din[1]) + bi[3] * din[2])
    new_delta = spec.aid * x_new[1] - code_err_filt

    # --- next epoch length (A.6 split precision) ---
    new_code_freq = spec.chip_rate + new_delta
    d_t = -(spec.t0_int_f * new_delta / new_code_freq
            + spec.t0_frac * new_delta / new_code_freq)
    frac = spec.t0_frac + d_t + rem
    frac_floor = torch.floor(frac)
    next_len = spec.t0_int + frac_floor.to(i32)
    new_rem = frac - frac_floor

    # --- CN0 / lock supervision (A.7) over the prompt history ---
    hr, hq = f[R_HIST:R_HIST + N], f[R_HIST + N:R_HIST + 2 * N]
    hr = torch.where(valid, torch.cat([hr[1:], pr[None]]), hr)
    hq = torch.where(valid, torch.cat([hq[1:], pi_[None]]), hq)
    hist_count = torch.clamp(i[I_HIST_COUNT] + valid.to(i32), max=N)
    hist_full = hist_count >= N
    psig = (torch.abs(hr).sum(0) * spec.inv_n_hist) ** 2
    ptot = (hr * hr + hq * hq).sum(0) * spec.inv_n_hist
    noise = torch.clamp(ptot - psig, min=_TINY)
    cn0 = (10.0 * torch.log10(torch.clamp(psig / noise, min=1e-10))
           - spec.cn0_log_t)
    i2, q2 = (hr * hr).sum(0), (hq * hq).sum(0)
    carrier_lock = (i2 - q2) / torch.clamp(i2 + q2, min=_TINY)
    cn0_run = torch.where(valid & hist_full, cn0, f[R_CN0])
    epochs = epochs0 + valid.to(i32)
    check_now = valid & hist_full & (mod_floor(epochs, N) == 0)
    fail = check_now & ((cn0 < spec.cn0_min_dbhz)
                        | (carrier_lock < spec.carrier_lock_th))
    lock_fail0 = i[I_LOCK_FAIL]
    lock_fail = torch.where(
        fail, lock_fail0 + 1,
        torch.where(check_now, torch.clamp(lock_fail0 - 1, min=0),
                    lock_fail0))
    still_active = active & (lock_fail <= spec.max_lock_fail)

    # --- merge by valid: a channel that did not run keeps its state ---
    def mv(n, o):
        return torch.where(valid, n, o)

    x_m = mv(x_new, X)
    f_new = torch.cat([
        torch.stack([mv(new_rem, rem), mv(new_delta, delta)]),
        x_m, mv(P_new.reshape(9, -1), f[R_P:R_P + 9]),
        mv(torch.stack([code_err, din[0], din[1]]), din),
        mv(torch.stack([code_err_filt, dout[0], dout[1]]), dout),
        cn0_run[None], niw, hr, hq])
    active_m = mv(still_active, active)
    i_new = torch.stack([
        active_m.to(i32), i[I_SLOT], mv(start + cur_len, start),
        mv(next_len, cur_len), hist_count, mv(lock_fail, lock_fail0),
        epochs])
    out_f = torch.cat([
        torch.stack([
            x_m[1], x_m[2], torch.where(valid, r_est, zero),
            f_new[R_DELTA], f_new[R_REM_CODE],
            mod_floor(x_m[0], spec.two_pi),
            torch.where(valid & hist_full, cn0, zero)]),
        torch.where(valid, corr.real.T, zero),
        torch.where(valid, corr.imag.T, zero)])
    out_i = torch.stack([valid.to(i32), start, cur_len, active_m.to(i32)])
    return f_new, i_new, out_f, out_i


def kf_block_plain(spec: KfSpec, samples, codes, fst, ist):
    """The block walk in plain torch ops (any device); same rows as the
    kernel."""
    dev = samples.device
    Fm = torch.tensor(spec.F, dtype=torch.float32, device=dev).reshape(3, 3)
    Qm = torch.tensor(spec.Q, dtype=torch.float32, device=dev).reshape(3, 3)
    shifts = torch.tensor(spec.shifts, dtype=torch.float32, device=dev)
    n_idx = torch.arange(spec.n_max, device=dev)
    f, i = fst, ist
    outs_f, outs_i = [], []
    for b in range(spec.n_blocks):
        lo = b * spec.base
        hi = (lo + spec.base + spec.n_max if b < spec.n_blocks - 1
              else samples.shape[0])
        xb = samples[lo:hi]
        for _ in range(spec.n_epochs):
            f, i, of, oi = _epoch(spec, xb, codes, shifts, Fm, Qm, f, i,
                                  spec.base, n_idx)
            outs_f.append(of)
            outs_i.append(oi)
        i = i.clone()
        i[I_START] -= spec.base                             # rebase
    return torch.stack(outs_f), torch.stack(outs_i), f, i


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/kf_block.cu)
# ---------------------------------------------------------------------------

# launch geometry: threads per CTA (== the kernel's __launch_bounds__), the
# largest cluster the kernel asks for, the portable cluster size (the C
# entry sets cudaFuncAttributeNonPortableClusterSizeAllowed above it) and
# the dynamic shared memory one CTA may use on Hopper
KF_THREADS = 512
KF_WARPS = KF_THREADS // 32
KF_MAX_CLUSTER = 16
PORTABLE_CLUSTER = 8
SMEM_MAX = 232_448
# the timeline the KF_BLOCK_STAGES build writes, per epoch, of CTA 0's
# first channel (kf_block.cu TL_*): SM clock stamps of thread 0 (the epoch
# begins, m known, the update's state-only part done, the taps reduced,
# the update done) and of thread 32 (m known, the prefetch wait done, its
# samples done, its warp's sums stored), and 1 where the epoch read the
# prefetch buffer
TL_START, TL_M0, TL_PRE, TL_RED, TL_UPD, TL_M32, TL_WAIT, TL_SAMP, TL_PART, \
    TL_HIT = range(10)
STAGE_POINTS = 10
# bytes of the update's state-only part (kf_block.cu KfPre)
PRE_BYTES = 160


def _round16(v: int) -> int:
    return (v + 15) // 16 * 16


def prefetch_bytes(n_max: int) -> int:
    """One prefetch buffer: n_max samples from a 16-byte aligned start
    (one sample of skew at most) rounded up to 16 bytes."""
    return _round16(8 * (n_max + 2))


def kf_layout(cpc: int, n_max: int, code_len: int, n_hist: int,
              prefetch: bool) -> dict:
    """Byte offsets of one CTA's dynamic shared memory, as kf_block.cu
    `kf_layout` computes them: the mbarriers, the two m slots, the prefetch
    records, the prefetch buffers, the code bits, the state rows, the warp
    partial sums and the update's state-only part; `total` is the launch's
    dynamic shared memory."""
    W = (code_len + 31) // 32
    lay = {"bar": 0, "slot": 8 * cpc}
    lay["info"] = lay["slot"] + 8
    lay["pf"] = _round16(lay["info"] + 16 * cpc)
    lay["bits"] = lay["pf"] + (cpc * prefetch_bytes(n_max) if prefetch
                               else 0)
    lay["sf"] = lay["bits"] + 4 * cpc * W
    lay["si"] = lay["sf"] + 4 * n_frows(n_hist) * cpc
    lay["part"] = lay["si"] + 4 * N_IROWS * cpc
    lay["pre"] = lay["part"] + 4 * 2 * KF_WARPS * 6
    lay["total"] = lay["pre"] + PRE_BYTES
    return lay


@dataclasses.dataclass(frozen=True)
class KfGeometry:
    """One launch: a cluster of n_cta CTAs of `threads` threads; CTA r
    takes channels r, r + n_cta, ... (at most `cpc` each); `prefetch`
    where every CTA's cpc buffers of `pf_bytes` fit beside the rest in
    `smem` bytes of dynamic shared memory."""

    C: int
    n_cta: int
    threads: int
    cpc: int
    prefetch: bool
    pf_bytes: int
    smem: int


def kf_geometry(C: int, n_max: int, code_len: int, n_hist: int,
                max_cluster: int) -> KfGeometry:
    """The launch geometry of C channels when the card schedules clusters
    of up to `max_cluster` CTAs."""
    if not 1 <= max_cluster <= KF_MAX_CLUSTER:
        raise ValueError(f"max_cluster must be in [1, {KF_MAX_CLUSTER}], "
                         f"got {max_cluster}")
    if C < 1:
        raise ValueError("the KF kernel takes at least one channel")
    n_cta = min(C, max_cluster)
    cpc = -(-C // n_cta)
    smem = kf_layout(cpc, n_max, code_len, n_hist, True)["total"]
    prefetch = smem <= SMEM_MAX
    if not prefetch:
        smem = kf_layout(cpc, n_max, code_len, n_hist, False)["total"]
        if smem > SMEM_MAX:
            raise ValueError(f"{C} channels of {code_len} chips and "
                             f"{n_hist} history rows need {smem} B of shared "
                             f"memory a CTA (at most {SMEM_MAX})")
    return KfGeometry(C=C, n_cta=n_cta, threads=KF_THREADS, cpc=cpc,
                      prefetch=prefetch,
                      pf_bytes=prefetch_bytes(n_max) if prefetch else 0,
                      smem=smem)


@functools.lru_cache(maxsize=64)
def _max_cluster(order: int, bayes: bool, smem: int) -> int:
    from ._build import kf_library

    n = kf_library().kf_block_max_cluster(order, int(bayes), smem)
    if n < 1:
        raise RuntimeError(f"the card schedules no cluster of the KF kernel "
                           f"({smem} B of shared memory a CTA): CUDA error "
                           f"{-n}")
    return n


@functools.lru_cache(maxsize=64)
def launch_geometry(spec: KfSpec) -> KfGeometry:
    """The geometry of the spec's launch on this card: the largest cluster
    it schedules (cudaOccupancyMaxActiveClusters, asked at first launch)
    for the shared memory the geometry needs."""
    args = (spec.C, spec.n_max, spec.code_len, spec.n_hist)
    geo = kf_geometry(*args, KF_MAX_CLUSTER)
    while True:
        n = _max_cluster(spec.order, spec.bayes_run, geo.smem)
        if n >= geo.n_cta:
            return geo
        geo = kf_geometry(*args, n)


class KfParams(ctypes.Structure):
    """Mirror of `KfParams` in csrc/kf_block.cu (copied by the C entry;
    every float is the float32 value the plain version uses)."""

    _fields_ = [
        ("C", ctypes.c_int), ("n_hist", ctypes.c_int),
        ("code_len", ctypes.c_int), ("n_max", ctypes.c_int),
        ("win", ctypes.c_int), ("base", ctypes.c_int),
        ("n_epochs", ctypes.c_int), ("n_blocks", ctypes.c_int),
        ("n_samp", ctypes.c_int), ("order", ctypes.c_int),
        ("bayes_run", ctypes.c_int), ("bayes_ptrans", ctypes.c_int),
        ("bayes_strans", ctypes.c_int), ("max_lock_fail", ctypes.c_int),
        ("t0_int", ctypes.c_int),
        ("chip_rate", ctypes.c_float), ("fs", ctypes.c_float),
        ("two_pi", ctypes.c_float), ("fs2", ctypes.c_float),
        ("t", ctypes.c_float), ("aid", ctypes.c_float),
        ("t0_int_f", ctypes.c_float), ("t0_frac", ctypes.c_float),
        ("cn0_min_dbhz", ctypes.c_float), ("carrier_lock_th", ctypes.c_float),
        ("cn0_log_t", ctypes.c_float), ("inv_fs", ctypes.c_float),
        ("inv_fs2", ctypes.c_float), ("inv_n_hist", ctypes.c_float),
        ("tenth", ctypes.c_float),
        ("shifts", ctypes.c_float * 3), ("F", ctypes.c_float * 9),
        ("Q", ctypes.c_float * 9), ("dll_b_in", ctypes.c_float * 4),
        ("dll_b_out", ctypes.c_float * 3),
        ("n_cta", ctypes.c_int), ("cpc", ctypes.c_int),
        ("threads", ctypes.c_int), ("prefetch", ctypes.c_int),
        ("pf_bytes", ctypes.c_int), ("smem", ctypes.c_int),
    ]


@functools.lru_cache(maxsize=64)
def kf_params(spec: KfSpec, n_samp: int, geo: KfGeometry) -> KfParams:
    """The kernel's constants for one spec, sample count and geometry
    (built once)."""
    if spec.order not in (2, 3):
        raise ValueError("the KF kernel takes order 2 or 3")
    if geo.C != spec.C:
        raise ValueError(f"geometry of {geo.C} channels for {spec.C}")
    p = KfParams()
    for name in ("C", "n_hist", "code_len", "n_max", "win", "base",
                 "n_epochs", "n_blocks", "order", "bayes_ptrans",
                 "bayes_strans", "max_lock_fail", "t0_int"):
        setattr(p, name, int(getattr(spec, name)))
    p.n_samp, p.bayes_run = int(n_samp), int(spec.bayes_run)
    for name in ("chip_rate", "fs", "two_pi", "fs2", "t", "aid", "t0_int_f",
                 "t0_frac", "cn0_min_dbhz", "carrier_lock_th"):
        setattr(p, name, _f32(getattr(spec, name)))
    p.cn0_log_t, p.inv_fs, p.inv_fs2 = (spec.cn0_log_t, spec.inv_fs,
                                        spec.inv_fs2)
    p.inv_n_hist, p.tenth = spec.inv_n_hist, _TENTH
    for name, n in (("shifts", 3), ("F", 9), ("Q", 9), ("dll_b_in", 4),
                    ("dll_b_out", 3)):
        arr = getattr(p, name)
        for j in range(n):
            arr[j] = _f32(getattr(spec, name)[j])
    for name in ("n_cta", "cpc", "threads", "pf_bytes", "smem"):
        setattr(p, name, int(getattr(geo, name)))
    p.prefetch = int(geo.prefetch)
    return p


def check_inputs(spec: KfSpec, samples, codes, fst, ist):
    """Device, dtype, shape and contiguity of the kernel's inputs."""
    need = (spec.n_blocks - 1) * spec.base + spec.base + spec.n_max
    if samples.dim() != 1 or samples.shape[0] < need:
        raise ValueError(f"samples must be [>= {need}], got "
                         f"{tuple(samples.shape)}")
    check_tensor(samples, "samples", samples.shape, torch.complex64)
    if codes.dim() != 2 or codes.shape[1] != spec.code_len:
        raise ValueError(f"codes must be [n_slots, {spec.code_len}]")
    check_tensor(codes, "codes", codes.shape, torch.float32)
    check_tensor(fst, "fst", (n_frows(spec.n_hist), spec.C), torch.float32)
    check_tensor(ist, "ist", (N_IROWS, spec.C), torch.int32)


def kf_block_cuda(spec: KfSpec, samples, codes, fst, ist, stages=None):
    """Launch the CUDA kernel once for the spec's n_blocks blocks, as one
    cluster (launch_geometry).  The code tables must be +-1 (the kernel
    keeps them as bits; the engine checks).  `stages` (int64 [n_blocks *
    n_epochs, STAGE_POINTS] on the card, zeroed) launches the
    KF_BLOCK_STAGES build instead, which writes its timeline there."""
    global launches
    from ._build import kf_library, kf_stage_library

    check_inputs(spec, samples, codes, fst, ist)
    C, E = spec.C, spec.n_blocks * spec.n_epochs
    if stages is not None:
        check_tensor(stages, "stages", (E, STAGE_POINTS), torch.int64)
    dev = samples.device
    out_f = torch.empty((E, N_OROWS, C), dtype=torch.float32, device=dev)
    out_i = torch.empty((E, N_OIROWS, C), dtype=torch.int32, device=dev)
    fst_out = torch.empty_like(fst)
    ist_out = torch.empty_like(ist)
    geo = launch_geometry(spec)
    lib = kf_library() if stages is None else kf_stage_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.kf_block_launch(
        samples.data_ptr(), codes.data_ptr(), codes.shape[0], fst.data_ptr(),
        ist.data_ptr(), out_f.data_ptr(), out_i.data_ptr(),
        fst_out.data_ptr(), ist_out.data_ptr(),
        None if stages is None else stages.data_ptr(),
        ctypes.addressof(kf_params(spec, int(samples.shape[0]), geo)),
        stream)
    if err != 0:
        raise RuntimeError(f"kf_block kernel launch failed: CUDA error {err}")
    launches += 1
    return out_f, out_i, fst_out, ist_out


def kf_block(spec: KfSpec, samples, codes, fst, ist):
    """Walk the blocks where the inputs lie: the CUDA kernel for CUDA
    tensors, the plain torch version for CPU tensors."""
    devs = {t.device.type for t in (samples, codes, fst, ist)}
    if devs == {"cuda"}:
        return kf_block_cuda(spec, samples, codes, fst, ist)
    if devs == {"cpu"}:
        return kf_block_plain(spec, samples, codes, fst, ist)
    raise ValueError(f"kf_block inputs must all lie on one device type, got "
                     f"{sorted(devs)}")
