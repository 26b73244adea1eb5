"""RTK / DGNSS: double-difference relative positioning with MLAMBDA
integer ambiguity resolution.

Reference parity: the single-baseline slice of the reference's RTK engine —
rtklib_lambda.cc:1-419 (LD factorization, lattice reduction, mlambda
search), driven the way rtklib_rtkpos.cc relpos()/rtklib_solver.cc:491 use
it, with positioning modes selected via PVT.positioning_mode (pvt_conf).

Architecture difference vs the reference (by design, not translation): the
reference runs a per-epoch EKF over float ambiguities (rtkpos).  Here the
baseline processor is a BATCH weighted least squares over an epoch window
with constant double-difference ambiguities — equivalent information
content for the static/short-kinematic cases this slice covers, and far
simpler to validate.  Modes:

  * "DGNSS"      — code-only double differences (sub-meter).
  * "Static"     — code+carrier batch float solution, MLAMBDA fix,
                   ratio-test validation, fixed-baseline output (cm).
  * "Kinematic"  — ambiguities estimated over the window (rover may move
                   slowly) then per-epoch carrier-only position updates
                   with the fixed integers.

All math is host-side float64 (PVT plane, SURVEY.md §2.10 TPU mapping).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import SPEED_OF_LIGHT_M_S
from .ephemeris import satellite_clock_correction, satellite_position_velocity
from .geodesy import az_el
from .solver import _rotate_earth

_LOOPMAX = 10000


# ---------------------------------------------------------------------------
# MLAMBDA integer least squares (rtklib_lambda.cc parity)
# ---------------------------------------------------------------------------

def _ld(Q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Factor Q = L' diag(D) L with unit lower-triangular L (LD at
    rtklib_lambda.cc:59)."""
    n = Q.shape[0]
    A = Q.astype(np.float64).copy()
    L = np.zeros((n, n))
    D = np.zeros(n)
    for i in range(n - 1, -1, -1):
        D[i] = A[i, i]
        if D[i] <= 0.0:
            raise np.linalg.LinAlgError("LD factorization: Q not positive definite")
        a = np.sqrt(D[i])
        L[i, : i + 1] = A[i, : i + 1] / a
        for j in range(i):
            A[j, : j + 1] -= L[i, : j + 1] * L[i, j]
        L[i, : i + 1] /= L[i, i]
    return L, D


def _reduction(L: np.ndarray, D: np.ndarray) -> np.ndarray:
    """Lattice (decorrelation) reduction; mutates L, D; returns Z with
    z = Z' a (reduction/gauss/perm at rtklib_lambda.cc:97-173)."""
    n = len(D)
    Z = np.eye(n)
    j = k = n - 2
    while j >= 0:
        if j <= k:
            for i in range(j + 1, n):
                mu = np.round(L[i, j])
                if mu != 0.0:
                    L[i:n, j] -= mu * L[i:n, i]
                    Z[:, j] -= mu * Z[:, i]
        delta = D[j] + L[j + 1, j] ** 2 * D[j + 1]
        if delta + 1e-6 < D[j + 1]:
            eta = D[j] / delta
            lam = D[j + 1] * L[j + 1, j] / delta
            D[j] = eta * D[j + 1]
            D[j + 1] = delta
            a0 = L[j, :j].copy()
            a1 = L[j + 1, :j].copy()
            L[j, :j] = -L[j + 1, j] * a0 + a1
            L[j + 1, :j] = eta * a0 + lam * a1
            L[j + 1, j] = lam
            tmp = L[j + 2 :, j].copy()
            L[j + 2 :, j] = L[j + 2 :, j + 1]
            L[j + 2 :, j + 1] = tmp
            tmp = Z[:, j].copy()
            Z[:, j] = Z[:, j + 1]
            Z[:, j + 1] = tmp
            k = j
            j = n - 2
        else:
            j -= 1
    return Z


def _search(L: np.ndarray, D: np.ndarray, zs: np.ndarray, m: int
            ) -> tuple[np.ndarray, np.ndarray]:
    """Depth-first mlambda search for the m best integer vectors
    (search at rtklib_lambda.cc:178)."""
    n = len(D)
    zn = np.zeros((m, n))
    s = np.zeros(m)
    S = np.zeros((n, n))
    dist = np.zeros(n)
    zb = np.zeros(n)
    z = np.zeros(n)
    step = np.zeros(n)
    k = n - 1
    zb[k] = zs[k]
    z[k] = np.round(zb[k])
    y = zb[k] - z[k]
    step[k] = np.sign(y) if y != 0 else 1.0
    nn = 0
    imax = 0
    maxdist = 1e99
    for _ in range(_LOOPMAX):
        newdist = dist[k] + y * y / D[k]
        if newdist < maxdist:
            if k != 0:
                k -= 1
                dist[k] = newdist
                S[k, : k + 1] = (S[k + 1, : k + 1]
                                 + (z[k + 1] - zb[k + 1]) * L[k + 1, : k + 1])
                zb[k] = zs[k] + S[k, k]
                z[k] = np.round(zb[k])
                y = zb[k] - z[k]
                step[k] = np.sign(y) if y != 0 else 1.0
            else:
                if nn < m:
                    if nn == 0 or newdist > s[imax]:
                        imax = nn
                    zn[nn] = z
                    s[nn] = newdist
                    nn += 1
                else:
                    if newdist < s[imax]:
                        zn[imax] = z
                        s[imax] = newdist
                        imax = int(np.argmax(s))
                    maxdist = s[imax]
                z[0] += step[0]
                y = zb[0] - z[0]
                step[0] = -step[0] - np.sign(step[0])
        else:
            if k == n - 1:
                break
            k += 1
            z[k] += step[k]
            y = zb[k] - z[k]
            step[k] = -step[k] - np.sign(step[k])
    order = np.argsort(s[:nn])
    return zn[order], s[order]


def lambda_ilse(a_float: np.ndarray, Q: np.ndarray, m: int = 2
                ) -> tuple[np.ndarray, np.ndarray]:
    """Integer least-squares: return the m best integer vectors (rows) and
    their quadratic residuals, smallest first (lambda() at
    rtklib_lambda.cc:300-360)."""
    a_float = np.asarray(a_float, dtype=np.float64)
    L, D = _ld(np.asarray(Q, dtype=np.float64))
    Z = _reduction(L, D)
    zs = Z.T @ a_float
    zn, s = _search(L, D, zs, m)
    # back-transform: a = Z'^{-1} z (integer since Z is unimodular)
    cands = np.linalg.solve(Z.T, zn.T).T
    return np.round(cands), s


# ---------------------------------------------------------------------------
# Double-difference baseline processor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BaselineSolution:
    valid: bool
    mode: str
    fixed: bool = False
    ratio: float = 0.0
    rover_ecef_m: np.ndarray | None = None       # float/DGNSS or fixed
    rover_float_ecef_m: np.ndarray | None = None
    ambiguities: np.ndarray | None = None        # fixed DD integers
    n_dd: int = 0
    n_epochs: int = 0
    epoch_positions: list | None = None          # kinematic per-epoch fixes


def _sat_pos_at(eph, tow: float, pr_m: float) -> np.ndarray:
    tau = pr_m / SPEED_OF_LIGHT_M_S
    t_tx = tow - tau
    clk = satellite_clock_correction(eph, t_tx)
    pos, _ = satellite_position_velocity(eph, t_tx - clk)
    return _rotate_earth(pos, tau)


def interpolate_base(base_epochs: list, tow: float):
    """Linear interpolation of the base station's (pseudorange, phase) to a
    rover epoch time — the role of the reference's age-of-differential
    handling in relpos (base obs arrive asynchronously over RTCM)."""
    times = [t for t, _ in base_epochs]
    if not times or tow < times[0] or tow > times[-1]:
        return None
    i1 = int(np.searchsorted(times, tow))
    i1 = max(1, min(i1, len(times) - 1))
    i0 = i1 - 1
    t0, o0 = base_epochs[i0]
    t1, o1 = base_epochs[i1]
    span = t1 - t0
    w = 0.0 if span == 0 else (tow - t0) / span
    out = {}
    for prn in set(o0) & set(o1):
        a, b = o0[prn], o1[prn]
        out[prn] = (
            a.pseudorange_m + w * (b.pseudorange_m - a.pseudorange_m),
            a.carrier_phase_cycles
            + w * (b.carrier_phase_cycles - a.carrier_phase_cycles),
        )
    return out


def solve_baseline(
    rover_epochs: list,
    base_epochs: list,
    base_ecef: np.ndarray,
    ephemerides: dict,
    wavelength_m: float,
    mode: str = "Static",
    code_sigma_m: float = 0.7,
    phase_sigma_m: float = 0.01,
    ratio_threshold: float = 3.0,
    el_mask_deg: float = 10.0,
) -> BaselineSolution:
    """Batch double-difference solution over an epoch window.

    `rover_epochs` / `base_epochs`: lists of (rx_tow_s, {prn: Observation})
    with Observation carrying pseudorange_m and carrier_phase_cycles (the
    receiver's integrated-NCO phase: -range/lambda + per-channel constant,
    so DD ambiguities are constant while lock holds).
    """
    inval = BaselineSolution(False, mode)
    base_ecef = np.asarray(base_ecef, dtype=np.float64)
    use_phase = mode.upper() != "DGNSS"

    # epoch matching: interpolate base to rover times
    matched = []
    for tow, robs in rover_epochs:
        bobs = interpolate_base(base_epochs, tow)
        if bobs is None:
            continue
        common = sorted(set(robs) & set(bobs) & set(ephemerides))
        if len(common) >= 4:
            matched.append((tow, robs, bobs, common))
    if not matched:
        return inval

    # satellites present in EVERY matched epoch; reference = highest
    # elevation from the base (rtkpos selects per-system reference sats)
    sats = sorted(set.intersection(*[set(c) for *_, c in matched]))
    if len(sats) < 4:
        return inval
    t0, r0, b0, _ = matched[0]
    els = {}
    for p in sats:
        sp = _sat_pos_at(ephemerides[p], t0, b0[p][0])
        els[p] = az_el(base_ecef, sp)[1]
    sats = [p for p in sats if np.degrees(els[p]) >= el_mask_deg]
    if len(sats) < 4:
        return inval
    ref = max(sats, key=lambda p: els[p])
    others = [p for p in sats if p != ref]
    n_dd = len(others)
    K = len(matched)

    # initial rover position: base (short-baseline assumption)
    x0 = base_ecef.copy()
    lam = wavelength_m
    n_unk = 3 + (n_dd if use_phase else 0)

    for _ in range(4):  # Gauss-Newton on the batch
        rows_a, rows_r, rows_w = [], [], []
        for tow, robs, bobs, _ in matched:
            spos = {p: _sat_pos_at(ephemerides[p], tow, bobs[p][0])
                    for p in sats}
            rho_r = {p: np.linalg.norm(spos[p] - x0) for p in sats}
            rho_b = {p: np.linalg.norm(spos[p] - base_ecef) for p in sats}
            e = {p: (x0 - spos[p]) / rho_r[p] for p in sats}
            for j, p in enumerate(others):
                g = e[p] - e[ref]
                rng_dd = (rho_r[p] - rho_b[p]) - (rho_r[ref] - rho_b[ref])
                dd_p = ((robs[p].pseudorange_m - bobs[p][0])
                        - (robs[ref].pseudorange_m - bobs[ref][0]))
                row = np.zeros(n_unk)
                row[:3] = g
                rows_a.append(row)
                rows_r.append(dd_p - rng_dd)
                rows_w.append(1.0 / code_sigma_m)
                if use_phase:
                    # receiver phase is -range/lambda + const:
                    # lambda * (-DDphi) = DDrange + lambda * N
                    dd_l = -lam * ((robs[p].carrier_phase_cycles
                                    - bobs[p][1])
                                   - (robs[ref].carrier_phase_cycles
                                      - bobs[ref][1]))
                    row = np.zeros(n_unk)
                    row[:3] = g
                    row[3 + j] = lam
                    rows_a.append(row)
                    rows_r.append(dd_l - rng_dd)
                    rows_w.append(1.0 / phase_sigma_m)
        A = np.asarray(rows_a)
        r = np.asarray(rows_r)
        w = np.asarray(rows_w)
        N = (A * w[:, None] ** 2).T @ A
        try:
            Qu = np.linalg.inv(N)
        except np.linalg.LinAlgError:
            return inval
        du = Qu @ ((A * w[:, None] ** 2).T @ r)
        x0 = x0 + du[:3]
        if np.linalg.norm(du[:3]) < 1e-4:
            break
    sol = BaselineSolution(True, mode, n_dd=n_dd, n_epochs=K,
                           rover_float_ecef_m=x0.copy(),
                           rover_ecef_m=x0.copy())
    if not use_phase:
        return sol

    # MLAMBDA fix on the ambiguity block + ratio-test validation.
    # The Gauss-Newton above re-forms the residual from raw observables each
    # pass and only x is iterated, so the solved N block is the ABSOLUTE
    # float ambiguity at the converged linearization point.
    a_float = du[3:]
    Qa = Qu[3:, 3:]
    Qxa = Qu[:3, 3:]
    try:
        cands, s = lambda_ilse(a_float, Qa, m=2)
    except np.linalg.LinAlgError:
        return sol
    if len(s) < 2 or s[0] <= 0:
        return sol
    ratio = float(s[1] / max(s[0], 1e-12))
    sol.ratio = ratio
    if ratio < ratio_threshold:
        return sol
    a_fix = cands[0]
    x_fix = x0 - Qxa @ np.linalg.solve(Qa, a_float - a_fix)
    sol.fixed = True
    sol.ambiguities = a_fix
    sol.rover_ecef_m = x_fix

    if mode.upper() == "KINEMATIC":
        # per-epoch carrier-only position with the fixed integers
        positions = []
        for tow, robs, bobs, _ in matched:
            xk = x_fix.copy()
            for _ in range(3):
                spos = {p: _sat_pos_at(ephemerides[p], tow, bobs[p][0])
                        for p in sats}
                rows_a, rows_r = [], []
                rho_b = {p: np.linalg.norm(spos[p] - base_ecef) for p in sats}
                rho_r = {p: np.linalg.norm(spos[p] - xk) for p in sats}
                e = {p: (xk - spos[p]) / rho_r[p] for p in sats}
                for j, p in enumerate(others):
                    g = e[p] - e[ref]
                    rng_dd = (rho_r[p] - rho_b[p]) - (rho_r[ref] - rho_b[ref])
                    dd_l = -lam * ((robs[p].carrier_phase_cycles - bobs[p][1])
                                   - (robs[ref].carrier_phase_cycles
                                      - bobs[ref][1]))
                    rows_a.append(g)
                    rows_r.append(dd_l - rng_dd - lam * a_fix[j])
                A = np.asarray(rows_a)
                r = np.asarray(rows_r)
                dx = np.linalg.lstsq(A, r, rcond=None)[0]
                xk = xk + dx
                if np.linalg.norm(dx) < 1e-5:
                    break
            positions.append((tow, xk))
        sol.epoch_positions = positions
    return sol
