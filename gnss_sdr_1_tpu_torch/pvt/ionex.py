"""IONEX TEC grid reader + ionospheric delay (rtklib_ionex.cc parity).

Reference: src/algorithms/libs/rtklib/rtklib_ionex.cc — readtec (:422,
IONEX 1.0 'START OF TEC MAP' epochs over LAT/LON1/LON2/DLON rows),
interptec (:493, bilinear grid interpolation), iondelay (:585, pierce
point + obliquity x 40.30e16/f^2 TECU->m), iontec (:646, linear time
interpolation between the bracketing maps).  The delay feeds the solver's
sat_corr hook or PPP's iono rows, scaled by (f_L1/f)^2 per band.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_FREQ1 = 1575.42e6
_FACT = 40.30e16 / _FREQ1 / _FREQ1      # TECU -> L1 meters
_RE_KM = 6371.0


@dataclasses.dataclass
class TecProduct:
    """TEC maps on a regular (epoch, lat, lon) grid; TECU units."""

    epochs_tow: np.ndarray      # [T] seconds of week
    lats: np.ndarray            # [NLAT] degrees (descending allowed)
    lons: np.ndarray            # [NLON] degrees
    tec: np.ndarray             # [T, NLAT, NLON] TECU (nan = no data)
    hgt_km: float = 450.0
    week: int = 0

    def _interp_map(self, k: int, lat: float, lon: float) -> float | None:
        """Bilinear interpolation on map k (rtklib interptec)."""
        lats, lons = self.lats, self.lons
        dlat = lats[1] - lats[0]
        dlon = lons[1] - lons[0]
        i = (lat - lats[0]) / dlat
        j = (lon - lons[0]) / dlon
        i0 = int(np.floor(i))
        j0 = int(np.floor(j))
        if not (0 <= i0 < len(lats) - 1 and 0 <= j0 < len(lons) - 1):
            return None
        a, b = i - i0, j - j0
        q = self.tec[k, i0 : i0 + 2, j0 : j0 + 2]
        if np.isnan(q).any():
            return None
        return float((1 - a) * (1 - b) * q[0, 0] + a * (1 - b) * q[1, 0]
                     + (1 - a) * b * q[0, 1] + a * b * q[1, 1])

    def _pierce(self, lat, lon, az, el):
        """Pierce point + slant factor (rtklib ionppp with the product's
        layer height)."""
        rp = _RE_KM / (_RE_KM + self.hgt_km) * np.cos(el)
        ap = np.pi / 2.0 - el - np.arcsin(rp)
        sinap = np.sin(ap)
        latp = np.arcsin(np.sin(lat) * np.cos(ap)
                         + np.cos(lat) * sinap * np.cos(az))
        lonp = lon + np.arcsin(sinap * np.sin(az) / np.cos(latp))
        fs = 1.0 / np.sqrt(1.0 - rp * rp)
        return np.degrees(latp), np.degrees(lonp), fs

    def delay_m(self, tow_s: float, lat_rad: float, lon_rad: float,
                az_rad: float, el_rad: float,
                freq_hz: float | None = None) -> float | None:
        """Slant iono delay at `freq_hz` (default L1) via time-bracketed
        maps (rtklib iontec: linear time interpolation, nearest map
        extrapolation when only one side covers the pierce point)."""
        if el_rad <= 0.0:
            return 0.0
        t = self.epochs_tow
        k = int(np.searchsorted(t, tow_s))
        if k == 0 or k >= len(t):
            return None
        latp, lonp, fs = self._pierce(lat_rad, lon_rad, az_rad, el_rad)
        v0 = self._interp_map(k - 1, latp, lonp)
        v1 = self._interp_map(k, latp, lonp)
        if v0 is None and v1 is None:
            return None
        if v0 is not None and v1 is not None:
            a = (tow_s - t[k - 1]) / (t[k] - t[k - 1])
            vtec = (1.0 - a) * v0 + a * v1
        else:
            vtec = v0 if v0 is not None else v1
        d = _FACT * fs * vtec
        if freq_hz is not None:
            d *= (_FREQ1 / freq_hz) ** 2
        return float(d)

    def sat_corr(self, freq_hz: float | None = None):
        """pvt.solver solve_pvt sat_corr hook (meters added to the modeled
        range; 0 outside the grid)."""
        def corr(_prn, az, el, lat, lon, tow):
            d = self.delay_m(tow, lat, lon, az, el, freq_hz)
            return 0.0 if d is None else d

        return corr


def read_ionex(path_or_lines, week: int = 0) -> TecProduct:
    """Parse an IONEX 1.0 file (rtklib readtec): header LAT1/LAT2/DLAT +
    LON1/LON2/DLON + HGT grids, 'START OF TEC MAP' blocks of 'LAT/LON1/
    LON2/DLON/H' rows, EXPONENT scaling, 9999 = undefined."""
    import datetime as _dt

    if isinstance(path_or_lines, (list, tuple)):
        lines = list(path_or_lines)
    else:
        with open(path_or_lines) as f:
            lines = f.readlines()
    lat1 = lat2 = dlat = lon1 = lon2 = dlon = None
    hgt = 450.0
    expo = -1
    maps = []
    epochs = []
    i = 0
    n = len(lines)
    while i < n:
        ln = lines[i]
        label = ln[60:].strip()
        if label == "LAT1 / LAT2 / DLAT":
            lat1, lat2, dlat = (float(ln[k : k + 6]) for k in (2, 8, 14))
        elif label == "LON1 / LON2 / DLON":
            lon1, lon2, dlon = (float(ln[k : k + 6]) for k in (2, 8, 14))
        elif label == "HGT1 / HGT2 / DHGT":
            hgt = float(ln[2:8])
        elif label == "EXPONENT":
            expo = int(ln[:6])
        elif label == "START OF TEC MAP":
            lats = np.arange(lat1, lat2 + 0.5 * np.sign(dlat or 1), dlat)
            lons = np.arange(lon1, lon2 + 0.5 * np.sign(dlon or 1), dlon)
            grid = np.full((len(lats), len(lons)), np.nan)
            ep = None
            i += 1
            while i < n and lines[i][60:].strip() != "END OF TEC MAP":
                lab = lines[i][60:].strip()
                if lab == "EPOCH OF CURRENT MAP":
                    y, mo, d, h, mi, s = (int(v) for v in lines[i].split()[:6])
                    t = (_dt.datetime(y, mo, d, h, mi, s)
                         - _dt.datetime(1980, 1, 6)).total_seconds()
                    w = int(t // 604800)
                    ep = t - w * 604800 + (w - (week or w)) * 604800
                    if not week:
                        week = w
                elif lab == "LAT/LON1/LON2/DLON/H":
                    lat = float(lines[i][2:8])
                    ri = int(round((lat - lat1) / dlat))
                    vals = []
                    i += 1
                    while len(vals) < len(lons):
                        row = lines[i]
                        vals.extend(int(row[5 * k : 5 * k + 5])
                                    for k in range(len(row.rstrip()) // 5))
                        i += 1
                    i -= 1
                    v = np.asarray(vals[: len(lons)], dtype=float)
                    v[v == 9999] = np.nan
                    grid[ri] = v * 10.0 ** expo
                i += 1
            epochs.append(ep)
            maps.append(grid)
        i += 1
    return TecProduct(
        epochs_tow=np.asarray(epochs, dtype=float),
        lats=np.arange(lat1, lat2 + 0.5 * np.sign(dlat or 1), dlat),
        lons=np.arange(lon1, lon2 + 0.5 * np.sign(dlon or 1), dlon),
        tec=np.stack(maps), hgt_km=hgt, week=week)


def write_ionex(path, product: TecProduct) -> None:
    """Minimal IONEX 1.0 writer (fixture generator for tests/tools)."""
    import datetime as _dt

    lats, lons = product.lats, product.lons
    dlat = lats[1] - lats[0]
    dlon = lons[1] - lons[0]
    with open(path, "w") as f:
        def hline(body, label):
            f.write(f"{body:<60}{label}\n")

        hline(f"{1.0:8.1f}            IONOSPHERE MAPS     GNSS",
              "IONEX VERSION / TYPE")
        hline(f"{len(product.epochs_tow):6d}", "# OF MAPS IN FILE")
        hline(f"  {product.hgt_km:6.1f}{product.hgt_km:6.1f}{0.0:6.1f}",
              "HGT1 / HGT2 / DHGT")
        hline(f"  {lats[0]:6.1f}{lats[-1]:6.1f}{dlat:6.1f}",
              "LAT1 / LAT2 / DLAT")
        hline(f"  {lons[0]:6.1f}{lons[-1]:6.1f}{dlon:6.1f}",
              "LON1 / LON2 / DLON")
        hline(f"{-1:6d}", "EXPONENT")
        hline("", "END OF HEADER")
        for k, tow in enumerate(product.epochs_tow):
            hline(f"{k + 1:6d}", "START OF TEC MAP")
            t = (_dt.datetime(1980, 1, 6)
                 + _dt.timedelta(seconds=product.week * 604800 + float(tow)))
            hline(f"{t.year:6d}{t.month:6d}{t.day:6d}{t.hour:6d}"
                  f"{t.minute:6d}{t.second:6d}", "EPOCH OF CURRENT MAP")
            for ri, lat in enumerate(lats):
                hline(f"  {lat:6.1f}{lons[0]:6.1f}{lons[-1]:6.1f}"
                      f"{dlon:6.1f}{product.hgt_km:6.1f}",
                      "LAT/LON1/LON2/DLON/H")
                row = product.tec[k, ri] * 10.0
                vals = np.where(np.isnan(row), 9999, np.round(row)).astype(int)
                for j0 in range(0, len(vals), 16):
                    f.write("".join(f"{v:5d}" for v in vals[j0 : j0 + 16])
                            + "\n")
            hline(f"{k + 1:6d}", "END OF TEC MAP")
        hline("", "END OF FILE")
