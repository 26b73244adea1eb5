"""A-GNSS assistance persistence and hot/warm-start support.

Reference parity: ControlThread's assistance path (control_thread.cc:566
assist_GNSS) — ephemeris/almanac/iono/UTC/ref-time/ref-location persisted
as XML via boost::serialization (filenames control_thread.h:186-199) so the
next run starts hot/warm.  Here the store is JSON (same content,
inspectable); the SUPL 1.0 network client is represented by the same
interface and lands in a later round (SURVEY §2.13 item 6, low priority —
this container is zero-egress anyway).

Hot start uses saved ephemerides + a reference position/time to predict
visible satellites and their Doppler, shrinking the acquisition search
(get_visible_sats analogue, control_thread.cc:890).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

from ..constants import SPEED_OF_LIGHT_M_S
from ..pvt.ephemeris import satellite_position_velocity
from ..pvt.geodesy import az_el
from ..telemetry.lnav import GpsEphemeris


def save_assistance(path: str, ephemerides: dict[int, GpsEphemeris],
                    ref_llh: tuple[float, float, float] | None = None,
                    ref_tow_s: float | None = None) -> None:
    data = {
        "ephemerides": {
            str(p): dataclasses.asdict(e) for p, e in ephemerides.items()
        },
        "ref_llh_deg_m": list(ref_llh) if ref_llh else None,
        "ref_tow_s": ref_tow_s,
    }
    pathlib.Path(path).write_text(json.dumps(data, indent=1))


def load_assistance(path: str) -> tuple[dict[int, GpsEphemeris], tuple | None, float | None]:
    data = json.loads(pathlib.Path(path).read_text())
    ephs = {
        int(p): GpsEphemeris(**fields)
        for p, fields in data["ephemerides"].items()
    }
    ref = tuple(data["ref_llh_deg_m"]) if data.get("ref_llh_deg_m") else None
    return ephs, ref, data.get("ref_tow_s")


def predict_visible(
    ephemerides: dict[int, GpsEphemeris],
    rx_ecef: np.ndarray,
    tow_s: float,
    min_elevation_deg: float = 5.0,
    carrier_freq_hz: float = 1575.42e6,
) -> dict[int, dict]:
    """Visible satellites with predicted Doppler for assisted acquisition.

    Returns {prn: {az_deg, el_deg, doppler_hz}} — feeds a narrowed
    acquisition Doppler window (pcps_assisted_acquisition analogue).
    """
    out: dict[int, dict] = {}
    for prn, eph in ephemerides.items():
        pos, vel = satellite_position_velocity(eph, tow_s)
        if not np.all(np.isfinite(pos)):
            continue
        az, el = az_el(rx_ecef, pos)
        if np.degrees(el) < min_elevation_deg:
            continue
        los = (pos - rx_ecef)
        los = los / np.linalg.norm(los)
        range_rate = float(vel @ los)
        doppler = -range_rate / SPEED_OF_LIGHT_M_S * carrier_freq_hz
        out[prn] = {
            "az_deg": float(np.degrees(az)),
            "el_deg": float(np.degrees(el)),
            "doppler_hz": doppler,
        }
    return out


def predict_visible_from_almanac(
    almanacs: dict[int, "GpsAlmanac"],
    rx_ecef: np.ndarray,
    tow_s: float,
    week: int = 0,
    **kwargs,
) -> dict[int, dict]:
    """Warm-start visible-sat prediction from BROADCAST almanac alone
    (subframe 4/5 pages collected by LnavDecoder.almanacs) — the
    control_thread.cc:890 get_visible_sats path that works without full
    ephemerides."""
    from ..telemetry.lnav import GpsAlmanac  # noqa: F401 (type only)

    ephs = {p: a.to_ephemeris(week) for p, a in almanacs.items()}
    return predict_visible(ephs, rx_ecef, tow_s, **kwargs)
