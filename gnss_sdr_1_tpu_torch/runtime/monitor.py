"""Monitoring: the inter-block record and UDP streaming sinks.

Reference parity: Gnss_Synchro (src/core/system_parameters/gnss_synchro.h:
44-81 — THE inter-block record), gnss_synchro_monitor
(src/core/monitor/gnss_synchro_monitor.{h,cc} — UDP stream of per-epoch
channel states with decimation) and Monitor_Pvt_Udp_Sink
(src/algorithms/PVT/libs/monitor_pvt_udp_sink.cc).  Serialization is JSON
lines instead of boost::serialization — same content, inspectable with any
tool.
"""

from __future__ import annotations

import dataclasses
import json
import socket

import numpy as np


@dataclasses.dataclass
class GnssSynchro:
    """Per-channel per-epoch record (gnss_synchro.h field parity)."""

    system: str = "G"
    signal: str = "1C"
    prn: int = 0
    channel_id: int = -1
    # acquisition
    acq_delay_samples: float = 0.0
    acq_doppler_hz: float = 0.0
    acq_samplestamp_samples: int = 0
    flag_valid_acquisition: bool = False
    # tracking
    prompt_i: float = 0.0
    prompt_q: float = 0.0
    cn0_db_hz: float = 0.0
    carrier_doppler_hz: float = 0.0
    carrier_phase_rads: float = 0.0
    code_phase_samples: float = 0.0
    tracking_sample_counter: int = 0
    flag_valid_symbol_output: bool = False
    # telemetry
    tow_at_current_symbol_ms: float = 0.0
    flag_valid_word: bool = False
    # observables
    pseudorange_m: float = 0.0
    rx_time: float = 0.0
    flag_valid_pseudorange: bool = False

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


class UdpSink:
    """Decimated UDP JSON-lines sink (gnss_synchro_monitor analogue)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 1234,
                 decimation: int = 1):
        self._addr = (host, port)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._decimation = max(1, int(decimation))
        self._count = 0

    def send_synchro(self, records: list[GnssSynchro]) -> None:
        self._count += 1
        if self._count % self._decimation:
            return
        payload = "\n".join(r.to_json() for r in records).encode()
        self._sock.sendto(payload, self._addr)

    def send_pvt(self, sol) -> None:
        """Monitor_Pvt analogue: stream one PVT solution."""
        d = {
            "valid": bool(sol.valid),
            "rx_time": float(sol.rx_time_tow_s),
            "lat_deg": sol.lat_deg,
            "lon_deg": sol.lon_deg,
            "height_m": sol.height_m,
            "vel_ecef_ms": [float(v) for v in np.asarray(sol.rx_vel_ecef_ms)],
            "clock_bias_s": float(sol.rx_clock_bias_s),
            "clock_drift_s_s": float(sol.rx_clock_drift_s_s),
            "n_sats": sol.n_sats,
        }
        if sol.dops:
            d.update({k: float(v) for k, v in sol.dops.items()})
        self._sock.sendto(json.dumps(d).encode(), self._addr)

    def close(self) -> None:
        self._sock.close()
