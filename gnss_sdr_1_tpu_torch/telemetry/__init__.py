"""Telemetry decoding (host-side — bit-level, branchy, low-rate).

Reference parity: src/algorithms/telemetry_decoder/: GPS L1 C/A LNAV
(gps_l1_ca_telemetry_decoder_gs.cc + gps_navigation_message.cc); the other
signals' decoders sit behind the adapters of channel_adapters.py, BeiDou
B1I/B3I D1/D2 NAV (beidou_dnav.py) among them.
"""

from .lnav import (
    LNAV_PREAMBLE,
    GpsEphemeris,
    encode_lnav_frame,
    decode_subframe,
    parity_check,
)
from .decoder import LnavDecoder, SymbolBatch
from .channel_adapters import BeidouChannelDecoder

__all__ = [
    "LNAV_PREAMBLE", "GpsEphemeris", "encode_lnav_frame", "decode_subframe",
    "parity_check", "LnavDecoder", "SymbolBatch", "BeidouChannelDecoder",
]
