"""Tracking: the DLL/PLL/FLL engine over channel-batched captures, the KF
tracker (track.kf) and the TCP connector (track.tcp_connector).

Reference parity: src/algorithms/tracking/ dll_pll_veml_tracking.cc.  The
engine's chunked correlator correlates each chunk of epochs in one batched
pass, then one launch of the tracking-chain kernel (ops.track_chain) closes
the loops epoch by epoch; its gather correlator walks every epoch of a
segment with the exact resampler in one gather_block launch.
"""

from .config import TrackConfig
from .engine import TrackingEngine, TrackState, TrackOutputs, SymbolOutputs
from . import discriminators, loop_filter, lock_detectors

__all__ = [
    "TrackConfig", "TrackingEngine", "TrackState", "TrackOutputs",
    "SymbolOutputs", "discriminators", "loop_filter", "lock_detectors",
]
