"""Tracking: the chunked DLL/PLL/FLL engine over channel-batched captures.

Reference parity: src/algorithms/tracking/ dll_pll_veml_tracking.cc.  Each
chunk of epochs is correlated in one batched matmul, then one launch of the
tracking-chain kernel (ops.track_chain) closes the loops epoch by epoch.
"""

from .config import TrackConfig
from .engine import TrackingEngine, TrackState, TrackOutputs, SymbolOutputs
from . import discriminators, loop_filter, lock_detectors

__all__ = [
    "TrackConfig", "TrackingEngine", "TrackState", "TrackOutputs",
    "SymbolOutputs", "discriminators", "loop_filter", "lock_detectors",
]
