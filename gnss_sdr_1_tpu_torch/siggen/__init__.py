"""Synthetic multi-satellite baseband signal generator (host, NumPy).

Reference parity: src/algorithms/signal_generator/ — the flowgraph source
that synthesizes multi-satellite baseband with configurable CN0, Doppler and
delay, used as the deterministic test fixture throughout the reference's
test suite (SURVEY.md §4.8).
"""

from .generator import SatParams, generate_baseband

__all__ = ["SatParams", "generate_baseband"]
