"""Receiver orchestration (the control plane).

Reference parity: src/core/receiver/ — ControlThread + GNSSFlowgraph +
channel FSM: acquire (idle channels) -> track (one capture segment on the
card) -> stream epochs to host telemetry / observables / PVT -> update
channel assignments between segments.
"""

from .receiver import Receiver, ReceiverConfig

__all__ = ["Receiver", "ReceiverConfig"]
