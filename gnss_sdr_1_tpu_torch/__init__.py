"""GNSS software-defined receiver on PyTorch and CUDA (NVIDIA Hopper).

A port of the `gnss_sdr_1_tpu` package (JAX on a TPU) to PyTorch, with its
tracking kernels written by hand in CUDA C++ for `sm_90a`.  The JAX package
stays the reference; this package imports none of it and keeps its own
copies of the numpy host modules it needs.  Module names follow the JAX
package so each counterpart is easy to find.

Signals: GPS L1 C/A ('1C'), L2CM ('2S') and L5 ('L5'), Galileo E1B ('1B')
and E5a ('5X'), GLONASS L1/L2 C/A with FDMA ('1G'/'2G') and BeiDou B1I/B3I
('B1'/'B3').

Layering (bottom-up):
    constants   per-signal ICD constants of the nine signals
    codes       PRN, secondary and BOC replica codes
    acquire     batched PCPS and its variants on torch.fft
    track       the DLL/PLL/FLL engine with two correlators (chunked: lag
                windows read by interpolation, the default; gather: the
                exact per-epoch resampler), the KF tracker, the TCP
                connector, and the loop primitives
    ops         the hand-written kernels and their plain torch versions
                (chunk correlator, tracking chain, gather walk, one-epoch
                multicorrelator, KF block walk)
    csrc        CUDA C++ sources of those kernels
    telemetry   LNAV, CNAV, I/NAV, F/NAV, GNAV and D1/D2 decoding (host)
    observables pseudorange/phase formation (host)
    pvt         least-squares PVT (host)
    runtime     receiver orchestration, multi-group receivers, conf files
    siggen      synthetic signal generator

Entry points run on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# Full float32 everywhere: the correlation matmuls must not drop to TF32
# (three decimal digits would move the tracking discriminators).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    None means the card: `cuda`, and an error when no GPU is present — there
    is no path that quietly carries on on the CPU.  The CPU is used only
    when the caller asks for it (`device="cpu"`), as the tests do."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the "
                "CPU explicitly")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but none is available")
    return dev
