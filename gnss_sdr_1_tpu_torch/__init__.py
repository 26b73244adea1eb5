"""GNSS software-defined receiver on PyTorch and CUDA (NVIDIA Hopper).

A port of the `gnss_sdr_1_tpu` package (JAX on a TPU) to PyTorch, with the
fused tracking-chain kernel written by hand in CUDA C++ for `sm_90a`.  The
JAX package stays the reference; this package imports none of it and keeps
its own copies of the numpy host modules it needs.  Module names follow the
JAX package so each counterpart is easy to find.

Layering (bottom-up):
    constants   per-signal ICD constants (GPS L1 C/A)
    codes       PRN code generation
    acquire     batched PCPS on torch.fft
    track       chunked DLL/PLL/FLL engine (torch) + loop primitives
    ops         the hand-written kernels and their plain torch versions
    csrc        CUDA C++ sources of those kernels
    telemetry   LNAV decoding (host)
    observables pseudorange/phase formation (host)
    pvt         least-squares PVT (host)
    runtime     receiver orchestration
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
