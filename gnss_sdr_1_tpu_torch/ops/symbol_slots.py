"""The symbol-grid reduction of a capture segment's per-epoch rows: the
CUDA kernel's wrapper and its plain torch version.

Each channel's epochs are cut on its own symbol grid of N epochs, its next
boundary `b0` (an epoch in [1, N], from the host's bit sync): slot 0 is
the partial head [0, b0) finishing the previous segment's symbol, slot
s >= 1 covers [b0 + (s-1)N, b0 + sN); S = cap // N + 2 slots hold every
epoch of the segment.  Per slot: the mean of the valid prompt I and Q
(the slot sums times 1/N), the valid count, and the loop-state rows
entering the slot (its first epoch's start; the pre-floor code fraction,
rem_carr, Doppler, C/N0 and code-frequency delta of the epoch before);
per channel the valid epochs and whether it still tracks after its last.
The JAX package reduces in XLA (gnss_sdr_1_tpu/track/engine.py
`_symbol_outputs`); it is not a Pallas kernel.

The kernel (csrc/symbol_slots.cuh, built into both walks' libraries) is
one launch of a CTA per channel, queued behind the walk on the same
stream; the symbol offsets go by value in its parameter block, so nothing
is uploaded and nothing synchronises.  It writes every field into one
packed int32 buffer (`layout`), which one copy brings to the host and
`unpack` splits into numpy arrays.  It gives the plain version's bits,
zeros' signs included.  The engine takes the kernel for rows on the card
and the plain version's fields for rows on the CPU.

Signature of `symbol_slots_plain` / `symbol_slots_cuda`:
    (out_f [cap, N_OROWS, C] f32, out_i [cap, 2, C] i32,
     out_corr [cap, 2K, C] f32, entering_rem [C] f32 (the channels'
     rem_code entering epoch 0), sym_off [C] (host integers), N,
     prompt_index)
`symbol_slots_plain` returns FIELDS as a dict of tensors where the rows
lie; `symbol_slots_cuda` (with the library handle of the walk that wrote
the rows) the packed buffer, int32 [SYM_FIELDS S C + 2 C], on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .track_chain import (N_OROWS, O_ACTIVE, O_CN0, O_DELTA, O_DOPPLER,
                          O_REM_CARR, O_REM_CODE, O_VALID, check_tensor)

_F32 = torch.float32
_I32 = torch.int32

# the fields, in SymbolOutputs' order: SYM_FIELDS [S, C] ones
# (symbol_slots.cuh SYM_START .. SYM_VCOUNT), then n_valid and active [C]
FIELDS = ("start", "mean_i", "mean_q", "frac", "rem_carr_phase_rad",
          "carrier_doppler_hz", "cn0_dbhz", "code_freq_delta", "vcount",
          "n_valid", "active")
SYM_FIELDS = 9
_INT_FIELDS = ("start", "vcount", "n_valid")
# channels whose symbol offsets the parameter block holds: the block and
# the kernel's pointers fill the 4 KB of a launch's parameters
SYM_MAX_C = 1000

# kernel launches made by `symbol_slots_cuda` (never by symbol_slots_plain)
launches = 0


def n_slots(cap: int, N: int) -> int:
    return cap // N + 2


def symbol_slots_plain(out_f, out_i, out_corr, entering_rem, sym_off,
                       N: int, prompt_index: int) -> dict:
    """The reduction in plain torch ops where the rows lie: slot sums by a
    per-channel roll forward by N - b0, which puts epoch b0 at row N, and
    an [S, N] reshape; the picks by gathers.  Returns FIELDS as tensors
    ([S, C], n_valid int32 and active bool [C])."""
    dev = out_f.device
    cap, _, C = out_f.shape
    S = n_slots(cap, N)
    p = prompt_index
    K = out_corr.shape[1] // 2
    v = out_f[:, O_VALID]                                      # [cap, C]
    fields = torch.stack([out_corr[:, p] * v, out_corr[:, K + p] * v,
                          v], dim=-1)                          # [cap,C,3]
    P = S * N
    fields = torch.cat([fields, torch.zeros(
        (P - cap, C, 3), dtype=_F32, device=dev)])
    b0 = torch.as_tensor(np.asarray(sym_off, np.int64), device=dev)
    rows = torch.arange(P, device=dev)[:, None]
    src = torch.remainder(rows - (N - b0)[None, :], P)         # [P, C]
    rolled = torch.gather(fields, 0, src[..., None].expand(P, C, 3))
    # the slot sums epoch by epoch, in order: a channel's sums do not
    # depend on how many channels share the call (a reduction kernel's
    # order does, on the CPU and on the card)
    slots = rolled.reshape(S, N, C, 3)
    sums = slots[:, 0]
    for k in range(1, N):
        sums = sums + slots[:, k]                              # [S, C, 3]
    sl = torch.arange(S, device=dev)[:, None]
    e_s = torch.clamp(b0[None, :] - N + sl * N, 0, cap - 1)    # [S, C]
    em1 = torch.clamp(e_s - 1, 0, cap - 1)
    rem = out_f[:, O_REM_CODE]
    prev = torch.cat([entering_rem[None], rem[:-1]])
    # pre-floor code-phase fraction (receiver._harvest wrap note)
    fracs = rem - torch.round(rem - prev)
    nv = v.sum(dim=0).to(torch.int64)                          # [C]
    last = torch.clamp(nv - 1, 0, cap - 1)
    return dict(
        start=torch.gather(out_i[:, 0], 0, e_s),
        mean_i=sums[..., 0] * (1.0 / N),
        mean_q=sums[..., 1] * (1.0 / N),
        frac=torch.gather(fracs, 0, em1),
        rem_carr_phase_rad=torch.gather(out_f[:, O_REM_CARR], 0, em1),
        carrier_doppler_hz=torch.gather(out_f[:, O_DOPPLER], 0, em1),
        cn0_dbhz=torch.gather(out_f[:, O_CN0], 0, em1),
        code_freq_delta=torch.gather(out_f[:, O_DELTA], 0, em1),
        vcount=sums[..., 2].to(_I32),
        n_valid=nv.to(_I32),
        active=out_f[:, O_ACTIVE].gather(0, last[None])[0] > 0.5)


def layout(S: int, C: int) -> dict:
    """Word offsets of each field in the packed buffer and its `total`
    length (symbol_slots.cuh): the [S, C] fields one after another, then
    n_valid and active [C]."""
    off = {f: k * S * C for k, f in enumerate(FIELDS[:SYM_FIELDS])}
    off["n_valid"] = SYM_FIELDS * S * C
    off["active"] = off["n_valid"] + C
    off["total"] = off["active"] + C
    return off


def unpack(buf: np.ndarray, S: int, C: int) -> dict:
    """FIELDS as numpy arrays of their own (copies) from a packed buffer
    on the host: [S, C] int32 / float32, n_valid int32 and active bool
    [C]."""
    off = layout(S, C)
    out = {}
    for f in FIELDS[:SYM_FIELDS]:
        a = buf[off[f]:off[f] + S * C]
        a = a if f in _INT_FIELDS else a.view(np.float32)
        out[f] = a.reshape(S, C).copy()
    out["n_valid"] = buf[off["n_valid"]:off["active"]].copy()
    out["active"] = buf[off["active"]:off["total"]] != 0
    return out


class SymParams(ctypes.Structure):
    """Mirror of `SymParams` in csrc/symbol_slots.cuh (its static_asserts
    state the offsets): the shapes, the mean's scale and each channel's
    symbol offset."""

    _fields_ = [("cap", ctypes.c_int), ("C", ctypes.c_int),
                ("S", ctypes.c_int), ("N", ctypes.c_int),
                ("K", ctypes.c_int), ("prompt", ctypes.c_int),
                ("scale", ctypes.c_float),
                ("off", ctypes.c_int * SYM_MAX_C)]


def sym_params(cap: int, C: int, N: int, K: int, prompt_index: int,
               sym_off) -> SymParams:
    """The launch's parameter block; `sym_off` [C] host integers."""
    if not 1 <= C <= SYM_MAX_C:
        raise ValueError(f"the symbol-grid kernel takes 1 to {SYM_MAX_C} "
                         f"channels an engine, got {C}")
    off = np.asarray(sym_off, np.int64).reshape(-1)
    if off.size != C:
        raise ValueError(f"sym_off holds {off.size} offsets for {C} "
                         f"channels")
    if np.any(off != off.astype(np.int32)):
        raise ValueError("symbol offsets must fit in 32 bits")
    # the float32 that torch rounds the mean's Python scale 1.0 / N to
    p = SymParams(cap=cap, C=C, S=n_slots(cap, N), N=N, K=K,
                  prompt=prompt_index, scale=1.0 / N)
    p.off[:C] = off.tolist()
    return p


def symbol_slots_cuda(out_f, out_i, out_corr, entering_rem, sym_off,
                      N: int, prompt_index: int, lib) -> torch.Tensor:
    """One kernel launch on the current stream, behind what it holds (the
    walk that wrote the rows); never synchronises.  `lib` is the library
    the walk already loaded (`_build.library()` for the chunked walk,
    `_build.gather_library()` for the gather walk): both carry the kernel.
    Returns the packed buffer on the card."""
    global launches

    cap, _, C = out_f.shape
    K = out_corr.shape[1] // 2
    check_tensor(out_f, "out_f", (cap, N_OROWS, C), _F32)
    check_tensor(out_i, "out_i", (cap, 2, C), _I32)
    check_tensor(out_corr, "out_corr", (cap, 2 * K, C), _F32)
    entering_rem = entering_rem.contiguous()
    check_tensor(entering_rem, "entering_rem", (C,), _F32)
    dev = out_f.device
    if any(t.device != dev for t in (out_i, out_corr, entering_rem)):
        raise ValueError("the rows and entering_rem must lie on one card")
    p = sym_params(cap, C, int(N), K, int(prompt_index), sym_off)
    out = torch.empty((layout(p.S, C)["total"],), dtype=_I32, device=dev)
    err = lib.symbol_slots_launch(
        out_f.data_ptr(), out_i.data_ptr(), out_corr.data_ptr(),
        entering_rem.data_ptr(), out.data_ptr(), ctypes.addressof(p),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"symbol_slots kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
