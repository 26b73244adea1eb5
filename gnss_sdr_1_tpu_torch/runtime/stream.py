"""Sample transport for Receiver.process_stream: raw items staged in pinned
host memory, copied to the card as they are, and unpacked there.

Raw integer I/Q crosses PCIe at its own width (ishort 4 B a sample, ibyte
2 B, nibble-packed 2bits_cpx 0.5 B, against complex64's 8 B) and becomes
complex64 on the receiver's device with torch ops (the JAX package's
`unpack_dev`, an XLA program there; no TPU kernel stands behind it).
"""

from __future__ import annotations

import numpy as np
import torch

# the raw formats process_stream accepts: interleaved I/Q integers and the
# nibble-packed 2-bit I/Q of LabSat/NSR-class front ends
STREAM_FORMATS = ("ishort", "ibyte", "cshort", "cbyte", "2bits_cpx")


def unpack_raw(raw: torch.Tensor, fmt: str, scale: float) -> torch.Tensor:
    """Raw items -> complex64 samples times `scale`, on raw's device.

    Interleaved I/Q: `scale * raw.view(-1, 2)` in float32.  2bits_cpx (the
    io.formats layout): two samples a byte, the most significant nibble
    first, a nibble Q1 Q0 I1 I0, a two-bit field v >= 2 standing for v - 4;
    the shifts are done in int32."""
    s = float(np.float32(scale))
    if fmt == "2bits_cpx":
        b = raw.to(torch.int32)
        nibs = torch.stack([(b >> 4) & 0xF, b & 0xF], dim=1).reshape(-1)

        def s2(v):
            return torch.where(v >= 2, v - 4, v).to(torch.float32)

        iq = torch.stack([s2(nibs & 0x3), s2((nibs >> 2) & 0x3)], dim=-1) * s
    elif fmt in STREAM_FORMATS:
        iq = raw.view(-1, 2).to(torch.float32) * s
    else:
        raise ValueError(f"no device unpack for raw format {fmt!r}")
    return torch.view_as_complex(iq)


class PinnedStaging:
    """Host-to-device transport of a stream's segments.

    On the card: two reusable pinned host buffers, used in turn; a segment
    is copied into one and from there to the card with `non_blocking=True`,
    and an event recorded after that copy.  A buffer is refilled only once
    the event of its previous copy has completed.  Pinning that fails
    raises: a pageable copy would be synchronous.  On the CPU the segment
    is the tensor itself."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._bufs: list[torch.Tensor | None] = [None, None]
        self._events: list[torch.cuda.Event | None] = [None, None]
        self._next = 0

    def upload(self, seg: np.ndarray) -> torch.Tensor:
        seg = np.ascontiguousarray(seg)
        dtype = torch.from_numpy(np.empty(0, seg.dtype)).dtype
        if self.device.type != "cuda":
            return torch.from_numpy(np.require(seg, requirements="W"))
        k, self._next = self._next, self._next ^ 1
        if self._events[k] is not None:
            self._events[k].synchronize()
        n = seg.nbytes
        buf = self._bufs[k]
        if buf is None or buf.numel() < n:
            buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
            if not buf.is_pinned():
                raise RuntimeError("the staging buffer could not be pinned")
            self._bufs[k] = buf
        buf[:n].numpy()[:] = seg.reshape(-1).view(np.uint8)
        dev = torch.empty(n, dtype=torch.uint8, device=self.device)
        dev.copy_(buf[:n], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._events[k] = ev
        return dev.view(dtype)
