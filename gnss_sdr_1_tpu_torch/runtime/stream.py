"""Sample transport for Receiver.process_stream: raw items staged in pinned
host memory, copied to the card as they are, and unpacked there, or
conditioned there by the conf's front end.

Raw integer I/Q crosses PCIe at its own width (ishort 4 B a sample, ibyte
2 B, nibble-packed 2bits_cpx 0.5 B, NSR's real 2-bit 0.25 B, against
complex64's 8 B) and becomes complex64 on the receiver's device with torch
ops (the JAX package's `unpack_dev`, an XLA program there; no TPU kernel
stands behind it).  Where the conf's SignalConditioner does more than pass
the samples through (an IF, a filter, a resampler), `StreamFrontEnd` does
the unpacking and the conditioning in one kernel launch a segment
(ops/xlate_fir.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import xlate_fir as xf
from ..utils import spans

# the raw formats process_stream accepts: interleaved I/Q integers, the
# nibble-packed 2-bit I/Q of LabSat-class front ends and the real 2-bit IF
# samples of NSR front ends
STREAM_FORMATS = ("ishort", "ibyte", "cshort", "cbyte", "2bits_cpx", "nsr")


@spans.traced("stream.unpack")
def unpack_raw(raw: torch.Tensor, fmt: str, scale: float) -> torch.Tensor:
    """Raw items -> complex64 samples times `scale`, on raw's device.

    Interleaved I/Q: `scale * raw.view(-1, 2)` in float32.  2bits_cpx (the
    io.formats layout): two samples a byte, the most significant nibble
    first, a nibble Q1 Q0 I1 I0, a two-bit field v >= 2 standing for v - 4;
    nsr: four real samples a byte, the least significant pair first, each
    such a two-bit field, Q zero; the shifts are done in int32."""
    s = float(np.float32(scale))
    if fmt == "nsr":
        b = raw.to(torch.int32)
        v = torch.stack([(b >> (2 * j)) & 0x3 for j in range(4)],
                        dim=1).reshape(-1)
        re = torch.where(v >= 2, v - 4, v).to(torch.float32) * s
        iq = torch.stack([re, torch.zeros_like(re)], dim=-1)
    elif fmt == "2bits_cpx":
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
        with spans.span("stream.upload") as sp:
            seg = np.ascontiguousarray(seg)
            dtype = torch.from_numpy(np.empty(0, seg.dtype)).dtype
            if self.device.type != "cuda":
                return torch.from_numpy(np.require(seg, requirements="W"))
            k, self._next = self._next, self._next ^ 1
            if self._events[k] is not None:
                with spans.wait("stream.upload.wait") as w:
                    if w:
                        w.count("ready", int(self._events[k].query()))
                    self._events[k].synchronize()
            n = seg.nbytes
            buf = self._bufs[k]
            if buf is None or buf.numel() < n:
                buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
                if not buf.is_pinned():
                    raise RuntimeError(
                        "the staging buffer could not be pinned")
                sp.count("pinned_allocs")
                self._bufs[k] = buf
            with spans.span("stream.upload.stage") as st:
                st.count("bytes", n)
                buf[:n].numpy()[:] = seg.reshape(-1).view(np.uint8)
            with spans.span("stream.upload.copy"):
                dev = torch.empty(n, dtype=torch.uint8, device=self.device)
                dev.copy_(buf[:n], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record()
            self._events[k] = ev
            return dev.view(dtype)


class StreamFrontEnd:
    """The conf's SignalConditioner chain on a stream's raw segments: one
    uploaded segment of source items in, complex64 at the internal rate
    out, scaled by the ingest scale, in one `xlate_fir` launch on the card
    (its plain version on the CPU).

    Built from a `runtime.config.FrontEnd` by its `stream_plan` (the same
    taps and decimation its batch `process` filters with): a
    Freq_Xlating_Fir_Filter with an IF and decimation, a Direct_Resampler
    with a whole-number ratio (the one tap 1.0), or both.  It carries from
    one segment to the next what makes a stream cut into segments give the
    samples of one pass over it: the items of the last `n_hist` source
    samples before the next segment's first output (the FIR's history, a
    view of the previous segment on its device), and that output's
    absolute index (the mixer's phase; the decimation's phase is zero at
    every segment start, which advances by whole outputs).  Segments
    overlap as process_stream's do: each conditions `n_out` outputs from
    its first and hands `advance` of them on."""

    def __init__(self, front_end, raw_format: str | None, device):
        plan = front_end.stream_plan()
        if plan is None:
            raise ValueError("a Pass_Through front end streams unpacked "
                             "samples (unpack_raw), not through "
                             "StreamFrontEnd")
        taps, decim, if_hz = plan
        self.fmt = raw_format or "gr_complex"
        self.code = xf.format_code(self.fmt)
        self.decim = int(decim)
        self.n_taps = len(taps)
        # whole raw items of history, at least the FIR's n_taps - 1 samples
        spi = xf.SAMPLES_PER_ITEM[self.code]
        self.n_hist = -(-(self.n_taps - 1) // spi) * spi
        fs = front_end.source_fs_hz
        self.taps = torch.as_tensor(xf.rotated_taps(taps, if_hz, fs),
                                    device=torch.device(device))
        self.dphase = xf.phase_step(if_hz, fs, self.decim)
        # the absolute index of the next segment's first output, and the
        # items of the n_hist source samples before it
        self.reset()

    def reset(self) -> None:
        """Start the stream anew at source sample 0 (zero history)."""
        self.seek(0)

    def seek(self, next_out: int, hist=None) -> None:
        """Continue a stream at absolute output `next_out`: `hist` holds
        the raw items of the n_hist source samples before its first source
        sample (host or device; None: zeros, as at a stream's start)."""
        self.next_out = int(next_out)
        self._hist = None if hist is None or not self.n_hist else \
            torch.as_tensor(hist).to(self.taps.device)

    def history(self) -> np.ndarray | None:
        """The raw items of the n_hist source samples before the next
        segment's first output, copied to the host (None: zeros)."""
        return None if self._hist is None else self._hist.cpu().numpy()

    def items(self, n_samples: int) -> int:
        """Raw items that hold `n_samples` source samples (a whole number
        of items: raises otherwise)."""
        ipi = xf.ITEMS_PER_SAMPLE[self.code]
        spi = xf.SAMPLES_PER_ITEM[self.code]
        if (n_samples * ipi) % spi:
            raise ValueError(f"{n_samples} {self.fmt} samples are not whole "
                             f"raw items")
        return n_samples * ipi // spi

    def condition(self, raw: torch.Tensor, n_out: int, advance: int,
                  scale: float) -> torch.Tensor:
        """The `n_out` outputs of a segment whose raw items `raw` (on the
        front end's device) hold its n_out * decim source samples from the
        first output's; the next segment starts `advance` outputs on."""
        with spans.span("stream.condition") as sp:
            if sp:
                sp.count("samples_in", xf.n_samples(raw, self.code))
                sp.count("samples_out", n_out)
                sp.count("taps", self.n_taps)
            out = xf.xlate_fir(self._hist, raw, self.fmt, self.taps,
                               self.decim, self.n_hist, n_out,
                               xf.fixed_phase(self.next_out, self.dphase),
                               self.dphase, scale)
            if self.n_hist:
                a = self.items(advance * self.decim)
                self._hist = raw[a - self.items(self.n_hist):a]
            self.next_out += advance
            return out
