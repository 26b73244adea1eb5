"""LabSat 2/3 file source.

Reference parity: Labsat_Signal_Source ->
src/algorithms/signal_source/gnuradio_blocks/labsat23_source.cc:
  - files come in numbered sequences `<basename>_0000.LS3`, `_0001.LS3`, ...
    (generate_filename); a bare existing path is accepted as a single file
  - 1024-byte header: 8x 0x00 preamble, "LS2"/"LS3" magic, sub-version
    byte, int32-LE total header length, then TLV sections; section id 2
    carries ref-clock, bits/sample (2 or 4), channel-selector and
    constellation ids (labsat23_source.cc header parse)
  - sample data as little-endian int16 words:
      2 bits/sample: 8 complex samples per word, I = bit 15-2i,
        Q = bit 14-2i, values mapped 0/1 -> -1/+1
        (decode_samples_one_channel type 2)
      4 bits/sample: 4 complex samples per word, each component from a
        (sign-ish, low) bit pair 00->0, 01->1, 10->-2, 11->-1 plus a +0.5
        offset (decode_samples_one_channel type 4)
  - dual-channel files (channel selector 0) are rejected, as in the
    reference ("not currently supported").
"""

from __future__ import annotations

import os
import struct

import numpy as np

REF_CLOCK_NAMES = {0: "internal OXCO", 1: "internal TXCO",
                   2: "external 10 MHz", 3: "external 16.386 MHz"}
CONSTELLATION_NAMES = {0: "GPS", 1: "GLONASS", 2: "BDS"}


class LabsatHeaderError(ValueError):
    pass


def parse_labsat_header(block: bytes) -> dict:
    """Parse the 1024-byte LabSat 2/3 file header; returns metadata incl.
    `data_offset` (bytes to seek past) and `bits_per_sample`."""
    if len(block) < 32:
        raise LabsatHeaderError("header block too short")
    if block[:8] != b"\x00" * 8:
        raise LabsatHeaderError("LabSat preamble (8x 0x00) not found")
    magic = block[8:11]
    if magic == b"LS2":
        version = 2
    elif magic == b"LS3":
        version = 3
    else:
        raise LabsatHeaderError(f"unknown LabSat magic {magic!r}")
    sub_version = block[11]
    header_bytes = struct.unpack_from("<i", block, 12)[0]
    pos = 16
    section_id = struct.unpack_from("<H", block, pos)[0]
    pos += 6                                    # id (2) + section length (4)
    if section_id != 2:
        raise LabsatHeaderError(
            f"expected section 2 in LabSat header, got {section_id}")
    ref_clock = block[pos]
    bits_per_sample = block[pos + 1]
    channel_selector = block[pos + 2]
    quantization = block[pos + 3]
    const_a = block[pos + 4]
    const_b = block[pos + 5]
    if bits_per_sample not in (2, 4):
        raise LabsatHeaderError(
            f"unsupported LabSat bits/sample {bits_per_sample}")
    if channel_selector == 0:
        raise LabsatHeaderError(
            "dual-channel LabSat files are not supported")
    return {
        "version": version, "sub_version": sub_version,
        "data_offset": header_bytes, "ref_clock": ref_clock,
        "bits_per_sample": int(bits_per_sample),
        "channel_selector": int(channel_selector),
        "quantization": int(quantization),
        "constellation_a": CONSTELLATION_NAMES.get(const_a, "?"),
        "constellation_b": CONSTELLATION_NAMES.get(const_b, "?"),
    }


def decode_labsat_words(words: np.ndarray, bits_per_sample: int) -> np.ndarray:
    """Vectorized decode of little-endian int16 words to complex64
    (labsat23_source.cc decode_samples_one_channel)."""
    w = words.astype(np.int64) & 0xFFFF
    if bits_per_sample == 2:
        out = np.empty(8 * len(w), dtype=np.complex64)
        for i in range(8):
            out.real[i::8] = (((w >> (15 - 2 * i)) & 1) * 2.0 - 1.0)
            out.imag[i::8] = (((w >> (14 - 2 * i)) & 1) * 2.0 - 1.0)
        return out
    if bits_per_sample == 4:
        lut = np.array([0.0, 1.0, -2.0, -1.0], dtype=np.float32)
        out = np.empty(4 * len(w), dtype=np.complex64)
        for i in range(4):
            ib = ((w >> (15 - 4 * i)) & 1) * 2 + ((w >> (13 - 4 * i)) & 1)
            qb = ((w >> (14 - 4 * i)) & 1) * 2 + ((w >> (12 - 4 * i)) & 1)
            out.real[i::4] = lut[ib] + 0.5
            out.imag[i::4] = lut[qb] + 0.5
        return out
    raise ValueError(f"bits_per_sample must be 2 or 4, got {bits_per_sample}")


class LabsatSource:
    """Memory-mapped LabSat 2/3 capture reader over a numbered file
    sequence, exposing the FileSignalSource read/blocks API."""

    def __init__(self, path: str, sampling_frequency: float = 16.368e6,
                 max_samples: int | None = None):
        self.sampling_frequency = sampling_frequency
        paths = []
        if os.path.exists(path):
            paths.append(path)
            base = path[:-9] if path.endswith(".LS3") and "_" in path else None
        else:
            base = path
        if base is not None:
            k = len(paths)
            while True:
                p = f"{base}_{k:04d}.LS3"
                if not os.path.exists(p) or p in paths:
                    break
                paths.append(p)
                k += 1
        if not paths:
            raise FileNotFoundError(
                f"no LabSat file at '{path}' or '{path}_0000.LS3'")
        with open(paths[0], "rb") as f:
            self.header = parse_labsat_header(f.read(1024))
        self.bits_per_sample = self.header["bits_per_sample"]
        self._spw = 8 if self.bits_per_sample == 2 else 4
        self._maps: list[np.memmap] = []
        for i, p in enumerate(paths):
            off = self.header["data_offset"] if i == 0 else 0
            n_words = (os.path.getsize(p) - off) // 2
            if n_words > 0:
                self._maps.append(np.memmap(
                    p, dtype="<i2", mode="r", offset=off, shape=(n_words,)))
        self._bounds = np.cumsum([0] + [len(m) for m in self._maps])
        self._max = max_samples

    @property
    def n_samples(self) -> int:
        n = int(self._bounds[-1]) * self._spw
        return min(n, self._max) if self._max is not None else n

    def read(self, start: int, count: int) -> np.ndarray:
        stop = min(start + count, self.n_samples)
        if stop <= start:
            return np.empty(0, dtype=np.complex64)
        w0, w1 = start // self._spw, (stop + self._spw - 1) // self._spw
        parts = []
        for i, m in enumerate(self._maps):
            lo, hi = int(self._bounds[i]), int(self._bounds[i + 1])
            if w1 <= lo or w0 >= hi:
                continue
            parts.append(np.asarray(m[max(w0 - lo, 0):min(w1 - lo, hi - lo)]))
        words = np.concatenate(parts) if parts else np.empty(0, "<i2")
        x = decode_labsat_words(words, self.bits_per_sample)
        o = start - w0 * self._spw
        return x[o:o + (stop - start)]

    def blocks(self, block_size: int):
        pos = 0
        while pos < self.n_samples:
            blk = self.read(pos, block_size)
            if len(blk) < block_size:
                blk = np.pad(blk, (0, block_size - len(blk)))
            yield pos, blk
            pos += block_size
