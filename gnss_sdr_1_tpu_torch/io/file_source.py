"""File-based IQ sample source with bounded-stream (valve) semantics.

Reference parity: File_Signal_Source (src/algorithms/signal_source/adapters/
file_signal_source.cc) + gnss_sdr_valve (gnss_sdr_valve.h:44-62).  The file
is memory-mapped; blocks are converted to complex64 on demand, ready for
device transfer.  `max_samples` reproduces the valve's bounded-run behavior
used by every file-based test in the reference.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np

from .formats import FORMATS, SampleFormat, convert_to_complex64


@dataclasses.dataclass
class FileSignalSource:
    path: str
    item_type: str = "ishort"
    sampling_frequency: float = 4_000_000.0
    max_samples: int | None = None   # valve bound, complex samples
    skip_samples: int = 0

    def __post_init__(self) -> None:
        self.fmt: SampleFormat = FORMATS[self.item_type]
        n_bytes = os.path.getsize(self.path)
        self._file_samples = int(n_bytes / self.fmt.bytes_per_sample)
        # tolerate trailing partial items (real captures sometimes carry a
        # truncated tail, e.g. NT1065_GLONASS_..._4ms.bin ends 4 bytes
        # short of a gr_complex boundary) — memmap only whole items
        item_bytes = np.dtype(self.fmt.dtype).itemsize
        n_items = (n_bytes // item_bytes) \
            // self.fmt.items_per_sample * self.fmt.items_per_sample
        self._raw = np.memmap(self.path, dtype=self.fmt.dtype, mode="r",
                              shape=(n_items,))

    @property
    def n_samples(self) -> int:
        """Total complex samples this source will emit (valve-bounded)."""
        avail = self._file_samples - self.skip_samples
        if self.max_samples is not None:
            return max(0, min(avail, self.max_samples))
        return max(0, avail)

    def read(self, start: int, count: int) -> np.ndarray:
        """Read `count` complex64 samples at absolute sample offset `start`
        (relative to skip_samples).  Short reads at EOF return fewer."""
        start = start + self.skip_samples
        stop = min(start + count, self.skip_samples + self.n_samples)
        if stop <= start:
            return np.empty(0, dtype=np.complex64)
        spi = self.fmt.samples_per_item
        if spi > 1:
            # sub-byte packing: read whole items, trim to the sample range
            i0 = start // spi
            i1 = (stop + spi - 1) // spi
            x = convert_to_complex64(np.asarray(self._raw[i0:i1]), self.fmt)
            return x[start - i0 * spi : start - i0 * spi + (stop - start)]
        ipc = self.fmt.items_per_sample
        raw = self._raw[start * ipc : stop * ipc]
        return convert_to_complex64(np.asarray(raw), self.fmt)

    def blocks(self, block_size: int) -> Iterator[tuple[int, np.ndarray]]:
        """Iterate (sample_offset, complex64 block).  The final short block
        is zero-padded to `block_size`; iteration covers n_samples."""
        pos = 0
        total = self.n_samples
        while pos < total:
            blk = self.read(pos, block_size)
            if len(blk) < block_size:
                blk = np.pad(blk, (0, block_size - len(blk)))
            yield pos, blk
            pos += block_size


def read_capture(
    path: str,
    item_type: str = "gr_complex",
    max_samples: int | None = None,
) -> np.ndarray:
    """Convenience: read an entire capture file to complex64."""
    src = FileSignalSource(path, item_type=item_type, max_samples=max_samples)
    return src.read(0, src.n_samples)
