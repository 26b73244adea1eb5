"""Binary dump files for offline analysis.

Reference parity: the per-block `dump=true` machinery — acquisition grid
dumps (pcps_acquisition.cc dump_results), tracking dumps incl. the
MATLAB-compatible export (dll_pll_veml_tracking.cc save_matfile), and the
dump-reader oracles used by tests (SURVEY.md §4.5).  Format here is .npz
(and .mat when scipy is available) — binary, versioned, self-describing.
"""

from __future__ import annotations

import pathlib

import numpy as np


class TrackingDump:
    """Accumulates per-epoch channel series and writes one file per channel
    (tracking_dump_reader analogue)."""

    FIELDS = ("start_sample", "cur_len", "prompt_i", "prompt_q", "early_i",
              "early_q", "late_i", "late_q", "carrier_doppler_hz",
              "code_freq_delta", "rem_code_phase_samples", "cn0_dbhz")

    def __init__(self) -> None:
        self._data: dict[int, dict[str, list]] = {}

    def push_outputs(self, channel_prns, outs, block_offset: int,
                     prompt_index: int = 1) -> None:
        """Harvest a TrackOutputs batch ([T, C, ...] host arrays)."""
        valid = np.asarray(outs.valid)
        starts = np.asarray(outs.start)
        corr = np.asarray(outs.correlators)
        for ch, prn in enumerate(channel_prns):
            if prn is None:
                continue
            v = valid[:, ch]
            if not v.any():
                continue
            d = self._data.setdefault(prn, {f: [] for f in self.FIELDS})
            c = corr[v, ch]
            d["start_sample"].extend(starts[v, ch] + block_offset)
            d["cur_len"].extend(np.asarray(outs.cur_len)[v, ch])
            d["prompt_i"].extend(c[:, prompt_index, 0])
            d["prompt_q"].extend(c[:, prompt_index, 1])
            d["early_i"].extend(c[:, 0, 0])
            d["early_q"].extend(c[:, 0, 1])
            d["late_i"].extend(c[:, -1, 0])
            d["late_q"].extend(c[:, -1, 1])
            d["carrier_doppler_hz"].extend(
                np.asarray(outs.carrier_doppler_hz)[v, ch])
            d["code_freq_delta"].extend(
                np.asarray(outs.code_freq_delta)[v, ch])
            d["rem_code_phase_samples"].extend(
                np.asarray(outs.rem_code_phase_samples)[v, ch])
            d["cn0_dbhz"].extend(np.asarray(outs.cn0_dbhz)[v, ch])

    def write(self, directory: str, prefix: str = "tracking_ch") -> list[str]:
        out = []
        path = pathlib.Path(directory)
        path.mkdir(parents=True, exist_ok=True)
        for prn, d in self._data.items():
            f = path / f"{prefix}_prn{prn:02d}.npz"
            np.savez_compressed(f, **{k: np.asarray(v) for k, v in d.items()})
            out.append(str(f))
            try:
                from scipy.io import savemat  # optional .mat export

                savemat(str(f.with_suffix(".mat")),
                        {k: np.asarray(v) for k, v in d.items()})
                out.append(str(f.with_suffix(".mat")))
            except Exception:
                pass
        return out


def read_tracking_dump(path: str) -> dict[str, np.ndarray]:
    """Dump-reader oracle (tracking_dump_reader analogue)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def dump_acquisition_grid(path: str, grid: np.ndarray, prns, doppler_bins,
                          fs_hz: float, test_stats=None) -> str:
    """Acquisition grid dump (acquisition_dump_reader analogue):
    grid [C, D, delay_bins]."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        p, grid=np.asarray(grid), prns=np.asarray(prns),
        doppler_bins_hz=np.asarray(doppler_bins), fs_hz=fs_hz,
        test_stats=np.asarray(test_stats) if test_stats is not None else 0)
    return str(p)
