"""Binary ICD data tables (see tools/extract_icd_tables.py for provenance)."""

from __future__ import annotations

import functools
import pathlib

import numpy as np

_NPZ = pathlib.Path(__file__).parent / "icd_tables.npz"


@functools.lru_cache(maxsize=1)
def tables() -> dict:
    with np.load(_NPZ, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
