"""Build the package's CUDA kernels with nvcc at first use.

Each `csrc/<name>.cu` has a plain C interface; it is compiled for Hopper
(`sm_90a`) into `build/lib<name>-<hash>.so` beside the package and loaded
with ctypes.  The file name carries a hash of the source and flags, so an
edited source is rebuilt and an unchanged one is reused.  The build runs
from the repository's sources alone: nvcc from `$CUDA_HOME/bin`,
`/usr/local/cuda/bin` or the PATH.

Flags: `-O3`, no `--use_fast_math` (atan2f / sincosf / log10f keep full
float32 accuracy) and `--fmad=false` (no multiply-add contraction, so the
kernel rounds op by op like its plain torch version).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "--fmad=false", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: dict[str, ctypes.CDLL] = {}
# per-kernel build record: seconds taken (0.0 when reused) and ptxas report
BUILD_LOG: dict[str, dict] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = pathlib.Path(root) / "bin" / "nvcc"
            if cand.exists():
                return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(
        src + " ".join(ARCH_FLAGS + NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{key}.so"


def build(name: str) -> pathlib.Path:
    """Compile csrc/<name>.cu unless an up-to-date library exists."""
    out = _target(name)
    if out.exists():
        BUILD_LOG.setdefault(name, {"seconds": 0.0, "ptxas": "reused"})
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.NamedTemporaryFile(dir=BUILD, suffix=".so",
                                     delete=False) as tmp:
        tmp_path = pathlib.Path(tmp.name)
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp_path),
           str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp_path.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}\n"
                           f"{res.stderr}")
    os.replace(tmp_path, out)          # atomic: concurrent builds agree
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                       "ptxas": (res.stdout + res.stderr).strip()}
    return out


def build_all(names) -> dict[str, pathlib.Path]:
    """Compile several kernels at once, one nvcc process per source."""
    names = [n for n in names if not _target(n).exists()]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        paths = list(pool.map(build, names))
    return dict(zip(names, paths))


def load_library(name: str) -> ctypes.CDLL:
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib
