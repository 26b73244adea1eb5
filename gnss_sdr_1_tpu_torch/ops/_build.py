"""Build the package's CUDA kernels with nvcc at first use.

Each `csrc/<name>.cu` has a plain C interface; it is compiled for Hopper
(`sm_90a`) into `build/lib<name>-<hash>.so` beside the package and loaded
with ctypes.  The file name carries a hash of the source, of every header
in `csrc/` and of the flags, so an edited source or header is rebuilt and
an unchanged one is reused.  The build runs from the repository's sources
alone: nvcc from `$CUDA_HOME/bin`, `/usr/local/cuda/bin` or the PATH.

The chunked engine's kernels form one library, `track_chain` (`library()`):
the chain in `track_chain.cu` (its loop closure in `loop_close.cuh`), the
chunk correlator in `chunk_corr.cuh`, and the capture-level entry that
enqueues both for every chunk.  The KF block walk is a second, `kf_block`
(`kf_library()`: `kf_block.cu` with the gather correlation in
`gather_corr.cuh` and the cluster skeleton in `cluster_walk.cuh`); the
gather DLL/PLL walk a third, `gather_block` (`gather_library()`:
`gather_block.cu` with `gather_corr.cuh`, `cluster_walk.cuh`,
`loop_close.cuh` and the TCP connector's one-epoch multicorrelator,
`multicorrelate.cuh`).  Both walks' libraries carry the symbol-grid
reduction (`symbol_slots.cuh`), each with its own entry, so either
correlator reaches it from the library it already loads.  A stream's
front end is a fourth, `xlate_fir` (`xlate_library()`: `xlate_fir.cu`).
`kf_stage_library()` and `gather_stage_library()`
build `kf_block.cu` and `gather_block.cu` once more with `-DKF_BLOCK_STAGES`
and `-DGATHER_BLOCK_STAGES` (each kernel's stage clocks), and
`mc_stage_library()` builds `gather_block.cu` with `-DMC_STAGES` (the
one-epoch multicorrelator's stage clocks and probes); nothing on the
receiver's path loads them.  `build_all()` runs one nvcc per library and
stage variant, all at once.

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
from concurrent.futures import ThreadPoolExecutor

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "--fmad=false", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
# per-library build record: seconds taken (0.0 when reused) and ptxas report
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


def _variant(name: str, defines: tuple) -> str:
    return "-".join([name, *(d.lower() for d in defines)])


def _target(name: str, defines: tuple = ()) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS + list(defines)).encode())
    return BUILD / f"lib{_variant(name, defines)}-{h.hexdigest()[:16]}.so"


def build(name: str, defines: tuple = (), force: bool = False) -> pathlib.Path:
    """Compile csrc/<name>.cu (with -D for each of `defines`) unless an
    up-to-date library exists (`force`: compile anyway, for ptxas'
    report)."""
    out = _target(name, defines)
    key = _variant(name, defines)
    if out.exists() and not force:
        BUILD_LOG.setdefault(key, {"seconds": 0.0, "ptxas": "reused"})
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.NamedTemporaryFile(dir=BUILD, suffix=".so",
                                     delete=False) as tmp:
        tmp_path = pathlib.Path(tmp.name)
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS,
           *(f"-D{d}" for d in defines), "-o", str(tmp_path),
           str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp_path.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}\n"
                           f"{res.stderr}")
    os.replace(tmp_path, out)          # atomic: concurrent builds agree
    BUILD_LOG[key] = {"seconds": time.perf_counter() - t0,
                       "ptxas": (res.stdout + res.stderr).strip()}
    return out


LIBRARY = "track_chain"
KF_LIBRARY = "kf_block"
GATHER_LIBRARY = "gather_block"
XLATE_LIBRARY = "xlate_fir"
KF_STAGES = ("KF_BLOCK_STAGES",)
GATHER_STAGES = ("GATHER_BLOCK_STAGES",)
MC_STAGES = ("MC_STAGES",)
# the stage-clock variants build_all() builds beside the libraries
STAGE_VARIANTS = ((KF_LIBRARY, KF_STAGES), (GATHER_LIBRARY, GATHER_STAGES),
                  (GATHER_LIBRARY, MC_STAGES))
_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points of each library: pointers and the stream as c_void_p
# (ctypes would cut a Python int to 32 bits), counts as c_int; each returns
# the first CUDA error, 0 on success
_ENTRIES = {
    LIBRARY: {
        # x, n_samp, rows, slot, fst, ist, zr, zi, s_reg, step0, params,
        # stream
        "chunk_corr_launch": [_P, _I] + [_P] * 10,
        # cluster size, dynamic shared memory, TF32 passes
        "chunk_corr_max_active": [_I, _I, _I],
        # zr, zi, s_reg, step0, sec_rows, fst, ist, out_f, out_i, out_corr,
        # fst_out, ist_out, params, stream
        "track_chain_launch": [_P] * 14,
        # n_chunks, x, n_samp, rows, slot, sec_rows, fst_in, ist_in, fst_a,
        # ist_a, fst_b, ist_b, zr, zi, s_reg, step0, out_f, out_i, out_corr,
        # corr params, chain params, stream
        "track_capture_launch": [_I, _P, _I] + [_P] * 19,
        # out_f, out_i, out_corr, entering_rem, out, params, stream
        "symbol_slots_launch": [_P] * 7,
    },
    KF_LIBRARY: {
        # x, codes, n_slots, fst, ist, out_f, out_i, fst_out, ist_out,
        # stages, params, stream
        "kf_block_launch": [_P, _P, _I] + [_P] * 9,
        # order, bayes_run, dynamic shared memory
        "kf_block_max_cluster": [_I, _I, _I],
    },
    GATHER_LIBRARY: {
        # x, codes, sec_rows, fst, ist, out_f, out_i, out_corr, fst_out,
        # ist_out, stages, loop params, params, stream
        "gather_block_launch": [_P] * 14,
        # taps, dynamic shared memory
        "gather_block_max_cluster": [_I, _I],
        # x, codes, out, stages, params (the per-channel arguments by
        # value or by pointer), stream
        "multicorrelate_launch": [_P] * 6,
        # params, stream: an empty kernel in the multicorrelator's geometry
        "multicorrelate_empty_launch": [_P] * 2,
        # out_f, out_i, out_corr, entering_rem, out, params, stream
        "symbol_slots_launch": [_P] * 7,
    },
    XLATE_LIBRARY: {
        # hist, seg, taps, out, params, stream
        "xlate_fir_launch": [_P] * 6,
    },
}


def build_all(force: bool = False) -> None:
    """Build every library and stage variant at once, one nvcc each (a
    no-op for those already built unless `force`)."""
    jobs = [(name, ()) for name in _ENTRIES] + list(STAGE_VARIANTS)
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: build(*job, force=force), jobs))


def _load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Library `name` (built with `defines`), built at first use, entry
    points declared."""
    key = _variant(name, defines)
    if key not in _LIBS:
        lib = ctypes.CDLL(str(build(name, defines)))
        for fn_name, argtypes in _ENTRIES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[key] = lib
    return _LIBS[key]


def library() -> ctypes.CDLL:
    """The chunked engine's tracking library."""
    return _load(LIBRARY)


def kf_library() -> ctypes.CDLL:
    """The KF block library."""
    return _load(KF_LIBRARY)


def gather_library() -> ctypes.CDLL:
    """The gather DLL/PLL walk's library (with the one-epoch
    multicorrelator)."""
    return _load(GATHER_LIBRARY)


def xlate_library() -> ctypes.CDLL:
    """The stream front end's library."""
    return _load(XLATE_LIBRARY)


def kf_stage_library() -> ctypes.CDLL:
    """The KF block library built with the kernel's stage clocks."""
    return _load(KF_LIBRARY, KF_STAGES)


def gather_stage_library() -> ctypes.CDLL:
    """The gather walk's library built with the kernel's stage clocks."""
    return _load(GATHER_LIBRARY, GATHER_STAGES)


def mc_stage_library() -> ctypes.CDLL:
    """The gather walk's library built with the one-epoch multicorrelator's
    stage clocks and probes."""
    return _load(GATHER_LIBRARY, MC_STAGES)
