"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on first use into one shared library
with a plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC``); no PyTorch header is included, so a build
takes seconds. Libraries land in ``kernels/build/`` (listed in
``.gitignore``) under a name keyed by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is.
Sources are compiled in parallel, one nvcc process each. A failed build
raises; nothing falls back.

Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

#: C entry points per source: name -> argtypes. Every pointer and the stream
#: are ``c_void_p`` so 64-bit addresses are never truncated.
SIGNATURES: Dict[str, Dict[str, List]] = {
    "spc5_spmv": {
        **{f"spc5_spmv_whole_s{s}": [_P] * 9 + [_I] * 13 + [_P]
           for s in (1, 2)},
        "spc5_spmv_whole_occupancy": [_I] * 5 + [_P],
        "spc5_spmv_whole_smem": [_I] * 6,
        "spc5_spmv_panels_s1": [_P] * 10 + [_I] * 14 + [_P],
        "spc5_spmv_panels_s2": [_P] * 10 + [_I] * 15 + [_P],
        "spc5_spmv_panels_occupancy": [_I] * 5 + [_P],
        "spc5_spmv_panels_smem": [_I] * 5,
        # the column-map twins: the same arguments, then cmap
        **{f"spc5_spmv_whole_cmap_s{s}": [_P] * 9 + [_I] * 13 + [_P, _P]
           for s in (1, 2)},
        "spc5_spmv_whole_cmap_occupancy": [_I] * 5 + [_P],
        "spc5_spmv_panels_cmap_s1": [_P] * 10 + [_I] * 14 + [_P, _P],
        "spc5_spmv_panels_cmap_s2": [_P] * 10 + [_I] * 15 + [_P, _P],
        "spc5_spmv_panels_cmap_occupancy": [_I] * 5 + [_P],
    },
    "spc5_spmv_desc": {
        "spc5_spmv_desc_whole_s1": [_P] * 9 + [_I] * 16 + [_P],
        "spc5_spmv_desc_whole_s2": [_P] * 9 + [_I] * 15 + [_P],
        "spc5_spmv_desc_whole_occupancy": [_I] * 5 + [_P],
        "spc5_spmv_desc_whole_smem": [_I] * 9,
        **{f"spc5_spmv_desc_panels_s{s}": [_P] * 10 + [_I] * 19 + [_P]
           for s in (1, 2)},
        "spc5_spmv_desc_panels_occupancy": [_I] * 5 + [_P],
        "spc5_spmv_desc_panels_smem": [_I] * 10,
        # the column-map twins: the same arguments, then cmap and ncols
        **{f"spc5_spmv_desc_panels_cmap_s{s}": [_P] * 10 + [_I] * 19
           + [_P, _P, _I] for s in (1, 2)},
        "spc5_spmv_desc_panels_cmap_occupancy": [_I] * 5 + [_P],
    },
    "spc5_spmm": {
        "spc5_spmm_whole": [_P] * 9 + [_I] * 20 + [_P],
        "spc5_spmm_whole_occupancy": [_I] * 7 + [_P],
        "spc5_spmm_whole_smem": [_I] * 11,
        **{f"spc5_spmm_panels_s{s}": [_P] * 10 + [_I] * 21 + [_P]
           for s in (1, 2)},
        "spc5_spmm_panels_occupancy": [_I] * 7 + [_P],
        "spc5_spmm_panels_smem": [_I] * 7,
    },
    # the mask SpMM kernels with a column map: the arguments of their twins
    # in spc5_spmm, then cmap
    "spc5_spmm_cmap": {
        "spc5_spmm_whole_cmap": [_P] * 9 + [_I] * 20 + [_P, _P],
        "spc5_spmm_whole_cmap_occupancy": [_I] * 7 + [_P],
        **{f"spc5_spmm_panels_cmap_s{s}": [_P] * 10 + [_I] * 21 + [_P, _P]
           for s in (1, 2)},
        "spc5_spmm_panels_cmap_occupancy": [_I] * 7 + [_P],
    },
    "spc5_spmm_desc": {
        "spc5_spmm_desc_whole": [_P] * 9 + [_I] * 23 + [_P],
        "spc5_spmm_desc_whole_occupancy": [_I] * 7 + [_P],
        "spc5_spmm_desc_whole_smem": [_I] * 13,
        "spc5_spmm_desc_panels_s1": [_P] * 10 + [_I] * 25 + [_P],
        "spc5_spmm_desc_panels_s2": [_P] * 10 + [_I] * 24 + [_P],
        "spc5_spmm_desc_panels_occupancy": [_I] * 8 + [_P],
        "spc5_spmm_desc_panels_smem": [_I] * 11,
    },
    # the panel descriptor SpMM kernels with a column map: the arguments of
    # their twins in spc5_spmm_desc, then cmap
    "spc5_spmm_desc_cmap": {
        "spc5_spmm_desc_panels_cmap_s1": [_P] * 10 + [_I] * 25 + [_P, _P],
        "spc5_spmm_desc_panels_cmap_s2": [_P] * 10 + [_I] * 24 + [_P, _P],
        "spc5_spmm_desc_panels_cmap_occupancy": [_I] * 8 + [_P],
    },
    "spc5_spmv_tail": {
        "spc5_spmv_tail": [_P] * 6 + [_I] * 11 + [_P],
        "spc5_spmv_tail_occupancy": [_I] * 3 + [_P],
        "spc5_spmm_tail": [_P] * 5 + [_I] * 14 + [_P],
        "spc5_spmm_tail_occupancy": [_I] * 5 + [_P],
        "spc5_spmm_tail_smem": [_I] * 5,
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

#: What the last build printed, per source: nvcc's ``-Xptxas -v`` report
#: (registers, shared memory and spills of each kernel) and the seconds it
#: took. Empty for a source loaded from an earlier build.
BUILD_LOG: Dict[str, Dict[str, object]] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH and $CUDA_HOME/bin); the "
        "CUDA kernels are built from source at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[str, subprocess.Popen, Path, Path, float]:
    out = _lib_path(name)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, proc, tmp, out, time.perf_counter()


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_all(names=None) -> Dict[str, ctypes.CDLL]:
    """Build (where needed) and load every source in ``names`` (default:
    all of :data:`SIGNATURES`), all nvcc processes started together."""
    names = list(SIGNATURES if names is None else names)
    with _lock:
        todo = [n for n in names if n not in _libs]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        started = [_start(n) for n in todo if not _lib_path(n).exists()]
        failures = []
        for name, proc, tmp, out, t0 in started:
            log, _ = proc.communicate()
            BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                               "log": log}
            if proc.returncode != 0:
                failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failures:
            raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
        for n in todo:
            _libs[n] = _bind(n, _lib_path(n))
        return {n: _libs[n] for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all([name])[name]
