"""Build and load the port's hand-written CUDA kernels.

The sources in ``openr_tpu_torch/csrc/*.cu`` have plain C entry points
(pointers, ints and a stream in; ``cudaGetLastError()`` out). They are
compiled by ``nvcc`` for ``sm_90a`` into
``build/openr_tpu_torch/libopenr_kernels.so`` at the repository root the
first time a kernel is launched, and loaded with ``ctypes``. A stamp file
beside the library holds the hash of the sources and flags; a changed
source rebuilds. Each source compiles in its own ``nvcc`` process, all
started together, and one more ``nvcc`` links the objects.

Nothing here runs at import: the CPU tests import every module of the
port on a machine without ``nvcc``.
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
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "openr_tpu_torch"
LIB_NAME = "libopenr_kernels.so"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argtypes. Every pointer and the stream are c_void_p:
# without argtypes ctypes would pass a Python int as a 32-bit C int.
SIGNATURES: Dict[str, List] = {
    # a, b, out, scratch [splits, S, N] (null without a split), S, K, N,
    # k_warps, k_chunk, splits, stream
    "openr_minplus": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # d, S, n_pad, src, w, rows, k, overloaded, ov_is_int32, pos,
    # row_threads, out, stream
    "openr_ell_band_relax": [
        _P, _I, _I, _P, _P, _I, _I, _P, _I, _I, _I, _P, _P,
    ],
    # d, S, n_pad, src, w, mask (packed int32 words), rows, k, overloaded,
    # ov_is_int32, pos, kmax, group, row_threads, chunk, out, stream
    "openr_ell_band_relax_masked": [
        _P, _I, _I, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P,
    ],
    # dr, B, n_pad, v, w, rows, k, t_ids, overloaded, ov_is_int32, pos,
    # chunk, out, stream
    "openr_rev_band_relax": [
        _P, _I, _I, _P, _P, _I, _I, _P, _P, _I, _I, _I, _P, _P,
    ],
    # gath [G, B, S], w [G, S, R], out [G, B, R], scratch
    # [splits, G, B, R] (null without a split), G, B, S, R, body (0 rows,
    # 1 cols), r_tile, threads, chunk, s_chunk, splits, stream
    "openr_batched_minplus": [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ],
    # gath_t [G, S, B], w [G, S, R], out [G, R, B], scratch
    # [splits, G, R, B] (null without a split), G, B, S, R, r_tile,
    # threads, s_chunk, splits, stream
    "openr_batched_minplus_t": [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build in this process did: seconds, whether it
# compiled or found a current library, and the ptxas report
BUILD_INFO: Dict[str, object] = {}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is not None:
            cand = Path(CUDA_HOME) / "bin" / "nvcc"
            if cand.exists():
                nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Run the commands together; raise with the compiler's output if
    any fails. Returns each command's stderr (ptxas -v reports there)."""
    procs = [
        subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        for cmd in cmds
    ]
    logs = []
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        logs.append(out + err)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}{err}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def build(force: bool = False) -> Path:
    """Compile the sources into the shared library unless a library
    built from the same sources and flags is already there."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    if (
        not force
        and lib_path.exists()
        and stamp.exists()
        and stamp.read_text().strip() == digest
    ):
        BUILD_INFO.update(seconds=0.0, compiled=False, log="")
        return lib_path
    t0 = time.monotonic()
    nvcc = find_nvcc()
    objs = [BUILD_DIR / (src.stem + ".o") for src in sources()]
    logs = _run_all(
        [
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            for src, obj in zip(sources(), objs)
        ]
    )
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    _run_all(
        [[nvcc, *NVCC_FLAGS[:2], "-shared", *map(str, objs), "-o", str(tmp)]]
    )
    os.replace(tmp, lib_path)
    stamp.write_text(digest + "\n")
    BUILD_INFO.update(
        seconds=time.monotonic() - t0, compiled=True, log="".join(logs)
    )
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
