"""ctypes bindings for the port's native SPF core (``csrc/spfcore.cpp``).

Port note: mirrors ``openr_tpu/graph/native_spf.py``: the ctypes
signatures, ``_edge_arrays``, ``all_pairs_distances``, ``first_hop_matrix``
and ``trace_batch`` with its grow-and-retry. The core is host C++, built
by ``g++ -O3 -std=c++17 -shared -fPIC -pthread`` from
``openr_tpu_torch/csrc/spfcore.cpp`` into
``build/openr_tpu_torch/libspfcore.so`` at the repository root on first
use. A stamp file beside the library holds the hash of the compiler's
version, the flags and the source; any change rebuilds. The build
compiles to a temporary name and ``os.replace``s it into place under a
file lock, so processes that race to build it (test workers on a clean
tree) each load a whole library.

One departure from the reference: where the reference degrades quietly
when the toolchain is missing (``is_available()`` False, callers fall
back to Python), the port raises. A library that cannot be built or
loaded is an error on every path that uses it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SRC = _PKG / "csrc" / "spfcore.cpp"
BUILD_DIR = _PKG.parent / "build" / "openr_tpu_torch"
LIB_NAME = "libspfcore.so"
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build in this process did: seconds, and whether it
# compiled or found a current library
BUILD_INFO: Dict[str, object] = {}


class NativeBuildError(RuntimeError):
    """The native core could not be built or loaded."""


def _digest() -> str:
    """Hash of the compiler's version, the flags and the source: a
    library built by another toolchain is rebuilt."""
    h = hashlib.sha256()
    h.update(compiler_version().encode())
    h.update(" ".join([CXX, *CXX_FLAGS]).encode())
    h.update(SRC.read_bytes())
    return h.hexdigest()


def compiler_version() -> str:
    """The first line of ``g++ --version``."""
    cxx = shutil.which(CXX)
    if cxx is None:
        raise NativeBuildError(f"{CXX} not found: the native SPF core cannot be built")
    out = subprocess.run(
        [cxx, "--version"], capture_output=True, text=True, timeout=60
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def build(force: bool = False) -> Path:
    """Compile the core into the shared library unless one built by the
    same compiler from the same source and flags is already there.
    Raises ``NativeBuildError`` when the compiler is missing or fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    with open(BUILD_DIR / (LIB_NAME + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (
            not force
            and lib_path.exists()
            and stamp.exists()
            and stamp.read_text().strip() == digest
        ):
            BUILD_INFO.update(seconds=0.0, compiled=False)
            return lib_path
        t0 = time.monotonic()
        tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [shutil.which(CXX), *CXX_FLAGS, str(SRC), "-o", str(tmp)],
            capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"native SPF core build failed:\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib_path)
        stamp.write_text(digest + "\n")
        BUILD_INFO.update(seconds=time.monotonic() - t0, compiled=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded core, built on first use. Raises ``NativeBuildError``
    when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            raise NativeBuildError(f"cannot load {path}: {exc}") from exc
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.spf_from_sources.argtypes = [
            ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p, u8p,
            i32p, ctypes.c_int32, ctypes.c_int32, i32p,
        ]
        lib.spf_all_pairs.argtypes = [
            ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p, u8p,
            ctypes.c_int32, i32p,
        ]
        lib.spf_first_hops.argtypes = [
            ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p, u8p,
            ctypes.c_int32, i32p, i32p, u8p,
        ]
        lib.ksp2_trace_batch.argtypes = [
            ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p, i32p,
            ctypes.c_int32, u8p, ctypes.c_int32, i32p, i32p,
            ctypes.c_int32, i32p, i32p, i32p, ctypes.c_int32,
        ]
        lib.ksp2_trace_batch.restype = ctypes.c_int32
        _lib = lib
        return _lib


def _as_i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _as_u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _edge_arrays(snap) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    srcs, dsts, weights = [], [], []
    for links in snap.links_from:
        for dl in links:
            srcs.append(dl.src_id)
            dsts.append(dl.dst_id)
            weights.append(dl.metric)
    return (
        np.asarray(srcs, dtype=np.int32),
        np.asarray(dsts, dtype=np.int32),
        np.asarray(weights, dtype=np.int32),
    )


def all_pairs_distances(snap, n_threads: int = 0) -> np.ndarray:
    """All-sources distances ``[n, n]`` int32 over a host
    ``GraphSnapshot``."""
    lib = library()
    n = snap.n
    srcs, dsts, weights = _edge_arrays(snap)
    overloaded = np.ascontiguousarray(snap.overloaded[:n].astype(np.uint8))
    out = np.empty((n, n), dtype=np.int32)
    if n_threads <= 0:
        n_threads = min(16, os.cpu_count() or 1)
    lib.spf_all_pairs(
        n, len(srcs), _as_i32p(srcs), _as_i32p(dsts), _as_i32p(weights),
        _as_u8p(overloaded), n_threads, _as_i32p(out),
    )
    return out


def first_hop_matrix(
    snap, src_id: int, dist_src: np.ndarray, dist_all: np.ndarray
) -> np.ndarray:
    """ECMP first hops ``[n, n]`` uint8 of ``src_id``: entry (v, j) is 1
    when neighbour v starts a shortest path toward j."""
    lib = library()
    n = snap.n
    srcs, dsts, weights = _edge_arrays(snap)
    overloaded = np.ascontiguousarray(snap.overloaded[:n].astype(np.uint8))
    dist_src = np.ascontiguousarray(dist_src[:n].astype(np.int32))
    dist_all = np.ascontiguousarray(dist_all[:n, :n].astype(np.int32))
    out = np.zeros((n, n), dtype=np.uint8)
    lib.spf_first_hops(
        n, len(srcs), _as_i32p(srcs), _as_i32p(dsts), _as_i32p(weights),
        _as_u8p(overloaded), src_id, _as_i32p(dist_src), _as_i32p(dist_all),
        _as_u8p(out),
    )
    return out


def trace_batch(
    n: int,
    n_links: int,
    cand_off: np.ndarray,
    cand_link: np.ndarray,
    cand_uid: np.ndarray,
    cand_w: np.ndarray,
    src: int,
    transit_blocked: np.ndarray,
    dst_ids: np.ndarray,
    rows: np.ndarray,
    shared_row: bool,
    excl_off: np.ndarray,
    excl_ids: np.ndarray,
    cap: Optional[int] = None,
) -> list:
    """Batched KSP2 link-disjoint path enumeration (``ksp2_trace_batch``):
    the same path content and order as ``ksp2_engine.trace_paths_from_row``.
    Returns a list (one per destination) of lists of link-id paths. The
    int32 output buffer starts at ``cap`` (by default room for every link
    twice and 64 ids a destination) and grows fourfold each time the core
    returns -1 for too small a buffer."""
    lib = library()
    n_dsts = len(dst_ids)
    if cap is None:
        cap = max(4096, 2 * n_links + 64 * n_dsts)
    while True:
        out = np.empty(cap, dtype=np.int32)
        wrote = lib.ksp2_trace_batch(
            n, n_links, _as_i32p(cand_off), _as_i32p(cand_link),
            _as_i32p(cand_uid), _as_i32p(cand_w), src,
            _as_u8p(transit_blocked), n_dsts, _as_i32p(dst_ids),
            _as_i32p(rows), 1 if shared_row else 0,
            _as_i32p(excl_off), _as_i32p(excl_ids), _as_i32p(out), cap,
        )
        if wrote >= 0:
            break
        cap *= 4
    result = []
    pos = 0
    for _ in range(n_dsts):
        n_paths = int(out[pos])
        pos += 1
        paths = []
        for _p in range(n_paths):
            ln = int(out[pos])
            pos += 1
            paths.append(out[pos : pos + ln].tolist())
            pos += ln
        result.append(paths)
    return result
