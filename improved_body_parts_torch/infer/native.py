"""ctypes binding to the native C++ decoder (``native/decoder.cpp``).

The port's own copy of ``improved_body_parts_tpu/infer/native.py``: the
same entry points over the same C ABI (connection scoring + greedy
assembly with the NumPy path's semantics; reference: evaluate.py:206-498).
The library is built from the repository's ``native/decoder.cpp`` with
the flags of ``native/Makefile`` into the port's ignored build directory
``csrc/_build/``, named by a hash of the source, the flags and the host
(``platform.platform()``: OS, kernel, C library) so an edited source or
a build copied from another machine never loads; nothing is written
into ``native/``.
This is host code: when the build or the load fails, a warning says so
and decoding takes the NumPy path of ``infer.decode``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from ..config import InferenceParams

SOURCE = Path(__file__).resolve().parents[2] / "native" / "decoder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False
_HAS_ASSEMBLE = False


def library_path() -> Path:
    """Where the decoder library for the current source, flags and host
    lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(platform.platform().encode())
    return BUILD_DIR / f"posedecoder-{h.hexdigest()[:16]}.so"


def ensure_built() -> str:
    """Build the decoder library unless an up-to-date one exists.  Returns
    '' when the library is there, else why it is not (a warning carries
    the compiler's output)."""
    if not SOURCE.is_file():
        return f"no native decoder source at {SOURCE}"
    out = library_path()
    if out.exists():
        return ""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        return "no C++ compiler (g++ or $CXX) to build the native decoder"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private temporary name, then an atomic rename: a concurrent
    # build or load never sees a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    except (OSError, subprocess.CalledProcessError) as e:
        stderr = getattr(e, "stderr", b"") or b""
        detail = stderr.decode(errors="replace")[-500:] or str(e)
        warnings.warn("native decoder build failed; decoding will use the "
                      f"slower NumPy path:\n{detail}", RuntimeWarning)
        tmp.unlink(missing_ok=True)
        return "native decoder build failed"
    return ""


def _declare(lib: ctypes.CDLL) -> bool:
    """Declare both entry points; False when ``assemble_people`` is
    missing (``decode_people`` alone still serves ``decode``)."""
    dp, ip = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int)
    c_int = ctypes.c_int
    lib.decode_people.restype = c_int
    lib.decode_people.argtypes = [
        dp, c_int,                                    # peaks, n
        ip,                                           # peaks per part
        c_int,                                        # num_parts
        ctypes.POINTER(ctypes.c_float),               # paf
        c_int, c_int, c_int,                          # H, W, C
        ip, c_int,                                    # limbs, n_limbs
        c_int,                                        # image_size
        dp,                                           # params[8]
        dp,                                           # out subsets
        c_int,                                        # max people
    ]
    try:
        fn = lib.assemble_people
    except AttributeError:
        return False
    fn.restype = c_int
    fn.argtypes = [
        dp, c_int,                                    # peaks, n
        dp,                                           # conns
        ip,                                           # conns per limb
        c_int,                                        # num_parts
        ip, c_int,                                    # limbs, n_limbs
        dp,                                           # params[8]
        dp,                                           # out
        c_int,                                        # max people
    ]
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED, _HAS_ASSEMBLE
    if _LIB_TRIED:
        return _LIB
    with _lock:
        if _LIB_TRIED:
            return _LIB
        if not ensure_built():
            path = library_path()
            try:
                lib = ctypes.CDLL(str(path))
                has_assemble = _declare(lib)
            except (OSError, AttributeError) as e:
                warnings.warn(f"could not load {path} ({e}); decoding will "
                              "use the NumPy path", RuntimeWarning)
            else:
                _LIB, _HAS_ASSEMBLE = lib, has_assemble
        _LIB_TRIED = True
    return _LIB


def native_available() -> bool:
    return _load() is not None


def native_assemble_available() -> bool:
    """True when the loaded library exports ``assemble_people``."""
    return _load() is not None and _HAS_ASSEMBLE


def _params_array(params: InferenceParams) -> np.ndarray:
    return np.asarray([
        params.thre2, params.connect_ration, float(params.mid_num),
        params.len_rate, params.connection_tole, float(params.remove_recon),
        float(params.min_parts), params.min_mean_score,
    ], dtype=np.float64)


def _flat_peaks(all_peaks: Sequence[np.ndarray]
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(counts per part, candidate (n, 4), its float64 C-order copy)."""
    counts = np.asarray([len(p) for p in all_peaks], dtype=np.int32)
    candidate = (np.concatenate([p for p in all_peaks], axis=0)
                 if counts.sum() else np.zeros((0, 4)))
    return counts, candidate, np.ascontiguousarray(candidate,
                                                   dtype=np.float64)


def native_find_connections_people(
        all_peaks: Sequence[np.ndarray], paf: np.ndarray, image_size: int,
        params: InferenceParams, limbs_conn: Sequence[Tuple[int, int]],
        num_parts: int) -> Tuple[np.ndarray, np.ndarray]:
    """Run the native connection scoring + assembly; returns (subset,
    candidate) with the same layout as the NumPy path."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder not built")
    counts, candidate, peaks_flat = _flat_peaks(all_peaks)
    paf_c = np.ascontiguousarray(paf, dtype=np.float32)
    limbs = np.ascontiguousarray(
        np.asarray(limbs_conn, dtype=np.int32).reshape(-1))
    p = _params_array(params)
    max_people = max(int(counts.sum()), 1)
    out = np.full((max_people, num_parts + 2, 2), -1.0, dtype=np.float64)

    n_people = lib.decode_people(
        peaks_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(counts.sum()),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        num_parts,
        paf_c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        paf.shape[0], paf.shape[1], paf.shape[2],
        limbs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        len(limbs_conn),
        image_size,
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_people,
    )
    if n_people < 0:
        raise RuntimeError("native decoder failed")
    return out[:n_people], candidate


def native_assemble_people(
        connection_all: Sequence[np.ndarray],
        all_peaks: Sequence[np.ndarray], params: InferenceParams,
        limbs_conn: Sequence[Tuple[int, int]],
        num_parts: int) -> Tuple[np.ndarray, np.ndarray]:
    """Native greedy assembly from already-selected connections (the host
    stage of the compact path: pair scoring ran on the device); same
    semantics and layout as ``decode.find_people``."""
    lib = _load()
    if lib is None or not _HAS_ASSEMBLE:
        raise RuntimeError("native assembly not built")
    counts, candidate, peaks_flat = _flat_peaks(all_peaks)
    conns_per_limb = np.asarray([len(c) for c in connection_all],
                                dtype=np.int32)
    conns_flat = (np.ascontiguousarray(
        np.concatenate([c.reshape(-1, 6) for c in connection_all], axis=0),
        dtype=np.float64) if conns_per_limb.sum() else np.zeros((0, 6)))
    limbs = np.ascontiguousarray(
        np.asarray(limbs_conn, dtype=np.int32).reshape(-1))
    p = _params_array(params)
    max_people = max(int(counts.sum()), 1)
    out = np.full((max_people, num_parts + 2, 2), -1.0, dtype=np.float64)

    n_people = lib.assemble_people(
        peaks_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(counts.sum()),
        conns_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        conns_per_limb.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        num_parts,
        limbs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        len(limbs_conn),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_people,
    )
    if n_people < 0:
        raise RuntimeError("native assembly failed")
    return out[:n_people], candidate
