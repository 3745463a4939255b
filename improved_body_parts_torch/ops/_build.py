"""Build and load the kernels (``csrc/*.cu``) at first use.

Each CUDA source is compiled by its own ``nvcc`` process (all started
together) into a shared library with a plain C interface, which is loaded
with ``ctypes`` — no PyTorch headers, so a build takes seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

``--fmad=false`` (and no ``--use_fast_math``) keeps the kernels' float
arithmetic IEEE-rounded op by op, which their exactness against the plain
versions relies on (see ``csrc/limbs.cu``).  The libraries go to
``csrc/_build/`` (listed in ``.gitignore``), named by a hash of the
sources and flags, so an edited source never loads a stale library.
Only the repository's own sources are compiled.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
#: per-source nvcc output, with ptxas's report of registers, shared
#: memory and spills (``-Xptxas -v``)
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _digest(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile (in parallel) and load every ``csrc/*.cu``; returns
    {source stem: library}.  Cached for the process."""
    with _lock:
        if _libs:
            return dict(_libs)
        sources = sorted(CSRC.glob("*.cu"))
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = None
        procs = {}
        for src in sources:
            out = BUILD_DIR / f"{src.stem}-{_digest(src)}.so"
            if out.exists():
                continue
            nvcc = nvcc or _nvcc()
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[src.stem] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for stem, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_log[stem] = log
            if proc.returncode != 0:
                failed.append(f"{stem}.cu (nvcc exit {proc.returncode}):\n"
                              f"{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for src in sources:
            out = BUILD_DIR / f"{src.stem}-{_digest(src)}.so"
            _libs[src.stem] = ctypes.CDLL(str(out))
        return dict(_libs)


def function(stem: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of ``csrc/<stem>.cu`` (every library is
    built on first use) with its argument types declared (pointers and
    the stream as ``c_void_p``) and an ``int`` result (a launcher's
    ``cudaError_t``).  The handle is made once and cached: later calls
    take no lock and declare nothing."""
    fn = _fns.get((stem, name))
    if fn is None:
        fn = getattr(build_all()[stem], name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[(stem, name)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise when a launch returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
