"""Build, load and launch the hand-written CUDA kernels (``plink_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled on first use by its own ``nvcc`` process
(all started together) into ``build/plink_torch_kernels/<name>-<hash>.so``
under the repository root, a shared library with a plain C interface loaded
with ctypes.  The hash covers the sources and the flags, so an edited
kernel is rebuilt and a stale library is never loaded.

``LAUNCHES`` counts, per kernel, the launches made by the wrappers in
``ops/counts.py`` and ``ops/glm.py``; it is the only module state the port
keeps besides the loaded libraries.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_CSRC)), "build",
                         "plink_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry point and argument types of each kernel library
_ENTRY = {
    "geno_counts": ("pt_geno_counts", [_P, _L, _P, _P, _I, _I, _P, _P]),
    "glm_moments": ("pt_glm_moments",
                    [_P, _L, _I, _P, _L, _I, _L, _I, _P, _P, _P, _P]),
    "glm_irls": ("pt_glm_irls_pass",
                 [_P, _L, _I, _P, _L, _I, _I, _L, _I, _P, _P, _P, _P, _P, _P,
                  _P, _P, _P, _P]),
    "chol_small": ("pt_chol_small", [_P, _I, _I, _P, _P, _P, _P, _P]),
}

LAUNCHES: dict[str, int] = dict.fromkeys(_ENTRY, 0)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of plink_torch are "
                       "built on first use and need the CUDA toolkit")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in (name + ".cu", "common.cuh"):
        with open(os.path.join(_CSRC, fn), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all() -> dict[str, float]:
    """Compile every kernel library that is not built yet, one nvcc process
    per source, all at once.  Returns the seconds each build took (0.0 for
    a library already present).  Raises with nvcc's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    times = {}
    for name in _ENTRY:
        path = _lib_path(name)
        if os.path.exists(path):
            times[name] = 0.0
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        log = open(path[:-3] + ".log", "w")  # nvcc + ptxas -v output
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       log, tmp, path, time.perf_counter())
    failed = []
    while procs:
        time.sleep(0.05)
        for name in [k for k, v in procs.items() if v[0].poll() is not None]:
            proc, log, tmp, path, t0 = procs.pop(name)
            times[name] = time.perf_counter() - t0
            log.close()
            if proc.returncode != 0:
                failed.append(f"{name}:\n{build_log(name)}")
            else:
                os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return times


def build_log(name: str) -> str:
    """nvcc/ptxas output of the last build of `name` (registers, spills)."""
    with open(_lib_path(name)[:-3] + ".log") as f:
        return f.read()


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build_all()
            for nm, (fn, argtypes) in _ENTRY.items():
                cdll = ctypes.CDLL(_lib_path(nm))
                entry = getattr(cdll, fn)
                entry.argtypes = argtypes
                entry.restype = ctypes.c_int
                cdll.pt_error_string.argtypes = [ctypes.c_int]
                cdll.pt_error_string.restype = ctypes.c_char_p
                _libs[nm] = cdll
    return _libs[name]


def launch(name: str, *args) -> None:
    """Call kernel `name`'s C entry point on the current CUDA stream (the
    stream is appended to `args`) and count the launch; raise on a non-zero
    cudaError_t."""
    import torch

    lib = _lib(name)
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, _ENTRY[name][0])(*args, stream)
    if rc != 0:
        msg = lib.pt_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {rc} ({msg})")
    LAUNCHES[name] += 1


def ptr(t) -> int:
    """Device pointer of a tensor, or None for an absent optional input."""
    return None if t is None else t.data_ptr()
