"""Build, load and launch the hand-written CUDA kernels (``plink_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled on first use by its own ``nvcc`` process
(all started together) into ``build/plink_torch_kernels/<name>-<hash>.so``
under the repository root, a shared library with a plain C interface loaded
with ctypes.  The hash covers the sources and the flags, so an edited
kernel is rebuilt and a stale library is never loaded.

``LAUNCHES`` counts, per kernel entry point and per mode in ``_MODES``, the
launches made by the wrappers in ``ops/counts.py``, ``ops/glm.py``,
``ops/pairwise.py``, ``ops/pca.py``, ``ops/ld.py`` and ``ops/epistasis.py``;
it is the only module state the port keeps besides the loaded libraries.
An entry point lives in ``csrc/<name>.cu`` unless ``_SOURCE`` names another
file (K9 and K10 share one; so do K11-K12, K17-K18, K19-K20, K21-K22 and
K24's two kernels); every source may include any ``csrc/*.cuh``.
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
_D = ctypes.c_double
# C entry point and argument types of each kernel library (the last is the
# stream, which `launch` appends)
_ENTRY = {
    "geno_counts": ("pt_geno_counts", [_P, _L, _P, _P, _I, _I, _P, _P]),
    "glm_moments": ("pt_glm_moments",
                    [_P, _L, _I, _P, _L, _I, _L, _I, _P, _P, _P, _P, _P]),
    "glm_irls": ("pt_glm_irls_pass",
                 [_P, _L, _I, _P, _L, _I, _I, _L, _I, _P, _P, _P, _P, _P, _P,
                  _P, _P, _P, _P]),
    "glm_irls_x": ("pt_glm_irls_pass_x",
                   [_P, _L, _I, _P, _L, _I, _I, _I, _L, _I] + [_P] * 13),
    "glm_moments_p2": ("pt_glm_moments_p2",
                       [_P, _L, _I, _P, _L, _I, _L, _I, _P, _P, _P, _P]),
    "glm_irls_p2": ("pt_glm_irls_pass_p2",
                    [_P, _L, _I, _P, _L, _I, _I, _I, _L, _I] + [_P] * 13),
    "glm_wide": ("pt_glm_wide", [_P, _L, _I, _P, _L, _I, _I, _P, _I, _L, _I]
                 + [_P] * 12),
    "glm_dense_moments": ("pt_glm_dense_moments",
                          [_P, _I, _P, _L, _I, _L, _I, _P, _P, _P]),
    "glm_dense_irls": ("pt_glm_dense_irls",
                       [_P, _I, _P, _L, _I, _I, _L, _I] + [_P] * 9),
    "xm1_stats": ("pt_xm1_stats", [_P, _L, _I, _P, _P, _I, _P, _P, _P]),
    "chol_small": ("pt_chol_small", [_P, _I, _I, _P, _P, _P, _P, _P, _P]),
    "sample_counts": ("pt_sample_counts", [_P, _L, _I, _P, _I, _I, _P, _P]),
    "linear_sums": ("pt_linear_sums", [_P, _L, _I, _P, _P, _I, _L, _I, _P, _P,
                                       _P]),
    "king_gram": ("pt_king_gram", [_P, _L, _L, _P, _L, _I, _L, _I, _L, _D, _I,
                                   _P, _P, _P, _P, _P, _P, _P, _P, _P]),
    "grm_gram": ("pt_grm_gram", [_P, _L, _L, _P, _P, _P, _L, _L, _I, _L, _I,
                                 _I, _P, _P, _P]),
    "pca_x": ("pt_pca_x", [_P, _L, _L, _P, _P, _L, _P, _I, _P, _P, _P]),
    "pca_xt": ("pt_pca_xt", [_P, _L, _L, _P, _P, _L, _P, _I, _P, _P]),
    "ld_band_bits": ("pt_ld_band_bits", [_P, _L, _L, _P, _L, _I, _D, _P, _P,
                                         _P, _P, _P, _P, _P]),
    "ld_band_stats": ("pt_ld_band_stats", [_P, _L, _L, _P, _L, _I, _P, _P, _P,
                                           _P, _P, _P, _P]),
    "ld_gram_pair": ("pt_ld_gram_pair", [_P, _L, _P, _L, _L, _P, _L, _P, _P]),
    "linear_perm_xty": ("pt_linear_perm_xty", [_P, _L, _I, _P, _I, _P, _I, _P,
                                               _I, _P, _P, _P, _L, _P, _P, _P]),
    "linear_perm_stat": ("pt_linear_perm_stat", [_P, _P, _P, _P, _P, _I, _I, _I,
                                                 _I, _I, _P, _P]),
    "sample_plane_weighted": ("pt_sample_plane_weighted",
                              [_P, _L, _I, _P, _I, _I, _I, _P, _P, _P]),
    "variant_plane_weighted": ("pt_variant_plane_weighted",
                               [_P, _L, _I, _P, _I, _I, _I, _P, _P, _P]),
    "wmiss_gram": ("pt_wmiss_gram", [_P, _L, _L, _P, _P, _L, _I, _L, _I, _P,
                                     _P, _P]),
    "epi_split_planes": ("pt_epi_split_planes", [_P, _L, _P, _P, _L, _P, _P, _I,
                                                 _L, _P, _P]),
    "epi_joint_counts": ("pt_epi_joint_counts", [_P, _L, _L, _P, _I, _P, _I, _P,
                                                 _P]),
}
# kernel modes counted apart from their entry point's default mode: name ->
# entry point (K2 scaled; K3 scaled and residualized share glm_irls_x; K3
# residualized with two columns is a mode of glm_irls_p2; K15 and K16 share
# glm_wide; K4 above d = 48; K18's firth2 mode)
_MODES = {"glm_moments_scaled": "glm_moments", "glm_irls_scaled": "glm_irls_x",
          "glm_irls_resid": "glm_irls_x", "glm_irls_resid_p2": "glm_irls_p2",
          "glm_moments_wide": "glm_wide", "glm_irls_wide": "glm_wide",
          "chol_small_wide": "chol_small", "glm_dense_firth": "glm_dense_irls"}
# entry points launched only through their modes
_MODE_ONLY = ("glm_irls_x", "glm_wide")
# entry points whose source file is not named after them
_SOURCE = {"pca_x": "pca_apply", "pca_xt": "pca_apply", "ld_band_bits": "ld_band",
           "ld_band_stats": "ld_band", "ld_gram_pair": "ld_gram",
           "glm_dense_moments": "glm_dense", "glm_dense_irls": "glm_dense",
           "linear_perm_xty": "linear_perm", "linear_perm_stat": "linear_perm",
           "sample_plane_weighted": "plane_weighted",
           "variant_plane_weighted": "plane_weighted",
           "epi_split_planes": "epi_counts", "epi_joint_counts": "epi_counts"}
_SOURCES = sorted({_SOURCE.get(k, k) for k in _ENTRY})

LAUNCHES: dict[str, int] = dict.fromkeys(
    [k for k in _ENTRY if k not in _MODE_ONLY] + list(_MODES), 0)

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


def _lib_path(src: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for fn in [src + ".cu"] + headers:
        with open(os.path.join(_CSRC, fn), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{src}-{h.hexdigest()[:16]}.so")


def build_all() -> dict[str, float]:
    """Compile every kernel library that is not built yet, one nvcc process
    per source, all at once.  Returns the seconds each source's build took
    (0.0 for a library already present).  Raises with nvcc's output on
    failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    times = {}
    for name in _SOURCES:
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


def build_log(src: str) -> str:
    """nvcc/ptxas output of the last build of source `src` (registers,
    spills)."""
    with open(_lib_path(src)[:-3] + ".log") as f:
        return f.read()


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build_all()
            cdlls = {}
            for nm, (fn, argtypes) in _ENTRY.items():
                src = _SOURCE.get(nm, nm)
                if src not in cdlls:
                    cdlls[src] = ctypes.CDLL(_lib_path(src))
                    cdlls[src].pt_error_string.argtypes = [ctypes.c_int]
                    cdlls[src].pt_error_string.restype = ctypes.c_char_p
                entry = getattr(cdlls[src], fn)
                entry.argtypes = argtypes
                entry.restype = ctypes.c_int
                _libs[nm] = cdlls[src]
    return _libs[name]


def _raw_stream(torch) -> int:
    """The current CUDA stream as an int, by torch's raw query where it has
    one: building a Stream object at every launch costs host time that sets
    the pace of short kernels."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(torch.cuda.current_device())
    return torch.cuda.current_stream().cuda_stream


def launch(name: str, *args) -> None:
    """Call kernel `name`'s C entry point (a mode of `_MODES` calls its
    entry point's) on the current CUDA stream (the stream is appended to
    `args`) and count the launch under `name`; raise on a non-zero
    cudaError_t."""
    import torch

    entry = _MODES.get(name, name)
    lib = _lib(entry)
    stream = _raw_stream(torch)
    rc = getattr(lib, _ENTRY[entry][0])(*args, stream)
    if rc != 0:
        msg = lib.pt_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {rc} ({msg})")
    LAUNCHES[name] += 1


def ptr(t) -> int:
    """Device pointer of a tensor, or None for an absent optional input."""
    return None if t is None else t.data_ptr()
