"""Native (C++) host-codec acceleration.

The compute path is PyTorch + hand-written CUDA kernels; these are the host-side pieces the
reference implements in C++ (pgenlib record decode).  The library is built
lazily with g++ on first use and cached next to the source; every native
entry point has a vectorized-numpy fallback so the package works without a
toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libpgen_decode.so")
_SRC = os.path.join(_DIR, "pgen_decode.cc")
_HASH = _SO + ".hash"
_lock = threading.Lock()
_lib = None
_tried = False


def _src_hash() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _build(src_hash: str) -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-o",
             _SO + ".tmp", _SRC],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(_SO + ".tmp", _SO)
        with open(_HASH, "w") as f:
            f.write(src_hash)
        return True
    except Exception:
        return False


def get_lib():
    """Return the loaded ctypes library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        # Rebuild keyed on a content hash of the source (mtimes are
        # unreliable on fresh checkouts where everything shares one stamp).
        src_hash = _src_hash()
        built_hash = None
        if os.path.exists(_SO) and os.path.exists(_HASH):
            with open(_HASH) as f:
                built_hash = f.read().strip()
        if built_hash != src_hash:
            if not _build(src_hash):
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.pgen_decode_block.restype = ctypes.c_int
        lib.pgen_decode_block.argtypes = [
            ctypes.c_void_p,  # buf
            ctypes.c_void_p,  # rel
            ctypes.c_void_p,  # vrtypes
            ctypes.c_int64,  # vct
            ctypes.c_int64,  # sample_ct
            ctypes.c_void_p,  # ld_base
            ctypes.c_void_p,  # ld_valid
            ctypes.c_void_p,  # out
        ]
        lib.pgen_decode_block_mt.restype = ctypes.c_int
        lib.pgen_decode_block_mt.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.bed_to_pgen_bytes.restype = None
        lib.bed_to_pgen_bytes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.vcf_parse_gt_rows.restype = ctypes.c_int
        lib.vcf_parse_gt_rows.argtypes = [
            ctypes.c_char_p,  # buf
            ctypes.c_void_p,  # offs
            ctypes.c_int64,  # n_rows
            ctypes.c_int64,  # n_samples
            ctypes.c_int,  # halfcall
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # status
            ctypes.c_void_p,  # phased (nullable)
            ctypes.c_void_p,  # swap (nullable)
            ctypes.c_int,  # nthreads
        ]
        lib.lasso_cd_lambda.restype = ctypes.c_int64
        lib.lasso_cd_lambda.argtypes = [
            ctypes.c_void_p,  # X
            ctypes.c_int64,  # C
            ctypes.c_int64,  # n
            ctypes.c_double,  # lambda
            ctypes.c_int64,  # unpen_ct
            ctypes.c_void_p,  # y
            ctypes.c_void_p,  # xhat
            ctypes.c_void_p,  # residuals
        ]
        lib.pgen_encode_rows.restype = ctypes.c_int64
        lib.pgen_encode_rows.argtypes = [
            ctypes.c_void_p,  # rows
            ctypes.c_int64,  # n_rows
            ctypes.c_int64,  # N
            ctypes.c_int64,  # written0
            ctypes.c_int,  # use_ld
            ctypes.c_void_p,  # ld_base
            ctypes.c_void_p,  # ld_valid
            ctypes.c_void_p,  # out
            ctypes.c_int64,  # out_cap
            ctypes.c_void_p,  # offs
            ctypes.c_void_p,  # vrtypes
        ]
        lib.ld_prune_walk.restype = None
        lib.ld_prune_walk.argtypes = [
            ctypes.c_void_p,  # exceeds [n, width+1] uint8
            ctypes.c_void_p,  # mono [n] uint8
            ctypes.c_void_p,  # majf [n] f64
            ctypes.c_void_p,  # bps [n] int64
            ctypes.c_int64,  # n
            ctypes.c_int64,  # width
            ctypes.c_int64,  # ws
            ctypes.c_int,  # is_kb
            ctypes.c_int64,  # step
            ctypes.c_double,  # eps
            ctypes.c_void_p,  # removed [n] uint8 out
        ]
        _lib = lib
        return _lib
