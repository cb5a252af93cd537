"""Fast deterministic synthetic panels for the benchmark harness.

Role model: plink2's --dummy generator (GenerateDummy,
2.0/plink2_import.cc:16326) and testgen.py's planted-structure panels --
but engineered for COLD-CACHE benchmark runs: the 500k x 16384 GLM panel
must regenerate in seconds inside a benchmark's time budget, not the ~7
minutes the numpy --dummy path takes.

Design:
  * stateless counter-based RNG (splitmix64 finalizer per cell), so the
    output is byte-identical regardless of thread count, and the pure
    numpy fallback here reproduces the native bytes exactly;
  * the cell path uses only IEEE add/mul/compare (gaussians are
    Irwin-Hall sums of 12 uniforms) -- no transcendentals, hence no
    libm-vs-numpy last-ulp divergence;
  * .pgen is written as storage mode 0x02 (fixed-width 2-bit records,
    pgen_spec.tex) by the multithreaded native generator
    (native/pgen_decode.cc panelgen_iid/panelgen_structured).

Panels produced by this module are what BASELINE_MEASURED.json walls and
the committed bench_golden/ oracle artifacts were computed on; changing
any constant here invalidates those and requires re-measuring.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

GOLD = np.uint64(0x9E3779B97F4A7C15)
_FREQ_SALT = np.uint64(0xA5A5A5A5A5A5A5A5)
_WL_SALT = np.uint64(0x5151515151515151)
_U_SALT = np.uint64(0x3C3C3C3C3C3C3C3C)
_SEX_SALT = np.uint64(0x1111111111111111)
_PHENO_SALT = np.uint64(0x2222222222222222)


def _mix64(z: np.ndarray | np.uint64) -> np.ndarray | np.uint64:
    with np.errstate(over="ignore"):  # uint64 wraparound is the algorithm
        z = np.uint64(z) if np.isscalar(z) or isinstance(z, np.uint64) \
            else z.astype(np.uint64, copy=True)
        z = z ^ (z >> np.uint64(30))
        z = z * np.uint64(0xBF58476D1CE4E5B9)
        z = z ^ (z >> np.uint64(27))
        z = z * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
        return z


def _unit(r: np.ndarray) -> np.ndarray:
    return (r >> np.uint64(11)).astype(np.float64) * (1.0 / 9007199254740992.0)


def _gauss12(key: np.ndarray) -> np.ndarray:
    acc = np.zeros(key.shape, np.float64)
    with np.errstate(over="ignore"):
        for i in range(12):
            acc += _unit(_mix64(key + np.uint64(i) * GOLD))
    return acc - 6.0


def _pack_rows(codes: np.ndarray) -> np.ndarray:
    """[V, N] uint8 codes -> [V, ceil(N/4)] packed 2-bit."""
    V, N = codes.shape
    nb = (N + 3) // 4
    out = np.zeros((V, nb), np.uint8)
    for k in range(4):
        cols = codes[:, k::4]
        out[:, : cols.shape[1]] |= cols << (2 * k)
    return out


@np.errstate(over="ignore")  # uint64 wraparound is the algorithm
def _numpy_pgen(path, seed, sample_ct, variant_ct, miss_rate, k,
                scale_top, decay):
    """Bit-identical fallback for the native generators."""
    miss21 = np.uint64(int(miss_rate * 2097152.0))
    sidx = (np.arange(1, sample_ct + 1, dtype=np.uint64)) * GOLD
    if k:
        scales = scale_top * decay ** np.arange(k)
        ukey = _mix64(np.uint64(seed) ^ _U_SALT)
        u = np.empty((k, sample_ct), np.float64)
        s_arr = np.arange(sample_ct, dtype=np.uint64)
        for j in range(k):
            u[j] = _gauss12(ukey + (s_arr * np.uint64(64) + np.uint64(j))
                            * np.uint64(131) * GOLD)
    with open(path, "wb") as f:
        f.write(b"\x6c\x1b\x02")
        f.write(np.asarray([variant_ct, sample_ct], "<u4").tobytes())
        f.write(bytes([0x40]))
        block = max(16, min(4096, (1 << 26) // max(sample_ct, 1)))
        for v0 in range(0, variant_ct, block):
            v1 = min(v0 + block, variant_ct)
            rows = np.empty((v1 - v0, sample_ct), np.uint8)
            for v in range(v0, v1):
                rowkey = _mix64(np.uint64(seed) ^ (np.uint64(v + 1) * GOLD))
                r = _mix64(rowkey + sidx)
                if k:
                    base = 0.1 + 0.4 * float(_unit(_mix64(rowkey ^ _FREQ_SALT)))
                    wlkey = _mix64(rowkey ^ _WL_SALT)
                    p = np.full(sample_ct, base, np.float64)
                    for j in range(k):
                        wlj = float(_gauss12(np.asarray(
                            [wlkey + np.uint64(j) * np.uint64(977) * GOLD],
                            np.uint64))[0]) * scales[j]
                        p += wlj * u[j]
                    np.clip(p, 0.01, 0.99, out=p)
                    p21 = (p * 2097152.0).astype(np.uint64)
                else:
                    p = float(_unit(_mix64(rowkey ^ _FREQ_SALT)))
                    p21 = np.uint64(int(p * 2097152.0))
                m21 = np.uint64(0x1FFFFF)
                code = ((r & m21) < p21).astype(np.uint8) \
                    + (((r >> np.uint64(21)) & m21) < p21).astype(np.uint8)
                if miss_rate > 0.0:
                    code[((r >> np.uint64(42)) & m21) < miss21] = 3
                rows[v - v0] = code
            f.write(_pack_rows(rows).tobytes())


def _native_pgen(path, seed, sample_ct, variant_ct, miss_rate, k,
                 scale_top, decay, threads):
    from .native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "panelgen_iid"):
        return False
    lib.panelgen_iid.restype = ctypes.c_int
    lib.panelgen_iid.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_double, ctypes.c_int]
    lib.panelgen_structured.restype = ctypes.c_int
    lib.panelgen_structured.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int]
    if k:
        rc = lib.panelgen_structured(
            path.encode(), seed, sample_ct, variant_ct, k, scale_top, decay,
            miss_rate, threads)
    else:
        rc = lib.panelgen_iid(
            path.encode(), seed, sample_ct, variant_ct, miss_rate, threads)
    return rc == 0


@np.errstate(over="ignore")
def _write_meta(prefix, seed, sample_ct, variant_ct):
    from .io.psam import PhenoCol, SampleInfo, write_psam
    from .io.pvar import VariantInfo, write_pvar

    M, N = variant_ct, sample_ct
    vi = VariantInfo(
        chrom=np.ones(M, dtype=np.int16),
        pos=np.arange(1, M + 1, dtype=np.int32),
        vid=np.array([f"snp{i}" for i in range(M)], dtype=object),
        ref=np.full(M, "B", dtype=object),
        alt=np.full(M, "A", dtype=object),
    )
    write_pvar(prefix + ".pvar", vi)
    s_arr = (np.arange(1, N + 1, dtype=np.uint64)) * GOLD
    sex = 1 + (_mix64(_mix64(np.uint64(seed) ^ _SEX_SALT) + s_arr)
               & np.uint64(1)).astype(np.int8)
    cc = (_mix64(_mix64(np.uint64(seed) ^ _PHENO_SALT) + s_arr)
          & np.uint64(1)).astype(np.float64)
    iid = np.array([f"per{i}" for i in range(N)], dtype=object)
    si = SampleInfo(
        fid=np.full(N, "0", dtype=object), iid=iid, sid=None, pat=None,
        mat=None, sex=sex,
        phenos={"PHENO1": PhenoCol("PHENO1", "cc", cc, np.ones(N, bool))},
        has_fid=False,
    )
    write_psam(prefix + ".psam", si)


def gen_panel(prefix: str, sample_ct: int, variant_ct: int,
              miss_rate: float = 0.0, seed: int = 42, k: int = 0,
              scale_top: float = 0.032, decay: float = 0.84,
              threads: int | None = None) -> None:
    """Write <prefix>.pgen/.pvar/.psam; k>0 plants k structure axes."""
    if threads is None:
        threads = min(8, os.cpu_count() or 1)
    ok = _native_pgen(prefix + ".pgen", seed, sample_ct, variant_ct,
                      miss_rate, k, scale_top, decay, threads)
    if not ok:
        _numpy_pgen(prefix + ".pgen", seed, sample_ct, variant_ct,
                    miss_rate, k, scale_top, decay)
    _write_meta(prefix, seed, sample_ct, variant_ct)


def make_cov(prefix: str, seed: int, n_pcs: int = 10) -> str:
    """Deterministic covariate file (SEX + n_pcs gaussian PCs)."""
    cov = prefix + ".cov"
    rng = np.random.default_rng(seed)
    with open(prefix + ".psam") as f:
        header = f.readline().rstrip("\n").split("\t")
        sex_idx = header.index("SEX")
        rows = [line.rstrip("\n").split("\t") for line in f]
    pcs = rng.standard_normal((len(rows), n_pcs))
    with open(cov, "w") as f:
        f.write("#IID\tSEX\t"
                + "\t".join(f"PC{i + 1}" for i in range(n_pcs)) + "\n")
        for r, row in enumerate(rows):
            f.write(row[0] + "\t" + row[sex_idx] + "\t"
                    + "\t".join(f"{v:.6f}" for v in pcs[r]) + "\n")
    return cov


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("prefix")
    ap.add_argument("sample_ct", type=int)
    ap.add_argument("variant_ct", type=int)
    ap.add_argument("--miss", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--k", type=int, default=0)
    ap.add_argument("--cov", action="store_true")
    a = ap.parse_args(argv)
    gen_panel(a.prefix, a.sample_ct, a.variant_ct, a.miss, a.seed, a.k)
    if a.cov:
        make_cov(a.prefix, a.seed + 1)


if __name__ == "__main__":
    main()
