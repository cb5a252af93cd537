"""Hardy-Weinberg exact test (Wigginton/Cutler/Abecasis SNP-HWE, as extended
by the reference: 2.0/include/plink2_stats.cc:1585-1594 HweP / midp variant).

p = sum of P(het = h') over all h' whose probability does not exceed the
observed configuration's probability (with the reference's relative
tolerance), where P follows the exact distribution of heterozygote counts
given allele counts under HWE.  The log-probability of each achievable het
count has the closed form

  log w(h) = h ln 2 - lgamma((r-h)/2 + 1) - lgamma(h+1) - lgamma((2n-r-h)/2 + 1)

(r = minor allele copies, n = genotype count), so instead of the reference's
scalar tail-walk recurrence we evaluate the support vectorized, bucketing
variants by support size to bound padding waste.

Port of plink_tpu/stats/hwe.py, with one change to `hwe_exact_pvals`: only
the window of het counts whose weight relative to the mode does not
underflow to 0.0 is evaluated.  The support grows with the sample count
(~250,000 het counts per variant at 500,000 samples), the window with its
square root, so at biobank size the full support costs minutes per 4,096
variants; on panels small enough that the window is the whole support the
arrays, and so the p-values, are those of plink_tpu.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .distributions import gammaln

_REL_TOL = 1 + 1e-12  # mirrors the reference's kExactTestBias-style tolerance
# exp(x) is exactly 0.0 in f64 for x < -745.2: a het count whose log-weight
# lies this far below the mode's adds nothing to any sum of `_hwe_bucket`
_LOG_CUT = 760.0
# buckets of supports above 2^_THREAD_LEVEL het counts are cut into chunks
# of _CHUNK_ROWS variants, evaluated on a thread pool (numpy's array
# operations release the GIL); smaller buckets stay whole
_THREAD_LEVEL = 12
_CHUNK_ROWS = 32


def _logw(h, r, n):
    """log w(h) of the module docstring (r, n broadcast against h)."""
    return (
        h * np.log(2.0)
        - gammaln((r - h) / 2.0 + 1.0)
        - gammaln(h + 1.0)
        - gammaln((2 * n - r - h) / 2.0 + 1.0)
    )


def _hwe_window(r, n, h_min, h_max):
    """Per variant, the het counts [lo, hi] (same parity as h_min) outside
    which every weight is below the mode's by more than _LOG_CUT.  w(h+2) /
    w(h) = (r-h)(2n-r-h) / ((h+1)(h+2)) falls with h, so log w is concave
    and peaks next to h_c = (r(2n-r) - 2) / (2n+3); the half-width doubles
    until both ends (or the support's ends) fall below the cut."""
    hc = (r * (2 * n - r) - 2) / (2 * n + 3)
    c = np.clip(h_min + 2 * np.round((hc - h_min) / 2).astype(np.int64),
                h_min, h_max)
    top = _logw(c, r, n) - _LOG_CUT
    half = np.full(r.shape, 256, np.int64)
    while True:
        lo = np.maximum(h_min, c - 2 * half)
        hi = np.minimum(h_max, c + 2 * half)
        done = (((lo == h_min) | (_logw(lo, r, n) < top))
                & ((hi == h_max) | (_logw(hi, r, n) < top)))
        if done.all():
            return lo, hi
        half = np.where(done, half, 2 * half)


def _hwe_bucket(hom_r: np.ndarray, het: np.ndarray, hom_c: np.ndarray, midp: bool) -> np.ndarray:
    """Exact p-values for one bucket (arrays of equal-ish support), from the
    het counts of each variant's window (the weights outside it are 0.0)."""
    n = hom_r + het + hom_c
    r = 2 * hom_r + het  # rare allele copies
    h_min, h_max = _hwe_window(r, n, r & 1, np.minimum(r, 2 * n - r))
    S = int(((h_max - h_min) // 2 + 1).max())
    B = hom_r.shape[0]
    h = h_min[:, None] + 2 * np.arange(S, dtype=np.int64)[None, :]
    valid = h <= h_max[:, None]
    hc = np.where(valid, h, 0)
    logw = _logw(hc, r[:, None], n[:, None])
    logw = np.where(valid, logw, -np.inf)
    mx = logw.max(axis=1, keepdims=True)
    w = np.exp(logw - mx)
    total = w.sum(axis=1)
    obs_idx = ((het - h_min) // 2).astype(np.int64)
    in_win = (het >= h_min) & (het <= h_max)
    w_obs = np.where(in_win, w[np.arange(B), np.clip(obs_idx, 0, S - 1)], 0.0)
    tail = (w <= w_obs[:, None] * _REL_TOL) & valid
    p = (w * tail).sum(axis=1) / total
    if midp:
        p = p - 0.5 * w_obs / total
    return np.minimum(p, 1.0)


def hwe_exact_pvals(
    hom_ref: np.ndarray, het: np.ndarray, hom_alt: np.ndarray, midp: bool = False
) -> np.ndarray:
    """Vectorized exact HWE p-values.  Inputs: int genotype counts [V]."""
    hom_ref = np.asarray(hom_ref, dtype=np.int64)
    het = np.asarray(het, dtype=np.int64)
    hom_alt = np.asarray(hom_alt, dtype=np.int64)
    V = hom_ref.shape[0]
    out = np.ones(V, dtype=np.float64)
    n = hom_ref + het + hom_alt
    ok = n > 0
    if not ok.any():
        out[:] = np.nan
        return out
    out[~ok] = np.nan
    hom_r = np.minimum(hom_ref, hom_alt)
    hom_c = np.maximum(hom_ref, hom_alt)
    r = 2 * hom_r + het
    support = np.minimum(r, 2 * n - r) // 2 + 1
    # Bucket by support size in powers of two to bound padding to 2x.
    idx_ok = np.flatnonzero(ok)
    if idx_ok.size:
        levels = np.clip(np.ceil(np.log2(np.maximum(support[idx_ok], 1))).astype(int), 0, 63)
        parts = []
        for lv in np.unique(levels):
            sel = idx_ok[levels == lv]
            step = _CHUNK_ROWS if lv > _THREAD_LEVEL else sel.size
            parts += [sel[i : i + step] for i in range(0, sel.size, step)]
        with ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
            for part, p in zip(parts, pool.map(
                    lambda s_: _hwe_bucket(hom_r[s_], het[s_], hom_c[s_], midp),
                    parts)):
                out[part] = p
    return out


def hwe_exact_thresh(
    hom_ref: np.ndarray,
    het: np.ndarray,
    hom_alt: np.ndarray,
    thresh: float,
    midp: bool = False,
) -> np.ndarray:
    """Boolean mask of variants FAILING the HWE filter (p < thresh).

    The reference has early-exit threshold-only kernels
    (2.0/include/plink2_stats.cc:2105,2620 HweThreshP); full p-values are
    computed here since the vectorized path is already cheap relative to I/O.
    """
    p = hwe_exact_pvals(hom_ref, het, hom_alt, midp)
    return ~(np.isnan(p)) & (p < thresh)


# ---------------------------------------------------------------------------
# extreme-regime ln-space computation (role of the reference's double-double
# tail sums: HweLnP + plink2_highprec dd_real, 2.0/include/plink2_stats.cc:
# 1554+, 2.0/include/plink2_highprec.h:36-60).  x86 80-bit long double keeps
# ~18-19 significant digits; the printed extreme-p mantissa has 6, so the
# ~1e-12 absolute ln-p accuracy this gives reproduces lntoa_g output without
# the reference's 106-bit machinery.
# ---------------------------------------------------------------------------

_LD = np.longdouble
_LFACT_TABLE: np.ndarray | None = None


def _lfact_ld(x: np.ndarray) -> np.ndarray:
    """ln(x!) in extended precision (role of ddr_lfact,
    2.0/include/plink2_highprec.cc:488): lookup below 256, Euler-Maclaurin
    series above (first omitted term ~n^-11 is below long-double eps)."""
    global _LFACT_TABLE
    x = np.asarray(x)
    out = np.empty(x.shape, _LD)
    small = x < 256
    if _LFACT_TABLE is None:
        k = np.arange(1, 256, dtype=_LD)
        _LFACT_TABLE = np.concatenate(
            [np.zeros(1, _LD), np.cumsum(np.log(k))])
    if small.any():
        out[small] = _LFACT_TABLE[x[small].astype(np.int64)]
    if (~small).any():
        xb = x[~small].astype(_LD)
        invn = 1 / xb
        invn2 = invn * invn
        ser = invn * (
            _LD(1) / 12 + invn2 * (
                _LD(-1) / 360 + invn2 * (
                    _LD(1) / 1260 + invn2 * (
                        _LD(-1) / 1680 + invn2 * (_LD(1) / 1188)))))
        half_log_2pi = _LD("0.91893853320467274178032973640561764")
        out[~small] = ser + half_log_2pi - xb + np.log(xb) * (xb + _LD(0.5))
    return out


def _hwe_lnbucket(hom_r, het, hom_c, midp):
    """ln p for one support-size bucket, extended-precision tail sums."""
    n = hom_r + het + hom_c
    r = 2 * hom_r + het
    h_min = r & 1
    h_max = np.minimum(r, 2 * n - r)
    S = int(((h_max - h_min) // 2 + 1).max())
    B = hom_r.shape[0]
    h = h_min[:, None] + 2 * np.arange(S, dtype=np.int64)[None, :]
    valid = h <= h_max[:, None]
    hc = np.where(valid, h, 0)
    ln2 = np.log(_LD(2))
    logw = (
        hc * ln2
        - _lfact_ld((r[:, None] - hc) // 2)
        - _lfact_ld(hc)
        - _lfact_ld(n[:, None] - (r[:, None] + hc) // 2)
    )
    neg_inf = _LD("-1e4900")
    logw = np.where(valid, logw, neg_inf)
    obs_idx = ((het - h_min) // 2).astype(np.int64)
    logw_obs = logw[np.arange(B), obs_idx]
    # the reference's relative tolerance (kExactTestBias analog)
    tol = _LD(1e-12)
    tail = (logw <= logw_obs[:, None] + tol) & valid
    mx = logw.max(axis=1, keepdims=True)
    w = np.exp(logw - mx)
    total = w.sum(axis=1)
    # the tail is shifted by its OWN max: relative to the distribution mode
    # it can underflow even extended precision (ln p down to -1e6+)
    logw_t = np.where(tail, logw, neg_inf)
    mxt = logw_t.max(axis=1, keepdims=True)
    tail_sum = np.exp(logw_t - mxt).sum(axis=1)
    if midp:
        tail_sum = tail_sum - _LD(0.5) * np.exp(logw_obs - mxt[:, 0])
    with np.errstate(divide="ignore", invalid="ignore"):
        lnp = (np.log(np.maximum(tail_sum, _LD(0))) + mxt[:, 0]
               - np.log(total) - mx[:, 0])
    return np.minimum(lnp, _LD(0)).astype(np.float64)


def hwe_exact_lnpvals(
    hom_ref: np.ndarray, het: np.ndarray, hom_alt: np.ndarray,
    midp: bool = False,
) -> np.ndarray:
    """ln-space exact HWE p-values, accurate through the extreme regime
    (1e-325 .. 1e-1000000) where linear-space p underflows.  Same bucketed
    vectorization as hwe_exact_pvals; log-weights carry ~1e-12 absolute
    accuracy (extended-precision ln-factorials), so exp(ln p) agrees with
    the f64 path in range and the lntoa_g 6-digit mantissa out of range."""
    hom_ref = np.asarray(hom_ref, dtype=np.int64)
    het = np.asarray(het, dtype=np.int64)
    hom_alt = np.asarray(hom_alt, dtype=np.int64)
    V = hom_ref.shape[0]
    out = np.zeros(V, dtype=np.float64)
    n = hom_ref + het + hom_alt
    ok = n > 0
    out[~ok] = np.nan
    hom_r = np.minimum(hom_ref, hom_alt)
    hom_c = np.maximum(hom_ref, hom_alt)
    r = 2 * hom_r + het
    support = np.minimum(r, 2 * n - r) // 2 + 1
    idx_ok = np.flatnonzero(ok)
    if idx_ok.size:
        levels = np.clip(
            np.ceil(np.log2(np.maximum(support[idx_ok], 1))).astype(int),
            0, 63)
        for lv in np.unique(levels):
            sel = idx_ok[levels == lv]
            out[sel] = _hwe_lnbucket(hom_r[sel], het[sel], hom_c[sel], midp)
    return out
