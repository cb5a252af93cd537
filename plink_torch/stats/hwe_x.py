"""chrX Hardy-Weinberg exact test (Graffelman & Weir 2016).

Behavior reference: HweXchrLnP (2.0/include/plink2_stats.h:96, .cc), used by
--hardy's chrX report (ComputeHweXLnPvals, 2.0/plink2_misc.cc:5222).

Null model: with female genotype counts (a/h/b), male allele counts
(ma/mb), and ALL margins fixed (n_f females, n_m males, total minor allele
count nA = 2a + h + ma), every distinct arrangement of the nA minor alleles
over the 2*n_f + n_m allele slots is equally likely:

  w(h, ma) ∝ C(n_m, ma) * n_f! / (d! h! r!) * 2^h,
  d = (nA - ma - h)/2 (female hom-minor), r = n_f - d - h.

p = sum of w over tables no more probable than the observed one (with the
same relative tolerance style as the autosomal test); midp subtracts half
the observed table's probability.  The reference walks tails with scalar
recurrences + double-double tie resolution; here the whole support grid is
evaluated vectorized in log space.
"""

from __future__ import annotations

import numpy as np

from .distributions import gammaln

_REL_TOL = 1 + 1e-12


def hwe_x_exact_pval(
    fhom_a: int, fhet: int, fhom_b: int, male_a: int, male_b: int,
    midp: bool = False,
) -> float:
    """Single-variant chrX exact p-value (a = one allele, b = the other)."""
    n_f = fhom_a + fhet + fhom_b
    n_m = male_a + male_b
    n_a = 2 * fhom_a + fhet + male_a
    n_tot = 2 * n_f + n_m
    # use the minor orientation for a smaller grid (the test is symmetric)
    if n_a * 2 > n_tot:
        fhom_a, fhom_b = fhom_b, fhom_a
        male_a, male_b = male_b, male_a
        n_a = n_tot - n_a
    if n_f == 0 and n_m == 0:
        return np.nan
    ma = np.arange(0, min(n_m, n_a) + 1)
    h = np.arange(0, min(n_f, n_a) + 1)
    H, MA = np.meshgrid(h, ma, indexing="ij")
    D2 = n_a - MA - H  # = 2*d
    valid = (D2 >= 0) & (D2 % 2 == 0)
    D = np.where(valid, D2 // 2, 0)
    R = n_f - D - H
    valid &= R >= 0
    logw = (
        -gammaln(MA + 1.0)
        - gammaln(n_m - MA + 1.0)
        - gammaln(D + 1.0)
        - gammaln(H + 1.0)
        - gammaln(np.maximum(R, 0) + 1.0)
        + H * np.log(2.0)
    )
    logw = np.where(valid, logw, -np.inf)
    mx = logw.max()
    if not np.isfinite(mx):
        return np.nan
    w = np.exp(logw - mx)
    total = w.sum()
    obs_h = fhet
    obs_ma = male_a
    w_obs = w[obs_h, obs_ma] if (obs_h < w.shape[0] and obs_ma < w.shape[1]) else 0.0
    p = w[(w <= w_obs * _REL_TOL) & valid].sum() / total
    if midp:
        p -= 0.5 * w_obs / total
    return float(min(p, 1.0))


def hwe_x_exact_pvals(
    fhom_a, fhet, fhom_b, male_a, male_b, midp: bool = False
) -> np.ndarray:
    out = np.empty(len(fhet), dtype=np.float64)
    for i in range(len(fhet)):
        out[i] = hwe_x_exact_pval(
            int(fhom_a[i]), int(fhet[i]), int(fhom_b[i]),
            int(male_a[i]), int(male_b[i]), midp,
        )
    return out


def hwe_x_exact_lnpval(
    fhom_a: int, fhet: int, fhom_b: int, male_a: int, male_b: int,
    midp: bool = False,
) -> float:
    """ln-space chrX exact p-value, accurate through the extreme regime
    (role of the reference's dd tail sums in HweXchrLnP,
    2.0/include/plink2_stats.cc:3309+; see stats/hwe.py for the
    extended-precision rationale)."""
    from .hwe import _LD, _lfact_ld

    n_f = fhom_a + fhet + fhom_b
    n_m = male_a + male_b
    n_a = 2 * fhom_a + fhet + male_a
    n_tot = 2 * n_f + n_m
    if n_a * 2 > n_tot:
        fhom_a, fhom_b = fhom_b, fhom_a
        male_a, male_b = male_b, male_a
        n_a = n_tot - n_a
    if n_f == 0 and n_m == 0:
        return np.nan
    ma = np.arange(0, min(n_m, n_a) + 1)
    h = np.arange(0, min(n_f, n_a) + 1)
    if len(ma) * len(h) > (1 << 26):
        # the full-grid evaluation is quadratic in the margins; beyond this
        # the extended-precision pass would need the reference's tail-walk
        # recurrence (HweXchrLnPLowHetTailsum) -- fall back to -inf ("0")
        return -np.inf
    H, MA = np.meshgrid(h, ma, indexing="ij")
    D2 = n_a - MA - H
    valid = (D2 >= 0) & (D2 % 2 == 0)
    D = np.where(valid, D2 // 2, 0)
    R = n_f - D - H
    valid &= R >= 0
    logw = (
        -_lfact_ld(MA)
        - _lfact_ld(n_m - MA)
        - _lfact_ld(D)
        - _lfact_ld(H)
        - _lfact_ld(np.maximum(R, 0))
        + H * np.log(_LD(2))
    )
    neg_inf = _LD("-1e4900")
    logw = np.where(valid, logw, neg_inf)
    mx = logw.max()
    if not mx > neg_inf:
        return np.nan
    total = np.exp(logw - mx).sum()
    obs_h, obs_ma = fhet, male_a
    if obs_h < logw.shape[0] and obs_ma < logw.shape[1]:
        logw_obs = logw[obs_h, obs_ma]
    else:
        return np.nan
    tol = _LD(1e-12)
    tail = (logw <= logw_obs + tol) & valid
    logw_t = np.where(tail, logw, neg_inf)
    mxt = logw_t.max()
    tail_sum = np.exp(logw_t - mxt).sum()
    if midp:
        tail_sum = tail_sum - _LD(0.5) * np.exp(logw_obs - mxt)
    with np.errstate(divide="ignore", invalid="ignore"):
        lnp = float(np.log(max(tail_sum, _LD(0))) + mxt
                    - np.log(total) - mx)
    return min(lnp, 0.0)
