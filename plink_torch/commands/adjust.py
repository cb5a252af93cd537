"""--adjust: multiple-testing correction report.

Copy of plink_tpu/commands/adjust.py's `write_adjusted` and its helpers
(host only); --adjust-file is not ported yet.

Behavior reference: Multcomp (2.0/plink2_adjust.cc:122):
- rows = valid ADD tests sorted by p ascending;
- GC: chisq = LnPToChisq(ln p) (1 df), lambda = median chisq / 0.456
  clamped >= 1, GC p = chisq_sf(chisq/lambda) (:365-386).  Deliberate
  difference: the reference's p->chisq inverse (gamma_p_inv_imp2,
  include/plink2_stats.cc:831) Halley-iterates to only 24 bits
  (factor = 2^-23), so its GC values carry ~1e-7 relative error; we use a
  full-precision inverse, which can flip the 6th printed digit;
- BONF/HOLM/SIDAK_SS/SIDAK_SD/FDR_BH/FDR_BY classical formulas computed in
  ln space so 1e-300-range p-values survive.
Default columns: #CHROM ID A1 UNADJ GC BONF HOLM SIDAK_SS SIDAK_SD FDR_BH
FDR_BY.
"""

from __future__ import annotations

import numpy as np

from ..utils.fmt import logp_to_str
from ..utils.logging import RunLogger


def _lnp_to_chisq(lnp: np.ndarray) -> np.ndarray:
    """Inverse 1-df chi-square survival function from ln p."""
    from scipy.special import ndtri_exp

    # p = 2*Phi(-sqrt(x))  =>  sqrt(x) = -Phi^-1(p/2)
    z = ndtri_exp(lnp - np.log(2.0))
    return z * z


def _chisq_logsf1(x: np.ndarray) -> np.ndarray:
    from ..stats.distributions import chisq_logsf

    return np.asarray(chisq_logsf(x, 1.0))


def _adjust_columns(lnp: np.ndarray, log: RunLogger, use_gc: bool = False):
    """Shared adjustment math for --adjust and --adjust-file; lnp must be
    sorted ascending.  Returns dict of ln-space adjusted columns.  With
    use_gc (the 'gc' modifier), the GC-corrected p-values feed every
    correction formula (ref sorted_ln_pvals = ln_pv_gc,
    2.0/plink2_adjust.cc:389-391); UNADJ/GC columns are unaffected."""
    m = lnp.size
    chisq = _lnp_to_chisq(lnp)
    med = chisq[m // 2] if m % 2 else 0.5 * (chisq[m // 2] + chisq[m // 2 - 1])
    lam = med / 0.456
    log.log(
        f"--adjust: Genomic inflation est. lambda (based on median chisq) = "
        f"{lam:g}."
    )
    lam = max(lam, 1.0)
    ln_gc = _chisq_logsf1(chisq / lam)
    if use_gc:
        lnp = ln_gc
    i = np.arange(m, dtype=np.float64)
    ln_m = np.log(m)
    ln_bonf = np.minimum(lnp + ln_m, 0.0)
    ln_holm = np.minimum(np.maximum.accumulate(lnp + np.log(m - i)), 0.0)
    p = np.exp(lnp)
    with np.errstate(divide="ignore"):
        ln_sidak_ss = np.log(-np.expm1(m * np.log1p(-np.minimum(p, 1 - 1e-16))))
        ln_sidak_ss = np.where(p < 1e-280, lnp + ln_m, ln_sidak_ss)
        k = m - i
        ln_sd = np.log(-np.expm1(k * np.log1p(-np.minimum(p, 1 - 1e-16))))
        ln_sd = np.where(p < 1e-280, lnp + np.log(k), ln_sd)
    ln_sidak_sd = np.minimum(np.maximum.accumulate(ln_sd), 0.0)
    ln_bh = np.minimum.accumulate((lnp + ln_m - np.log(i + 1.0))[::-1])[::-1]
    ln_bh = np.minimum(ln_bh, 0.0)
    cm = np.log(np.sum(1.0 / np.arange(1, m + 1)))
    ln_by = np.minimum.accumulate((lnp + ln_m + cm - np.log(i + 1.0))[::-1])[::-1]
    ln_by = np.minimum(ln_by, 0.0)
    return {
        "GC": ln_gc, "BONF": ln_bonf, "HOLM": ln_holm,
        "SIDAK_SS": ln_sidak_ss, "SIDAK_SD": ln_sidak_sd,
        "FDR_BH": ln_bh, "FDR_BY": ln_by,
    }


def write_adjusted(
    ds, cfg, log: RunLogger, pheno_name: str, suffix: str,
    results: list[tuple[int, float]], a1: np.ndarray,
) -> None:
    """results: (variant index, ln p) for each valid ADD test."""
    if not results:
        log.log(f"--adjust: no valid tests for {pheno_name}; skipping.")
        return
    vidx = np.array([r[0] for r in results])
    lnp = np.array([r[1] for r in results], dtype=np.float64)
    ok = np.isfinite(lnp)
    vidx, lnp = vidx[ok], lnp[ok]
    order = np.lexsort((vidx, lnp))
    vidx, lnp = vidx[order], lnp[order]
    m = lnp.size
    cols = _adjust_columns(lnp, log)
    ln_gc, ln_bonf, ln_holm = cols["GC"], cols["BONF"], cols["HOLM"]
    ln_sidak_ss, ln_sidak_sd = cols["SIDAK_SS"], cols["SIDAK_SD"]
    ln_bh, ln_by = cols["FDR_BH"], cols["FDR_BY"]

    vi = ds.vi
    path = f"{cfg.out}.{pheno_name}.{suffix}.adjusted"
    with open(path, "w") as f:
        f.write(
            "#CHROM\tID\tA1\tUNADJ\tGC\tBONF\tHOLM\tSIDAK_SS\tSIDAK_SD\t"
            "FDR_BH\tFDR_BY\n"
        )
        for r in range(m):
            v = vidx[r]
            f.write(
                f"{vi.chr_info.name(int(vi.chrom[v]))}\t{vi.vid[v]}\t{a1[v]}\t"
                f"{logp_to_str(lnp[r])}\t{logp_to_str(ln_gc[r])}\t"
                f"{logp_to_str(ln_bonf[r])}\t{logp_to_str(ln_holm[r])}\t"
                f"{logp_to_str(ln_sidak_ss[r])}\t{logp_to_str(ln_sidak_sd[r])}\t"
                f"{logp_to_str(ln_bh[r])}\t{logp_to_str(ln_by[r])}\n"
            )
    log.log(f"--adjust: Results written to {path} .")
