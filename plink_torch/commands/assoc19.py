"""PLINK 1.9 analysis commands: --assoc / --model (case/control), and the
--assoc permutation tests (plink_tpu/commands/assoc19.py).

Behavior reference: model_assoc (1.9/plink_assoc.c:6200-6900): the .assoc
allelic chi-square and the .model GENO/TREND/ALLELIC/DOM/REC test battery,
with 1.9's fixed-width dtoa_g_wxp4 column layout.  The case / control
genotype counts come from kernel K1 (ops/counts.py `masked_geno_counts`,
through Dataset.counts) over the [case, ctrl] sample masks, with the male
masks beside them for chrX / chrY; 1.9's A1 flip and haploid rules are
applied to the counts.  The permutation engines stay on the host and
decode one variant's codes at a time.

The quantitative --assoc (qassoc), --within / --family clusters and the
set test are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np

from .. import NotPortedError
from ..dataset import Dataset
from ..stats.assoc_perm19 import (
    EPSILON, adaptive_scan, chi22_eval, chi22_precomp_val_bounds,
    fisher22_precomp_pval_bounds, fisher22_tail_pval, get_precomp_bounds)
from ..stats.binom19 import fisher22, fisher23
from ..stats.distributions import chisq_logsf
from ..stats.perm19 import cc_perm_matrix, master_sfmt
from ..utils.chrom import MT_CODE, X_CODE, Y_CODE
from ..utils.fmt import dtoa_g_wxp4, fw_width
from ..utils.logging import RunLogger
from .basic_reports import alt_allele_freqs
from .cluster import _ltqnorm
from .model_perm import (ca_trend_evalx, chi22_evalx, chi23_evalx, chiprob_px,
                         run_model_perm, variant_codes)


def _fw(s, width: int) -> str:
    return str(s).rjust(width)


def _cc_masks(ds: Dataset, allow_no_sex: bool):
    pheno = None
    for name, pc in ds.si.phenos.items():
        if pc.kind == "cc":
            pheno = pc
            break
    if pheno is None:
        raise ValueError("--assoc/--model requires a case/control phenotype.")
    nonmiss = pheno.nonmiss.copy()
    if not allow_no_sex:
        nonmiss &= ds.si.sex != 0
    case = ds.sample_mask & nonmiss & (pheno.data == 1)
    ctrl = ds.sample_mask & nonmiss & (pheno.data == 0)
    return case, ctrl


def _chisq_2x2(a, b, c, d):
    """Pearson chi-square for the table [[a, b], [c, d]] (allelic test)."""
    n = a + b + c + d
    den = (a + b) * (c + d) * (a + c) * (b + d)
    if den <= 0:
        return np.nan
    return n * (a * d - b * c) ** 2 / den


def _p(chisq, df=1.0):
    if not np.isfinite(chisq):
        return np.nan
    return float(np.exp(chisq_logsf(chisq, df)))


def assoc_allele_counts(ds: Dataset, case, ctrl, inc, a1_is_alt):
    """Per-variant A1/A2 allele counts for cases and controls with
    1.9's sex handling (model_assoc orig pass,
    1.9/plink_assoc.c:6716-6770): X = nonmale diploid + male haploid
    (het male missing), Y = males only haploid, MT = all-sample haploid.
    Returns arrays (da1, da2, du1, du2, set_cts, missing_cts) where set =
    A2 allele count among all pheno-nm samples and missing follows
    genovec_set_freq* conventions (needed by the permutation engine).
    The genotype counts come from K1 over [case, ctrl] and, when chrX or
    chrY is included, [case & male, ctrl & male] (plink_tpu decodes the
    whole matrix on the host and sums per variant)."""
    male = ds.male_mask()
    pheno_nm = case | ctrl
    male_ct = int((male & pheno_nm).sum())
    nonmale_ct = int(pheno_nm.sum()) - male_ct
    chrom = ds.vi.chrom[inc]
    is_x = chrom == X_CODE
    is_y = chrom == Y_CODE
    hap = is_y | (chrom == MT_CODE)
    a1 = np.asarray(a1_is_alt)[inc]

    def classes(c):
        """(hom A1, het, hom A2, missing) of the included variants."""
        c = c[inc]
        return (np.where(a1, c[:, 2], c[:, 0]), c[:, 1],
                np.where(a1, c[:, 0], c[:, 2]), c[:, 3])

    full = [classes(c) for c in ds.counts([case, ctrl])]
    if (is_x | is_y).any():
        males = [classes(c) for c in ds.counts([case & male, ctrl & male])]
    else:
        males = [tuple(np.zeros(inc.size, np.int64) for _ in range(4))] * 2
    allele, miss = [], []
    for (h1, het, h2, ms), (m1, mhet, m2, mms) in zip(full, males):
        # autosomes: both alleles of every called sample
        a1c, a2c, mc = het + 2 * h1, het + 2 * h2, ms
        # chrX: non-males diploid, males haploid with hets missing
        n1, nhet, n2, nms = h1 - m1, het - mhet, h2 - m2, ms - mms
        a1c = np.where(is_x, nhet + 2 * n1 + m1, a1c)
        a2c = np.where(is_x, nhet + 2 * n2 + m2, a2c)
        # chrY (males) / MT (everyone): haploid, hets missing
        a1c = np.where(is_y, m1, np.where(hap, h1, a1c))
        a2c = np.where(is_y, m2, np.where(hap, h2, a2c))
        allele.append((a1c, a2c))
        miss.append((nms, mms + mhet, mms + mhet, ms + het))
    (da1, da2), (du1, du2) = allele
    miss_cts = np.where(
        is_x, 2 * (miss[0][0] + miss[1][0]) + miss[0][1] + miss[1][1] + male_ct,
        np.where(is_y, miss[0][2] + miss[1][2] + nonmale_ct,
                 np.where(hap, miss[0][3] + miss[1][3],
                          full[0][3] + full[1][3])))
    return (da1.astype(np.float64), da2.astype(np.float64),
            du1.astype(np.float64), du2.astype(np.float64),
            (da2 + du2).astype(np.int64), miss_cts.astype(np.int64))


def run_assoc(ds: Dataset, cfg, log: RunLogger) -> None:
    """--assoc: per-variant allelic case/control chi-square (.assoc).

    A1 = minor allele (1.9 reorders alleles on load so A1 is minor by
    founder frequency); layout matches model_assoc's fixed-width writer.
    """
    mods = set(cfg.assoc_mods)
    if "set-test" in mods:
        raise NotPortedError(
            "--assoc set-test is not yet ported to plink_torch.")
    counts_mode = "counts" in mods
    case, ctrl = _cc_masks(ds, cfg.allow_no_sex)
    freqs = alt_allele_freqs(ds, founders_only=True, dosage=True)
    a1_is_alt = ~(freqs > 0.5)
    vi = ds.vi
    ci = vi.chr_info
    inc = np.flatnonzero(ds.variant_mask)
    maxsnp = fw_width(len(str(vi.vid[i])) for i in inc)
    da1v, da2v, du1v, du2v, set_cts, miss_cts = assoc_allele_counts(
        ds, case, ctrl, inc, a1_is_alt)
    alt1 = vi.alt1()
    fisher = "fisher" in mods or "fisher-midp" in mods
    midp = "fisher-midp" in mods
    display_ci = cfg.ci is not None
    if display_ci:
        EPS19 = 0.000000000931322574615478515625
        ci_pct = int(cfg.ci * (100 + EPS19))
        ci_zt = _ltqnorm(1 - (1 - cfg.ci) / 2)
    perm_adapt = "perm" in mods
    mperm_val = None
    for m in mods:
        if m.startswith("mperm="):
            mperm_val = int(m.split("=", 1)[1])
    perm_count = "perm-count" in mods
    orig_chisq_arr = np.full(inc.size, -9.0)
    orig_pvals_arr = np.full(inc.size, -9.0)
    path = cfg.out + (".assoc.fisher" if fisher else ".assoc")
    with open(path, "w") as f:
        hdr = (" CHR " + "SNP".rjust(maxsnp) + "         BP   A1 "
               + ("     C_A      C_U   A2 " if counts_mode
                  else "     F_A      F_U   A2 "))
        if not fisher:
            hdr += "       CHISQ "
        hdr += "           P           OR "
        if display_ci:
            if ci_pct >= 10:
                hdr += (f"          SE          L{ci_pct}"
                        f"          U{ci_pct} ")
            else:
                hdr += (f"          SE           L{ci_pct}"
                        f"           U{ci_pct} ")
        f.write(hdr + "\n")
        for k, i in enumerate(inc):
            flip = not a1_is_alt[i]
            a1 = vi.ref[i] if flip else alt1[i]
            a2 = alt1[i] if flip else vi.ref[i]
            da1 = da1v[k]
            da2 = da2v[k]
            du1 = du1v[k]
            du2 = du2v[k]
            row = (
                _fw(ci.name19(int(vi.chrom[i])), 4) + " "
                + _fw(vi.vid[i], maxsnp) + " "
                + _fw(int(vi.pos[i]), 10) + " "
                + _fw(a1, 4) + " "
            )
            if da1 + da2 > 0:
                row += (_fw(int(da1), 8) if counts_mode
                        else dtoa_g_wxp4(da1 / (da1 + da2), 8)) + " "
            else:
                row += "      NA "
            if du1 + du2 > 0:
                row += (_fw(int(du1), 8) if counts_mode
                        else dtoa_g_wxp4(du1 / (du1 + du2), 8))
            else:
                row += "      NA"
            row += " " + _fw(a2, 4) + " "
            # chi22_eval validity: both allele columns must be nonzero
            # (1.9/plink_assoc.c:6781); zero rows give chisq 0, p 1
            if fisher:
                if (da1 + du1) > 0 and (da2 + du2) > 0:
                    pv = fisher22(int(du2), int(du1), int(da2),
                                  int(da1), midp)
                    orig_pvals_arr[k] = pv
                    row += dtoa_g_wxp4(pv, 12)
                else:
                    row += "           1"
            elif (da1 + du1) > 0 and (da2 + du2) > 0:
                chisq = _chisq_2x2(da1, da2, du1, du2)
                if not np.isfinite(chisq):
                    chisq = 0.0
                pv = _p(chisq)
                orig_chisq_arr[k] = chisq
                orig_pvals_arr[k] = pv
                row += dtoa_g_wxp4(chisq, 12) + " " + dtoa_g_wxp4(pv, 12)
            else:
                row += "          NA           NA"
            row += " "
            if du1 * da2 == 0.0:
                row += "          NA"
                if display_ci:
                    row += ("           NA           NA"
                            "           NA")
            else:
                orr = (da1 * du2) / (du1 * da2)
                row += dtoa_g_wxp4(orr, 12)
                if display_ci:
                    lo = math.log(orr)
                    se = math.sqrt(1 / da1 + 1 / da2
                                   + 1 / du1 + 1 / du2)
                    dzz = ci_zt * se
                    row += (" " + dtoa_g_wxp4(se, 12) + " "
                            + dtoa_g_wxp4(math.exp(lo - dzz), 12) + " "
                            + dtoa_g_wxp4(math.exp(lo + dzz), 12))
            f.write(row + " \n")
    log.log(f"--assoc: Results written to {path} .")
    if perm_adapt or mperm_val is not None:
        _assoc_perm_engine(
            ds, cfg, log, fisher, midp, inc, a1_is_alt,
            orig_chisq_arr, orig_pvals_arr, set_cts, miss_cts,
            case, ctrl, maxsnp, path, perm_adapt, mperm_val,
            perm_count)


def _assoc_perm_engine(ds, cfg, log, fisher, midp, inc, a1_is_alt,
                       orig_chisq, orig_pvals, set_cts, miss_cts,
                       case, ctrl, maxsnp, out_base, perm_adapt,
                       mperm_val, perm_count):
    """--assoc perm / mperm=N: EMP1 (+EMP2) empirical p-values,
    byte-identical to assoc_adapt_thread / assoc_maxt_thread
    (1.9/plink_assoc.c:2287,2471) for a fixed --seed.  Single
    generation batch (the reference sizes batches by free memory;
    with default --memory all perms fit in one batch)."""
    vi = ds.vi
    ci = vi.chr_info
    nraw = ds.raw_sample_ct
    nm_mask = (case | ctrl)[:nraw]
    nm_idx = np.flatnonzero(nm_mask)
    n_nm = nm_idx.size
    case_nm = case[:nraw][nm_idx]
    case_ct = int(case_nm.sum())
    male = ds.male_mask()[:nraw][nm_idx]
    pheno_nm_ct = n_nm
    M = inc.size
    if perm_adapt:
        ap_min, ap_max, ap_alpha, ap_beta, ap_init, ap_slope = \
            cfg.aperm
        perms_total = ap_max
        ci_zt = _ltqnorm(1 - ap_beta / (2.0 * M))
        first_adapt_check = int(ap_init) if ap_min < ap_init \
            else ap_min
    else:
        perms_total = mperm_val
        first_adapt_check = perms_total + 1
        ap_init = ap_slope = ap_alpha = ci_zt = 0.0
    precomp_width = 1 + int(math.sqrt(pheno_nm_ct) * 0.05 * 5.65686)
    thread_ct = min(cfg.threads or 1, perms_total)
    master = master_sfmt(cfg)
    perms = cc_perm_matrix(case_nm, perms_total, thread_ct, master)  # [P, n_nm]
    permsi = perms.astype(np.int64)

    success2 = np.zeros(M, np.int64)
    attempt = np.full(M, perms_total, np.int64)
    extremes = None
    maxt_pending = None
    if not perm_adapt:
        # block structure: 64 markers, then 960 per block
        # (MODEL_BLOCKKEEP / MODEL_BLOCKSIZE); cur-extreme refreshed
        # at each block start.  Fisher extremes track the MINIMUM p-value
        # and start at 1.0 (model_assoc init, 1.9/plink_assoc.c:6178-6183)
        extremes = np.ones(perms_total) if fisher else np.zeros(perms_total)
        maxt_pending = np.ones(M) if fisher else np.zeros(M)
        bstarts = [0]
        nxt = 64
        while nxt < M:
            bstarts.append(nxt)
            nxt += 960
        bstarts.append(M)
        block_boundary = set(bstarts[:-1])
    for k in range(M):
        if extremes is not None and k in block_boundary and k:
            maxt_pending[k:] = float(
                extremes.max() if fisher else extremes.min())
        v = int(inc[k])
        if orig_pvals[k] == -9:
            if perm_adapt:
                attempt[k] = first_adapt_check
                success2[k] = first_adapt_check
            else:
                success2[k] = perms_total
            continue
        chrom = int(vi.chrom[v])
        is_x = chrom == X_CODE
        is_y = chrom == Y_CODE
        is_hap = is_y or chrom == MT_CODE
        raw = variant_codes(ds, v, nm_idx)
        g = raw if a1_is_alt[v] \
            else np.where(raw == 3, 3, 2 - raw).astype(raw.dtype)
        g = g.astype(np.int64)
        if not (is_x or is_hap):
            min_ploidy = 2
            setw = np.choose(np.minimum(g, 3),
                             [2, 1, 0, 0]).astype(np.int64)
            missw = (g == 3).astype(np.int64)
            row1x = 2 * case_ct
            tot_obs = 2 * (pheno_nm_ct - int(miss_cts[k]))
            uqq = 2
        elif is_x:
            min_ploidy = 1
            setw = np.where(male, (g == 0).astype(np.int64),
                            np.choose(np.minimum(g, 3),
                                      [2, 1, 0, 0]))
            missw = np.where(
                male, 1 + ((g == 1) | (g == 3)).astype(np.int64),
                2 * (g == 3).astype(np.int64))
            row1x = 2 * case_ct
            tot_obs = 2 * pheno_nm_ct - int(miss_cts[k])
            uqq = 1
        else:
            min_ploidy = 1
            if is_y:
                setw = np.where(male, (g == 0).astype(np.int64), 0)
                missw = np.where(
                    male, ((g == 1) | (g == 3)).astype(np.int64), 1)
            else:
                setw = (g == 0).astype(np.int64)
                missw = ((g == 1) | (g == 3)).astype(np.int64)
            row1x = case_ct
            tot_obs = pheno_nm_ct - int(miss_cts[k])
            uqq = 1
        col1_sum = int(set_cts[k])
        col2_sum = tot_obs - col1_sum
        case_set = permsi @ setw          # [P]
        case_miss = permsi @ missw
        missing_start, entry_ct = get_precomp_bounds(
            int(miss_cts[k]), 0, case_ct, pheno_nm_ct,
            precomp_width, is_x)
        # per-missing-count bounds
        tables = {}
        mjj = missing_start * uqq
        for e in range(entry_ct):
            m = missing_start + e
            if fisher:
                b, _ = fisher22_precomp_pval_bounds(
                    orig_pvals[k], midp, row1x - mjj, col1_sum,
                    tot_obs)
            else:
                b, _ = chi22_precomp_val_bounds(
                    orig_chisq[k], row1x - mjj, col1_sum, tot_obs)
            tables[m] = b
            mjj += uqq
        if fisher:
            stat_high = orig_pvals[k] * (1.0 + EPSILON)
            stat_low = orig_pvals[k] * (1.0 - EPSILON)
        else:
            stat_high = orig_chisq[k] + EPSILON
            stat_low = orig_chisq[k] - EPSILON
        P = perms_total
        outcomes = np.zeros(P, np.int64)
        widx = case_miss - missing_start
        in_win = (widx >= 0) & (widx < precomp_width)
        if perm_adapt:
            for p in np.flatnonzero(in_win):
                b = tables[int(case_miss[p])]
                cs = int(case_set[p])
                if cs < b[0]:
                    outcomes[p] = 2 if cs < b[2] else 1
                elif cs >= b[1]:
                    outcomes[p] = 2 if cs >= b[3] else 1
            for p in np.flatnonzero(~in_win):
                row1 = row1x - int(case_miss[p]) * min_ploidy
                cs = int(case_set[p])
                if fisher:
                    dxx = fisher22(cs, row1 - cs, col1_sum - cs,
                                   col2_sum + cs - row1, midp)
                    if dxx < stat_low:
                        outcomes[p] = 2
                    elif dxx <= stat_high:
                        outcomes[p] = 1
                else:
                    dxx = chi22_eval(cs, row1, col1_sum, tot_obs)
                    # reference quirk: the non-precomp chi path never
                    # counts an outcome as 0 (plink_assoc.c:2437-2443)
                    outcomes[p] = 2 if dxx > stat_high else 1
            s2i, stopped, nac = adaptive_scan(
                outcomes, 0, first_adapt_check, 0, ap_init,
                ap_slope, ap_alpha, ci_zt, perms_total)
            success2[k] = s2i
            if stopped:
                attempt[k] = nac
        elif fisher:
            # maxT fisher (assoc_maxt_thread model_fisher branch,
            # 1.9/plink_assoc.c:2684-2712): extremes are minima of the
            # exact p-values.  In-window extreme updates go through
            # fisher22_tail_pval continuing from the cur-extreme reference
            # pair, exactly like the thread, so the stored doubles match
            # bit-for-bit.
            cur_ext = maxt_pending[k]
            mtables = {}
            mjj = missing_start * uqq
            for e in range(entry_ct):
                m = missing_start + e
                b2, tp = fisher22_precomp_pval_bounds(
                    cur_ext, midp, row1x - mjj, col1_sum, tot_obs)
                mtables[m] = (b2[2], b2[3] - b2[2], tp)
                mjj += uqq
            for p in range(P):
                cm = int(case_miss[p])
                cs = int(case_set[p])
                row1 = row1x - cm * min_ploidy
                if 0 <= cm - missing_start < precomp_width:
                    b = tables[cm]
                    if cs < b[0]:
                        outcomes[p] = 2 if cs < b[2] else 1
                    elif cs >= b[1]:
                        outcomes[p] = 2 if cs >= b[3] else 1
                    ukk, width, tp = mtables[cm]
                    if tp is not None and not (0 <= cs - ukk < width):
                        sval = fisher22_tail_pval(
                            ukk, row1 - ukk, col1_sum - ukk,
                            col2_sum + ukk - row1, width - 1,
                            tp[0], tp[1], midp, cs)
                        if extremes[p] > sval:
                            extremes[p] = sval
                else:
                    sval = fisher22(cs, row1 - cs, col1_sum - cs,
                                    col2_sum + cs - row1, midp)
                    if sval < stat_low:
                        outcomes[p] = 2
                    elif sval <= stat_high:
                        outcomes[p] = 1
                    if extremes[p] > sval:
                        extremes[p] = sval
            success2[k] = int(outcomes.sum())
        else:
            # maxT (assoc_maxt_thread): bounds vs cur-extreme decide
            # whether the coefficient-form stat is computed at all
            cur_ext = maxt_pending[k]
            mtables = {}
            mjj = missing_start * uqq
            for e in range(entry_ct):
                m = missing_start + e
                b2, coeffs = chi22_precomp_val_bounds(
                    cur_ext, row1x - mjj, col1_sum, tot_obs)
                mtables[m] = (b2[2], b2[3], coeffs)
                mjj += uqq
            for p in range(P):
                cm = int(case_miss[p])
                cs = int(case_set[p])
                if 0 <= cm - missing_start < precomp_width:
                    b = tables[cm]
                    if cs < b[0]:
                        outcomes[p] = 2 if cs < b[2] else 1
                    elif cs >= b[1]:
                        outcomes[p] = 2 if cs >= b[3] else 1
                    lo, hi, coeffs = mtables[cm]
                    if not (lo <= cs < hi):
                        sval = (float(cs) - coeffs[0])
                        sval = sval * sval * coeffs[1]
                        if extremes[p] < sval:
                            extremes[p] = sval
                else:
                    row1 = row1x - cm * min_ploidy
                    sval = chi22_eval(cs, row1, col1_sum, tot_obs)
                    if sval > stat_high:
                        outcomes[p] = 2
                    elif sval > stat_low:
                        outcomes[p] = 1
                    if extremes[p] < sval:
                        extremes[p] = sval
            success2[k] = int(outcomes.sum())
    # report
    outp = out_base + (".perm" if perm_adapt else ".mperm")
    with open(outp, "w") as fh:
        if perm_adapt:
            fh.write(" CHR " + "SNP".rjust(maxsnp)
                     + "         EMP1           NP \n")
        else:
            fh.write(" CHR " + "SNP".rjust(maxsnp)
                     + "         EMP1         EMP2 \n")
        perms_done = perms_total
        if perm_adapt:
            perms_done = 0
            for k in range(M):
                if attempt[k] > perms_done:
                    perms_done = int(attempt[k])
                    if perms_done == perms_total:
                        break
        log.log(f"{perms_done} "
                f"{'max(T)' if not perm_adapt else '(adaptive)'} "
                f"permutation{'' if perms_done == 1 else 's'} complete.")
        dyy = 1.0 / (perms_total + 1)
        dxx_half = 0.5 * dyy
        if not perm_adapt:
            sorted_ext = np.sort(extremes)
        for k in range(M):
            v = int(inc[k])
            line = (ci.name19(int(vi.chrom[v])).rjust(4) + " "
                    + _fw(str(vi.vid[v]), maxsnp) + " ")
            if perm_adapt:
                pval = (int(success2[k]) + 2) \
                    / (2 * (int(attempt[k]) + 1))
                if not perm_count:
                    line += dtoa_g_wxp4(pval, 12) + " "
                else:
                    line += dtoa_g_wxp4(int(success2[k]) * 0.5, 12) + " "
                line += "  " + str(int(attempt[k])).rjust(10)
            else:
                pval = (int(success2[k]) + 2) * dxx_half
                if not perm_count:
                    line += dtoa_g_wxp4(pval, 12) + " "
                else:
                    line += dtoa_g_wxp4(int(success2[k]) * 0.5, 12) + " "
                if fisher:
                    dzz = int(np.searchsorted(
                        sorted_ext, orig_pvals[k] * (1.0 + EPSILON),
                        side="right")) + 1
                else:
                    gt = int(np.searchsorted(
                        sorted_ext, orig_chisq[k] - EPSILON, side="right"))
                    dzz = perms_total - gt + 1
                if not perm_count:
                    line += dtoa_g_wxp4(dzz * dyy, 12)
                else:
                    line += dtoa_g_wxp4(float(dzz - 1), 12)
            fh.write(line + " \n")
    log.log(f"Permutation test report written to {outp} .")


def run_model(ds: Dataset, cfg, log: RunLogger) -> None:
    """--model: GENO/TREND/ALLELIC/DOM/REC chi-square battery (.model).

    GENO/DOM/REC are reported only when every genotype cell count reaches
    the --cell threshold (default 5, verified against the 1.9 binary);
    A1 = minor allele as in --assoc.
    """
    model_mods = set(getattr(cfg, "model_mods", ()) or ())
    model_fisher = bool(model_mods
                        & {"fisher", "fisher-midp"})
    # fisher drops the cell-count requirement (1.9/plink.c:13273)
    cell_min = cfg.cell if cfg.cell is not None \
        else (0 if model_fisher else 5)
    case, ctrl = _cc_masks(ds, cfg.allow_no_sex)
    ca, cu = ds.counts([case, ctrl])
    freqs = alt_allele_freqs(ds, founders_only=True, dosage=True)
    a1_is_alt = ~(freqs > 0.5)
    vi = ds.vi
    ci = vi.chr_info
    inc = np.flatnonzero(ds.variant_mask)
    # --model skips haploid/MT chromosomes except X; on X, males are
    # force-missing (1.9/plink_assoc.c:6693,7330)
    chrom_inc = vi.chrom[inc]
    is_x_v = chrom_inc == X_CODE
    hap_v = np.array([ci.is_haploid(int(c), 1) for c in chrom_inc]) \
        | (chrom_inc == MT_CODE)
    inc = inc[~(hap_v & ~is_x_v)]
    if is_x_v.any():
        male = ds.male_mask()
        ca_nm, cu_nm = ds.counts([case & ~male, ctrl & ~male])
        x_set = set(int(v) for v in np.flatnonzero(
            vi.chrom == X_CODE))
    else:
        x_set = set()
    maxsnp = fw_width(len(str(vi.vid[i])) for i in inc)
    alt1 = vi.alt1()
    path = cfg.out + ".model"
    r_list, s_list, inval_list = [], [], []
    midp = "fisher-midp" in model_mods
    trendonly = "trend-only" in model_mods
    if model_fisher and trendonly:
        raise ValueError("Conflicting --model parameters.")
    with open(path, "w") as f:
        hdr = (" CHR " + "SNP".rjust(maxsnp)
               + "   A1   A2     TEST            AFF          UNAFF ")
        if not model_fisher:
            hdr += "       CHISQ   DF "
        hdr += "           P\n"
        f.write(hdr)
        for i in inc:
            flip = not a1_is_alt[i]
            a1 = vi.ref[i] if flip else alt1[i]
            a2 = alt1[i] if flip else vi.ref[i]
            # genotype classes ordered hom-A1 / het / hom-A2
            cav = ca_nm[i] if int(i) in x_set else ca[i]
            cuv = cu_nm[i] if int(i) in x_set else cu[i]
            if flip:
                r_d = cav[[0, 1, 2]].astype(np.float64)
                s_d = cuv[[0, 1, 2]].astype(np.float64)
            else:
                r_d = cav[[2, 1, 0]].astype(np.float64)
                s_d = cuv[[2, 1, 0]].astype(np.float64)
            meta = (
                _fw(ci.name19(int(vi.chrom[i])), 4) + " "
                + _fw(vi.vid[i], maxsnp) + " "
                + _fw(a1, 4) + " " + _fw(a2, 4) + " "
            )
            rows = []
            # 1.9 conventions (plink_assoc.c:6880):
            # uii/ujj/ukk = ctrl homcom/het/homrar,
            # umm/unn/uoo = case homcom/het/homrar
            uii, ujj, ukk = int(s_d[2]), int(s_d[1]), int(s_d[0])
            umm, unn, uoo = int(r_d[2]), int(r_d[1]), int(r_d[0])
            r_list.append(r_d.copy())
            s_list.append(s_d.copy())
            ok_cells = min(r_d.min(), s_d.min()) >= cell_min
            inval_list.append(not ok_cells)
            na_tail = ("          NA\n" if model_fisher
                       else "          NA   NA           NA\n")

            def row(test, aff, unaff, pval, chisq=None, df=None):
                line = (meta + _fw(test, 8) + " " + _fw(aff, 14)
                        + " " + _fw(unaff, 14) + " ")
                if pval < -1:
                    line += na_tail
                else:
                    if not model_fisher:
                        line += dtoa_g_wxp4(chisq, 12) + "    " + str(df) \
                            + " "
                    line += dtoa_g_wxp4(max(pval, 0.0), 12) + "\n"
                rows.append(line)

            if not trendonly:
                if not ok_cells:
                    gen_p = -9.0
                    dvv, upp = -9.0, 0
                elif model_fisher:
                    gen_p = fisher23(uii, ujj, ukk, umm, unn, uoo,
                                     midp)
                    dvv, upp = 0.0, 0
                else:
                    dvv, upp = chi23_evalx(uii, ujj, ukk, umm, unn,
                                           uoo)
                    gen_p = chiprob_px(dvv, upp)
                row("GENO", f"{uoo}/{unn}/{umm}",
                    f"{ukk}/{ujj}/{uii}", gen_p, dvv, upp)
            ca_chisq = ca_trend_evalx(
                umm * 2 + unn, umm + unn + uoo, ujj + unn,
                uii + umm, uii + ujj + ukk + umm + unn + uoo)
            ca_p = chiprob_px(ca_chisq, 1)
            row("TREND", f"{uoo * 2 + unn}/{umm * 2 + unn}",
                f"{ukk * 2 + ujj}/{uii * 2 + ujj}", ca_p,
                ca_chisq, 1)
            if not trendonly:
                if model_fisher:
                    mult_p = fisher22(2 * uoo + unn, 2 * umm + unn,
                                      2 * ukk + ujj, 2 * uii + ujj,
                                      midp)
                    dww = 0.0
                else:
                    dww = chi22_evalx(
                        2 * uoo + unn, 2 * (uoo + unn + umm),
                        2 * (uoo + ukk) + unn + ujj,
                        2 * (uoo + unn + umm + ukk + ujj + uii))
                    mult_p = chiprob_px(dww, 1)
                row("ALLELIC", f"{2 * uoo + unn}/{2 * umm + unn}",
                    f"{2 * ukk + ujj}/{2 * uii + ujj}", mult_p,
                    dww, 1)
                if not ok_cells:
                    dom_p = -9.0
                    dww = -9.0
                elif model_fisher:
                    dom_p = fisher22(uoo + unn, umm, ukk + ujj, uii,
                                     midp)
                else:
                    dww = chi22_evalx(
                        uoo + unn, uoo + unn + umm,
                        uoo + unn + ukk + ujj,
                        uoo + unn + umm + ukk + ujj + uii)
                    dom_p = chiprob_px(dww, 1)
                row("DOM", f"{uoo + unn}/{umm}", f"{ukk + ujj}/{uii}",
                    dom_p, dww, 1)
                if not ok_cells:
                    rec_p = -9.0
                    dww = -9.0
                elif model_fisher:
                    rec_p = fisher22(uoo, unn + umm, ukk, ujj + uii,
                                     midp)
                else:
                    dww = chi22_evalx(
                        uoo, uoo + unn + umm, uoo + ukk,
                        uoo + unn + umm + ukk + ujj + uii)
                    rec_p = chiprob_px(dww, 1)
                row("REC", f"{uoo}/{unn + umm}", f"{ukk}/{ujj + uii}",
                    rec_p, dww, 1)
            f.writelines(rows)
    log.log(f"--model: Results written to {path} .")
    if "perm" in model_mods or any(
            m.startswith("mperm") for m in model_mods):
        run_model_perm(ds, cfg, log, model_mods, case, ctrl, inc, a1_is_alt,
                       r_list, s_list, inval_list, maxsnp, cell_min)
