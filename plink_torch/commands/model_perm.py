"""--model perm: adaptive permutation for the model test battery
(plink_tpu/commands/model_perm.py).

Behavior reference: model_adapt_domrec/trend/gen/best_thread
(1.9/plink_assoc.c:3701-5165), precomp fills (:7205-7380),
ca_trend_eval(x) / chi23_eval (1.9/plink_stats.c:2047,1940).

Supported: dom / rec / trend / gen (chi + Fisher modes) and best, in
both adaptive (.perm) and max(T) (mperm=N, .mperm EMP1/EMP2) modes,
including max(T) 'best'.  The max(T) in-window extreme
updates use the reference's coefficient/tail-continuation forms
(model_maxt_* threads, 1.9/plink_assoc.c:4390-5160) so the stored
doubles match bit-for-bit.
"""

from __future__ import annotations

import math

import numpy as np

from ..dataset import Dataset
from ..ops.planes import _unpack_np
from ..stats.assoc_perm19 import (
    EPSILON, adaptive_scan, chi22_eval, chi22_precomp_val_bounds,
    fisher22_precomp_pval_bounds, fisher22_tail_pval, get_precomp_bounds)
from ..stats.binom19 import fisher22, fisher23
from ..stats.cdflib19 import cumchi1, inverse_chiprob1
from ..stats.distributions import chisq_logsf
from ..stats.perm19 import cc_perm_matrix, master_sfmt
from ..utils.chrom import X_CODE
from ..utils.fmt import dtoa_g_wxp4
from .cluster import _ltqnorm

SMALL_EPSILON = 0.00000000000005684341886080801486968994140625


def variant_codes(ds: Dataset, v: int, idx: np.ndarray) -> np.ndarray:
    """Variant v's 2-bit codes of the samples idx, decoded on the host from
    its packed row alone (the permutation engines walk one variant at a
    time)."""
    pk = ds.all_packed()
    row = pk[v : v + 1] if pk is not None else ds.reader.read_packed(v, 1)
    return _unpack_np(row)[0][idx]


def ca_trend_eval(case_dom_ct, case_ct, het_ct, homdom_ct, total):
    dom_ct = float(het_ct + 2 * homdom_ct)
    totald = float(total)
    case_ctd = float(case_ct)
    cat = case_dom_ct * totald - dom_ct * case_ctd
    dxx = totald * float(het_ct + 4 * homdom_ct) - dom_ct * dom_ct
    dxx *= case_ctd * (totald - case_ctd)
    return cat * cat * totald / dxx


def ca_trend_evalx(case_dom_ct, case_ct, het_ct, homdom_ct, total):
    dom_ct = float(het_ct + 2 * homdom_ct)
    totald = float(total)
    case_ctd = float(case_ct)
    cat = case_dom_ct * totald - dom_ct * case_ctd
    dxx = totald * float(het_ct + 4 * homdom_ct) - dom_ct * dom_ct
    if dxx != 0:
        dxx *= case_ctd * (totald - case_ctd)
        return cat * cat * totald / dxx
    return -9.0


def ca_trend_precomp_val_bounds(chisq, case_ct, het_ct, homdom_ct,
                                total):
    """1.9/plink_stats.c:2091."""
    BIG_EPSILON = 0.000000476837158203125
    dom_ct = het_ct + 2 * homdom_ct
    dom_ctd = float(dom_ct)
    totald = float(total)
    case_ctd = float(case_ct)
    tot_recip = 1.0 / totald
    expm11 = dom_ctd * case_ctd * tot_recip
    dxx = case_ctd * (totald - case_ctd) \
        * (totald * float(het_ct + 4 * homdom_ct)
           - dom_ctd * dom_ctd)
    bounds = [0, 0, 0, 0]
    if dxx == 0:
        return bounds, None
    varca_recip = totald * totald * totald / dxx
    coeffs = (expm11, varca_recip)
    ceil11 = case_ct * 2
    if dom_ct < ceil11:
        ceil11 = dom_ct
    varca_recip = math.sqrt(chisq / varca_recip)
    cur11 = expm11 - varca_recip
    dxx = cur11 + 1 - BIG_EPSILON
    if dxx < 0:
        bounds[0] = 0
        bounds[2] = 0
    else:
        lii = int(dxx)
        bounds[2] = lii
        bounds[0] = lii + 1 if lii == int(cur11 + BIG_EPSILON) \
            else lii
    cur11 = expm11 + varca_recip
    if cur11 > ceil11 + BIG_EPSILON:
        bounds[1] = ceil11 + 1
        bounds[3] = bounds[1]
    else:
        dxx = cur11 + 1 - BIG_EPSILON
        lii = int(dxx)
        bounds[1] = lii
        bounds[3] = lii + 1 if lii == int(cur11 + BIG_EPSILON) \
            else lii
    return bounds, coeffs


def chi23_eval(m11, m12, row1_sum, col1_sum, col2_sum, total):
    m13 = row1_sum - m11 - m12
    col3_sum = total - col1_sum - col2_sum
    col1_sumd = float(col1_sum)
    col2_sumd = float(col2_sum)
    col3_sumd = float(col3_sum)
    tot_recip = 1.0 / float(total)
    dxx = row1_sum * tot_recip
    expect = dxx * col1_sumd
    delta = m11 - expect
    chisq = delta * delta / expect
    expect = dxx * col2_sumd
    delta = m12 - expect
    chisq += delta * delta / expect
    expect = dxx * col3_sumd
    delta = m13 - expect
    chisq += delta * delta / expect
    dxx = (total - row1_sum) * tot_recip
    expect = dxx * col1_sumd
    delta = (col1_sum - m11) - expect
    chisq += delta * delta / expect
    expect = dxx * col2_sumd
    delta = (col2_sum - m12) - expect
    chisq += delta * delta / expect
    expect = dxx * col3_sumd
    delta = (col3_sum - m13) - expect
    chisq += delta * delta / expect
    if chisq < SMALL_EPSILON * SMALL_EPSILON:
        return 0.0
    return chisq


def chi23_evalx(m11, m12, m13, m21, m22, m23):
    """Returns (chisq, df)."""
    row1 = m11 + m12 + m13
    row2 = m21 + m22 + m23
    col1 = m11 + m21
    col2 = m12 + m22
    col3 = m13 + m23
    if not row1 or not row2:
        return -9.0, 0
    total = row1 + row2
    if not col1:
        c = chi22_evalx(m12, row1, col2, total)
        return (c, 1 if c != -9 else 0)
    if not col2:
        c = chi22_evalx(m11, row1, col1, total)
        return (c, 1 if c != -9 else 0)
    if not col3:
        c = chi22_evalx(m11, row1, col1, total)
        return (c, 1 if c != -9 else 0)
    return chi23_eval(m11, m12, row1, col1, col2, total), 2


def chi22_evalx(m11, row1_sum, col1_sum, total):
    expm11_numer = float(row1_sum * col1_sum)
    denom = expm11_numer * float((total - row1_sum)
                                 * (total - col1_sum))
    if denom != 0:
        dxx = float(total)
        dyy = m11 * dxx - expm11_numer
        return (dyy * dyy * dxx) / denom
    return -9.0


def chiprob_px(x, df):
    if x == -9:
        return -9.0
    if not math.isfinite(x) or x < 0:
        return -9.0
    if df == 1:
        return cumchi1(x)[1]
    try:
        return math.exp(chisq_logsf(x, df))
    except (ValueError, OverflowError):
        return -9.0


def run_model_perm(ds, cfg, log, mods, case, ctrl, inc, a1_is_alt, r_all,
                   s_all, is_invalid_arr, maxsnp, cell_min):
    """Adaptive --model permutation.  case / ctrl: the raw-sample masks of
    --model; r_all/s_all: per-included-marker case/ctrl genotype counts
    [homA1(rar), het, homA2(com)].  Each variant's codes are decoded on the
    host from its packed row alone."""
    fisher = "fisher" in mods or "fisher-midp" in mods
    midp = "fisher-midp" in mods
    perm_count = "perm-count" in mods
    mperm_val = None
    for m_ in mods:
        if m_.startswith("mperm="):
            mperm_val = int(m_.split("=", 1)[1])
    perm_adapt = mperm_val is None
    if "trend" in mods and "trend-only" not in mods:
        test = "trend"
    elif "dom" in mods:
        test = "dom"
    elif "rec" in mods:
        test = "rec"
    elif "gen" in mods:
        test = "gen"
    elif "trend-only" in mods:
        test = "trend"
    else:
        test = "best"
    vi = ds.vi
    ci = vi.chr_info
    nraw = ds.raw_sample_ct
    nm_mask = (case | ctrl)[:nraw]
    nm_idx = np.flatnonzero(nm_mask)
    n_nm = nm_idx.size
    case_nm = case[:nraw][nm_idx]
    case_ct = int(case_nm.sum())
    male = ds.male_mask()[:nraw][nm_idx]
    M = inc.size
    ap_min, ap_max, ap_alpha, ap_beta, ap_init, ap_slope = cfg.aperm
    if perm_adapt:
        perms_total = ap_max
        ci_zt = _ltqnorm(1 - ap_beta / (2.0 * M))
        first_adapt_check = int(ap_init) if ap_min < ap_init else ap_min
    else:
        perms_total = mperm_val
        first_adapt_check = perms_total + 1
        ap_init = ap_slope = ap_alpha = ci_zt = 0.0
    precomp_width = 1 + int(math.sqrt(n_nm) * 0.05 * 5.65686)
    thread_ct = min(cfg.threads or 1, perms_total)
    master = master_sfmt(cfg)
    perms = cc_perm_matrix(case_nm, perms_total, thread_ct, master)
    permsi = perms.astype(np.int64)

    success2 = np.zeros(M, np.int64)
    attempt = np.full(M, perms_total, np.int64)
    valid = np.ones(M, bool)
    orig_stat_arr = np.full(M, -9.0)
    extremes = None
    if not perm_adapt:
        extremes = np.ones(perms_total) if fisher \
            else np.zeros(perms_total)
        maxt_pending = np.ones(M) if fisher else np.zeros(M)
        bstarts = [0]
        nxt = 64
        while nxt < M:
            bstarts.append(nxt)
            nxt += 960
        block_boundary = set(bstarts)

    for k in range(M):
        if extremes is not None and k in block_boundary and k:
            maxt_pending[k:] = float(
                extremes.max() if fisher else extremes.min())
        v = int(inc[k])
        r_d = r_all[k]
        s_d = s_all[k]
        case_homcom_o = int(r_d[2])
        case_het_o = int(r_d[1])
        case_homrar_o = int(r_d[0])
        ctrl_homcom = int(s_d[2])
        ctrl_het = int(s_d[1])
        ctrl_homrar = int(s_d[0])
        homcom_ct = case_homcom_o + ctrl_homcom
        het_ct = case_het_o + ctrl_het
        homrar_ct = case_homrar_o + ctrl_homrar
        tot_obs = homcom_ct + het_ct + homrar_ct
        com_ct = 2 * homcom_ct + het_ct
        missing_ct = n_nm - tot_obs
        case_nonmiss_o = case_homcom_o + case_het_o + case_homrar_o
        is_invalid = bool(is_invalid_arr[k])
        # ---- original stat for the chosen test ----
        orig_chisq = -9.0
        orig_pval = -9.0
        inv_attempt = 0
        if test == "trend":
            cch = ca_trend_evalx(
                2 * case_homcom_o + case_het_o, case_nonmiss_o,
                het_ct, homcom_ct, tot_obs)
            orig_pval = chiprob_px(cch, 1)
            orig_chisq = cch if cch != -9 else 0.0
            inv_attempt = first_adapt_check
        elif test in ("dom", "rec"):
            if is_invalid:
                orig_pval = -9.0
                orig_chisq = -9.0
            else:
                # orig pass uses A1-side tables (plink_assoc.c:7013,
                # 7054); the perm threads count the A2 side
                if test == "dom":
                    m11 = case_homrar_o + case_het_o
                    col1 = homrar_ct + het_ct
                    m21 = ctrl_homrar + ctrl_het
                    m22 = ctrl_homcom
                else:
                    m11 = case_homrar_o
                    col1 = homrar_ct
                    m21 = ctrl_homrar
                    m22 = ctrl_het + ctrl_homcom
                if fisher:
                    orig_pval = fisher22(
                        m11, case_nonmiss_o - m11, m21, m22, midp)
                else:
                    dww = chi22_evalx(m11, case_nonmiss_o, col1,
                                      tot_obs)
                    orig_pval = chiprob_px(dww, 1)
                    orig_chisq = dww if dww != -9 else 0.0
        elif test == "gen":
            if is_invalid:
                orig_pval = -9.0
            elif fisher:
                orig_pval = fisher23(
                    case_homcom_o, case_het_o, case_homrar_o,
                    ctrl_homcom, ctrl_het, ctrl_homrar, midp)
            else:
                dvv, upp = chi23_evalx(
                    ctrl_homcom, ctrl_het, ctrl_homrar,
                    case_homcom_o, case_het_o, case_homrar_o)
                orig_pval = chiprob_px(dvv, upp)
                orig_chisq = dvv if dvv != -9 else 0.0
        else:  # best
            # orig pass A1-side tables (plink_assoc.c:6980,7013,7054)
            a1c = 2 * case_homrar_o + case_het_o
            a1u = 2 * ctrl_homrar + ctrl_het
            a1_tot = a1c + a1u
            if fisher:
                mult_p = fisher22(
                    a1c, 2 * case_homcom_o + case_het_o,
                    a1u, 2 * ctrl_homcom + ctrl_het, midp)
            else:
                dww = chi22_evalx(a1c, 2 * case_nonmiss_o, a1_tot,
                                  2 * tot_obs)
                mult_p = chiprob_px(dww, 1)
            dxx = mult_p
            if not is_invalid:
                trials = [
                    (case_homrar_o + case_het_o, homrar_ct + het_ct,
                     ctrl_homrar + ctrl_het, ctrl_homcom),
                    (case_homrar_o, homrar_ct,
                     ctrl_homrar, ctrl_het + ctrl_homcom),
                ]
                for m11, col1, m21, m22 in trials:
                    if fisher:
                        pp = fisher22(m11, case_nonmiss_o - m11,
                                      m21, m22, midp)
                    else:
                        cc2 = chi22_evalx(m11, case_nonmiss_o, col1,
                                          tot_obs)
                        pp = chiprob_px(cc2, 1)
                    if 0 <= pp < dxx:
                        dxx = pp
            orig_pval = dxx
            if not fisher:
                orig_chisq = inverse_chiprob1(dxx) \
                    if dxx != -9 else -9.0
        # invalid handling per thread type
        stat_is_p = fisher or (test == "best" and fisher)
        orig_stat = orig_pval if fisher else orig_chisq
        if (fisher and orig_pval == -9) \
                or ((not fisher) and orig_chisq == -9) \
                or (test == "trend" and orig_pval == -9):
            valid[k] = False
            attempt[k] = inv_attempt if perm_adapt else 0
            success2[k] = inv_attempt if perm_adapt else 0
            continue
        if fisher:
            stat_high = orig_pval * (1.0 + EPSILON)
            stat_low = orig_pval * (1.0 - EPSILON)
            orig_stat_arr[k] = orig_pval
        else:
            stat_high = orig_chisq + EPSILON
            stat_low = orig_chisq - EPSILON
            orig_stat_arr[k] = orig_chisq
        # ---- per-perm class counts ----
        raw = variant_codes(ds, v, nm_idx)
        g = raw if a1_is_alt[v] \
            else np.where(raw == 3, 3, 2 - raw).astype(raw.dtype)
        g = g.astype(np.int64)
        if int(vi.chrom[v]) == X_CODE:
            g = np.where(male, 3, g)      # force_missing
        miss_ind = (g == 3).astype(np.int64)
        het_ind = (g == 1).astype(np.int64)
        homcom_ind = (g == 0).astype(np.int64)
        case_miss = permsi @ miss_ind
        case_het = permsi @ het_ind
        case_homcom = permsi @ homcom_ind
        missing_start, entry_ct = get_precomp_bounds(
            missing_ct, 1, case_ct, n_nm, precomp_width, False)
        P = perms_total
        outcomes = np.zeros(P, np.int64)
        if test == "trend":
            tables = {}
            mtables = {}
            ujj = case_ct - missing_start
            for e in range(entry_ct):
                b, _c = ca_trend_precomp_val_bounds(
                    orig_chisq, ujj, het_ct, homcom_ct, tot_obs)
                tables[missing_start + e] = b
                if not perm_adapt:
                    b2, c2 = ca_trend_precomp_val_bounds(
                        maxt_pending[k], ujj, het_ct, homcom_ct, tot_obs)
                    mtables[missing_start + e] = (b2[2], b2[3] - b2[2], c2)
                ujj -= 1
            case_com = 2 * case_homcom + case_het
            for p in range(P):
                cm = int(case_miss[p])
                m11 = int(case_com[p])
                u = cm - missing_start
                if 0 <= u < precomp_width:
                    b = tables[cm]
                    if m11 < b[0]:
                        outcomes[p] = 2 if m11 < b[2] else 1
                    elif m11 >= b[1]:
                        outcomes[p] = 2 if m11 >= b[3] else 1
                    if not perm_adapt:
                        ukk, width, c2 = mtables[cm]
                        if not (0 <= m11 - ukk < width):
                            sval = float(m11) - c2[0]
                            sval = sval * sval * c2[1]
                            if extremes[p] < sval:
                                extremes[p] = sval
                else:
                    dxx = ca_trend_eval(m11, case_ct - cm, het_ct,
                                        homcom_ct, tot_obs)
                    if dxx > stat_high:
                        outcomes[p] = 2
                    elif dxx > stat_low:
                        outcomes[p] = 1
                    if not perm_adapt and extremes[p] < dxx:
                        extremes[p] = dxx
        elif test in ("dom", "rec"):
            col1 = homcom_ct if test == "dom" else homrar_ct
            col2 = tot_obs - col1
            tables = {}
            mtables = {}
            ujj = case_ct - missing_start
            for e in range(entry_ct):
                if fisher:
                    b, _c = fisher22_precomp_pval_bounds(
                        orig_pval, midp, ujj, col1, tot_obs)
                    if not perm_adapt:
                        b2, tp = fisher22_precomp_pval_bounds(
                            maxt_pending[k], midp, ujj, col1, tot_obs)
                        mtables[missing_start + e] = (
                            b2[2], b2[3] - b2[2], tp)
                else:
                    b, _c = chi22_precomp_val_bounds(
                        orig_chisq, ujj, col1, tot_obs)
                    if not perm_adapt:
                        b2, c2 = chi22_precomp_val_bounds(
                            maxt_pending[k], ujj, col1, tot_obs)
                        mtables[missing_start + e] = (
                            b2[2], b2[3] - b2[2], c2)
                tables[missing_start + e] = b
                ujj -= 1
            if test == "dom":
                homx = case_homcom
            else:
                homx = case_ct - case_homcom - case_miss - case_het
            for p in range(P):
                cm = int(case_miss[p])
                m11 = int(homx[p])
                u = cm - missing_start
                if 0 <= u < precomp_width:
                    b = tables[cm]
                    if m11 < b[0]:
                        outcomes[p] = 2 if m11 < b[2] else 1
                    elif m11 >= b[1]:
                        outcomes[p] = 2 if m11 >= b[3] else 1
                    if not perm_adapt:
                        ukk, width, cc = mtables[cm]
                        if not (0 <= m11 - ukk < width):
                            if fisher:
                                if cc is not None:
                                    uii = case_ct - cm
                                    sval = fisher22_tail_pval(
                                        ukk, uii - ukk, col1 - ukk,
                                        col2 + ukk - uii, width - 1,
                                        cc[0], cc[1], midp, m11)
                                    if extremes[p] > sval:
                                        extremes[p] = sval
                            else:
                                sval = float(m11) - cc[0]
                                sval = sval * sval * cc[1]
                                if extremes[p] < sval:
                                    extremes[p] = sval
                else:
                    uii = case_ct - cm
                    if fisher:
                        dxx = fisher22(m11, uii - m11, col1 - m11,
                                       col2 + m11 - uii, midp)
                        if dxx < stat_low:
                            outcomes[p] = 2
                        elif dxx <= stat_high:
                            outcomes[p] = 1
                        if not perm_adapt and extremes[p] > dxx:
                            extremes[p] = dxx
                    else:
                        dxx = chi22_eval(m11, uii, col1, tot_obs)
                        if dxx > stat_high:
                            outcomes[p] = 2
                        elif dxx > stat_low:
                            outcomes[p] = 1
                        if not perm_adapt and extremes[p] < dxx:
                            extremes[p] = dxx
        elif test == "gen":
            for p in range(P):
                cm = int(case_miss[p])
                chom = int(case_homcom[p])
                chet = int(case_het[p])
                if fisher:
                    crar = case_ct - cm - chom - chet
                    dxx = fisher23(chom, chet, crar,
                                   homcom_ct - chom, het_ct - chet,
                                   homrar_ct - crar, midp)
                    if dxx < stat_low:
                        outcomes[p] = 2
                    elif dxx <= stat_high:
                        outcomes[p] = 1
                    if extremes is not None and extremes[p] > dxx:
                        extremes[p] = dxx
                    continue
                if het_ct:
                    if homcom_ct:
                        dxx = chi23_eval(chom, chet, case_ct - cm,
                                         homcom_ct, het_ct, tot_obs)
                    else:
                        dxx = chi22_eval(chet, case_ct - cm, het_ct,
                                         tot_obs)
                else:
                    dxx = chi22_eval(chom, case_ct - cm, homcom_ct,
                                     tot_obs)
                if dxx > stat_high:
                    outcomes[p] = 2
                elif dxx > stat_low:
                    outcomes[p] = 1
                if extremes is not None and extremes[p] < dxx:
                    extremes[p] = dxx
        else:  # best
            tables = {}
            mtables = {}
            ujj = case_ct - missing_start
            for e in range(entry_ct):
                row = []
                mrow = []
                args = [(2 * ujj, com_ct, 2 * tot_obs),
                        (ujj, homcom_ct, tot_obs),
                        (ujj, homrar_ct, tot_obs)]
                for (r1, c1, tt) in args:
                    if fisher:
                        b, _c = fisher22_precomp_pval_bounds(
                            orig_pval, midp, r1, c1, tt)
                        if not perm_adapt:
                            b2, tp = fisher22_precomp_pval_bounds(
                                maxt_pending[k], midp, r1, c1, tt)
                            mrow.append((b2[2], b2[3] - b2[2], tp))
                    else:
                        b, _c = chi22_precomp_val_bounds(
                            orig_chisq, r1, c1, tt)
                        if not perm_adapt:
                            b2, c2 = chi22_precomp_val_bounds(
                                maxt_pending[k], r1, c1, tt)
                            mrow.append((b2[2], b2[3] - b2[2], c2))
                    row.append(b)
                tables[missing_start + e] = row
                if not perm_adapt:
                    mtables[missing_start + e] = mrow
                ujj -= 1
            skip_domrec = is_invalid
            default_best = 1.0 if fisher else 0.0
            case_com = 2 * case_homcom + case_het
            for p in range(P):
                cm = int(case_miss[p])
                ccom = int(case_com[p])
                chom = int(case_homcom[p])
                crar = case_ct - cm - int(case_het[p]) - chom
                u = cm - missing_start
                ujj2 = 0
                if 0 <= u < precomp_width:
                    row = tables[cm]
                    hit = False
                    for m11, b, active in (
                            (ccom, row[0], True),
                            (chom, row[1], not skip_domrec),
                            (crar, row[2], not skip_domrec)):
                        if not active:
                            continue
                        if m11 < b[0]:
                            if m11 < b[2]:
                                hit = True
                                break
                            ujj2 = 1
                        elif m11 >= b[1]:
                            if m11 >= b[3]:
                                hit = True
                                break
                            ujj2 = 1
                    if hit:
                        ujj2 = 2
                    if not perm_adapt:
                        # extreme-stat tail continuations for the three
                        # tests (model_maxt_best_thread,
                        # 1.9/plink_assoc.c:5350-5430): the allelic tail
                        # ASSIGNS best_stat; dom/rec tails fold in
                        best_stat = default_best
                        mrow = mtables[cm]
                        uii = case_ct - cm
                        rar_ct = 2 * tot_obs - com_ct
                        specs = [(ccom, mrow[0], 2 * uii, com_ct,
                                  rar_ct, 2 * tot_obs, True)]
                        if not skip_domrec:
                            specs.append((chom, mrow[1], uii, homcom_ct,
                                          homrar_ct + het_ct, tot_obs,
                                          False))
                            specs.append((crar, mrow[2], uii, homrar_ct,
                                          homcom_ct + het_ct, tot_obs,
                                          False))
                        for si, (m11, (ukk, width, cc), r1, c1, c2_,
                                 tt, is_first) in enumerate(specs):
                            if 0 <= m11 - ukk < width:
                                continue
                            if fisher:
                                if cc is None:
                                    continue
                                sval = fisher22_tail_pval(
                                    ukk, r1 - ukk, c1 - ukk,
                                    c2_ + ukk - r1, width - 1,
                                    cc[0], cc[1], midp, m11)
                                if is_first:
                                    best_stat = sval
                                elif sval < best_stat:
                                    best_stat = sval
                            else:
                                sval = float(m11) - cc[0]
                                sval = sval * sval * cc[1]
                                if is_first:
                                    best_stat = sval
                                elif sval > best_stat:
                                    best_stat = sval
                        if fisher:
                            if extremes[p] > best_stat:
                                extremes[p] = best_stat
                        else:
                            if extremes[p] < best_stat:
                                extremes[p] = best_stat
                else:
                    uii = case_ct - cm
                    ukk = tot_obs - uii
                    trials = [(ccom, 2 * uii, com_ct, 2 * tot_obs,
                               2 * ukk + ccom - com_ct)]
                    if not skip_domrec:
                        trials.append((chom, uii, homcom_ct, tot_obs,
                                       ukk + chom - homcom_ct))
                        trials.append((crar, uii, homrar_ct, tot_obs,
                                       ukk + crar - homrar_ct))
                    # full evaluation computes best over ALL tests first
                    # (1.9/plink_assoc.c:5432-5470), then classifies
                    best_stat = None
                    for (m11, r1, c1, tt, m22) in trials:
                        if fisher:
                            dxx = fisher22(m11, r1 - m11, c1 - m11,
                                           m22, midp)
                            if best_stat is None or dxx < best_stat:
                                best_stat = dxx
                        else:
                            dxx = chi22_eval(m11, r1, c1, tt)
                            if best_stat is None or dxx > best_stat:
                                best_stat = dxx
                    if fisher:
                        if best_stat < stat_low:
                            ujj2 = 2
                        elif best_stat <= stat_high:
                            ujj2 = 1
                        if not perm_adapt and extremes[p] > best_stat:
                            extremes[p] = best_stat
                    else:
                        if best_stat > stat_high:
                            ujj2 = 2
                        elif best_stat > stat_low:
                            ujj2 = 1
                        if not perm_adapt and extremes[p] < best_stat:
                            extremes[p] = best_stat
                outcomes[p] = ujj2
        if perm_adapt:
            s2i, stopped, nac = adaptive_scan(
                outcomes, 0, first_adapt_check, 0, ap_init, ap_slope,
                ap_alpha, ci_zt, perms_total)
            success2[k] = s2i
            if stopped:
                attempt[k] = nac
        else:
            success2[k] = int(outcomes.sum())

    # ---- report ----
    outp = cfg.out + ".model." + test
    if fisher and test != "trend":
        # trend+fisher removes the ".fisher" suffix again
        # (plink_assoc.c:7610)
        outp += ".fisher"
    outp += ".perm" if perm_adapt else ".mperm"
    with open(outp, "w") as fh:
        if perm_adapt:
            fh.write(" CHR " + "SNP".rjust(maxsnp)
                     + "         EMP1           NP \n")
            perms_done = 0
            for k in range(M):
                if attempt[k] > perms_done:
                    perms_done = int(attempt[k])
                    if perms_done == perms_total:
                        break
        else:
            fh.write(" CHR " + "SNP".rjust(maxsnp)
                     + "         EMP1         EMP2 \n")
            perms_done = perms_total
            sorted_ext = np.sort(extremes)
        log.log(f"{perms_done} {'(adaptive)' if perm_adapt else 'max(T)'} "
                f"permutation{'' if perms_done == 1 else 's'} complete.")
        dyy = 1.0 / (perms_total + 1)
        for k in range(M):
            v = int(inc[k])
            line = (ci.name19(int(vi.chrom[v])).rjust(4) + " "
                    + str(vi.vid[v]).rjust(maxsnp) + " ")
            if not valid[k] and attempt[k] == 0:
                line += "          NA           NA"
            else:
                pval = (int(success2[k]) + 2) \
                    / (2 * (int(attempt[k]) + 1))
                if not perm_count:
                    line += dtoa_g_wxp4(pval, 12) + " "
                else:
                    line += dtoa_g_wxp4(int(success2[k]) * 0.5, 12) + " "
                if perm_adapt:
                    line += "  " + str(int(attempt[k])).rjust(10)
                else:
                    if fisher:
                        orig_stat_k = orig_stat_arr[k]
                        dzz = int(np.searchsorted(
                            sorted_ext, orig_stat_k * (1.0 + EPSILON),
                            side="right")) + 1
                    else:
                        orig_stat_k = orig_stat_arr[k]
                        gt = int(np.searchsorted(
                            sorted_ext, orig_stat_k - EPSILON, side="right"))
                        dzz = perms_total - gt + 1
                    if not perm_count:
                        line += dtoa_g_wxp4(dzz * dyy, 12)
                    else:
                        line += dtoa_g_wxp4(float(dzz - 1), 12)
            fh.write(line + " \n")
    log.log(f"Permutation test report written to {outp} .")
