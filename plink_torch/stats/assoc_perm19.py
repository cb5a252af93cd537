"""1.9 case/control association permutation support.

Ports of the threshold-precomputation routines the reference uses to
classify permuted contingency tables without evaluating the test
statistic: chi22_precomp_val_bounds / fisher22_precomp_pval_bounds
(1.9/plink_stats.c:1865,1348) plus chi22_eval and the adaptive
success-counting loop shared by assoc_adapt_thread
(1.9/plink_assoc.c:2287).
"""

from __future__ import annotations

import math

from .binom19 import EXACT_TEST_BIAS, FISHER_EPSILON

BIG_EPSILON = 0.000000476837158203125
EPSILON = 0.000000000931322574615478515625


def chi22_eval(m11, row1_sum, col1_sum, total):
    """1.9/plink_stats.c:1836."""
    expm11_numer = float(row1_sum * col1_sum)
    denom = expm11_numer * float((total - row1_sum)
                                 * (total - col1_sum))
    if denom != 0:
        dxx = float(total)
        dyy = m11 * dxx - expm11_numer
        return (dyy * dyy * dxx) / denom
    return 0.0


def chi22_get_coeffs(row1_sum, col1_sum, total):
    """1.9/plink_stats.c:1806."""
    m11_numer = float(row1_sum * col1_sum)
    denom = m11_numer * float((total - row1_sum)
                              * (total - col1_sum))
    if denom != 0:
        dxx = float(total)
        return m11_numer / dxx, dxx * dxx * dxx / denom
    if row1_sum + col1_sum < total:
        return 0.0, 0.0
    return float(row1_sum + col1_sum - total), 0.0


def chi22_precomp_val_bounds(chisq, row1_sum, col1_sum, total):
    """1.9/plink_stats.c:1865: [min m11 with smaller chisq,
    max+1, min with smaller-or-equal, max+1], plus (expm11,
    recip_sum) coefficients."""
    expm11, recip_sum = chi22_get_coeffs(row1_sum, col1_sum, total)
    bounds = [0, 0, 0, 0]
    if recip_sum == 0:
        bounds[0] = int(expm11)
        bounds[1] = bounds[0]
        bounds[2] = bounds[0]
        bounds[3] = bounds[0] + 1 if chisq == 0 else bounds[0]
        return bounds, (expm11, recip_sum)
    coeffs = (expm11, recip_sum)
    ceil11 = min(row1_sum, col1_sum)
    rs = math.sqrt(chisq / recip_sum)
    cur11 = expm11 - rs
    dxx = cur11 + 1 - BIG_EPSILON
    if dxx < 0:
        bounds[0] = 0
        bounds[2] = 0
    else:
        lii = int(dxx)
        bounds[2] = lii
        if lii == int(cur11 + BIG_EPSILON):
            bounds[0] = lii + 1
        else:
            bounds[0] = lii
    cur11 = expm11 + rs
    if cur11 > ceil11 + BIG_EPSILON:
        bounds[1] = ceil11 + 1
        bounds[3] = bounds[1]
    else:
        dxx = cur11 + 1 - BIG_EPSILON
        lii = int(dxx)
        bounds[1] = lii
        if lii == int(cur11 + BIG_EPSILON):
            bounds[3] = lii + 1
        else:
            bounds[3] = lii
    return bounds, coeffs


def fisher22_precomp_pval_bounds(pval, midp, row1_sum, col1_sum,
                                 total):
    """1.9/plink_stats.c:1348 (bounds only; tail coefficients are
    used by the max(T) engine and returned as (left_prob,
    right_prob/left_prob, tot_prob))."""
    bounds = [0, 0, 0, 0]
    if not total:
        bounds[3] = 1
        return bounds, None
    if pval == 0:
        if total >= row1_sum + col1_sum:
            bounds[0] = 0
            bounds[1] = min(row1_sum, col1_sum) + 1
        else:
            bounds[0] = row1_sum + col1_sum - total
            bounds[1] = total - max(row1_sum, col1_sum) + 1
        bounds[2] = bounds[0]
        bounds[3] = bounds[1]
        return bounds, None
    tot_prob = 1.0 / EXACT_TEST_BIAS
    left_prob = tot_prob
    right_prob = tot_prob
    m11_offset = 0
    tail_prob = 0.0
    cmult = 0.5 if midp else 1.0
    if total >= row1_sum + col1_sum:
        lii = (row1_sum * col1_sum) // total
        left11 = float(lii)
        left12 = float(row1_sum - lii)
        left21 = float(col1_sum - lii)
        left22 = float(total - row1_sum - col1_sum + lii)
    else:
        lii = ((total - row1_sum) * (total - col1_sum)) // total
        m11_offset = row1_sum + col1_sum - total
        left11 = float(lii)
        left12 = float(total - col1_sum - lii)
        left21 = float(total - row1_sum - lii)
        left22 = float(m11_offset + lii)
    if (left11 + 1) * (left22 + 1) < left12 * left21:
        left11 += 1
        left12 -= 1
        left21 -= 1
        left22 += 1
    if left12 > left21:
        left12, left21 = left21, left12
    right11 = left11
    right12 = left12
    right21 = left21
    right22 = left22
    while True:
        if right12 < 0.5:
            break
        right11 += 1
        right22 += 1
        right_prob *= (right12 * right21) / (right11 * right22)
        right12 -= 1
        right21 -= 1
        dxx = tot_prob
        tot_prob += right_prob
        if tot_prob <= dxx:
            break
    while True:
        if left11 < 0.5:
            break
        left12 += 1
        left21 += 1
        left_prob *= (left11 * left22) / (left12 * left21)
        left11 -= 1
        left22 -= 1
        dxx = tot_prob
        tot_prob += left_prob
        if tot_prob <= dxx:
            break
    dxx = 1 - (left11 * left22) / ((left12 + 1) * (left21 + 1))
    threshold = 1 - (right12 * right21) / ((right11 + 1)
                                           * (right22 + 1))
    threshold = pval * tot_prob * dxx * threshold / (dxx + threshold)
    while left11 > 0.5:
        if left_prob < threshold:
            tail_prob = left_prob
            cur11 = left11
            cur12 = left12
            cur21 = left21
            cur22 = left22
            cur_prob = left_prob
            while True:
                cur12 += 1
                cur21 += 1
                cur_prob *= (cur11 * cur22) / (cur12 * cur21)
                cur11 -= 1
                cur22 -= 1
                dxx = tail_prob
                tail_prob += cur_prob
                if dxx >= tail_prob:
                    break
            left11 += 1
            left22 += 1
            left_prob *= (left12 * left21) / (left11 * left22)
            left12 -= 1
            left21 -= 1
            break
        left12 += 1
        left21 += 1
        left_prob *= (left11 * left22) / (left12 * left21)
        left11 -= 1
        left22 -= 1
    while right12 > 0.5:
        if right_prob < threshold:
            tail_prob += right_prob
            cur11 = right11
            cur12 = right12
            cur21 = right21
            cur22 = right22
            cur_prob = right_prob
            while True:
                cur11 += 1
                cur22 += 1
                cur_prob *= (cur12 * cur21) / (cur11 * cur22)
                cur12 -= 1
                cur21 -= 1
                dxx = tail_prob
                tail_prob += cur_prob
                if dxx >= tail_prob:
                    break
            right12 += 1
            right21 += 1
            right_prob *= (right11 * right22) / (right12 * right21)
            right11 -= 1
            right22 -= 1
            break
        right11 += 1
        right22 += 1
        right_prob *= (right12 * right21) / (right11 * right22)
        right12 -= 1
        right21 -= 1
    dxx = pval * tot_prob * (1 - FISHER_EPSILON / 2)
    threshold = pval * tot_prob * (1 + FISHER_EPSILON / 2)
    lii = 0
    while True:
        if left_prob < right_prob * (1 - FISHER_EPSILON / 2):
            cur_prob = tail_prob + left_prob * cmult
            if cur_prob > threshold:
                break
            tail_prob += left_prob
            uii = 1
        elif right_prob < left_prob * (1 - FISHER_EPSILON / 2):
            cur_prob = tail_prob + right_prob * cmult
            if cur_prob > threshold:
                break
            tail_prob += right_prob
            uii = 2
        else:
            cur_prob = tail_prob + (left_prob + right_prob) * cmult
            if cur_prob > threshold:
                if left11 == right11:
                    cur_prob = tail_prob + left_prob * cmult
                    if cur_prob < threshold:
                        if cur_prob > dxx:
                            lii = 1
                        else:
                            left11 += 1
                            left22 += 1
                            left_prob *= (left12 * left21) \
                                / (left11 * left22)
                break
            tail_prob += left_prob + right_prob
            uii = 3
        if cur_prob > dxx:
            lii = uii
            break
        if uii & 1:
            left11 += 1
            left22 += 1
            left_prob *= (left12 * left21) / (left11 * left22)
            left12 -= 1
            left21 -= 1
        if uii & 2:
            right12 += 1
            right21 += 1
            right_prob *= (right11 * right22) / (right12 * right21)
            right11 -= 1
            right22 -= 1
    bounds[2] = m11_offset + int(left11)
    bounds[3] = m11_offset + int(right11) + 1
    bounds[0] = bounds[2] + (lii & 1)
    bounds[1] = bounds[3] - (lii >> 1)
    # tprobs exactly as the reference computes them (:1282-1284): the
    # max(T) fisher tail-continuation needs these bit-for-bit
    dxx = 1.0 / left_prob
    return bounds, (left_prob / tot_prob, right_prob * dxx)


def get_precomp_bounds(missing_ct, is_model, case_ct, pheno_nm_ct,
                       precomp_width, is_x):
    """get_model_assoc_precomp_bounds (1.9/plink_assoc.c:5957):
    (missing_start, entry_ct)."""
    xval = float(case_ct * missing_ct) / float(pheno_nm_ct)
    lbound = int(xval + EPSILON + 1 - precomp_width * 0.5)
    ctrl_ct = pheno_nm_ct - case_ct
    ubound = missing_ct
    if lbound < 0:
        lbound = 0
    if is_x and not is_model:
        lii = missing_ct - 2 * ctrl_ct
        if ubound > case_ct * 2:
            ubound = case_ct * 2
    else:
        lii = missing_ct - ctrl_ct
        if ubound > case_ct:
            ubound = case_ct
    if lii > lbound:
        lbound = lii
    if lbound + precomp_width > ubound:
        return lbound, ubound + 1 - lbound
    return lbound, precomp_width


def adaptive_scan(outcomes, success_2start, first_adapt_check,
                  perms_done_offset, ap_init, ap_slope, ap_alpha,
                  ci_zt, perms_in_batch):
    """The per-marker adaptive perm loop (assoc_adapt_thread tail):
    outcomes[pidx] in {0, 1, 2}; returns (success_2incr, stopped,
    attempt_ct_if_stopped)."""
    s2i = 0
    nac = first_adapt_check
    pidx = 0
    while pidx < perms_in_batch:
        s2i += outcomes[pidx]
        pidx += 1
        if pidx == nac - perms_done_offset:
            uii = success_2start + s2i
            if uii:
                pval = (uii + 2) / (2 * (nac + 1))
                dxx = ci_zt * math.sqrt(pval * (1 - pval) / nac)
                if (pval - dxx > ap_alpha) or (pval + dxx < ap_alpha):
                    return s2i, True, nac
            nac += int(ap_init + nac * ap_slope)
    return s2i, False, 0


def fisher22_tail_pval(m11, m12, m21, m22, right_offset, tot_prob_recip,
                       right_prob, midp, new_m11):
    """fisher22_tail_pval (1.9/plink_stats.c): p-value of new_m11 given a
    precomputed reference pair (left table at m11 with likelihood
    1/tot_prob, right table at m11+right_offset with likelihood
    right_prob/tot_prob).  Used by the max(T) fisher engine so extreme
    statistics carry the reference's exact rounding."""
    left_prob = 1.0
    dxx = float(new_m11)
    if new_m11 < m11:
        cur11 = float(m11)
        cur12 = float(m12)
        cur21 = float(m21)
        cur22 = float(m22)
        dxx += 0.5
        while True:
            cur12 += 1
            cur21 += 1
            left_prob *= cur11 * cur22 / (cur12 * cur21)
            cur11 -= 1
            cur22 -= 1
            if not (cur11 > dxx):
                break
        if left_prob == 0:
            return 0.0
        psum = left_prob * 0.5 if midp else left_prob
        thresh = left_prob * (1 + FISHER_EPSILON)
        while True:
            if cur11 < 0.5:
                break
            cur12 += 1
            cur21 += 1
            left_prob *= cur11 * cur22 / (cur12 * cur21)
            cur11 -= 1
            cur22 -= 1
            dxx = psum
            psum += left_prob
            if not (psum > dxx):
                break
        cur11 = float(m11 + right_offset)
        cur12 = float(m12 - right_offset)
        cur21 = float(m21 - right_offset)
        cur22 = float(m22 + right_offset)
        while right_prob > thresh:
            cur11 += 1
            cur22 += 1
            right_prob *= cur12 * cur21 / (cur11 * cur22)
            cur12 -= 1
            cur21 -= 1
        if right_prob > 0:
            if midp and right_prob < thresh * (1 - 2 * FISHER_EPSILON):
                psum += right_prob * 0.5
            else:
                psum += right_prob
            while True:
                cur11 += 1
                cur22 += 1
                right_prob *= cur12 * cur21 / (cur11 * cur22)
                cur12 -= 1
                cur21 -= 1
                dxx = psum
                psum += right_prob
                if not (psum > dxx):
                    break
    else:
        dxx -= 0.5
        cur11 = float(m11 + right_offset)
        cur12 = float(m12 - right_offset)
        cur21 = float(m21 - right_offset)
        cur22 = float(m22 + right_offset)
        while True:
            cur11 += 1
            cur22 += 1
            right_prob *= cur12 * cur21 / (cur11 * cur22)
            cur12 -= 1
            cur21 -= 1
            if not (cur11 < dxx):
                break
        if right_prob == 0:
            return 0.0
        psum = right_prob * 0.5 if midp else right_prob
        thresh = right_prob * (1 + FISHER_EPSILON)
        while True:
            if cur12 < 0.5:
                break
            cur11 += 1
            cur22 += 1
            right_prob *= cur12 * cur21 / (cur11 * cur22)
            cur12 -= 1
            cur21 -= 1
            dxx = psum
            psum += right_prob
            if not (psum > dxx):
                break
        cur11 = float(m11)
        cur12 = float(m12)
        cur21 = float(m21)
        cur22 = float(m22)
        while left_prob > thresh:
            cur12 += 1
            cur21 += 1
            left_prob *= cur11 * cur22 / (cur12 * cur21)
            cur11 -= 1
            cur22 -= 1
        if left_prob > 0:
            if midp and left_prob < thresh * (1 - 2 * FISHER_EPSILON):
                psum += left_prob * 0.5
            else:
                psum += left_prob
            while True:
                cur12 += 1
                cur21 += 1
                left_prob *= cur11 * cur22 / (cur12 * cur21)
                cur11 -= 1
                cur22 -= 1
                dxx = psum
                psum += left_prob
                if not (psum > dxx):
                    break
    return psum * tot_prob_recip
