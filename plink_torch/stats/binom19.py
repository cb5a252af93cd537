"""Exact two-sided binomial(p=0.5) test, PLINK 1.9 parity.

Behavior reference: binom_2sided (1.9/plink_stats.c:2213): relative
likelihoods are walked outward from the observed count in exact float64
op order, classifying mass into tail vs center against an
EXACT_TEST_BIAS-scaled threshold, with the mid-p tie adjustment.
"""

from __future__ import annotations

EXACT_TEST_BIAS = float(
    "0.000000000000000000000000103397576569128459358926086508745356695726"
    "51386260986328125")
SMALL_EPSILON = 0.00000000000005684341886080801486968994140625


def binom_2sided(succ: int, obs: int, midp: bool) -> float:
    cur_succ_t2 = float(succ)
    cur_fail_t2 = float(obs - succ)
    tailp = (1 - SMALL_EPSILON) * EXACT_TEST_BIAS
    centerp = 0.0
    lastp2 = tailp
    lastp1 = tailp
    tie_ct = 1
    if not obs:
        return 0.5 if midp else 1.0
    if obs < succ * 2:
        while cur_succ_t2 > 0.5:
            cur_fail_t2 += 1
            lastp2 *= cur_succ_t2 / cur_fail_t2
            cur_succ_t2 -= 1
            if lastp2 < EXACT_TEST_BIAS:
                if lastp2 > (1 - 2 * SMALL_EPSILON) * EXACT_TEST_BIAS:
                    tie_ct += 1
                tailp += lastp2
                break
            centerp += lastp2
            if centerp == float("inf"):
                return 0.0
        if centerp == 0 and not midp:
            return 1.0
        while cur_succ_t2 > 0.5:
            cur_fail_t2 += 1
            lastp2 *= cur_succ_t2 / cur_fail_t2
            cur_succ_t2 -= 1
            preaddp = tailp
            tailp += lastp2
            if tailp <= preaddp:
                break
        cur_succ_t1 = float(succ + 1)
        cur_fail_t1 = float(obs - succ)
        while cur_fail_t1 > 0.5:
            lastp1 *= cur_fail_t1 / cur_succ_t1
            preaddp = tailp
            tailp += lastp1
            if tailp <= preaddp:
                break
            cur_succ_t1 += 1
            cur_fail_t1 -= 1
    else:
        while cur_fail_t2 > 0.5:
            cur_succ_t2 += 1
            lastp2 *= cur_fail_t2 / cur_succ_t2
            cur_fail_t2 -= 1
            if lastp2 < EXACT_TEST_BIAS:
                if lastp2 > (1 - 2 * SMALL_EPSILON) * EXACT_TEST_BIAS:
                    tie_ct += 1
                tailp += lastp2
                break
            centerp += lastp2
            if centerp == float("inf"):
                return 0.0
        if centerp == 0 and not midp:
            return 1.0
        while cur_fail_t2 > 0.5:
            cur_succ_t2 += 1
            lastp2 *= cur_fail_t2 / cur_succ_t2
            cur_fail_t2 -= 1
            preaddp = tailp
            tailp += lastp2
            if tailp <= preaddp:
                break
        cur_succ_t1 = float(succ)
        cur_fail_t1 = float(obs - succ)
        while cur_succ_t1 > 0.5:
            cur_fail_t1 += 1
            lastp1 *= cur_succ_t1 / cur_fail_t1
            preaddp = tailp
            tailp += lastp1
            if tailp <= preaddp:
                break
            cur_succ_t1 -= 1
    if not midp:
        return tailp / (tailp + centerp)
    return (tailp - ((1 - SMALL_EPSILON) * EXACT_TEST_BIAS * 0.5)
            * tie_ct) / (tailp + centerp)


FISHER_EPSILON = 0.0000000000009094947017729282379150390625


def fisher22(m11: int, m12: int, m21: int, m22: int, midp: bool) -> float:
    """2x2 Fisher exact test, PLINK 1.9 parity (fisher22,
    1.9/plink_stats.c:771): relative-likelihood walk from the observed
    table with EXACT_TEST_BIAS tie handling and optional mid-p."""
    tprob = (1 - FISHER_EPSILON) * EXACT_TEST_BIAS
    cur_prob = tprob
    cprob = 0.0
    tie_ct = 1
    if m12 > m21:
        m12, m21 = m21, m12
    if m11 > m22:
        m11, m22 = m22, m11
    if m11 * m22 > m12 * m21:
        m11, m12 = m12, m11
        m21, m22 = m22, m21
    cur11, cur12, cur21, cur22 = float(m11), float(m12), float(m21), \
        float(m22)
    while cur12 > 0.5:
        cur11 += 1
        cur22 += 1
        cur_prob *= (cur12 * cur21) / (cur11 * cur22)
        cur12 -= 1
        cur21 -= 1
        if cur_prob == float("inf"):
            return 0.0
        if cur_prob < EXACT_TEST_BIAS:
            if cur_prob > (1 - 2 * FISHER_EPSILON) * EXACT_TEST_BIAS:
                tie_ct += 1
            tprob += cur_prob
            break
        cprob += cur_prob
    if cprob == 0 and not midp:
        return 1.0
    while cur12 > 0.5:
        cur11 += 1
        cur22 += 1
        cur_prob *= (cur12 * cur21) / (cur11 * cur22)
        cur12 -= 1
        cur21 -= 1
        preaddp = tprob
        tprob += cur_prob
        if tprob <= preaddp:
            break
    if m11:
        cur11, cur12, cur21, cur22 = float(m11), float(m12), \
            float(m21), float(m22)
        cur_prob = (1 - FISHER_EPSILON) * EXACT_TEST_BIAS
        while True:
            cur12 += 1
            cur21 += 1
            cur_prob *= (cur11 * cur22) / (cur12 * cur21)
            cur11 -= 1
            cur22 -= 1
            preaddp = tprob
            tprob += cur_prob
            if tprob <= preaddp:
                if not midp:
                    return preaddp / (cprob + preaddp)
                return (preaddp - ((1 - FISHER_EPSILON)
                                   * EXACT_TEST_BIAS * 0.5)
                        * tie_ct) / (cprob + preaddp)
            if not cur11 > 0.5:
                break
    if not midp:
        return tprob / (cprob + tprob)
    return (tprob - ((1 - FISHER_EPSILON) * EXACT_TEST_BIAS * 0.5)
            * tie_ct) / (cprob + tprob)


def _fisher23_tailsum(state, tie_box, right_side):
    """fisher23_tailsum (1.9/plink_stats.c:1328): state =
    [base_prob, s12, s13, s22, s23]; returns (stop, total)."""
    total = 0.0
    cur_prob = state[0]
    tmp12, tmp13, tmp22, tmp23 = state[1:5]
    if right_side:
        if cur_prob > EXACT_TEST_BIAS:
            prev_prob = tmp13 * tmp22
            while prev_prob > 0.5:
                tmp12 += 1
                tmp23 += 1
                cur_prob *= prev_prob / (tmp12 * tmp23)
                tmp13 -= 1
                tmp22 -= 1
                if cur_prob <= EXACT_TEST_BIAS:
                    break
                prev_prob = tmp13 * tmp22
            state[0] = cur_prob
            tmps12, tmps13, tmps22, tmps23 = (tmp12, tmp13, tmp22,
                                              tmp23)
        else:
            tmps12, tmps13, tmps22, tmps23 = (tmp12, tmp13, tmp22,
                                              tmp23)
            while True:
                prev_prob = cur_prob
                tmp13 += 1
                tmp22 += 1
                cur_prob *= (tmp12 * tmp23) / (tmp13 * tmp22)
                if cur_prob < prev_prob:
                    return True, 0.0
                tmp12 -= 1
                tmp23 -= 1
                if cur_prob > (1 - 2 * FISHER_EPSILON) \
                        * EXACT_TEST_BIAS:
                    if cur_prob > (1 - SMALL_EPSILON) \
                            * EXACT_TEST_BIAS:
                        break
                    tie_box[0] += 1
                total += cur_prob
            prev_prob = cur_prob
            cur_prob = state[0]
            state[0] = prev_prob
    else:
        if cur_prob > EXACT_TEST_BIAS:
            prev_prob = tmp12 * tmp23
            while prev_prob > 0.5:
                tmp13 += 1
                tmp22 += 1
                cur_prob *= prev_prob / (tmp13 * tmp22)
                tmp12 -= 1
                tmp23 -= 1
                if cur_prob <= EXACT_TEST_BIAS:
                    break
                prev_prob = tmp12 * tmp23
            state[0] = cur_prob
            tmps12, tmps13, tmps22, tmps23 = (tmp12, tmp13, tmp22,
                                              tmp23)
        else:
            tmps12, tmps13, tmps22, tmps23 = (tmp12, tmp13, tmp22,
                                              tmp23)
            while True:
                prev_prob = cur_prob
                tmp12 += 1
                tmp23 += 1
                cur_prob *= (tmp13 * tmp22) / (tmp12 * tmp23)
                if cur_prob < prev_prob:
                    return True, 0.0
                tmp13 -= 1
                tmp22 -= 1
                if cur_prob > (1 - 2 * FISHER_EPSILON) \
                        * EXACT_TEST_BIAS:
                    if cur_prob > EXACT_TEST_BIAS:
                        break
                    tie_box[0] += 1
                total += cur_prob
            prev_prob = cur_prob
            cur_prob = state[0]
            state[0] = prev_prob
    state[1] = tmp12
    state[2] = tmp13
    state[3] = tmp22
    state[4] = tmp23
    if cur_prob > (1 - 2 * FISHER_EPSILON) * EXACT_TEST_BIAS:
        if cur_prob > EXACT_TEST_BIAS:
            return False, 0.0
        tie_box[0] += 1
    if right_side:
        prev_prob = total
        total += cur_prob
        while total > prev_prob:
            tmps12 += 1
            tmps23 += 1
            cur_prob *= (tmps13 * tmps22) / (tmps12 * tmps23)
            tmps13 -= 1
            tmps22 -= 1
            prev_prob = total
            total += cur_prob
    else:
        prev_prob = total
        total += cur_prob
        while total > prev_prob:
            tmps13 += 1
            tmps22 += 1
            cur_prob *= (tmps12 * tmps23) / (tmps13 * tmps22)
            tmps12 -= 1
            tmps23 -= 1
            prev_prob = total
            total += cur_prob
    return False, total


def fisher23(m11, m12, m13, m21, m22, m23, midp):
    """2x3 Fisher-Freeman-Halton exact test
    (1.9/plink_stats.c:1447)."""
    cur_prob = (1 - FISHER_EPSILON) * EXACT_TEST_BIAS
    tprob = cur_prob
    cprob = 0.0
    dyy = 0.0
    tie_box = [1]
    # sort columns by sum
    if m11 + m21 > m12 + m22:
        m11, m12 = m12, m11
        m21, m22 = m22, m21
    if m12 + m22 > m13 + m23:
        m12, m13 = m13, m12
        m22, m23 = m23, m22
    if m11 + m21 > m12 + m22:
        m11, m12 = m12, m11
        m21, m22 = m22, m21
    if m11 * (m22 + m23) > m21 * (m12 + m13):
        m11, m21 = m21, m11
        m12, m22 = m22, m12
        m13, m23 = m23, m13
    if m12 * m23 > m13 * m22:
        base_probr = cur_prob
        savedr12 = float(m12)
        savedr13 = float(m13)
        savedr22 = float(m22)
        savedr23 = float(m23)
        tmp12 = savedr12
        tmp13 = savedr13
        tmp22 = savedr22
        tmp23 = savedr23
        dxx = tmp12 * tmp23
        while True:
            tmp13 += 1
            tmp22 += 1
            cur_prob *= dxx / (tmp13 * tmp22)
            tmp12 -= 1
            tmp23 -= 1
            if cur_prob <= EXACT_TEST_BIAS:
                if cur_prob > (1 - 2 * FISHER_EPSILON) \
                        * EXACT_TEST_BIAS:
                    tie_box[0] += 1
                tprob += cur_prob
                break
            cprob += cur_prob
            if cprob == float("inf"):
                return 0.0
            dxx = tmp12 * tmp23
            if not dxx > 0.5:
                break
        savedl12 = tmp12
        savedl13 = tmp13
        savedl22 = tmp22
        savedl23 = tmp23
        base_probl = cur_prob
        while True:
            tmp13 += 1
            tmp22 += 1
            cur_prob *= (tmp12 * tmp23) / (tmp13 * tmp22)
            tmp12 -= 1
            tmp23 -= 1
            preaddp = tprob
            tprob += cur_prob
            if tprob <= preaddp:
                break
        tmp12 = savedr12
        tmp13 = savedr13
        tmp22 = savedr22
        tmp23 = savedr23
        cur_prob = base_probr
        while True:
            tmp12 += 1
            tmp23 += 1
            cur_prob *= (tmp13 * tmp22) / (tmp12 * tmp23)
            tmp13 -= 1
            tmp22 -= 1
            preaddp = tprob
            tprob += cur_prob
            if tprob <= preaddp:
                break
    else:
        base_probl = cur_prob
        savedl12 = float(m12)
        savedl13 = float(m13)
        savedl22 = float(m22)
        savedl23 = float(m23)
        if not (m12 * m23 + m13 * m22):
            base_probr = cur_prob
            savedr12 = savedl12
            savedr13 = savedl13
            savedr22 = savedl22
            savedr23 = savedl23
        else:
            tmp12 = savedl12
            tmp13 = savedl13
            tmp22 = savedl22
            tmp23 = savedl23
            dxx = tmp13 * tmp22
            while True:
                tmp12 += 1
                tmp23 += 1
                cur_prob *= dxx / (tmp12 * tmp23)
                tmp13 -= 1
                tmp22 -= 1
                if cur_prob <= EXACT_TEST_BIAS:
                    if cur_prob > (1 - 2 * FISHER_EPSILON) \
                            * EXACT_TEST_BIAS:
                        tie_box[0] += 1
                    tprob += cur_prob
                    break
                cprob += cur_prob
                if cprob == float("inf"):
                    return 0.0
                dxx = tmp13 * tmp22
                if not dxx > 0.5:
                    break
            savedr12 = tmp12
            savedr13 = tmp13
            savedr22 = tmp22
            savedr23 = tmp23
            base_probr = cur_prob
            while True:
                tmp12 += 1
                tmp23 += 1
                cur_prob *= (tmp13 * tmp22) / (tmp12 * tmp23)
                tmp13 -= 1
                tmp22 -= 1
                preaddp = tprob
                tprob += cur_prob
                if tprob <= preaddp:
                    break
            tmp12 = savedl12
            tmp13 = savedl13
            tmp22 = savedl22
            tmp23 = savedl23
            cur_prob = base_probl
            while True:
                tmp13 += 1
                tmp22 += 1
                cur_prob *= (tmp12 * tmp23) / (tmp13 * tmp22)
                tmp12 -= 1
                tmp23 -= 1
                preaddp = tprob
                tprob += cur_prob
                if tprob <= preaddp:
                    break
    row_prob = tprob + cprob
    orig = (base_probl, base_probr, row_prob, savedl12, savedl13,
            savedl22, savedl23, savedr12, savedr13, savedr22,
            savedr23)
    for dirn in range(2):
        cur11 = float(m11)
        cur21 = float(m21)
        if dirn:
            (base_probl, base_probr, row_prob, savedl12, savedl13,
             savedl22, savedl23, savedr12, savedr13, savedr22,
             savedr23) = orig
            ukk = m11
            if ukk > m22 + m23:
                ukk = m22 + m23
        else:
            ukk = m21
            if ukk > m12 + m13:
                ukk = m12 + m13
        ukk += 1
        broke = False
        while True:
            ukk -= 1
            if not ukk:
                break
            if dirn:
                cur21 += 1
                if savedl23:
                    savedl13 += 1
                    row_prob *= (cur11 * (savedl22 + savedl23)) \
                        / (cur21 * (savedl12 + savedl13))
                    base_probl *= (cur11 * savedl23) \
                        / (cur21 * savedl13)
                    savedl23 -= 1
                else:
                    savedl12 += 1
                    row_prob *= (cur11 * (savedl22 + savedl23)) \
                        / (cur21 * (savedl12 + savedl13))
                    base_probl *= (cur11 * savedl22) \
                        / (cur21 * savedl12)
                    savedl22 -= 1
                cur11 -= 1
            else:
                cur11 += 1
                if savedl12:
                    savedl22 += 1
                    row_prob *= (cur21 * (savedl12 + savedl13)) \
                        / (cur11 * (savedl22 + savedl23))
                    base_probl *= (cur21 * savedl12) \
                        / (cur11 * savedl22)
                    savedl12 -= 1
                else:
                    savedl23 += 1
                    row_prob *= (cur21 * (savedl12 + savedl13)) \
                        / (cur11 * (savedl22 + savedl23))
                    base_probl *= (cur21 * savedl13) \
                        / (cur11 * savedl23)
                    savedl13 -= 1
                cur21 -= 1
            stl = [base_probl, savedl12, savedl13, savedl22, savedl23]
            stop, dxx = _fisher23_tailsum(stl, tie_box, 0)
            base_probl, savedl12, savedl13, savedl22, savedl23 = stl
            if stop:
                broke = True
                break
            tprob += dxx
            if dirn:
                if savedr22:
                    savedr12 += 1
                    base_probr *= ((cur11 + 1) * savedr22) \
                        / (cur21 * savedr12)
                    savedr22 -= 1
                else:
                    savedr13 += 1
                    base_probr *= ((cur11 + 1) * savedr23) \
                        / (cur21 * savedr13)
                    savedr23 -= 1
            else:
                if savedr13:
                    savedr23 += 1
                    base_probr *= ((cur21 + 1) * savedr13) \
                        / (cur11 * savedr23)
                    savedr13 -= 1
                else:
                    savedr22 += 1
                    base_probr *= ((cur21 + 1) * savedr12) \
                        / (cur11 * savedr22)
                    savedr12 -= 1
            str_ = [base_probr, savedr12, savedr13, savedr22,
                    savedr23]
            _stop2, dyy = _fisher23_tailsum(str_, tie_box, 1)
            base_probr, savedr12, savedr13, savedr22, savedr23 = str_
            tprob += dyy
            cprob += row_prob - dxx - dyy
            if cprob == float("inf"):
                return 0.0
        if not broke:
            continue
        savedl12 += savedl13
        savedl22 += savedl23
        if dirn:
            while True:
                preaddp = tprob
                tprob += row_prob
                if tprob <= preaddp:
                    break
                cur21 += 1
                savedl12 += 1
                row_prob *= (cur11 * savedl22) \
                    / (cur21 * savedl12)
                cur11 -= 1
                savedl22 -= 1
        else:
            while True:
                preaddp = tprob
                tprob += row_prob
                if tprob <= preaddp:
                    break
                cur11 += 1
                savedl22 += 1
                row_prob *= (cur21 * savedl12) \
                    / (cur11 * savedl22)
                cur21 -= 1
                savedl12 -= 1
    if not midp:
        return tprob / (tprob + cprob)
    return (tprob - ((1 - FISHER_EPSILON) * EXACT_TEST_BIAS * 0.5)
            * tie_box[0]) / (tprob + cprob)
