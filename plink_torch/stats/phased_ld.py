"""Two-variant phased LD via exact haplotype-frequency ML (cubic roots).

Behavior reference: PhasedLD / EmPhaseUnscaledLnlike / CubicRealRoots
(2.0/plink2_ld.cc:4573-4760), the plink 1.9 em_phase_hethet lineage.

Parametrized in MAJOR-allele space: known diplotype half-frequencies
f_majmaj / f_majmin / f_minmaj / f_minmin plus the double-het share K.
The ML in-phase increment x solves
    (f_majmaj + x)(f_minmin + x)(K - x) = x (f_majmin + K - x)(f_minmaj + K - x)
with roots clipped to [0, K]; among in-range roots the one with the best
log-likelihood wins (ties -> lowest root, matching the reference's
ctz(best_lnlike_mask)).  r^2 = D^2 / (p_maj p_min q_maj q_min) with
D = f_majmaj + x - p_maj q_maj.
"""

from __future__ import annotations

import numpy as np

_K2M32 = 2.0 ** -32
_EPS = 2.0 ** -44


def _cubic_real_roots(a2: float, a1: float, a0: float) -> list[float]:
    """Real roots of x^3 + a2 x^2 + a1 x + a0, ascending (ref:
    CubicRealRoots, 2.0/include/plink2_stats.cc)."""
    r = np.roots([1.0, a2, a1, a0])
    out = sorted(float(z.real) for z in r if abs(z.imag) < 1e-9)
    if not out:
        out = [float(min(r, key=lambda z: abs(z.imag)).real)]
    return out


def _lnlike(fmm, fmn, fnm, fnn, k, x):
    """Unscaled lnlike (ref EmPhaseUnscaledLnlike)."""
    f11 = fmm + x
    f22 = fnn + x
    f12 = fmn + k - x
    f21 = fnm + k - x
    ll = 0.0
    if k != 0.0:
        prod = f11 * f22 + f12 * f21
        if prod <= 0:
            return -np.inf
        ll += k * np.log(prod)
    for cnt, f in ((fmm, f11), (fmn, f12), (fnm, f21), (fnn, f22)):
        if cnt != 0.0:
            if f <= 0:
                return -np.inf
            ll += cnt * np.log(f)
    return ll


def _lnlike_plink2(fmm, fmn, fnm, fnn, k, x):
    """Bit-faithful replica of EmPhaseUnscaledLnlike (2.0/plink2_ld.cc:4573),
    INCLUDING its 'lnlike += fma(freq11, log(adj11), lnlike)' doubling of the
    running sum when adj_freq11 != 0 -- this quirk decides which cubic root
    wins for ambiguous pairs, and --clump's member sets depend on it."""
    adj11 = fmm + x
    adj22 = fnn + x
    adj12 = fmn + k - x
    adj21 = fnm + k - x
    cross = adj11 * adj22 + adj12 * adj21
    ll = k * np.log(cross) if cross != 0.0 else 0.0
    if adj11 != 0.0:
        ll = ll + (fmm * np.log(adj11) + ll)
    if adj12 != 0.0:
        ll = fmn * np.log(adj12) + ll
    if adj21 != 0.0:
        ll = fnm * np.log(adj21) + ll
    if adj22 != 0.0:
        ll = fnn * np.log(adj22) + ll
    return ll


def phased_r2(
    nmaj1: float, nmaj2: float, known_dotprod: float, unknown_hethet: float,
    valid_obs: float, plink2_lnlike: bool = False,
) -> float:
    """Signed-r-capable phased r^2 for one pair.

    Inputs are in 'haplotype' units over the valid (both-nonmissing) samples:
    nmaj1/nmaj2 = major-allele counts, known_dotprod = maj-maj known
    diplotype count, unknown_hethet = double-het sample count.
    Returns r (signed, major-major orientation); nan when monomorphic.
    """
    twice_tot = 2.0 * valid_obs
    if twice_tot == 0:
        return np.nan
    r = 1.0 / twice_tot
    fmm = max(1.0 - (nmaj1 + nmaj2 - known_dotprod) * r, 0.0)
    fmn = (nmaj2 - known_dotprod - unknown_hethet) * r
    fnm = (nmaj1 - known_dotprod - unknown_hethet) * r
    fnn = known_dotprod * r
    k = unknown_hethet * r
    fmajx = fmm + fmn + k
    fminx = 1.0 - fmajx
    fxmaj = fmm + fnm + k
    fxmin = 1.0 - fxmaj
    if min(fmajx, fminx, fxmaj, fxmin) < _EPS * 0.125:
        return np.nan
    if k != 0.0:
        if (fmm * fnn != 0.0) or (fmn * fnm != 0.0):
            sols = _cubic_real_roots(
                0.5 * (fmm + fnn - fmn - fnm - 3 * k),
                0.5 * (fmm * fnn + fmn * fnm + k * (fmn + fnm - fmm - fnn + k)),
                -0.5 * k * fmm * fnn,
            )
            # clip to [0, K] the way the reference does
            while len(sols) > 1 and sols[-1] > k + _K2M32:
                sols.pop()
            if sols and sols[-1] > k - _K2M32:
                sols[-1] = k
            while len(sols) > 1 and sols[0] < -_K2M32:
                sols.pop(0)
            if sols[0] < _K2M32:
                sols[0] = 0.0
        else:
            sols = [0.0]
            nz_xx = fmm + fnn
            nz_xy = fmn + fnm
            if (nz_xx + 2.0 ** -35 < k + nz_xy) and (nz_xy + 2.0 ** -35 < k + nz_xx):
                sols += [(k + nz_xy - nz_xx) * 0.5, k]
            else:
                sols.append(k)
        best = sols[0]
        if len(sols) > 1:
            llfun = _lnlike_plink2 if plink2_lnlike else _lnlike
            best_ll = -np.inf
            for x in sols:
                ll = llfun(fmm, fmn, fnm, fnn, k, x)
                if ll > best_ll:
                    best_ll = ll
                    best = x
    else:
        best = 0.0
    dd = fmm + best - fmajx * fxmaj
    if abs(dd) < _EPS:
        dd = 0.0
    denom = fmajx * fxmaj * fminx * fxmin
    return dd / np.sqrt(denom) if denom > 0 else np.nan


def phased_ld_detail(
    nmaj1: float, nmaj2: float, known_dotprod: float, unknown_hethet: float,
    valid_obs: float,
):
    """All in-range haplotype solutions for the --ld console.

    Inputs like phased_r2 (minor 'nmaj' convention).  Returns
    (solutions, best_idx, freqs) where each solution is a dict with
    x, r2, dprime, d and the four ML haplotype freqs (major-major first),
    and freqs holds (fmajx, fxmaj) plus the LE expectations.
    """
    twice_tot = 2.0 * valid_obs
    if twice_tot == 0:
        return [], -1, None
    r = 1.0 / twice_tot
    fmm = max(1.0 - (nmaj1 + nmaj2 - known_dotprod) * r, 0.0)
    fmn = (nmaj2 - known_dotprod - unknown_hethet) * r
    fnm = (nmaj1 - known_dotprod - unknown_hethet) * r
    fnn = known_dotprod * r
    k = unknown_hethet * r
    fmajx = fmm + fmn + k
    fminx = 1.0 - fmajx
    fxmaj = fmm + fnm + k
    fxmin = 1.0 - fxmaj
    if min(fmajx, fminx, fxmaj, fxmin) < _EPS * 0.125:
        return [], -1, None
    if k != 0.0:
        if (fmm * fnn != 0.0) or (fmn * fnm != 0.0):
            sols = _cubic_real_roots(
                0.5 * (fmm + fnn - fmn - fnm - 3 * k),
                0.5 * (fmm * fnn + fmn * fnm + k * (fmn + fnm - fmm - fnn + k)),
                -0.5 * k * fmm * fnn,
            )
            while len(sols) > 1 and sols[-1] > k + _K2M32:
                sols.pop()
            if sols and sols[-1] > k - _K2M32:
                sols[-1] = k
            while len(sols) > 1 and sols[0] < -_K2M32:
                sols.pop(0)
            if sols[0] < _K2M32:
                sols[0] = 0.0
        else:
            sols = [0.0]
            nz_xx = fmm + fnn
            nz_xy = fmn + fnm
            if (nz_xx + 2.0 ** -35 < k + nz_xy) and (nz_xy + 2.0 ** -35 < k + nz_xx):
                sols += [(k + nz_xy - nz_xx) * 0.5, k]
            else:
                sols.append(k)
    else:
        sols = [0.0]
    best_idx = 0
    if len(sols) > 1:
        best_ll = -np.inf
        for si, x in enumerate(sols):
            ll = _lnlike(fmm, fmn, fnm, fnn, k, x)
            if ll > best_ll:
                best_ll = ll
                best_idx = si
    out = []
    denom = fmajx * fxmaj * fminx * fxmin
    for x in sols:
        dd = fmm + x - fmajx * fxmaj
        if abs(dd) < _EPS:
            dd = 0.0
        if dd >= 0:
            dprime = dd / min(fxmaj * fminx, fxmin * fmajx)
        else:
            dprime = dd / min(fxmaj * fmajx, fxmin * fminx)
        out.append({
            "x": x,
            "d": dd,
            "r2": dd * dd / denom if denom > 0 else np.nan,
            "dprime": dprime,
            "freq_mm": fmm + x,
            "freq_mn": fmn + k - x,
            "freq_nm": fnm + k - x,
            "freq_nn": fnn + x,
        })
    exp = {
        "mm": fmajx * fxmaj, "mn": fmajx * fxmin,
        "nm": fminx * fxmaj, "nn": fminx * fxmin,
    }
    return out, best_idx, exp
