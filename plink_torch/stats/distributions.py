"""Ln-space distribution functions (host, float64 numpy).

Self-contained replacements for the reference's plink2_stats
(2.0/include/plink2_stats.{h,cc}): chi-square / t / F / normal survival
functions computed in log space so that extreme associations keep precision
far below DBL_MIN (the reference distinguishes 1e-325 from 1e-1000000;
2.0/README.md:96-100).  Implementations are the classic series /
continued-fraction algorithms for the incomplete gamma and beta functions,
written directly in vectorized numpy and carried in log space.

These run on host CPU: they are O(variants) postprocessing of device-side
test statistics, not a device bottleneck.
"""

from __future__ import annotations

import numpy as np

# Lanczos approximation, g=7, n=9 (double-precision accurate to ~1e-15).
_LANCZOS_G = 7.0
_LANCZOS = np.array(
    [
        0.99999999999980993,
        676.5203681218851,
        -1259.1392167224028,
        771.32342877765313,
        -176.61502916214059,
        12.507343278686905,
        -0.13857109526572012,
        9.9843695780195716e-6,
        1.5056327351493116e-7,
    ]
)
_LN_SQRT_2PI = 0.9189385332046727


def gammaln(x):
    """log|Gamma(x)| for x > 0, vectorized."""
    x = np.asarray(x, dtype=np.float64)
    out = np.empty_like(x)
    small = x < 0.5
    # Reflection for x < 0.5: Gamma(x) Gamma(1-x) = pi / sin(pi x)
    xs = np.where(small, 1.0 - x, x)
    z = xs - 1.0
    series = np.full_like(xs, _LANCZOS[0])
    for i in range(1, 9):
        series = series + _LANCZOS[i] / (z + i)
    t = z + _LANCZOS_G + 0.5
    lg = _LN_SQRT_2PI + (z + 0.5) * np.log(t) - t + np.log(series)
    if small.any():
        refl = np.log(np.pi / np.abs(np.sin(np.pi * x)))
        out = np.where(small, refl - lg, lg)
    else:
        out = lg
    return out


def _log1mexp(logp):
    """log(1 - exp(logp)) for logp <= 0, numerically stable."""
    logp = np.minimum(logp, -1e-300)
    return np.where(
        logp > -0.693147,  # ln 2
        np.log(-np.expm1(logp)),
        np.log1p(-np.exp(logp)),
    )


# ---------------------------------------------------------------------------
# Incomplete gamma: P(a,x) series, Q(a,x) continued fraction; both in log.
# ---------------------------------------------------------------------------

_MAX_ITER = 400


def _log_gamma_p_series(a, x):
    """log P(a,x) by the power series (valid/accurate for x < a + 1)."""
    # P(a,x) = x^a e^-x / Gamma(a) * sum_{n>=0} x^n / (a (a+1) ... (a+n))
    ap = a.copy()
    term = 1.0 / a
    total = term.copy()
    for _ in range(_MAX_ITER):
        ap = ap + 1.0
        term = term * x / ap
        total = total + term
        if np.all(np.abs(term) < np.abs(total) * 1e-17):
            break
    with np.errstate(divide="ignore"):
        return a * np.log(x) - x - gammaln(a) + np.log(total)


def _log_gamma_q_cf(a, x):
    """log Q(a,x) by modified Lentz continued fraction (for x >= a + 1)."""
    tiny = 1e-300
    b = x + 1.0 - a
    c = np.full_like(x, 1.0 / tiny)
    d = 1.0 / np.maximum(b, tiny)
    h = d.copy()
    for i in range(1, _MAX_ITER):
        an = -i * (i - a)
        b = b + 2.0
        d = an * d + b
        d = np.where(np.abs(d) < tiny, tiny, d)
        c = b + an / c
        c = np.where(np.abs(c) < tiny, tiny, c)
        d = 1.0 / d
        delta = d * c
        h = h * delta
        if np.all(np.abs(delta - 1.0) < 1e-16):
            break
    with np.errstate(divide="ignore"):
        return a * np.log(x) - x - gammaln(a) + np.log(h)


def log_igammaq(a, x):
    """log of regularized upper incomplete gamma Q(a, x), vectorized."""
    a = np.asarray(a, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    a, x = np.broadcast_arrays(a, x)
    a = a.astype(np.float64).copy()
    x = x.astype(np.float64).copy()
    out = np.zeros_like(x)
    zero = x <= 0
    use_cf = (x >= a + 1.0) & ~zero
    use_series = ~use_cf & ~zero
    if use_cf.any():
        out[use_cf] = _log_gamma_q_cf(a[use_cf], x[use_cf])
    if use_series.any():
        logp = _log_gamma_p_series(a[use_series], x[use_series])
        out[use_series] = _log1mexp(np.minimum(logp, 0.0))
    out[zero] = 0.0
    return out


def chisq_logsf(x, df):
    """ln P(Chi2_df > x)."""
    return log_igammaq(np.asarray(df, dtype=np.float64) / 2.0, np.asarray(x, dtype=np.float64) / 2.0)


def chisq_sf(x, df):
    return np.exp(chisq_logsf(x, df))


# ---------------------------------------------------------------------------
# Incomplete beta (log space) for t / F distributions.
# ---------------------------------------------------------------------------


def _betacf(a, b, x):
    """Continued fraction for incomplete beta (Numerical-Recipes-style Lentz)."""
    tiny = 1e-300
    qab = a + b
    qap = a + 1.0
    qam = a - 1.0
    c = np.ones_like(x)
    d = 1.0 - qab * x / qap
    d = np.where(np.abs(d) < tiny, tiny, d)
    d = 1.0 / d
    h = d.copy()
    for m in range(1, _MAX_ITER):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        d = np.where(np.abs(d) < tiny, tiny, d)
        c = 1.0 + aa / c
        c = np.where(np.abs(c) < tiny, tiny, c)
        d = 1.0 / d
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        d = np.where(np.abs(d) < tiny, tiny, d)
        c = 1.0 + aa / c
        c = np.where(np.abs(c) < tiny, tiny, c)
        d = 1.0 / d
        delta = d * c
        h = h * delta
        if np.all(np.abs(delta - 1.0) < 1e-16):
            break
    return h


def log_betainc(a, b, x):
    """log of regularized incomplete beta I_x(a, b), vectorized."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    a, b, x = (v.copy() for v in np.broadcast_arrays(a, b, x))
    out = np.full_like(x, -np.inf)
    one = x >= 1.0
    zero = x <= 0.0
    mid = ~one & ~zero
    out[one] = 0.0
    if mid.any():
        am, bm, xm = a[mid], b[mid], x[mid]
        direct = xm < (am + 1.0) / (am + bm + 2.0)
        lbeta = gammaln(am) + gammaln(bm) - gammaln(am + bm)
        with np.errstate(divide="ignore"):
            front = am * np.log(xm) + bm * np.log1p(-xm) - lbeta
        res = np.empty_like(xm)
        if direct.any():
            cf = _betacf(am[direct], bm[direct], xm[direct])
            res[direct] = front[direct] - np.log(am[direct]) + np.log(cf)
        indirect = ~direct
        if indirect.any():
            # I_x(a,b) = 1 - I_{1-x}(b,a)
            cf = _betacf(bm[indirect], am[indirect], 1.0 - xm[indirect])
            front_i = (
                bm[indirect] * np.log1p(-xm[indirect])
                + am[indirect] * np.log(xm[indirect])
                - (gammaln(am[indirect]) + gammaln(bm[indirect]) - gammaln(am[indirect] + bm[indirect]))
            )
            log_other = front_i - np.log(bm[indirect]) + np.log(cf)
            res[indirect] = _log1mexp(np.minimum(log_other, -1e-300))
        out[mid] = res
    return out


def t_logsf(t, df):
    """ln P(T_df > t) (one-sided)."""
    t = np.asarray(t, dtype=np.float64)
    df = np.asarray(df, dtype=np.float64)
    t, df = np.broadcast_arrays(t, df)
    x = df / (df + t * t)
    log_half_ibeta = np.log(0.5) + log_betainc(df / 2.0, 0.5, x)
    # For t >= 0: sf = 0.5 * I_x(df/2, 1/2); for t < 0: sf = 1 - that.
    return np.where(t >= 0, log_half_ibeta, _log1mexp(np.minimum(log_half_ibeta, -1e-300)))


def t_logp_2sided(t, df):
    """ln of two-sided t-test p-value: P(|T| > |t|) = I_x(df/2, 1/2)."""
    t = np.asarray(t, dtype=np.float64)
    df = np.asarray(df, dtype=np.float64)
    x = df / (df + t * t)
    return log_betainc(df / 2.0, 0.5, x)


def f_logsf(f, d1, d2):
    """ln P(F_{d1,d2} > f)."""
    f = np.asarray(f, dtype=np.float64)
    d1 = np.asarray(d1, dtype=np.float64)
    d2 = np.asarray(d2, dtype=np.float64)
    x = d2 / (d2 + d1 * f)
    return log_betainc(d2 / 2.0, d1 / 2.0, x)


def normal_logsf(z):
    """ln P(Z > z) for standard normal, via the chi-square relation."""
    z = np.asarray(z, dtype=np.float64)
    log_half_q = np.log(0.5) + chisq_logsf(z * z, 1.0)
    return np.where(z >= 0, log_half_q, _log1mexp(np.minimum(log_half_q, -1e-300)))


def zstat_logp_2sided(z):
    """ln of two-sided normal p-value: P(|Z| > |z|) = Q_chi2(z^2, 1)."""
    z = np.asarray(z, dtype=np.float64)
    return chisq_logsf(z * z, 1.0)


def norm_ppf(q):
    """Inverse standard-normal CDF (QuantileToZscore equivalent,
    2.0/include/plink2_stats.cc)."""
    from scipy.special import ndtri

    return ndtri(q)
