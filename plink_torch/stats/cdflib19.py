"""Exact ports of the dcdflib routines PLINK 1.9 relies on where
last-ulp agreement matters.

inverse_chiprob1(q) replicates inverse_chiprob(q, 1)
(1.9/plink_stats.c:42 -> dcdflib cdfchi which=2 with df=1): the dinvr
bracketing search + dzror zero-finder (dcdflib.c:6013-7000) driven by
cumchi(x,1) = gratio(0.5, x/2) evaluated through the NSWC erf1/erfc1
rational approximations (dcdflib.c:7138-7310, 8595-8615).  Every
floating-point operation follows the reference's order so the iterates,
and therefore the returned root, are bit-identical.
"""

from __future__ import annotations

import math

_SPMPAR1 = 2.220446049250313e-16   # 2^-52, spmpar(1)

_ERF_A = (.771058495001320e-04, -.133733772997339e-02,
          .323076579225834e-01, .479137145607681e-01,
          .128379167095513e+00)
_ERF_B = (.301048631703895e-02, .538971687740286e-01,
          .375795757275549e+00)
_ERF_P = (-1.36864857382717e-07, 5.64195517478974e-01,
          7.21175825088309e+00, 4.31622272220567e+01,
          1.52989285046940e+02, 3.39320816734344e+02,
          4.51918953711873e+02, 3.00459261020162e+02)
_ERF_Q = (1.00000000000000e+00, 1.27827273196294e+01,
          7.70001529352295e+01, 2.77585444743988e+02,
          6.38980264465631e+02, 9.31354094850610e+02,
          7.90950925327898e+02, 3.00459260956983e+02)
_ERF_R = (2.10144126479064e+00, 2.62370141675169e+01,
          2.13688200555087e+01, 4.65807828718470e+00,
          2.82094791773523e-01)
_ERF_S = (9.41537750555460e+01, 1.87114811799590e+02,
          9.90191814623914e+01, 1.80124575948747e+01)
_ERF_C = .564189583547756e0
# exparg(1) = largest w with exp(w) representable (dcdflib exparg)
_EXPARG1 = 0.99999 * (1024 * math.log(2.0))


def erf1(x):
    a, b, p, q, r, s = (_ERF_A, _ERF_B, _ERF_P, _ERF_Q, _ERF_R,
                        _ERF_S)
    ax = abs(x)
    if ax <= 0.5:
        t = x * x
        top = ((((a[0] * t + a[1]) * t + a[2]) * t + a[3]) * t
               + a[4] + 1.0)
        bot = ((b[0] * t + b[1]) * t + b[2]) * t + 1.0
        return x * (top / bot)
    if ax <= 4.0:
        top = ((((((p[0] * ax + p[1]) * ax + p[2]) * ax + p[3]) * ax
                 + p[4]) * ax + p[5]) * ax + p[6]) * ax + p[7]
        bot = ((((((q[0] * ax + q[1]) * ax + q[2]) * ax + q[3]) * ax
                 + q[4]) * ax + q[5]) * ax + q[6]) * ax + q[7]
        v = 0.5 + (0.5 - math.exp(-(x * x)) * top / bot)
        return -v if x < 0.0 else v
    if ax < 5.8:
        x2 = x * x
        t = 1.0 / x2
        top = (((r[0] * t + r[1]) * t + r[2]) * t + r[3]) * t + r[4]
        bot = (((s[0] * t + s[1]) * t + s[2]) * t + s[3]) * t + 1.0
        v = (_ERF_C - top / (x2 * bot)) / ax
        v = 0.5 + (0.5 - math.exp(-x2) * v)
        return -v if x < 0.0 else v
    return math.copysign(1.0, x)


def erfc1(ind, x):
    a, b, p, q, r, s = (_ERF_A, _ERF_B, _ERF_P, _ERF_Q, _ERF_R,
                        _ERF_S)
    ax = abs(x)
    if ax <= 0.5:
        t = x * x
        top = ((((a[0] * t + a[1]) * t + a[2]) * t + a[3]) * t
               + a[4] + 1.0)
        bot = ((b[0] * t + b[1]) * t + b[2]) * t + 1.0
        v = 0.5 + (0.5 - x * (top / bot))
        if ind != 0:
            v = math.exp(t) * v
        return v
    if ax <= 4.0:
        top = ((((((p[0] * ax + p[1]) * ax + p[2]) * ax + p[3]) * ax
                 + p[4]) * ax + p[5]) * ax + p[6]) * ax + p[7]
        bot = ((((((q[0] * ax + q[1]) * ax + q[2]) * ax + q[3]) * ax
                 + q[4]) * ax + q[5]) * ax + q[6]) * ax + q[7]
        v = top / bot
    else:
        if x <= -5.6:
            return 2.0 if ind == 0 else 2.0 * math.exp(x * x)
        if ind == 0 and (x > 100.0 or x * x > _EXPARG1):
            return 0.0
        t = math.pow(1.0 / x, 2.0)
        top = (((r[0] * t + r[1]) * t + r[2]) * t + r[3]) * t + r[4]
        bot = (((s[0] * t + s[1]) * t + s[2]) * t + s[3]) * t + 1.0
        v = (_ERF_C - t * top / bot) / ax
    if ind != 0:
        if x < 0.0:
            v = 2.0 * math.exp(x * x) - v
        return v
    w = x * x
    t = w
    e = w - t
    v = (0.5 + (0.5 - e)) * math.exp(-t) * v
    if x < 0.0:
        v = 2.0 - v
    return v


def _gratio_half(x):
    """gratio(a=0.5, x, ind=0) -> (ans, qans) (dcdflib.c S390)."""
    if x == 0.0:
        # a*x == 0, x <= a branch
        return 0.0, 1.0
    if x < 0.25:
        ans = erf1(math.sqrt(x))
        return ans, 0.5 + (0.5 - ans)
    qans = erfc1(0, math.sqrt(x))
    return 0.5 + (0.5 - qans), qans


def cumchi1(x):
    """cumchi(x, df=1) -> (cum, ccum)."""
    xx = 0.5 * x
    if xx <= 0.0:
        return 0.0, 1.0
    return _gratio_half(xx)


def inverse_chiprob1(qq):
    """inverse_chiprob(qq, 1): bit-exact cdfchi(which=2)."""
    if qq >= 1.0:
        return 0.0
    pp = 1 - qq
    if qq <= 0.0:
        return -9.0
    qporq = pp <= qq
    porq = pp if qporq else qq

    def f(x):
        cum, ccum = cumchi1(x)
        return (cum - pp) if qporq else (ccum - qq)

    small = 0.0
    big = 1.0e300
    absstp = 0.5
    relstp = 0.5
    stpmul = 5.0
    abstol = 1.0e-50
    reltol = 1.0e-8
    xsave = 5.0
    fsmall = f(small)
    fbig = f(big)
    qincr = fbig > fsmall
    if qincr:
        if fsmall > 0.0:
            return -9.0
        if fbig < 0.0:
            return -9.0
    else:
        if fsmall < 0.0:
            return -9.0
        if fbig > 0.0:
            return -9.0
    x = xsave
    step = max(absstp, relstp * abs(x))
    yy = f(x)
    if yy == 0.0:
        return x
    qup = (qincr and yy < 0.0) or ((not qincr) and yy > 0.0)
    if qup:
        xlb = xsave
        xub = min(xlb + step, big)
        while True:
            yy = f(xub)
            qbdd = (qincr and yy >= 0.0) \
                or ((not qincr) and yy <= 0.0)
            qlim = xub >= big
            if qbdd or qlim:
                break
            step = stpmul * step
            xlb = xub
            xub = min(xlb + step, big)
        if qlim and not qbdd:
            return -9.0
    else:
        xub = xsave
        xlb = max(xub - step, small)
        while True:
            yy = f(xlb)
            qbdd = (qincr and yy <= 0.0) \
                or ((not qincr) and yy >= 0.0)
            qlim = xlb <= small
            if qbdd or qlim:
                break
            step = stpmul * step
            xub = xlb
            xlb = max(xub - step, small)
        if qlim and not qbdd:
            return -9.0

    # ---- dzror (dcdflib E0001) ----
    def ftol(zx):
        return 0.5 * max(abstol, reltol * abs(zx))

    xlo = xlb
    xhi = xub
    b = xlo
    fb = f(b)
    xlo = xhi
    a = xlo
    fx = f(a)
    if fb < 0.0 and fx < 0.0:
        return -9.0
    if fb > 0.0 and fx > 0.0:
        return -9.0
    fa = fx
    first = True
    d = 0.0
    fd = 0.0
    while True:
        # S70
        c = a
        fc = fa
        ext = 0
        while True:
            # S80
            if abs(fc) < abs(fb):
                if c != a:
                    d = a
                    fd = fa
                a = b
                fa = fb
                xlo = c
                b = xlo
                fb = fc
                c = a
                fc = fa
            # S100
            tol = ftol(xlo)
            m = (c + b) * 0.5
            mb = m - b
            if not (abs(mb) > tol):
                # S240
                return xlo
            if ext > 3:
                w = mb
            else:
                tol = math.copysign(tol, mb)
                p = (b - a) * fb
                if first:
                    q = fa - fb
                    first = False
                else:
                    fdb = (fd - fb) / (d - b)
                    fda = (fd - fa) / (d - a)
                    p = fda * p
                    q = fdb * fa - fda * fb
                if p < 0.0:
                    p = -p
                    q = -q
                if ext == 3:
                    p *= 2.0
                if p * 1.0 == 0.0 or p <= q * tol:
                    w = tol
                elif p < mb * q:
                    w = p / q
                else:
                    w = mb
            # S170
            d = a
            fd = fa
            a = b
            fa = fb
            b += w
            xlo = b
            fb = f(xlo)
            if fc * fb >= 0.0:
                break       # back to S70
            if w == mb:
                ext = 0
            else:
                ext += 1
