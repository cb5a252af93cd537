"""Comparison rules for the relationship outputs (KING, GRM, .rel, PCA), and
the f64 logistic / Firth reference fit of the GLM checks.

One place for the rules that the CPU tests (plink_torch against plink_tpu)
and chip_smoke.py (the card against the CPU) hold two runs' files to:
- .grm.bin (and its --parallel pieces): f32 entries within GRM_BIN_ATOL
  absolute (f32 sums taken in another order);
- .grm: the i / j / count columns exact, the value within `text_rtol` of
  max(|ref|, text_floor);
- .rel: every value within `text_rtol` of max(|ref|, text_floor);
- .eigenval: within EIG_TOL relative; .eigenvec: the header and the ids
  exact, each column within EIG_TOL after matching its sign;
- .eigenvec.allele: the header and the variant / allele columns exact, each
  PC column within EIG_TOL absolute after matching its sign;
- everything else (.kin0, .king*, id files, cutoff lists, .grm.N.bin):
  byte-identical.
"""

from __future__ import annotations

import filecmp
import re

import numpy as np

GRM_BIN_ATOL = 2e-6
EIG_TOL = 1e-4


def close_floats(ref, got, rtol: float, floor: float = 1e-30) -> bool:
    """Same shape, and |got - ref| <= rtol * max(|ref|, floor) everywhere."""
    a, b = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return a.shape == b.shape and bool(
        (np.abs(a - b) <= rtol * np.maximum(np.abs(a), floor)).all())


def _rows(path):
    with open(path) as f:
        return [ln.split() for ln in f]


def relationship_output_close(ext: str, ref: str, got: str,
                              text_rtol: float = 1e-5,
                              text_floor: float = 1e-30) -> bool:
    """Whether output file `got` matches `ref` under the rules above; `ext`
    names the kind (a --parallel piece's ".<k>" suffix is ignored)."""
    kind = re.sub(r"\.\d+$", "", ext)
    if kind == ".grm.bin":
        a, b = np.fromfile(ref, np.float32), np.fromfile(got, np.float32)
        return a.size == b.size > 0 and float(np.abs(a - b).max()) <= GRM_BIN_ATOL
    if kind == ".grm":
        ra, rb = _rows(ref), _rows(got)
        return ([r[:3] for r in ra] == [r[:3] for r in rb]
                and close_floats([r[3] for r in ra], [r[3] for r in rb],
                                 text_rtol, text_floor))
    if kind == ".rel":
        ra, rb = _rows(ref), _rows(got)
        return ([len(r) for r in ra] == [len(r) for r in rb]
                and close_floats(sum(ra, []), sum(rb, []), text_rtol, text_floor))
    if kind == ".eigenval":
        return close_floats(np.loadtxt(ref), np.loadtxt(got), EIG_TOL)
    if kind in (".eigenvec", ".eigenvec.allele"):
        ra, rb = _rows(ref), _rows(got)
        k = 1 if kind == ".eigenvec" else len(ra[0]) - sum(
            c.startswith("PC") for c in ra[0])
        if ra[0] != rb[0] or [r[:k] for r in ra] != [r[:k] for r in rb]:
            return False
        a = np.array([r[k:] for r in ra[1:]], np.float64)
        b = np.array([r[k:] for r in rb[1:]], np.float64)
        if a.shape != b.shape:
            return False
        b = b * np.sign((a * b).sum(axis=0))
        return float(np.abs(a - b).max()) <= EIG_TOL
    return filecmp.cmp(ref, got, shallow=False)


def f64_logit(X, y, off=0.0, firth=False, slack=None):
    """plink2's logistic (LogisticRegressionD: OLS start on 4.8639 (y - 0.5),
    Newton steps until |dll| < 1e-8 (0.05 + |ll|), SE from the Hessian of
    the last solve) or Firth regression (FirthRegressionD: from 0, steps
    capped at 5, stop when the step, the score and the penalised loglik
    change are all below 1e-5, SE from the last step's second-weight
    Hessian), in numpy f64 from those rules, with a fixed offset `off`.
    Returns (beta, SE, the covariance the SE come from, converged).

    The reported numbers depend on where the rules stop: a loglik change
    under the threshold stops one iteration before the fit has settled, and
    the SE then comes from the previous iterate's Hessian (2e-4 relative on
    a variant with 40 carriers).  An f32 fit sums per-sample loglik terms
    that each carry f32 rounding, ~1e-7 |ll| in all against the 1e-8 |ll|
    threshold, so it can stop one iteration before or after the f64 fit.
    With `slack`, the function returns the list of every (beta, SE,
    covariance) such a fit can report: plink2's own stop first, then the
    stops at the earlier iterates whose tested quantities were within
    `slack` times their thresholds, then the stop one iteration later."""
    sign = 1.0 - 2.0 * (y != 0)  # ll_s = -log(1 + exp(-eta)) for a case, eta -> -eta else

    def terms(b):
        eta = X @ b + off
        p = 1.0 / (1.0 + np.exp(-eta))
        return p, p * (1.0 - p), -float(np.logaddexp(0, sign * eta).sum())

    # per iterate: (beta, hinv, the tested quantities over their thresholds)
    its = []
    if firth:
        b, pll_old, dmax = np.zeros(X.shape[1]), 0.0, 0.0
        for it in range(27):
            p, w, ll = terms(b)
            H = (X.T * w) @ X
            h = w * ((X @ np.linalg.inv(H)) * X).sum(axis=1)
            u = X.T @ (y - p + h * (0.5 - p))
            pll = ll + 0.5 * np.linalg.slogdet(H)[1]
            if it:
                its.append((b, hinv, max(dmax, np.abs(u).max(),
                                         pll - pll_old) / 1e-5))
                if its[-1][2] < 1.0:
                    break
            pll_old = pll
            hinv = np.linalg.inv((X.T * ((1.0 + h) * w)) @ X)
            step = hinv @ u
            dmax = np.abs(step).max()
            step *= min(1.0, 5.0 / max(dmax, 1e-300))
            dmax = min(dmax, 5.0)
            b = b + step
        conv = its[-1][2] < 1.0
        if not conv:  # what the last step reached
            its.append((b, hinv, np.inf))
        elif slack is not None:  # the stop one iteration later
            hinv = np.linalg.inv((X.T * ((1.0 + h) * w)) @ X)
            its.append((b + hinv @ u, hinv, 0.0))
    else:
        b = np.linalg.solve(X.T @ X, X.T @ (4.863891244002886 * (y - 0.5)))
        p, w, ll_old = terms(b)
        for _ in range(24):
            hinv = np.linalg.inv((X.T * w) @ X)
            b = b - hinv @ (X.T @ (p - y))
            p, w, ll = terms(b)
            its.append((b, hinv, abs(ll - ll_old) / (1e-8 * (0.05 + abs(ll)))))
            if its[-1][2] < 1.0:
                break
            ll_old = ll
        conv = its[-1][2] < 1.0
        if conv and slack is not None:  # the stop one iteration later
            hinv = np.linalg.inv((X.T * w) @ X)
            its.append((b - hinv @ (X.T @ (p - y)), hinv, 0.0))
    k = next((i for i, t in enumerate(its) if t[2] < 1.0), len(its) - 1)
    if slack is None:
        b, hinv = its[k][:2]
        return b, np.sqrt(np.diag(hinv)), hinv, conv
    pick = [k] + [i for i in range(k) if its[i][2] < slack]
    if conv:
        pick.append(k + 1)
    return [(its[i][0], np.sqrt(np.diag(its[i][1])), its[i][1]) for i in pick]
