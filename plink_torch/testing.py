"""Comparison rules for the relationship outputs (KING, GRM, .rel, PCA), the
--glm permutation reports and the --adjust report, and the f64 logistic /
Firth reference fit of the GLM checks.

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
- .mperm / .aperm: every column but EMP1 / EMP2 / PERM_CT (EMP1_CT /
  EMP2_CT with 'perm-count') byte-identical; those byte-identical in at
  least PERM_SAME_FRAC of the rows and within 3 / (N + 1) (3 counts)
  elsewhere (`perm_report_close`);
- .adjusted: the same rows (#CHROM ID A1), each p-value within
  ADJUST_RTOL relative, in the same order but where two rows' UNADJ are
  within it (`adjusted_close`);
- everything else (.kin0, .king*, id files, cutoff lists, .grm.N.bin):
  byte-identical.

Both packages (and the card and the CPU) permute the phenotype with the
same numpy stream, so a permutation report can differ only where an f32
permuted statistic sits within its rounding of the original one: the
count of that variant moves by one.
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


PERM_SAME_FRAC = 0.98
ADJUST_RTOL = 1e-3  # the GLM report's P rule (bench.py)
_EMP_COLS = ("EMP1", "EMP2", "PERM_CT", "EMP1_CT", "EMP2_CT")


def perm_report_close(ref: str, got: str, n_perm: int):
    """(whether permutation report `got` matches `ref` by the rule above,
    the fraction of rows whose EMP columns are byte-identical)."""
    ra, rb = _rows(ref), _rows(got)
    if not ra or ra[0] != rb[0] or len(ra) != len(rb):
        return False, 0.0
    emp = [i for i, c in enumerate(ra[0]) if c.lstrip("#") in _EMP_COLS]
    same = 0
    for a, b in zip(ra[1:], rb[1:]):
        if [x for i, x in enumerate(a) if i not in emp] != \
                [x for i, x in enumerate(b) if i not in emp]:
            return False, 0.0
        if all(a[i] == b[i] for i in emp):
            same += 1
            continue
        for i in emp:
            if "NA" in (a[i], b[i]):
                if a[i] != b[i]:
                    return False, 0.0
                continue
            col = ra[0][i]
            lim = 3.0 if col.endswith("_CT") else 3.0 / (n_perm + 1)
            if abs(float(a[i]) - float(b[i])) > lim + 1e-12:
                return False, 0.0
    frac = same / max(len(ra) - 1, 1)
    return frac >= PERM_SAME_FRAC, frac


def adjusted_close(ref: str, got: str, rtol: float = ADJUST_RTOL) -> bool:
    """Whether --adjust report `got` matches `ref` by the rule above."""
    ra, rb = _rows(ref), _rows(got)
    if not ra or ra[0] != rb[0] or len(ra) != len(rb):
        return False
    key = {tuple(r[:3]): r for r in ra[1:]}
    if set(key) != {tuple(r[:3]) for r in rb[1:]}:
        return False

    def pvals(r):
        return np.array([np.inf if x == "INF" else float(x) for x in r[3:]])

    for b in rb[1:]:
        if not close_floats(pvals(key[tuple(b[:3])]), pvals(b), rtol):
            return False
    unadj = {k: float(r[3]) for k, r in key.items()}
    for a, b in zip(ra[1:], rb[1:]):  # order: swaps only between near-ties
        ua, ub = unadj[tuple(a[:3])], unadj[tuple(b[:3])]
        if a[:3] != b[:3] and abs(ua - ub) > rtol * max(ua, ub):
            return False
    return True


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
