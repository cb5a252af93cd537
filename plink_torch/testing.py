"""Comparison rules for the relationship outputs (KING, GRM, .rel, PCA), the
--glm permutation reports and the --adjust report, the f64 logistic /
Firth reference fit of the GLM checks, the sample reports' cases and
their inputs (SR_RUNS, write_sample_report_inputs), and the pair-count
commands' cases, inputs and rules (PD_RUNS, write_pair_report_inputs,
pair_output_same, pair_log_lines).

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
                and close_floats([x for r in ra for x in r], [x for r in rb for x in r],
                                 text_rtol, text_floor))
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


# ---------------------------------------------------------------------------
# The sample reports' cases: tests/test_torch_sample_reports.py runs them on
# the CPU against plink_tpu, chip_smoke.py's phase 17f on the card against
# the CPU.  Filesets: p (a hard-call panel), sx (its chr1/X/Y/MT copy with
# SR_ALLELES), dp (a dosage panel), fam (p with all but 40 samples
# nonfounders), tiny (40 samples: the guard's fewer than 50 samples).
# `{d}` stands for the directory of write_sample_report_inputs's files.
# ---------------------------------------------------------------------------

SR_CHECK = ["max-female-xf=0.1", "min-male-xf=0.05", "max-female-yrate=0.45",
            "min-male-yrate=0.4"]
# run: (fileset, flags, reports that must be byte-identical)
SR_RUNS = {
    "het": ("p", ["--het", "--sample-counts"], (".het", ".scount")),
    "het_small": ("p", ["--het", "small-sample"], (".het",)),
    "scount": ("sx", ["--sample-counts"], (".scount",)),
    "check_sex": ("sx", ["--check-sex", *SR_CHECK, "cols=+ycount,+yobs"],
                  (".sexcheck",)),
    "check_default": ("sx", ["--check-sex"], (".sexcheck",)),
    # --het runs before --impute-sex (plink_tpu's order), --variant-score and
    # --score after it, on the imputed sexes
    "impute": ("sx", ["--impute-sex", "max-female-xf=0.02", "min-male-xf=0.02",
                      "--het", "--variant-score", "{d}/vs.txt",
                      "--xchr-model", "1", "--score", "{d}/s.txt", "header"],
               (".sexcheck", ".het", ".vscore", ".sscore")),
    "score": ("p", ["--score", "{d}/s.txt", "1", "2", "3", "header-read",
                    "list-variants", "--score-col-nums", "3-5"],
              (".sscore", ".sscore.vars")),
    "score_center": ("p", ["--score", "{d}/s.txt", "header", "center",
                           "no-mean-imputation"], (".sscore",)),
    "score_vstd": ("p", ["--score", "{d}/s.txt", "header", "variance-standardize",
                         "--score-col-nums", "3,5"], (".sscore",)),
    "score_dominant": ("p", ["--score", "{d}/s.txt", "header", "dominant"],
                       (".sscore",)),
    "score_recessive": ("p", ["--score", "{d}/s.txt", "header", "recessive",
                              "no-mean-imputation"], (".sscore",)),
    "score_list": ("p", ["--score-list", "{d}/list.txt", "1", "2", "3", "header",
                         "--score-col-nums", "3-4"], (".sscore",)),
    "q_score_range": ("p", ["--score", "{d}/s.txt", "header", "--q-score-range",
                            "{d}/ranges.txt", "{d}/pvals.txt"],
                      (".low.sscore", ".mid.sscore", ".all.sscore")),
    "read_freq": ("p", ["--read-freq", "{d}/moved.afreq", "--score", "{d}/s.txt",
                        "header", "--het", "--variant-score", "{d}/vs.txt"],
                  (".sscore", ".het", ".vscore")),
    "vscore": ("p", ["--variant-score", "{d}/vs.txt", "--vscore-col-nums", "2-3"],
               (".vscore",)),
    "vscore_bin": ("p", ["--variant-score", "{d}/vs.txt", "bin"],
                   (".vscore.bin", ".vscore.cols", ".vscore.vars")),
    "vscore_bin4": ("p", ["--variant-score", "{d}/vs.txt", "bin4"],
                    (".vscore.bin", ".vscore.cols", ".vscore.vars")),
    "vscore_single": ("p", ["--variant-score", "{d}/vs.txt", "single-prec"],
                      (".vscore",)),
    "vscore_x0": ("sx", ["--variant-score", "{d}/vs.txt", "--xchr-model", "0"],
                  (".vscore",)),
    "vscore_x1": ("sx", ["--variant-score", "{d}/vs.txt", "--xchr-model", "1"],
                  (".vscore",)),
    "vscore_x2": ("sx", ["--variant-score", "{d}/vs.txt", "--xchr-model", "2"],
                  (".vscore",)),
    "dosage": ("dp", ["--score", "{d}/ds.txt", "header", "--variant-score",
                      "{d}/vsd.txt", "--het", "--sample-counts"],
               (".sscore", ".vscore", ".het", ".scount")),
    "dosage_dominant": ("dp", ["--score", "{d}/ds.txt", "header", "dominant",
                               "no-mean-imputation"], (".sscore",)),
    # the frequency guard: < 50 founders of >= 50 samples, < 50 samples; and
    # what lifts it
    "guard_founders": ("fam", ["--het"], ()),
    "guard_samples": ("tiny", ["--score", "{d}/s.txt", "header"], ()),
    "guard_nonfounders": ("fam", ["--het", "--nonfounders", "--check-sex"],
                          (".het", ".sexcheck")),
    "guard_bad_freqs": ("tiny", ["--het", "--bad-freqs"], (".het",)),
    "guard_read_freq": ("fam", ["--read-freq", "{d}/moved.afreq", "--impute-sex"],
                        (".sexcheck",)),
}
# runs the guard refuses (ValueError, "decent allele frequencies")
SR_ERRORS = ("guard_founders", "guard_samples")
# reports of float sums whose bytes depend on the summation order, with the
# tolerance relative to sum |weight x dosage| of a sum: the f64 .vscore.bin
# (last bits) and the f32 sums of `single-prec` (~200 x f32 eps)
SR_ORDER_DEPENDENT = {("vscore_bin", ".vscore.bin"): 1e-12,
                      ("vscore_single", ".vscore"): 1e-5}
# the sx copy's alleles, one per variant in turn: transitions,
# transversions, a non-SNP and a symbolic ALT (every .scount class)
SR_ALLELES = (("A", "G"), ("C", "T"), ("G", "T"), ("A", "C"), ("AT", "A"),
              ("C", "<DEL>"), ("T", "C"))


def _variants(prefix: str) -> list[list[str]]:
    """(ID, REF, ALT) of each variant of <prefix>.pvar."""
    with open(prefix + ".pvar") as f:
        return [ln.rstrip("\n").split("\t")[2:5] for ln in f if not ln.startswith("#")]


def _samples(prefix: str) -> tuple[list[str], list[list[str]]]:
    with open(prefix + ".psam") as f:
        hdr = f.readline().lstrip("#").rstrip("\n").split("\t")
        return hdr, [ln.rstrip("\n").split("\t") for ln in f]


def _write_moved_afreq(afreq: str, dst: str) -> None:
    """A copy of .afreq file `afreq` with every ALT frequency moved (x 0.8 +
    0.05, at most 1)."""
    with open(afreq) as f, open(dst, "w") as g:
        head = f.readline()
        g.write(head)
        fc = head.lstrip("#").split().index("ALT_FREQS")
        for ln in f:
            t = ln.rstrip("\n").split("\t")
            t[fc] = f"{min(1.0, float(t[fc]) * 0.8 + 0.05):.6g}"
            g.write("\t".join(t) + "\n")


def write_sx_copy(p: str, sx: str) -> None:
    """The chr1/X/Y/MT copy sx of fileset p: the same genotypes and samples,
    its first 2/3 of the variants on chr1, then chrX, chrY and MT, with
    SR_ALLELES's alleles in turn."""
    import shutil

    for ext in (".pgen", ".psam"):
        shutil.copy(p + ext, sx + ext)
    with open(p + ".pvar") as f, open(sx + ".pvar", "w") as g:
        g.write(f.readline())
        lines = f.readlines()
        m = len(lines)
        for i, ln in enumerate(lines):
            t = ln.rstrip("\n").split("\t")
            chrom = "1" if i < m * 2 // 3 else "X" if i < m * 5 // 6 \
                else "Y" if i < m * 11 // 12 else "MT"
            ref, alt = SR_ALLELES[i % len(SR_ALLELES)]
            g.write("\t".join([chrom, t[1], t[2], ref, alt]) + "\n")


def write_sample_report_inputs(d: str, p: str, dp: str, afreq: str) -> None:
    """The inputs of SR_RUNS in directory d, from the hard-call fileset p,
    the dosage fileset dp and an .afreq of p: the sx and fam filesets;
    score files (every third variant of p, A1 alternately REF and ALT, every
    41st neither, one ID not in p; every fifth; every second of dp), a
    --score-list, --q-score-range ranges (one not numeric) and p-values,
    3-column sample weights for p (vs.txt) and dp (vsd.txt), each without
    the last sample, and moved.afreq (every ALT frequency moved)."""
    import os
    import shutil

    rng = np.random.default_rng(17)
    fam = os.path.join(d, "fam")
    write_sx_copy(p, os.path.join(d, "sx"))
    hdr, rows = _samples(p)
    iid, sex = hdr.index("IID"), hdr.index("SEX")
    pheno = hdr.index("PHENO1") if "PHENO1" in hdr else None
    iids = [r[iid] for r in rows]
    for ext in (".pgen", ".pvar"):
        shutil.copy(p + ext, fam + ext)
    with open(fam + ".psam", "w") as f:
        f.write("#FID\tIID\tPAT\tMAT\tSEX" + ("\tPHENO1" if pheno else "") + "\n")
        for i, r in enumerate(rows):
            par = ("0", "0") if i < 40 else (iids[i % 20], iids[20 + i % 20])
            f.write(f"f{i % 20}\t{r[iid]}\t{par[0]}\t{par[1]}\t{r[sex]}"
                    + (f"\t{r[pheno]}" if pheno else "") + "\n")
    pv, dv = _variants(p), _variants(dp)
    with open(os.path.join(d, "s.txt"), "w") as f:
        f.write("ID\tA1\tBETA\tOR\tW3\n")
        for i, (vid, ref, alt) in enumerate(pv[::3]):
            a = "Q" if i % 41 == 0 else alt if i % 2 else ref
            w = rng.normal(size=3)
            f.write(f"{vid}\t{a}\t{w[0]:.5f}\t{w[1]:.5f}\t{w[2]:.5f}\n")
        f.write("nosuch1\tA\t1\t1\t1\n")
    with open(os.path.join(d, "s2.txt"), "w") as f:
        f.write("ID\tA1\tBETA\tOR\n")
        for vid, _, alt in pv[1::5]:
            f.write(f"{vid}\t{alt}\t{rng.normal():.5f}\t{rng.normal():.5f}\n")
    with open(os.path.join(d, "list.txt"), "w") as f:
        f.write(f"{os.path.join(d, 's.txt')}\n{os.path.join(d, 's2.txt')}\n")
    with open(os.path.join(d, "ranges.txt"), "w") as f:
        f.write("low 0 0.1\nmid 0.1 0.6\nbad x y\nall 0 1\n")
    with open(os.path.join(d, "pvals.txt"), "w") as f:
        f.writelines(f"{v[0]}\t{rng.random():.4f}\n" for v in pv[::2])
    with open(os.path.join(d, "ds.txt"), "w") as f:
        f.write("ID\tA1\tW\n")
        for i, (vid, ref, alt) in enumerate(dv[::2]):
            f.write(f"{vid}\t{alt if i % 3 else ref}\t{rng.normal():.5f}\n")
    for name, src in (("vs.txt", p), ("vsd.txt", dp)):
        h, rs = _samples(src)
        with open(os.path.join(d, name), "w") as f:
            f.write("#IID\tV1\tV2\tV3\n")
            for r in rs[:-1]:
                w = rng.normal(size=3)
                f.write(f"{r[h.index('IID')]}\t{w[0]:.5f}\t{w[1]:.5f}\t{w[2]:.5f}\n")
    _write_moved_afreq(afreq, os.path.join(d, "moved.afreq"))


# ---------------------------------------------------------------------------
# The pair-count commands' cases (--distance, --genome, --cluster /
# --neighbour / --mds-plot, --ibs-test, --groupdist, --regress-distance):
# tests/test_torch_pair_reports.py runs them on the CPU against plink_tpu,
# chip_smoke.py's pair-report parity on the card against the CPU.
# Filesets: p (a hard-call panel with a case/control PHENO1), sx (its
# chr1/X/Y/MT copy), dp (a dosage panel), pedb (a .bed copy of p whose .fam
# holds PD_PEDIGREE: two trios, a sib pair, a half-sib pair, unrelated
# samples).  `{d}` stands for the directory of write_pair_report_inputs's
# files.  Every output is byte-identical but a .gz (its header names the
# file: the text inside) and the .log (`pair_log_lines`); the permutation
# and jackknife tests write their results to the .log only.
# ---------------------------------------------------------------------------

PD_CLUSTER = (".cluster1", ".cluster2", ".cluster3")
# (label, fileset, flags, outputs)
PD_RUNS = (
    ("dist", "p", ["--distance"], (".dist", ".dist.id")),
    ("dist_square_gz", "p", ["--distance", "square", "gz"], (".dist.gz",)),
    ("dist_square0_ibs", "p", ["--distance", "square0", "ibs", "1-ibs"],
     (".mibs", ".mibs.id", ".mdist", ".mdist.id")),
    ("dist_flat", "p", ["--distance", "flat-missing"], (".dist",)),
    ("dist_bin", "p", ["--distance", "bin"], (".dist.bin", ".dist.id")),
    ("dist_bin4_ibs", "p", ["--distance", "triangle", "bin4", "ibs", "1-ibs"],
     (".mibs.bin", ".mdist.bin")),
    ("dist_bin4_alct", "p", ["--distance", "square", "bin4", "allele-ct"],
     (".dist.bin",)),
    ("dist_plink1", "p", ["--distance-matrix", "--ibs-matrix"],
     (".mdist", ".mdist.id", ".mibs", ".mibs.id")),
    ("dist_remove", "p", ["--remove", "{d}/remove.txt", "--distance"],
     (".dist", ".dist.id")),
    ("dist_read_freq", "p", ["--read-freq", "{d}/moved.afreq", "--distance"],
     (".dist",)),
    ("dist_nonfounders", "pedb", ["--distance", "--nonfounders"], (".dist",)),
    ("dist_sx", "sx", ["--distance", "square"], (".dist",)),
    ("dist_dosage", "dp", ["--distance"], (".dist",)),
    ("err_modifier", "p", ["--distance", "squared"], ()),
    ("err_shapes", "p", ["--distance", "square", "triangle"], ()),
    ("err_ibs_matrix", "p", ["--distance", "ibs", "--ibs-matrix"], ()),
    ("err_parallel", "p", ["--distance", "--parallel", "1", "2"], ()),
    ("genome", "pedb", ["--genome"], (".genome",)),
    ("genome_gap", "pedb", ["--genome", "--ppc-gap", "0.05"], (".genome",)),
    ("cluster", "p", ["--cluster", "--neighbour", "1", "5", "--mds-plot", "4"],
     PD_CLUSTER + (".nearest", ".mds")),
    ("cluster_cc_avg", "p", ["--cluster", "cc", "group-avg"], PD_CLUSTER),
    ("cluster_missing", "p", ["--cluster", "missing"],
     (".cluster1", ".cluster2", ".cluster3.missing", ".mdist.missing")),
    ("cluster_only2", "p", ["--cluster", "only2", "old-tiebreaks"], (".cluster2",)),
    ("cluster_k_mc", "p", ["--cluster", "--K", "3", "--mc", "5"], PD_CLUSTER),
    ("cluster_mcc", "p", ["--cluster", "--mcc", "2", "3"], PD_CLUSTER),
    ("cluster_ppc_ibm", "p", ["--cluster", "--ppc", "0.05", "--ppc-gap", "0.05",
                              "--ibm", "0.9", "--neighbour", "1", "3"],
     PD_CLUSTER + (".nearest",)),
    ("cluster_mds_eig", "p", ["--cluster", "--K", "20", "--mds-plot", "3",
                              "eigendecomp", "eigvals", "by-cluster"],
     PD_CLUSTER + (".mds", ".mds.eigvals")),
    ("err_mds", "p", ["--mds-plot", "4"], ()),
    ("ibs_test", "p", ["--ibs-test", "1024", "--seed", "11", "--threads", "1"], ()),
    ("groupdist", "p", ["--groupdist", "1200", "--seed", "21", "--threads", "2"], ()),
    ("regress", "p", ["--regress-distance", "1000", "--seed", "7", "--threads", "1",
                      "--pheno", "{d}/qt.txt", "--pheno-name", "QT"], ()),
    ("ibs_groupdist", "p", ["--ibs-test", "1024", "--groupdist", "1200", "--seed",
                            "5"], ()),
    ("few_cases", "p", ["--ibs-test", "1024", "--groupdist", "1200", "--pheno",
                        "{d}/cc1.txt", "--pheno-name", "CC1"], ()),
    ("few_controls", "p", ["--ibs-test", "1024", "--groupdist", "1200", "--pheno",
                           "{d}/cc2.txt", "--pheno-name", "CC2"], ()),
)
# runs that are refused: label -> the message (ValueError, or FlagError for
# --mds-plot without --cluster)
PD_ERRORS = {
    "err_modifier": "Invalid --distance parameter 'squared'.",
    "err_shapes": "--distance 'square' and 'triangle' modifiers cannot coexist.",
    "err_ibs_matrix": '--ibs-matrix cannot be used with "--distance ibs".',
    "err_parallel": "--parallel is not yet supported with --distance.",
    "err_mds": "--mds-plot must be used with --cluster.",
}
# the pedigree of pedb: sample index -> (FID, PAT, MAT) by sample index
# (None = "0"); the other samples are founders of families of their own
PD_PEDIGREE = {0: ("fa", None, None), 1: ("fa", None, None), 2: ("fa", 0, 1),
               3: ("fa", 0, 1), 4: ("fb", None, None), 5: ("fb", None, None),
               6: ("fb", 4, 5), 7: ("fc", None, None), 8: ("fc", None, None),
               9: ("fc", None, None), 10: ("fc", 7, 8), 11: ("fc", 7, 9)}
# .log lines that are the run's own (banner, command line, timings)
_LOG_SKIP = ("PLINK-", "Options in effect", "  plink2t ", "[phase]", "[timing]",
             "End of run", "End time")


def pair_log_lines(prefix: str) -> list[str]:
    """The lines of <prefix>.log that report exclusions, settings, results,
    warnings and errors (every line but the banner, the command line and
    the timings), with the output prefix replaced by <out>."""
    with open(prefix + ".log") as f:
        return [ln.replace(prefix, "<out>") for ln in f
                if not ln.startswith(_LOG_SKIP)]


def pair_output_same(ref: str, got: str) -> bool:
    """Whether pair-report output file `got` equals `ref`: a .gz by its
    decompressed text, every other file byte for byte."""
    import gzip

    if ref.endswith(".gz"):
        with gzip.open(ref, "rb") as a, gzip.open(got, "rb") as b:
            return a.read() == b.read()
    return filecmp.cmp(ref, got, shallow=False)


def write_pedigree_fam(path: str) -> None:
    """Give the .fam at `path` PD_PEDIGREE's families (IID, SEX and the
    phenotype kept; the other samples founders of families of their own)."""
    with open(path) as f:
        rows = [ln.split() for ln in f]
    iids = [r[1] for r in rows]
    with open(path, "w") as f:
        for i, r in enumerate(rows):
            fid, pat, mat = PD_PEDIGREE.get(i, (f"u{i}", None, None))
            par = [iids[x] if x is not None else "0" for x in (pat, mat)]
            f.write("\t".join([fid, r[1], *par, r[4], r[5]]) + "\n")


def write_bed_copy(p: str, dst: str) -> None:
    """A .bed / .bim / .fam copy of the .pgen fileset p, as plink_tpu's
    `--make-bed` writes it (the port has no --make-bed yet)."""
    import torch

    from .dataset import load_dataset
    from .io.pgen_write import write_bed
    from .io.pvar import write_bim

    ds = load_dataset(p, torch.device("cpu"))
    write_bed(dst + ".bed", ds.all_packed(), sample_ct=ds.raw_sample_ct)
    write_bim(dst + ".bim", ds.vi)
    si = ds.si
    pheno = next(iter(si.phenos.values())) if si.phenos else None
    with open(dst + ".fam", "w") as f:
        for i in range(ds.raw_sample_ct):
            pat = si.pat[i] if si.pat is not None else "0"
            mat = si.mat[i] if si.mat is not None else "0"
            if pheno is None or not pheno.nonmiss[i]:
                ph = "-9"
            elif pheno.kind == "cc":
                ph = str(int(pheno.data[i]) + 1)
            else:
                ph = f"{pheno.data[i]:g}"
            f.write(f"{si.fid[i]}\t{si.iid[i]}\t{pat}\t{mat}\t{int(si.sex[i])}\t{ph}\n")


def write_pair_report_inputs(d: str, p: str, afreq: str) -> None:
    """PD_RUNS's files in directory d, from the hard-call fileset p and an
    .afreq of p: the sx copy, remove.txt (every 7th sample), moved.afreq
    (every ALT frequency moved), qt.txt (a Gaussian QT, numpy seed 19) and
    cc1.txt / cc2.txt (a case/control phenotype with one case / one
    control).  The pedb fileset is a .bed copy of p: `write_bed_copy` (or
    plink_tpu's --make-bed) and then `write_pedigree_fam`."""
    import os

    write_sx_copy(p, os.path.join(d, "sx"))
    hdr, rows = _samples(p)
    iids = [r[hdr.index("IID")] for r in rows]
    rng = np.random.default_rng(19)
    with open(os.path.join(d, "remove.txt"), "w") as f:
        f.writelines(f"{x}\n" for x in iids[::7])
    with open(os.path.join(d, "qt.txt"), "w") as f:
        f.write("#IID\tQT\n")
        f.writelines(f"{x}\t{v:.5f}\n" for x, v in zip(iids, rng.normal(size=len(iids))))
    for name, one in (("CC1", "2"), ("CC2", "1")):
        other = "1" if one == "2" else "2"
        with open(os.path.join(d, name.lower() + ".txt"), "w") as f:
            f.write(f"#IID\t{name}\n")
            f.writelines(f"{x}\t{one if i == 3 else other}\n" for i, x in enumerate(iids))
    _write_moved_afreq(afreq, os.path.join(d, "moved.afreq"))


# ---------------------------------------------------------------------------
# plink 1.9's case/control family: --fast-epistasis (EPI_RUNS), --assoc /
# --model and their permutation tests, and --fst (A19_RUNS).
# tests/test_torch_epistasis.py and tests/test_torch_assoc19.py run them on
# the CPU against plink_tpu, chip_smoke.py's 17h on the card against the
# CPU.  Filesets: p (a hard-call panel with a case/control PHENO1), ep (its
# copy on chr1 / chr2 at 150 kb spacing: write_epi_inputs), sx (its
# chr1/X/Y/MT copy: write_sx_copy), wide (65,536 samples x 128 variants, so
# that M * |group| >= 2^22 and plink_tpu takes its device dot for B8).
# Every output is byte-identical, and so are the .log lines of
# `pair_log_lines`.  `{d}` stands for the inputs' directory.
# ---------------------------------------------------------------------------

EPI_SPACING = 150_000  # bp between neighbouring variants of the ep copy
EPI_SETS = {"setsA.txt": "1 100000 3000000 SETA\n",
            "sets.txt": "1 100000 3000000 SETA\n1 4500000 9000000 SETB\n"}
_EPI_CC = (".epi.cc", ".epi.cc.summary")
_EPI_CO = (".epi.co", ".epi.co.summary")
# (label, fileset, flags, outputs); every run adds --allow-no-sex
EPI_RUNS = (
    ("default", "ep", ["--fast-epistasis", "--epi1", "0.5"], _EPI_CC),
    ("thresholds", "ep", ["--fast-epistasis", "--epi1", "0.5", "--epi2", "0.05"],
     _EPI_CC),
    ("no_ueki", "ep", ["--fast-epistasis", "no-ueki", "--epi1", "0.5"], _EPI_CC),
    ("joint", "ep", ["--fast-epistasis", "joint-effects", "--je-cellmin", "2",
                     "--epi1", "0.5"], _EPI_CC),
    ("boost", "ep", ["--fast-epistasis", "boost", "--epi1", "0.01"], _EPI_CC),
    ("nop", "ep", ["--fast-epistasis", "nop", "--epi1", "0.5"], _EPI_CC),
    ("case_only_gap", "ep", ["--fast-epistasis", "case-only", "--gap", "500",
                             "--epi1", "0.5"], _EPI_CO),
    ("set_one", "ep", ["--fast-epistasis", "set-by-set", "--make-set",
                       "{d}/setsA.txt", "--epi1", "0.5"], _EPI_CC),
    ("set_two", "ep", ["--fast-epistasis", "set-by-set", "--make-set",
                       "{d}/sets.txt", "--epi1", "0.5"], _EPI_CC),
    ("set_all", "ep", ["--fast-epistasis", "set-by-all", "--make-set",
                       "{d}/setsA.txt", "--epi1", "0.5"], _EPI_CC),
    ("boost_sets", "ep", ["--fast-epistasis", "boost", "set-by-set", "--make-set",
                          "{d}/sets.txt"], _EPI_CC),
    ("set_file_names", "ep", ["--fast-epistasis", "set-by-all", "--set",
                              "{d}/sets.set", "--set-names", "SETB", "--epi1", "0.5"],
     _EPI_CC),
    ("set_border_collapse", "ep", ["--fast-epistasis", "set-by-set", "--make-set",
                                   "{d}/sets.txt", "--make-set-border", "200",
                                   "--set-collapse-all", "ALL", "--epi1", "0.5"],
     _EPI_CC),
    ("set_gene", "ep", ["--fast-epistasis", "set-by-all", "--make-set",
                        "{d}/setsA.txt", "--gene", "SETA", "--epi1", "0.5"], _EPI_CC),
    ("set_complement", "ep", ["--fast-epistasis", "set-by-all", "--make-set",
                              "{d}/setsA.txt", "--complement-sets", "--epi1", "0.01"],
     _EPI_CC),
    ("sx", "sx", ["--fast-epistasis", "--epi1", "0.5"], _EPI_CC),
    ("wide", "wide", ["--fast-epistasis", "--epi1", "0.5"], _EPI_CC),
    ("err_boost_case_only", "ep", ["--fast-epistasis", "boost", "case-only"], ()),
    ("err_joint_no_ueki", "ep", ["--fast-epistasis", "joint-effects", "no-ueki"],
     ()),
    ("err_set_all_two", "ep", ["--fast-epistasis", "set-by-all", "--make-set",
                               "{d}/sets.txt"], ()),
    ("err_gene_empty_set", "ep", ["--fast-epistasis", "set-by-set", "--make-set",
                                  "{d}/sets.txt", "--gene", "SETA"], ()),
    ("err_cellmin", "ep", ["--fast-epistasis", "joint-effects", "--je-cellmin",
                           "20"], ()),
    ("err_qt", "ep", ["--fast-epistasis", "--pheno", "{d}/qt.txt", "--pheno-name",
                      "QT"], ()),
)
# refused runs: label -> the message (FlagError, a ValueError)
EPI_ERRORS = {
    "err_boost_case_only": "--fast-epistasis boost does not have a case-only mode.",
    "err_joint_no_ueki": "--fast-epistasis 'no-ueki' modifier cannot be used with "
                         "'boost'/'joint-effects'.",
    "err_set_all_two": "--{fast-}epistasis set-by-all requires exactly one set.  "
                       "(--set-names or\n--set-collapse-all may be handy here.",
    "err_cellmin": "Too few cases or controls for --je-cellmin 20.",
    "err_gene_empty_set": "Each --{fast-}epistasis set must contain at least one "
                          "autosomal diploid\nlocus not monomorphic in either cases "
                          "or controls.",
    "err_qt": "--fast-epistasis requires a case/control phenotype.",
}

FST_POPS = ("AFR", "AMR", "EAS", "EUR", "SAS")
_FST_PAIRS = tuple(f".{a}.{b}.fst.var" for i, a in enumerate(FST_POPS)
                   for b in FST_POPS[i + 1:])
# (label, fileset, flags, outputs); every run adds --allow-no-sex but
# "sx_sexed"
A19_RUNS = (
    ("assoc_model", "p", ["--assoc", "--model"], (".assoc", ".model")),
    ("assoc_counts", "p", ["--assoc", "counts"], (".assoc",)),
    ("assoc_ci", "p", ["--maf", "0.1", "--assoc", "--ci", "0.95"], (".assoc",)),
    ("fisher", "p", ["--assoc", "fisher", "--model", "fisher"],
     (".assoc.fisher", ".model")),
    ("fisher_midp_cell", "p", ["--assoc", "fisher-midp", "--model", "fisher-midp",
                               "--cell", "2"], (".assoc.fisher", ".model")),
    ("assoc_perm", "p", ["--assoc", "perm", "--aperm", "6", "300", "--seed", "1"],
     (".assoc", ".assoc.perm")),
    ("assoc_mperm", "p", ["--assoc", "mperm=200", "--seed", "1"],
     (".assoc", ".assoc.mperm")),
    ("assoc_fisher_count", "p", ["--assoc", "fisher", "mperm=100", "perm-count",
                                 "--seed", "1"],
     (".assoc.fisher", ".assoc.fisher.mperm")),
    ("model_mperm", "p", ["--model", "mperm=100", "--seed", "2"],
     (".model", ".model.best.mperm")),
    ("model_perm_trend", "p", ["--model", "perm", "trend", "--aperm", "6", "300",
                               "--seed", "2"], (".model", ".model.trend.perm")),
    ("model_dom_fisher", "p", ["--model", "fisher", "mperm=50", "dom", "--seed", "2"],
     (".model", ".model.dom.fisher.mperm")),
    ("model_rec", "p", ["--model", "mperm=50", "rec", "--seed", "2"],
     (".model", ".model.rec.mperm")),
    ("model_gen", "p", ["--model", "mperm=50", "gen", "--seed", "2"],
     (".model", ".model.gen.mperm")),
    ("sx_assoc_model", "sx", ["--assoc", "--model", "--cell", "2"],
     (".assoc", ".model")),
    ("sx_assoc_mperm", "sx", ["--assoc", "mperm=100", "--seed", "1"],
     (".assoc", ".assoc.mperm")),
    ("sx_sexed", "sx", ["--assoc", "--model"], (".assoc", ".model")),
    ("fst_hudson", "p", ["--pheno", "{d}/pop.txt", "--fst", "POP",
                         "report-variants"], (".fst.summary",) + _FST_PAIRS),
    ("fst_wc", "p", ["--pheno", "{d}/pop.txt", "--fst", "POP", "method=wc",
                     "report-variants"], (".fst.summary",) + _FST_PAIRS),
    ("fst_block_x", "sx", ["--pheno", "{d}/pop.txt", "--fst", "POP", "blocksize=20",
                           "report-variants"],
     (".fst.summary", ".x.fst.summary") + _FST_PAIRS
     + tuple(".x" + e for e in _FST_PAIRS)),
    ("fst_base_nobs", "sx", ["--pheno", "{d}/pop.txt", "--fst", "POP", "cols=nobs",
                             "base=AFR"], (".fst.summary", ".x.fst.summary")),
    ("fst_ids", "p", ["--pheno", "{d}/pop.txt", "--fst", "POP", "method=wc",
                      "ids=EUR", "SAS", "AFR"], (".fst.summary",)),
    ("err_qassoc", "p", ["--pheno", "{d}/qt.txt", "--pheno-name", "QT", "--assoc"],
     ()),
    ("err_within", "p", ["--assoc", "perm", "--within", "{d}/clusters.txt"], ()),
    ("err_set_test", "p", ["--assoc", "set-test", "mperm=10"], ()),
)
# runs the port refuses as not yet ported (exit code 2): label -> the start
# of its message
A19_NOT_PORTED = {"err_qassoc": "--assoc on a quantitative phenotype",
                  "err_within": "--within",
                  "err_set_test": "--assoc set-test"}


def write_epi_inputs(d: str, p: str) -> None:
    """EPI_RUNS's and A19_RUNS's files in directory d, from the hard-call
    fileset p: ep (p's genotypes and samples, the first half of its
    variants on chr1 and the rest on chr2, EPI_SPACING apart), sx
    (write_sx_copy), EPI_SETS, sets.set (two --set blocks: 20 IDs of chr1
    and an unknown one, 40 of chr2), pop.txt (FST_POPS, numpy seed 31),
    qt.txt (a Gaussian QT, seed 33) and clusters.txt (four clusters)."""
    import os
    import shutil

    ep = os.path.join(d, "ep")
    for ext in (".pgen", ".psam"):
        shutil.copy(p + ext, ep + ext)
    with open(p + ".pvar") as f, open(ep + ".pvar", "w") as g:
        g.write(f.readline())
        lines = f.readlines()
        half = len(lines) // 2
        for i, ln in enumerate(lines):
            t = ln.rstrip("\n").split("\t")
            t[0] = "1" if i < half else "2"
            t[1] = str(100_000 + (i % half) * EPI_SPACING)
            g.write("\t".join(t) + "\n")
    write_sx_copy(p, os.path.join(d, "sx"))
    for name, text in EPI_SETS.items():
        with open(os.path.join(d, name), "w") as f:
            f.write(text)
    ids = [v[0] for v in _variants(p)]
    with open(os.path.join(d, "sets.set"), "w") as f:
        f.write("SETA\n" + "\n".join(ids[5:25]) + "\nnosuch\nEND\n\nSETB\n"
                + " ".join(ids[300:340]) + "\nEND\n")
    hdr, rows = _samples(p)
    iids = [r[hdr.index("IID")] for r in rows]
    rng = np.random.default_rng(31)
    with open(os.path.join(d, "pop.txt"), "w") as f:
        f.write("#IID\tPOP\n")
        f.writelines(f"{x}\t{FST_POPS[k]}\n"
                     for x, k in zip(iids, rng.integers(0, len(FST_POPS), len(iids))))
    rng = np.random.default_rng(33)
    with open(os.path.join(d, "qt.txt"), "w") as f:
        f.write("#IID\tQT\n")
        f.writelines(f"{x}\t{v:.5f}\n" for x, v in zip(iids, rng.normal(size=len(iids))))
    with open(os.path.join(d, "clusters.txt"), "w") as f:
        f.writelines(f"{x}\t{x}\tc{i % 4}\n" for i, x in enumerate(iids))
