"""The --glm genotype models, `interaction` and --condition: plink_torch
against plink_tpu on the CPU.

Both CLIs run as subprocesses with 64-variant blocks on the panel of
tests/test_torch_glm_cli.py (--dummy 200 600 0.05 --seed 7, SEX + C1 + C2
covariates), its chr1/X/Y/MT copy and a --make-bed copy.  The phenotype
file carries the case/control PHENO1 and a Gaussian QT (numpy seed 12), so
each run writes the logistic and the linear report.  On a panel this small
both packages refit every row of a joint model in f64 on the host (the
f32 device fits are held against each other in tests/test_torch_ops_glm.py).

Rules: identity, count, FIRTH? and ERRCODE columns equal; OR / SE / P
within 1e-3 relative; BETA within 1e-3 of max(|BETA|, SE) and Z_OR_F_STAT /
T_OR_F_STAT / Z_STAT / T_STAT within 1e-3 of max(|stat|, 1) (a BETA or
statistic near 0 carries the f32 noise of the device sums, large relative
to itself and small against its SE); error messages and exit codes equal.

The models with one genotype column and `interaction` are not refitted on
the host unless a row is extreme, so their reports carry each package's
f32 device fit.  Where the two differ beyond the rule, the port's rows are
held to the same rule against a numpy f64 fit of the variant that follows
plink2's stopping rules, at any stop an f32 fit can take there
(plink_torch.testing.f64_logit with slack 10; plink_tpu rounds the IRLS
log-likelihood to f32 and stops one iteration early more often: ROADMAP
C).  A variant whose design is singular in f64 (cond(X^T X) > 1e12: a rare
allele spread over more genotype columns than its carriers support) has
no fit to hold either package to: plink2 built without LAPACK inverts it
to rounding noise, so each package prints what its own f32 sums give,
down to INVALID_RESULT or not.  Such a variant keeps its identity, count
and FIRTH? columns exact and is skipped otherwise.  COUNTS fixes how many
variants of each report are held and skipped.
"""

import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = ("#CHROM", "POS", "ID", "REF", "ALT", "PROVISIONAL_REF?", "A1",
         "OMITTED", "A1_FREQ", "FIRTH?", "TEST", "OBS_CT", "ERRCODE")
RELATIVE = ("OR", "LOG(OR)_SE", "BETA", "SE", "P", "NEG_LOG10_P")
STATS = ("Z_STAT", "T_STAT", "Z_OR_F_STAT", "T_OR_F_STAT")
TOL = 1e-3
PARALLEL = 8  # subprocesses at a time

LOGI, FIRTH, NOFIRTH = "glm.logistic.hybrid", "glm.firth", "glm.logistic"
MODES = {"hybrid": ([], LOGI), "firth": (["firth"], FIRTH),
         "no_firth": (["no-firth"], NOFIRTH)}
# the runs of each model in each logistic mode; some of them also carry
# --condition, a second panel or further modifiers
EXTRA = {
    "dominant_hybrid": ("p", [], ["--condition-list", "cond.txt", "dominant"]),
    "hetonly_no_firth": ("p", [], ["--condition", "snp5"]),
    "genotypic_hybrid": ("p", ["no-hide"], []),
    "genotypic_firth": ("p", [], ["--condition", "snp7", "recessive"]),
    "genotypic_no_firth": ("sx", [], ["--xchr-model", "1"]),
    "hethom_hybrid": ("p", ["no-hide", "sex", "intercept", "log10", "omit-ref"],
                      ["--covar", "p.nosex.cov"]),
    "hethom_no_firth": ("pb", [], []),
}
# id: (panel, --glm modifiers, extra flags, logistic report suffix)
CASES = {}
for _model in ("dominant", "recessive", "hetonly", "genotypic", "hethom"):
    for _mode, (_mods, _sfx) in MODES.items():
        _panel, _more, _extra = EXTRA.get(f"{_model}_{_mode}", ("p", [], []))
        _glm = [_model, *_mods, *(m for m in _more if m != "no-hide")]
        if "no-hide" not in _more:
            _glm.append("hide-covar")
        CASES[f"{_model}_{_mode}"] = (_panel, _glm, _extra, _sfx)
CASES.update({
    "interaction": ("p", ["interaction"], [], LOGI),
    "interaction_no_firth_hide_covar": ("p", ["interaction", "no-firth",
                                              "hide-covar"], [], NOFIRTH),
    "genotypic_interaction_firth": ("p", ["genotypic", "interaction", "firth",
                                          "hide-covar"], [], FIRTH),
    "interaction_xchr1": ("sx", ["interaction", "no-x-sex", "hide-covar"],
                          ["--xchr-model", "1"], LOGI),
    "genotypic_cc_residualize": ("p", ["genotypic", "cc-residualize",
                                       "hide-covar"], [], LOGI),
})
# plink_tpu's errors for these runs, each a ValueError there
ERRORS = {
    "haploid_condition_dominant": ("sx", ["hide-covar"],
                                   ["--condition", "snp520", "dominant"]),
    "duplicate_condition_id": ("dup", ["hide-covar"], ["--condition", "snp8"]),
    "two_models": ("p", ["genotypic", "hethom"], []),
}


def _env():
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PLINK_TPU_VB="64", PLINK_TPU_DEVICES="1",
               PLINK_TORCH_VB="64", PLINK_TORCH_DEVICE="cpu", PYTHONPATH=REPO,
               # one thread per process: PARALLEL of them share the cores
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    return env


def _cmd(pkg, args, out):
    return [sys.executable, "-m", f"{pkg}.cli", *args, "--out", out, "--silent"]


def _run_all(cmds, cwd):
    """Run the commands, PARALLEL at a time: (returncode, stdout, stderr)
    of each, in order."""
    results = [None] * len(cmds)
    running = {}
    todo = list(enumerate(cmds))
    while todo or running:
        while todo and len(running) < PARALLEL:
            i, cmd = todo.pop(0)
            running[i] = subprocess.Popen(
                cmd, env=_env(), cwd=cwd, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        for i in [i for i, p in running.items() if p.poll() is not None]:
            out, err = running[i].communicate()
            results[i] = (running.pop(i).returncode, out, err)
        time.sleep(0.05)
    return results


def _make_panels(d):
    r = subprocess.run(_cmd("plink_tpu", ["--dummy", "200", "600", "0.05",
                                          "--seed", "7"], "p"),
                       env=_env(), cwd=d, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(d / "p.psam") as f:
        hdr = f.readline().rstrip("\n").split("\t")
        rows = [ln.rstrip("\n").split("\t") for ln in f]
    si, pi = hdr.index("SEX"), hdr.index("PHENO1")
    rng = np.random.default_rng(11)
    cov = rng.normal(size=(len(rows), 2))
    with open(d / "p.cov", "w") as f, open(d / "p.nosex.cov", "w") as g:
        f.write("#IID\tSEX\tC1\tC2\n")
        g.write("#IID\tC1\tC2\n")
        for r, (c1, c2) in zip(rows, cov):
            f.write(f"{r[0]}\t{r[si]}\t{c1:.6f}\t{c2:.6f}\n")
            g.write(f"{r[0]}\t{c1:.6f}\t{c2:.6f}\n")
    qt = np.random.default_rng(12).normal(size=len(rows))
    with open(d / "p.both", "w") as f:
        f.write("#IID\tPHENO1\tQT\n")
        for r, q in zip(rows, qt):
            f.write(f"{r[0]}\t{r[pi]}\t{q:.6f}\n")
    # two IDs named, one of them absent: the "not found" warning
    (d / "cond.txt").write_text("snp11\nsnp404\nnosuchsnp\n")
    r = subprocess.run(_cmd("plink_tpu", ["--pfile", "p", "--make-bed"], "pb"),
                       env=_env(), cwd=d, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    for stem in ("sx", "dup", "pb"):
        for ext in (".cov", ".nosex.cov", ".both"):
            shutil.copy(d / f"p{ext}", d / f"{stem}{ext}")
    lines = (d / "p.pvar").read_text().splitlines()
    head = [ln for ln in lines if ln.startswith("#")]
    body = [ln.split("\t") for ln in lines if not ln.startswith("#")]
    for stem in ("sx", "dup"):
        shutil.copy(d / "p.pgen", d / f"{stem}.pgen")
        shutil.copy(d / "p.psam", d / f"{stem}.psam")
    sx = [["1" if i < 400 else "X" if i < 500 else "Y" if i < 550 else "MT"]
          + t[1:] for i, t in enumerate(body)]
    (d / "sx.pvar").write_text("\n".join(head + ["\t".join(t) for t in sx]) + "\n")
    dup = [t[:2] + (["snp8"] if t[2] == "snp9" else t[2:3]) + t[3:] for t in body]
    (d / "dup.pvar").write_text("\n".join(head + ["\t".join(t) for t in dup]) + "\n")


def _argv(panel, mods, extra):
    flag = "--bfile" if panel == "pb" else "--pfile"
    cov = [] if "--covar" in extra else ["--covar", f"{panel}.cov"]
    return [flag, panel, "--pheno", f"{panel}.both", "--glm", *mods, *cov, *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"case": {case: {pkg: result}}, "error": {...}, "dir": path}: every
    subprocess of the module in one pool."""
    d = tmp_path_factory.mktemp("glmjoint")
    _make_panels(d)
    cmds, keys = [], []
    for kind, table in (("case", CASES), ("error", ERRORS)):
        for case, spec in table.items():
            for pkg in ("plink_tpu", "plink_torch"):
                cmds.append(_cmd(pkg, _argv(*spec[:3]), f"{pkg}_{case}"))
                keys.append((kind, case, pkg))
    out = {"case": {}, "error": {}, "dir": d}
    for (kind, case, pkg), r in zip(keys, _run_all(cmds, d)):
        out[kind].setdefault(case, {})[pkg] = r
    return out


def _read(path):
    with open(path) as f:
        hdr = f.readline().rstrip("\n").split("\t")
        return hdr, [ln.rstrip("\n").split("\t") for ln in f]


def _close(col, x, y, se=None):
    """The float rule of the module docstring for one cell."""
    if x == y:  # equal, infinities included
        return True
    if col in STATS:
        scale = max(abs(y), 1.0)
    elif col == "BETA":
        scale = max(abs(y), se if se is not None else 0.0)
    else:
        scale = abs(y)
    return abs(x - y) <= TOL * scale


def _row_ok(hdr, a, b):
    """Row `a` against row `b` by the module's rules: (exact columns equal,
    floats close)."""
    se_i = hdr.index("SE") if "SE" in hdr else None
    exact, close = True, True
    for col, x, y in zip(hdr, a, b):
        if col in RELATIVE + STATS and "NA" not in (x, y):
            se = float(b[se_i]) if se_i is not None and b[se_i] != "NA" else None
            close &= _close(col, float(x), float(y), se)
        else:
            exact &= col in EXACT + RELATIVE + STATS and x == y
    return exact, close


# plane weights (het, hom-ALT, valid) of each predictor, A1 = ALT / A1 = REF
_PRED_W = {"ADD": ((1, 2, 0), (-1, -2, 2)), "DOM": ((1, 1, 0), (0, -1, 1)),
           "REC": ((0, 1, 0), (-1, -1, 1)), "HET": ((1, 0, 0), (1, 0, 0)),
           "DOMDEV": ((1, 0, 0), (1, 0, 0)), "HOM": ((0, 1, 0), (-1, -1, 1))}


def _f64_rows(d, case, hdr, rows):
    """numpy f64 fits of one variant's report rows: [{TEST: (effect, SE,
    stat, P)}] with effect = OR (logistic) or BETA (linear), one dict for
    each stop an f32 fit may take under plink2's rules (f64_logit with
    slack 10; one for the linear fit), or None when the variant's design
    is singular in f64.  Supports the cases without --condition or
    residualization."""
    from scipy.special import ndtr, stdtr

    from plink_torch.io.pgen_read import PgenReader
    from plink_torch.ops.planes import _unpack_np
    from plink_torch.testing import f64_logit

    panel, mods, extra, _ = CASES[case]
    assert "--condition" not in extra and "--condition-list" not in extra
    assert not any(m.endswith("residualize") for m in mods)
    col = {c: hdr.index(c) for c in hdr}
    r0 = rows[0]
    with open(d / f"{panel}.psam") as f:
        ph = f.readline().rstrip("\n").split("\t")
        sex = np.array([int(ln.split("\t")[ph.index("SEX")]) for ln in f])
    n = sex.size
    pheno = np.loadtxt(d / f"{panel}.both", skiprows=1, usecols=(1, 2))
    cov_path = extra[extra.index("--covar") + 1] if "--covar" in extra \
        else f"{panel}.cov"
    with open(d / cov_path) as f:
        cnames = f.readline().lstrip("#").split()[1:]
    cov = np.loadtxt(d / cov_path, skiprows=1, usecols=range(1, 1 + len(cnames)),
                     ndmin=2)
    if "sex" in mods:
        cnames, cov = cnames + ["SEX"], np.column_stack([cov, sex])
    vidx = int(r0[col["ID"]][3:])
    prefix = str(d / panel)
    reader = PgenReader(prefix + (".bed" if panel == "pb" else ".pgen"),
                        sample_ct=n)
    codes = _unpack_np(reader.read_packed(vidx, 1))[0][:n]
    chrom = r0[0]
    keep = np.ones(n, bool)
    if chrom == "Y":  # the chrY pass: nonfemales, SEX constant and dropped
        keep = sex != 2
        if "SEX" in cnames:
            j = cnames.index("SEX")
            cnames, cov = cnames[:j] + cnames[j + 1:], np.delete(cov, j, axis=1)
    linear = "BETA" in col
    y = pheno[:, 1] if linear else (pheno[:, 0] == 2).astype(float)
    keep &= (codes != 3) & (linear | (pheno[:, 0] > 0))
    scale = np.full(n, 0.5 if chrom in ("Y", "MT") else 1.0)
    if chrom == "X" and "--xchr-model" in extra and extra[extra.index(
            "--xchr-model") + 1] == "1":
        scale = np.where(sex == 1, 0.5, 1.0)
    alt = r0[col["A1"]] == r0[col["ALT"]]
    het, hom, val = (codes == 1), (codes == 2), (codes != 3)
    cols = {"INTERCEPT": np.ones(n)}
    cols.update({c: cov[:, j] for j, c in enumerate(cnames)})
    for t in {r[col["TEST"]] for r in rows}:
        main, _, cv = t.partition("x")
        if main in _PRED_W:
            w = _PRED_W[main][0 if alt else 1]
            g = (w[0] * het + w[1] * hom + w[2] * val) * scale
            cols[t] = g * (cols[cv] if cv else 1.0)
    names = ["INTERCEPT"] + cnames + sorted(
        (t for t in cols if t not in cnames and t != "INTERCEPT"),
        key=lambda t: (len(t), t))
    X = np.column_stack([cols[t] for t in names])[keep]
    yk = y[keep]
    assert all(int(r[col["OBS_CT"]]) == X.shape[0] for r in rows), (rows, X.shape)
    if np.linalg.cond(X.T @ X) > 1e12:
        return None
    if linear:
        xtx_inv = np.linalg.inv(X.T @ X)
        b = xtx_inv @ (X.T @ yk)
        res = yk - X @ b
        df = X.shape[0] - X.shape[1]
        se = np.sqrt(res @ res / df * np.diag(xtx_inv))
        t = b / se
        return [{nm: (b[i], se[i], t[i], 2.0 * stdtr(df, -abs(t[i])))
                 for i, nm in enumerate(names)}]
    firth = r0[col["FIRTH?"]] == "Y" if "FIRTH?" in col else FIRTH in CASES[case][3]
    out = []
    for b, se, _ in f64_logit(X, yk, firth=firth, slack=10.0):
        t = b / se
        out.append({nm: (np.exp(b[i]), se[i], t[i], 2.0 * ndtr(-abs(t[i])))
                    for i, nm in enumerate(names)})
    return out


def _compare(d, case, ref_path, got_path):
    """The port's report against plink_tpu's.  A variant whose rows differ
    beyond the float rule is held, row by row, to numpy's f64 fit at one of
    its stops instead; one whose f64 design is singular is skipped, as the
    reference's own output there is rounding (below).  The identity, count
    and FIRTH? columns of every row stay exact either way, and the
    ERRCODE of every row but the skipped variants'.  Returns (header, rows,
    count of variants held to f64, count skipped)."""
    h_ref, r_ref = _read(ref_path)
    h_got, r_got = _read(got_path)
    assert h_got == h_ref
    assert len(r_got) == len(r_ref) > 0, (len(r_got), len(r_ref))
    col = {c: h_ref.index(c) for c in h_ref}
    ident = [col[c] for c in EXACT if c in col and c != "ERRCODE"]
    by_variant = {}
    for a, b in zip(r_got, r_ref):
        assert [a[i] for i in ident] == [b[i] for i in ident], (a, b)
        exact, close = _row_ok(h_ref, a, b)
        if not (exact and close):
            by_variant.setdefault(a[col["ID"]], []).append((a, b, exact))
    held = skipped = 0
    eff_col = "BETA" if "BETA" in col else "OR"
    se_col = "SE" if "SE" in col else "LOG(OR)_SE"
    stat_col = next(c for c in STATS if c in col)
    p_col = "P" if "P" in col else "NEG_LOG10_P"

    def matches(a, fit):
        eff, se, stat, p = fit[a[col["TEST"]]]
        if p_col != "P":
            p = -np.log10(p)
        return all(_close(c, float(a[col[c]]), y, se) for c, y in (
            (eff_col, eff), (se_col, se), (stat_col, stat), (p_col, p)))

    for vid, rows in by_variant.items():
        group = [a for a in r_got if a[col["ID"]] == vid]
        fits = _f64_rows(d, case, h_ref, group)
        if fits is None:
            skipped += 1
            continue
        assert all(exact for _, _, exact in rows), rows
        held += 1
        assert any(all(matches(a, fit) for a in group) for fit in fits), \
            (group, fits)
    return h_ref, r_ref, held, skipped


# (logistic held, skipped, linear held, skipped) of each case: what the
# seeded panel shows
COUNTS = {"recessive_hybrid": (11, 0, 0, 0), "recessive_no_firth": (11, 0, 0, 0),
          "interaction": (6, 0, 0, 0),
          "interaction_no_firth_hide_covar": (6, 0, 0, 0),
          "genotypic_interaction_firth": (0, 1, 0, 7),
          "interaction_xchr1": (6, 0, 0, 2)}


@pytest.mark.parametrize("case", list(CASES))
def test_joint_model_report_matches_plink_tpu(runs, case):
    d = runs["dir"]
    res = runs["case"][case]
    for pkg in ("plink_tpu", "plink_torch"):
        assert res[pkg][0] == 0, (pkg, res[pkg][2][-3000:])
    sfx = CASES[case][3]
    hdr, rows, held, skipped = _compare(d, case,
                                        d / f"plink_tpu_{case}.PHENO1.{sfx}",
                                        d / f"plink_torch_{case}.PHENO1.{sfx}")
    _, _, held_q, skipped_q = _compare(d, case, d / f"plink_tpu_{case}.QT.glm.linear",
                                       d / f"plink_torch_{case}.QT.glm.linear")
    assert (held, skipped, held_q, skipped_q) == COUNTS.get(case, (0,) * 4)
    tests = {r[hdr.index("TEST")] for r in rows}
    mods = CASES[case][1]
    if "genotypic" in mods or "hethom" in mods:
        assert "GENO_2DF" in tests and "Z_OR_F_STAT" in hdr
    if "interaction" in mods:
        assert any("x" in t for t in tests), tests


def test_interaction_reports_every_product_term(runs):
    """`interaction` reports ADD x each covariate after the covariates."""
    hdr, rows = _read(runs["dir"] / f"plink_torch_interaction.PHENO1.{LOGI}")
    tests = [r[hdr.index("TEST")] for r in rows if r[2] == rows[0][2]]
    assert tests == ["ADD", "SEX", "C1", "C2", "ADDxSEX", "ADDxC1", "ADDxC2"]


def test_joint_models_drop_haploid_chromosomes(runs):
    """The diploid-only models leave chrY and MT out (and say so), keep
    chrX; the log lines equal plink_tpu's."""
    d = runs["dir"]
    hdr, rows = _read(d / f"plink_torch_genotypic_no_firth.PHENO1.{NOFIRTH}")
    assert {r[0] for r in rows} == {"1", "X"}
    for pkg in ("plink_tpu", "plink_torch"):
        with open(d / f"{pkg}_genotypic_no_firth.log") as f:
            said = [ln.strip() for ln in f if "non-diploid" in ln]
        assert said == ["--glm: Excluding 100 non-diploid variants "
                        "(diploid-only genotype model)."] * 2, (pkg, said)


def test_condition_log_lines_match(runs):
    d = runs["dir"]
    got = {}
    for pkg in ("plink_tpu", "plink_torch"):
        with open(d / f"{pkg}_dominant_hybrid.log") as f:
            got[pkg] = [ln.strip() for ln in f if "--condition" in ln
                        and not ln.strip().startswith("plink2t ")]
    assert got["plink_torch"] == got["plink_tpu"] == [
        "Warning: 1 --condition-list variant ID not found.",
        "--condition[-list]: 2 covariates added."]


@pytest.mark.parametrize("case", list(ERRORS))
def test_joint_model_error_matches_plink_tpu(runs, case):
    tpu = runs["error"][case]["plink_tpu"]
    got = runs["error"][case]["plink_torch"]
    assert tpu[0] != 0 and got[0] == tpu[0], (tpu[2][-1500:], got[2][-1500:])
    last = tpu[2].strip().splitlines()[-1]
    assert last.startswith("ValueError: ")
    assert got[2].strip().splitlines()[-1] == last
