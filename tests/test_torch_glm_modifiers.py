"""The --glm modifiers, the covariate / phenotype transforms and
--xchr-model 0/1/2: plink_torch against plink_tpu on the CPU.

Both CLIs run as subprocesses with 64-variant blocks on panels made by
`plink_tpu --dummy`, built as tests/test_glm_modifiers.py builds its
oracle panels:
- gp: 400 samples x 300 variants, case/control PHENO1 and a 4-covariate
  .cov (numpy seed 5); its phenotype file gp.both also carries QT, the
  PHENO1 of a `scalar-pheno` copy, so each run fits the logistic and the
  linear report in one process (a modifier that applies to one kind only is
  a no-op on the other, in both packages);
- mix: 300 x 200, the first 120 variants on chr1 and the rest on chrX,
  sexes alternating male / female with every 37th sample of unknown sex (so
  the chrX sample set differs and `pheno-ids` writes a .x.id), a
  2-covariate .cov without SEX (the automatic chrX SEX covariate) and the
  same two phenotypes;
- gb: gp as a .bed fileset (`--bfile`).

Rules: exact columns (identity, counts, A1_FREQ, FIRTH?, ERRCODE) equal;
OR / LOG(OR)_SE / Z_STAT / BETA / SE / T_STAT / P by
tests/test_glm_modifiers.py's min(SAPE, abs) < 1e-3 (both sides fit in
f32 on the device and refit borderline rows in f64 on the host);
`single-prec-cc` reports the f32 device fits unrefined, so its floats
take that test's own 0.02; .id files byte-equal; the residualize error
messages equal plink_tpu's.
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
FLOAT = ("OR", "LOG(OR)_SE", "Z_STAT", "BETA", "SE", "T_STAT", "P")
TOL = 1e-3
PARALLEL = 8  # subprocesses at a time

_CC, _QT = "PHENO1", "QT"
_LOGI = "glm.logistic.hybrid"
# id: (panel, --glm modifiers, extra flags, reports [(pheno, suffix)], .id files)
CASES = {
    "cc_residualize": ("gp", ["cc-residualize", "hide-covar"], [],
                       [(_CC, _LOGI)], []),
    "cc_residualize_no_firth": ("gp", ["cc-residualize", "no-firth",
                                       "hide-covar"], [],
                                [(_CC, "glm.logistic")], []),
    "firth_residualize_firth": ("gp", ["firth", "firth-residualize",
                                       "hide-covar"], [],
                                [(_CC, "glm.firth")], []),
    "firth_residualize_hybrid": ("gp", ["firth-residualize", "hide-covar"], [],
                                 [(_CC, _LOGI)], []),
    "cc_and_firth_residualize": ("gp", ["cc-residualize", "firth-residualize",
                                        "hide-covar"], [], [(_CC, _LOGI)], []),
    "qt_residualize": ("gp", ["qt-residualize", "hide-covar"], [],
                       [(_QT, "glm.linear")], []),
    "single_prec_cc": ("gp", ["single-prec-cc", "hide-covar"], [],
                       [(_CC, _LOGI)], []),
    "pheno_ids": ("gp", ["pheno-ids", "hide-covar"], [],
                  [(_CC, _LOGI), (_QT, "glm.linear")],
                  [f"{_CC}.{_LOGI}.id", f"{_QT}.glm.linear.id"]),
    "sex": ("gp", ["sex"], [], [(_CC, _LOGI), (_QT, "glm.linear")], []),
    "allow_no_covars": ("gp", ["allow-no-covars"], ["--no-covar"],
                        [(_CC, _LOGI), (_QT, "glm.linear")], []),
    "no_ops": ("gp", ["perm-count", "skip-invalid-pheno", "no-x-sex",
                      "cols=+a1freq", "hide-covar"], [],
               [(_CC, _LOGI), (_QT, "glm.linear")], []),
    "covar_variance_standardize": ("gp", [], ["--covar-variance-standardize"],
                                   [(_CC, _LOGI), (_QT, "glm.linear")], []),
    "variance_standardize": ("gp", [], ["--variance-standardize", "C1", "C3"],
                             [(_CC, _LOGI), (_QT, "glm.linear")], []),
    "quantile_normalize": ("gp", [], ["--quantile-normalize"],
                           [(_CC, _LOGI), (_QT, "glm.linear")], []),
    "pheno_quantile_normalize": ("gp", ["hide-covar"],
                                 ["--pheno-quantile-normalize"],
                                 [(_QT, "glm.linear")], []),
    "covar_quantile_normalize": ("gp", [], ["--covar-quantile-normalize", "C2"],
                                 [(_CC, _LOGI), (_QT, "glm.linear")], []),
    "bfile_sex": ("gb", ["sex", "hide-covar"], [],
                  [(_CC, _LOGI), (_QT, "glm.linear")], []),
    "xchr0": ("mix", [], ["--xchr-model", "0"],
              [(_CC, _LOGI), (_QT, "glm.linear")], []),
    "xchr1": ("mix", [], ["--xchr-model", "1"],
              [(_CC, _LOGI), (_QT, "glm.linear")], []),
    "xchr1_no_x_sex": ("mix", ["no-x-sex", "hide-covar"], ["--xchr-model", "1"],
                       [(_CC, _LOGI), (_QT, "glm.linear")], []),
    "xchr1_firth": ("mix", ["firth", "hide-covar"], ["--xchr-model", "1"],
                    [(_CC, "glm.firth")], []),
    "xchr1_cc_residualize": ("mix", ["cc-residualize", "hide-covar"],
                             ["--xchr-model", "1"], [(_CC, _LOGI)], []),
    "xchr1_firth_residualize": ("mix", ["firth", "firth-residualize",
                                        "hide-covar"], ["--xchr-model", "1"],
                                [(_CC, "glm.firth")], []),
    "xchr1_qt_residualize": ("mix", ["qt-residualize", "hide-covar"],
                             ["--xchr-model", "1"], [(_QT, "glm.linear")], []),
    "xchr2": ("mix", ["hide-covar"], ["--xchr-model", "2"],
              [(_CC, _LOGI), (_QT, "glm.linear")], []),
    "xchr2_sex_pheno_ids": ("mix", ["sex", "pheno-ids", "hide-covar"], [],
                            [(_CC, _LOGI), (_QT, "glm.linear")],
                            [f"{_CC}.{_LOGI}.id", f"{_QT}.glm.linear.id"]),
    "xchr2_pheno_ids": ("mix", ["pheno-ids", "hide-covar"], [],
                        [(_CC, _LOGI)],
                        [f"{_CC}.{_LOGI}.id", f"{_CC}.{_LOGI}.x.id"]),
}
# the residualize checks of plink_tpu run_glm, each a ValueError there
ERRORS = {
    "needs_hide_covar": ["cc-residualize"],
    "intercept": ["qt-residualize", "hide-covar", "intercept"],
    "interaction": ["cc-residualize", "hide-covar", "interaction"],
    "firth_residualize_no_firth": ["firth-residualize", "no-firth",
                                   "hide-covar"],
}
# what later slices port: plink_torch says so (rc 2); the genotype models,
# interaction and --condition run since the joint-models slice, permutation
# and local covariates since the permutation slice, so each case carries a
# flag that is still unported (--snps-only, --thin, --adjust-file: ROADMAP
# A4 / A5)
LATER = {
    "genotypic": ["--glm", "genotypic", "firth", "aperm", "hide-covar",
                  "--snps-only"],
    "interaction": ["--glm", "interaction", "--thin", "0.5"],
    "aperm": ["--glm", "firth", "aperm", "hide-covar", "--adjust-file",
              "gp.cov"],
    "mperm": ["--glm", "firth", "mperm=10", "hide-covar", "--thin", "0.5"],
    "condition": ["--glm", "firth", "mperm=10", "hide-covar", "--condition",
                  "snp3", "--snps-only"],
}


def _env():
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PLINK_TPU_VB="64", PLINK_TPU_DEVICES="1",
               PLINK_TORCH_VB="64", PLINK_TORCH_DEVICE="cpu", PYTHONPATH=REPO)
    return env


def _cmd(pkg, args, out):
    return [sys.executable, "-m", f"{pkg}.cli", *args, "--out", out, "--silent"]


def _run_all(cmds, cwd):
    """Run the commands, PARALLEL at a time; returns their
    CompletedProcess-like (returncode, stdout, stderr) in order."""
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
    def tpu(*args):
        r = subprocess.run(_cmd("plink_tpu", list(args[:-1]), args[-1]),
                           env=_env(), cwd=d, capture_output=True, text=True)
        assert r.returncode == 0, r.stderr[-2000:]

    tpu("--dummy", "400", "300", "0.03", "--seed", "18", "gp")
    tpu("--dummy", "400", "300", "0.03", "scalar-pheno", "--seed", "18", "gq")
    tpu("--pfile", "gp", "--make-bed", "gb")
    tpu("--dummy", "300", "200", "0.02", "--seed", "23", "base")

    def psam_rows(stem):
        lines = (d / f"{stem}.psam").read_text().splitlines()
        return lines[0], [ln.split("\t") for ln in lines[1:]]

    hdr, rows = psam_rows("gp")
    pi = hdr.lstrip("#").split("\t").index("PHENO1")
    _, qrows = psam_rows("gq")
    rng = np.random.default_rng(5)
    with open(d / "gp.cov", "w") as f:
        f.write("#IID\tC1\tC2\tC3\tC4\n")
        for r in rows:
            f.write(f"{r[0]}\t{rng.uniform():.6f}\t{rng.uniform():.6f}\t"
                    f"{rng.uniform():.6f}\t{rng.uniform():.6f}\n")
    with open(d / "gp.both", "w") as f:
        f.write(f"#IID\t{_CC}\t{_QT}\n")
        for r, q in zip(rows, qrows):
            f.write(f"{r[0]}\t{r[pi]}\t{q[pi]}\n")
    shutil.copy(d / "gp.cov", d / "gb.cov")
    shutil.copy(d / "gp.both", d / "gb.both")

    lines = (d / "base.pvar").read_text().splitlines()
    head = [ln for ln in lines if ln.startswith("#")]
    body = []
    for i, ln in enumerate(ln for ln in lines if not ln.startswith("#")):
        t = ln.split("\t")
        t[0] = "1" if i < 120 else "X"
        t[1] = str(1000 + i)
        body.append("\t".join(t))
    (d / "mix.pvar").write_text("\n".join(head + body) + "\n")
    shutil.copy(d / "base.pgen", d / "mix.pgen")
    hdr, rows = psam_rows("base")
    cols = hdr.lstrip("#").split("\t")
    si, pi = cols.index("SEX"), cols.index("PHENO1")
    out = [hdr]
    for i, t in enumerate(rows):
        t[si] = "0" if i % 37 == 36 else ("1" if i % 2 == 0 else "2")
        out.append("\t".join(t))
    (d / "mix.psam").write_text("\n".join(out) + "\n")
    rng = np.random.default_rng(9)
    with open(d / "mix.both", "w") as f:
        f.write(f"#IID\t{_CC}\t{_QT}\n")
        for t in rows:
            f.write(f"{t[0]}\t{t[pi]}\t{rng.normal():.6f}\n")
    rng = np.random.default_rng(10)
    with open(d / "mix.cov", "w") as f:
        f.write("#IID\tC1\tC2\n")
        for t in rows:
            f.write(f"{t[0]}\t{rng.normal():.6f}\t{rng.uniform():.6f}\n")


def _argv(case):
    panel, mods, extra, _, _ = CASES[case]
    no_covar = "--no-covar" in extra
    extra = [e for e in extra if e != "--no-covar"]
    flag = "--bfile" if panel == "gb" else "--pfile"
    return ([flag, panel, "--pheno", f"{panel}.both", "--glm", *mods]
            + ([] if no_covar else ["--covar", f"{panel}.cov"]) + extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (plink_tpu out prefix, plink_torch out prefix)},
    {error case: (tpu result, torch result)}, {later case: torch result};
    every subprocess of the module in one pool."""
    d = tmp_path_factory.mktemp("glmmods")
    _make_panels(d)
    cmds, keys = [], []
    for case in CASES:
        for pkg in ("plink_tpu", "plink_torch"):
            cmds.append(_cmd(pkg, _argv(case), f"{pkg}_{case}"))
            keys.append(("case", case, pkg))
    for case, mods in ERRORS.items():
        for pkg in ("plink_tpu", "plink_torch"):
            cmds.append(_cmd(pkg, ["--pfile", "gp", "--pheno", "gp.both",
                                   "--glm", *mods, "--covar", "gp.cov"],
                             f"err_{pkg}_{case}"))
            keys.append(("error", case, pkg))
    for case, args in LATER.items():
        cmds.append(_cmd("plink_torch", ["--pfile", "gp", *args, "--covar",
                                         "gp.cov"], f"later_{case}"))
        keys.append(("later", case, "plink_torch"))
    res = _run_all(cmds, d)
    out = {"case": {}, "error": {}, "later": {}}
    for (kind, case, pkg), r in zip(keys, res):
        out[kind].setdefault(case, {})[pkg] = r
        if kind == "case":
            assert r[0] == 0, (case, pkg, r[2][-3000:])
    out["dir"] = d
    return out


def _read(path):
    with open(path) as f:
        hdr = f.readline().rstrip("\n").split("\t")
        return hdr, [ln.rstrip("\n").split("\t") for ln in f]


def _float_close(x, y, tol):
    if x == y:
        return True
    fx, fy = float(x), float(y)
    sape = abs(fx - fy) / max((abs(fx) + abs(fy)) / 2, 1e-300)
    return min(sape, abs(fx - fy)) < tol


@pytest.mark.parametrize("case", list(CASES))
def test_glm_modifier_report_matches_plink_tpu(runs, case):
    d = runs["dir"]
    _, _, _, reports, ids = CASES[case]
    tol = 0.02 if case == "single_prec_cc" else TOL
    for pheno, ext in reports:
        h_ref, r_ref = _read(d / f"plink_tpu_{case}.{pheno}.{ext}")
        h_got, r_got = _read(d / f"plink_torch_{case}.{pheno}.{ext}")
        assert h_got == h_ref
        assert len(r_got) == len(r_ref) > 0, (ext, len(r_got), len(r_ref))
        for a, b in zip(r_got, r_ref):
            for col, x, y in zip(h_ref, a, b):
                if col in FLOAT and "NA" not in (x, y):
                    assert _float_close(x, y, tol), (ext, col, a, b)
                else:
                    assert col in EXACT + FLOAT and x == y, (ext, col, a, b)
    for name in ids:
        ref = (d / f"plink_tpu_{case}.{name}").read_bytes()
        assert (d / f"plink_torch_{case}.{name}").read_bytes() == ref, name
    for pkg in ("plink_tpu", "plink_torch"):  # no .x.id / .y.id beyond these
        for sfx in (".x.id", ".y.id"):
            for pheno, ext in reports:
                name = f"{pheno}.{ext}{sfx}"
                assert (d / f"{pkg}_{case}.{name}").exists() == (name in ids)


def _log_lines(path, needle):
    with open(path) as f:
        return [ln.rstrip("\n") for ln in f if needle in ln]


@pytest.mark.parametrize("case,needle", [
    ("cc_and_firth_residualize", "is redundant"),
    ("xchr0", "Excluding chrX"),
    ("covar_quantile_normalize", "--covar-quantile-normalize"),
    ("quantile_normalize", "--covar-quantile-normalize"),
    ("pheno_ids", "pheno-ids"),
])
def test_glm_modifier_log_lines_match(runs, case, needle):
    d = runs["dir"]
    ref = _log_lines(d / f"plink_tpu_{case}.log", needle)
    got = _log_lines(d / f"plink_torch_{case}.log", needle)
    assert ref and [ln.replace("plink_torch", "plink_tpu") for ln in got] == ref


def test_xchr1_covers_the_chrx_pass(runs):
    """--xchr-model 1 reports chrX with male dosages halved: A1_FREQ and the
    fits differ from --xchr-model 2's on chrX and agree on chr1."""
    d = runs["dir"]
    for ext in (f"{_CC}.{_LOGI}", f"{_QT}.glm.linear"):
        h, r1 = _read(d / f"plink_torch_xchr1.{ext}")
        _, r2 = _read(d / f"plink_torch_xchr2.{ext}")
        ti, fi = h.index("TEST"), h.index("A1_FREQ")
        r1 = [r for r in r1 if r[ti] == "ADD"]
        assert len(r1) == len(r2) == 200
        xs = [(a, b) for a, b in zip(r1, r2) if a[0] == "X"]
        assert len(xs) == 80
        assert sum(a[fi] != b[fi] for a, b in xs) > 40
        assert all(a[fi] == b[fi] for a, b in zip(r1, r2) if a[0] == "1")


@pytest.mark.parametrize("case", list(ERRORS))
def test_residualize_error_matches_plink_tpu(runs, case):
    tpu = runs["error"][case]["plink_tpu"]
    got = runs["error"][case]["plink_torch"]
    assert tpu[0] != 0 and got[0] == tpu[0], (tpu[2][-1500:], got[2][-1500:])
    last = tpu[2].strip().splitlines()[-1]
    assert last.startswith("ValueError: --glm '") and "residualize" in last
    assert got[2].strip().splitlines()[-1] == last


@pytest.mark.parametrize("case", list(LATER))
def test_later_slices_still_refused(runs, case):
    rc, _, err = runs["later"][case]["plink_torch"]
    assert rc == 2 and "not yet ported" in err, err[-1500:]


def test_plink2_flag_error_matches_plink_tpu(tmp_path):
    """A plink2 flag neither package runs: the same message and exit code
    from both CLIs (plink_tpu's help_data registry, copied into the port)."""
    res = _run_all([_cmd(pkg, ["--make-just-bim"], str(tmp_path / pkg))
                    for pkg in ("plink_tpu", "plink_torch")], tmp_path)
    (rc_t, _, err_t), (rc_g, _, err_g) = res
    assert rc_t == rc_g == 2
    assert err_g == err_t == ("Error: --make-just-bim is a plink2 flag that is "
                              "not implemented in plink-tpu yet.\n")
