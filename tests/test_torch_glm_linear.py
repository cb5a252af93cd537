"""The linear --glm (quantitative phenotype): plink_torch against plink_tpu.

Both CLIs run as subprocesses on the CPU, with 64-variant blocks, on the
panels of test_torch_qc_cli.py: QT1 from np.random.default_rng(3), SEX + C1
+ C2 covariates, and the copy whose last 200 variants sit on chrX, chrY and
MT (the per-ploidy passes).  Identity and count columns and ERRCODE must
match exactly; BETA / SE / P within 1e-3 relative and T_STAT within 1e-3 of
max(|T|, 1), the rule of test_torch_glm_cli.py: both sides sum the plane
statistics in f32 and solve in f64 on the host, so the floats carry f32
noise, and a T near 0 comes from a beta near 0 whose noise is large
relative to itself.
"""

import pytest
from test_torch_qc_cli import _start, _wait, make_panels

EXACT = ("#CHROM", "POS", "ID", "REF", "ALT", "PROVISIONAL_REF?", "A1",
         "OMITTED", "A1_FREQ", "FIRTH?", "TEST", "OBS_CT", "ERRCODE")
FLOAT = ("BETA", "SE", "T_STAT", "OR", "LOG(OR)_SE", "Z_STAT", "P",
         "NEG_LOG10_P")
# mode: (fileset, phenotype file, --glm modifiers, reports)
MODES = {
    "hide-covar": ("p", "p.qt", ["hide-covar"], ["QT1.glm.linear"]),
    "covariates": ("p", "p.qt", [], ["QT1.glm.linear"]),
    "modifiers": ("p", "p.qt", ["intercept", "omit-ref", "log10"],
                  ["QT1.glm.linear"]),
    "sexchr": ("sx", "sx.qt", ["hide-covar"], ["QT1.glm.linear"]),
    # --pheno without --pheno-name reads every column of the file: PHENO1
    # takes the logistic path and QT1 the linear one, in one process
    "two-phenos": ("p", "p.both", ["hide-covar"],
                   ["PHENO1.glm.logistic.hybrid", "QT1.glm.linear"]),
}
CASES = [(m, r) for m, (_, _, _, reps) in MODES.items() for r in reps]


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """{(mode, report): (plink_tpu path, plink_torch path)}; the ten runs
    go in parallel."""
    d = tmp_path_factory.mktemp("glmlin")
    make_panels(d)
    with open(d / "p.psam") as f, open(d / "p.qt") as q, \
            open(d / "p.both", "w") as g:
        f.readline()
        q.readline()
        g.write("#IID\tPHENO1\tQT1\n")
        for ln, lq in zip(f, q):
            iid, _sex, pheno = ln.rstrip("\n").split("\t")
            g.write(f"{iid}\t{pheno}\t{lq.rstrip().split()[1]}\n")
    procs, out = [], {}
    for mode, (fileset, pheno, mods, reps) in MODES.items():
        p = str(d / fileset)
        args = ["--pfile", p, "--pheno", str(d / pheno), "--covar", p + ".cov",
                "--glm", *mods]
        if pheno != "p.both":
            args += ["--pheno-name", "QT1"]
        prefixes = []
        for pkg in ("plink_tpu", "plink_torch"):
            o = str(d / f"{pkg}_{mode}")
            procs.append(_start(pkg, args, o))
            prefixes.append(o)
        for r in reps:
            out[mode, r] = tuple(f"{o}.{r}" for o in prefixes)
    for proc in procs:
        _wait(proc)
    return out


def _read(path):
    with open(path) as f:
        hdr = f.readline().rstrip("\n").split("\t")
        return hdr, [ln.rstrip("\n").split("\t") for ln in f]


@pytest.mark.parametrize("mode,report", CASES, ids=[f"{m}-{r}" for m, r in CASES])
def test_glm_report_matches_plink_tpu(reports, mode, report):
    h_ref, r_ref = _read(reports[mode, report][0])
    h_got, r_got = _read(reports[mode, report][1])
    assert h_got == h_ref
    assert len(r_got) == len(r_ref) >= 600
    for a, b in zip(r_got, r_ref):
        for col, x, y in zip(h_ref, a, b):
            if col in FLOAT and "NA" not in (x, y):
                x, y = float(x), float(y)
                ref = max(abs(y), 1.0) if col in ("T_STAT", "Z_STAT") else abs(y)
                assert abs(x - y) <= 1e-3 * ref, (col, a, b)
            else:
                assert col in EXACT + FLOAT and x == y, (col, a, b)


def test_linear_report_has_every_test(reports):
    """Without hide-covar every covariate has its row; the sexchr copy
    reports each ploidy's variants."""
    hdr, rows = _read(reports["covariates", "QT1.glm.linear"][1])
    assert {r[hdr.index("TEST")] for r in rows} == {"ADD", "SEX", "C1", "C2"}
    hdr, rows = _read(reports["sexchr", "QT1.glm.linear"][1])
    assert {r[0] for r in rows if r[-1] == "."} == {"1", "Y", "MT"}
    assert sum(r[0] == "X" for r in rows) == 100
