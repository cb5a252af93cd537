"""The --glm permutation tests (aperm / mperm=): plink_torch against
plink_tpu on the CPU.

Both CLIs run as subprocesses with 64-variant blocks on the 200 x 600
--dummy panel of tests/test_mesh_sharding.py (SEX + C1 + C2 covariates), a
QT with two planted variants (snp7, snp200; as tests/test_perm.py builds
it) and the panel's case/control PHENO1, and on its chr1/X/Y/MT copy (the
ploidy groups: chrX with SEX added, chrY on the males, MT haploid).

Both packages draw the permutations from the same numpy stream in the
same batches, so the reports can differ only where an f32 permuted
statistic sits within its rounding of the original one.  (Under
`interaction` the permuted statistic is the t of the main effect, which
the SEX interaction column all but absorbs: the planted variants are not
extreme there.)  Rules
(plink_torch.testing.perm_report_close): every column but the EMP ones
byte-identical; the EMP columns byte-identical in >= 98% of the rows and
within 3 / (N + 1) (3 counts under perm-count) elsewhere.  A joint F (the
genotypic model) carries an absolute f32 rounding that grows as n eps / q
in both packages (it differences two residual sums of ~n sigma^2 each):
at mperm=100, 12 of the 600 rows differed by a count (98.0%), so those
cases run 50 permutations.  The planted variants sit at the floor 1 / (N + 1) in
both reports.  Error messages and exit codes equal.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARALLEL = 8
PLANTED = ("snp7", "snp200")
QT = ["--pheno", "p.qt", "--pheno-name", "QT"]
COV = ["--covar", "p.cov"]
SEED = ["--seed", "4"]
# id: (fileset, argv after it, perm report, N, planted rows at the floor?)
CASES = {
    "linear_mperm": ("p", QT + COV + ["--glm", "hide-covar", "mperm=200"] + SEED,
                     "QT.glm.linear.mperm", 200, True),
    "linear_aperm": ("p", QT + COV + ["--glm", "hide-covar", "aperm", "--aperm",
                                      "6", "400"] + SEED,
                     "QT.glm.linear.aperm", 400, True),
    "firth_mperm": ("p", COV + ["--glm", "hide-covar", "firth", "mperm=40"] + SEED,
                    "PHENO1.glm.firth.mperm", 40, False),
    "dominant": ("p", QT + COV + ["--glm", "dominant", "hide-covar", "mperm=100"]
                 + SEED, "QT.glm.linear.mperm", 100, True),
    "genotypic": ("p", QT + COV + ["--glm", "genotypic", "hide-covar", "mperm=50"]
                  + SEED, "QT.glm.linear.mperm", 50, True),
    "hethom_firth": ("p", COV + ["--glm", "hethom", "firth", "hide-covar",
                                 "mperm=20"] + SEED,
                     "PHENO1.glm.firth.mperm", 20, False),
    "interaction": ("p", QT + COV + ["--glm", "interaction", "hide-covar",
                                     "mperm=100"] + SEED,
                    "QT.glm.linear.mperm", 100, False),
    "perm_count": ("p", QT + COV + ["--glm", "hide-covar", "mperm=100",
                                    "perm-count"] + SEED,
                   "QT.glm.linear.mperm", 100, True),
    "permute_qt_residuals": ("p", QT + COV + ["--glm", "hide-covar",
                                              "qt-residualize",
                                              "permute-qt-residuals",
                                              "mperm=50"] + SEED,
                             "QT.glm.linear.mperm", 50, True),
    "sx_linear": ("sx", QT + COV + ["--glm", "hide-covar", "mperm=100"] + SEED,
                  "QT.glm.linear.mperm", 100, True),
    "sx_xchr1": ("sx", QT + COV + ["--glm", "hide-covar", "no-x-sex", "mperm=50",
                                   "--xchr-model", "1"] + SEED,
                 "QT.glm.linear.mperm", 50, True),
    "sx_firth_aperm": ("sx", COV + ["--glm", "hide-covar", "firth", "aperm",
                                    "--aperm", "6", "60"] + SEED,
                       "PHENO1.glm.firth.aperm", 60, False),
}
# plink_tpu's errors for these runs, each a ValueError there
ERRORS = {
    "cc_without_firth": ("p", COV + ["--glm", "hide-covar", "mperm=10"]),
    "aperm_and_mperm": ("p", QT + COV + ["--glm", "hide-covar", "aperm",
                                         "mperm=10"]),
    "permute_qt_residuals_alone": ("p", QT + COV + ["--glm", "hide-covar",
                                                    "permute-qt-residuals",
                                                    "mperm=10"]),
    "qt_residualize_groups": ("sx", QT + COV + ["--glm", "hide-covar",
                                                "qt-residualize", "mperm=10"]),
}


def _env():
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PLINK_TPU_VB="64", PLINK_TPU_DEVICES="1",
               PLINK_TORCH_VB="64", PLINK_TORCH_DEVICE="cpu", PYTHONPATH=REPO,
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
    """The mesh-sharding panel, its SEX + C1 + C2 .cov (numpy seed 11), a QT
    with snp7 and snp200 planted (numpy seed 5) and the chr1/X/Y/MT copy."""
    r = subprocess.run(_cmd("plink_tpu", ["--dummy", "200", "600", "0.05",
                                          "--seed", "7"], "p"),
                       env=_env(), cwd=d, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(d / "p.psam") as f:
        hdr = f.readline().rstrip("\n").split("\t")
        rows = [ln.rstrip("\n").split("\t") for ln in f]
    rng = np.random.default_rng(11)
    with open(d / "p.cov", "w") as f:
        f.write("#IID\tSEX\tC1\tC2\n")
        for r_ in rows:
            f.write(f"{r_[0]}\t{r_[hdr.index('SEX')]}\t{rng.normal():.6f}\t"
                    f"{rng.normal():.6f}\n")
    sys.path.insert(0, REPO)
    from plink_torch.io.pgen_read import PgenReader
    from plink_torch.ops.planes import _unpack_np

    rd = PgenReader(str(d / "p.pgen"))
    codes = _unpack_np(rd.read_packed(0, 600))[:, : len(rows)].astype(float)
    codes[codes == 3] = np.nan
    rng = np.random.default_rng(5)
    yq = (np.nan_to_num(codes[7]) * 0.9 + np.nan_to_num(codes[200]) * 0.7
          + rng.standard_normal(len(rows)))
    with open(d / "p.qt", "w") as f:
        f.write("#IID\tQT\n")
        f.writelines(f"{r_[0]}\t{v:.6f}\n" for r_, v in zip(rows, yq))
    lines = (d / "p.pvar").read_text().splitlines()
    head = [ln for ln in lines if ln.startswith("#")]
    body = [ln.split("\t") for ln in lines if not ln.startswith("#")]
    sx = [["1" if i < 400 else "X" if i < 500 else "Y" if i < 550 else "MT"]
          + t[1:] for i, t in enumerate(body)]
    (d / "sx.pvar").write_text("\n".join(head + ["\t".join(t) for t in sx]) + "\n")
    for ext in (".pgen", ".psam"):
        (d / f"sx{ext}").write_bytes((d / f"p{ext}").read_bytes())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"case": {case: {pkg: result}}, "error": {...}, "dir": path}: every
    subprocess of the module in one pool."""
    d = tmp_path_factory.mktemp("glmperm")
    _make_panels(d)
    cmds, keys = [], []
    for kind, table in (("case", CASES), ("error", ERRORS)):
        for case, spec in table.items():
            for pkg in ("plink_tpu", "plink_torch"):
                cmds.append(_cmd(pkg, ["--pfile", spec[0], *spec[1]],
                                 f"{pkg}_{case}"))
                keys.append((kind, case, pkg))
    out = {"case": {}, "error": {}, "dir": d}
    for (kind, case, pkg), r in zip(keys, _run_all(cmds, d)):
        out[kind].setdefault(case, {})[pkg] = r
    return out


def _read(path):
    with open(path) as f:
        hdr = f.readline().rstrip("\n").split("\t")
        return hdr, [ln.rstrip("\n").split("\t") for ln in f]


@pytest.mark.parametrize("case", list(CASES))
def test_perm_report_matches_plink_tpu(runs, case):
    from plink_torch.testing import perm_report_close

    d = runs["dir"]
    res = runs["case"][case]
    for pkg in ("plink_tpu", "plink_torch"):
        assert res[pkg][0] == 0, (pkg, res[pkg][2][-3000:])
    _fileset, _args, report, n_perm, planted = CASES[case]
    ref, got = (d / f"{pkg}_{case}.{report}" for pkg in ("plink_tpu", "plink_torch"))
    ok, frac = perm_report_close(ref, got, n_perm)
    assert ok, (case, frac)
    hdr, rows = _read(got)
    assert len(rows) == 600
    if planted:
        emp = [c for c in hdr if c.startswith("EMP")]
        for pkg in ("plink_tpu", "plink_torch"):
            hdr, rows = _read(d / f"{pkg}_{case}.{report}")
            by_id = {r[hdr.index("ID")]: r for r in rows}
            for vid in PLANTED:
                for c in emp:  # the floor: no permutation reached the original
                    want = "0" if c.endswith("_CT") else None
                    v = by_id[vid][hdr.index(c)]
                    if want is not None:
                        assert v == want, (pkg, case, vid, c, v)
                    else:
                        assert float(v) == pytest.approx(1.0 / (n_perm + 1),
                                                         rel=1e-5), (pkg, vid, c, v)
    # the log lines of the permutation test are the same
    said = {}
    for pkg in ("plink_tpu", "plink_torch"):
        with open(d / f"{pkg}_{case}.log") as f:
            said[pkg] = [ln.strip().replace(pkg, "") for ln in f
                         if "ermutation" in ln and not ln.startswith("plink2")]
    assert said["plink_torch"] == said["plink_tpu"] and len(said["plink_tpu"]) == 2


@pytest.mark.parametrize("case", list(ERRORS))
def test_perm_error_matches_plink_tpu(runs, case):
    tpu = runs["error"][case]["plink_tpu"]
    got = runs["error"][case]["plink_torch"]
    assert tpu[0] != 0 and got[0] == tpu[0], (tpu[2][-1500:], got[2][-1500:])
    last = tpu[2].strip().splitlines()[-1]
    assert last.startswith("ValueError: ")
    assert got[2].strip().splitlines()[-1] == last
