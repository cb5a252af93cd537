"""--adjust: plink_torch's .adjusted reports against plink_tpu's on the CPU.

Both CLIs run as subprocesses with 64-variant blocks on the 200 x 600
--dummy panel of tests/test_mesh_sharding.py (SEX + C1 + C2 covariates;
one phenotype file with PHENO1 and a Gaussian QT, so a run writes the
logistic and the linear report and an .adjusted after each), its
chr1/X/Y/MT copy (the ploidy-group route: one .adjusted over the groups)
and a 300 x 150 dosage panel written by the port's --dummy (the dosage
route, device and host).

The .adjusted columns are functions of the report's P column, whose floats
two f32 packages agree on to the GLM rule (1e-3 relative), so the rule
(plink_torch.testing.adjusted_close) is: the same rows, every p-value
within 1e-3 relative, the order equal but where two rows' UNADJ are
within it; the genomic-inflation log line's lambda within 1e-3 too.  A
model without one of plink_tpu's --adjust tests (the linear `hetonly`)
writes no .adjusted in either package and logs the same line.
"""

import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARALLEL = 8
LOGI, LIN = "PHENO1.glm.logistic.hybrid", "QT.glm.linear"
# id: (argv, reports followed by an .adjusted)
CASES = {
    "additive": (["--pfile", "p", "--pheno", "p.both", "--covar", "p.cov",
                  "--glm", "hide-covar", "--adjust"], [LOGI, LIN]),
    "firth_hethom": (["--pfile", "p", "--covar", "p.cov", "--glm", "hethom",
                      "firth", "hide-covar", "--adjust"], ["PHENO1.glm.firth"]),
    "dominant_no_firth": (["--pfile", "p", "--pheno", "p.both", "--covar", "p.cov",
                           "--glm", "dominant", "no-firth", "hide-covar",
                           "--adjust"], ["PHENO1.glm.logistic", LIN]),
    "hetonly": (["--pfile", "p", "--pheno", "p.both", "--covar", "p.cov", "--glm",
                 "hetonly", "hide-covar", "--adjust"], [LOGI]),
    "groups": (["--pfile", "sx", "--pheno", "p.both", "--covar", "p.cov",
                "--glm", "hide-covar", "--adjust"], [LOGI, LIN]),
    "dosage": (["--pfile", "d", "--pheno", "d.both", "--covar", "d.cov", "--glm",
                "hide-covar", "--adjust"], [LOGI, LIN]),
    "dosage_genotypic": (["--pfile", "d", "--pheno", "d.both", "--covar", "d.cov",
                          "--glm", "genotypic", "hide-covar", "--adjust"],
                         [LOGI, LIN]),
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


def _side_files(d, stem, seed):
    """<stem>.cov (SEX + C1 + C2) and <stem>.both (PHENO1, QT) of a panel."""
    with open(d / f"{stem}.psam") as f:
        hdr = f.readline().rstrip("\n").split("\t")
        rows = [ln.rstrip("\n").split("\t") for ln in f]
    rng = np.random.default_rng(seed)
    with open(d / f"{stem}.cov", "w") as f, open(d / f"{stem}.both", "w") as g:
        f.write("#IID\tSEX\tC1\tC2\n")
        g.write("#IID\tPHENO1\tQT\n")
        for r in rows:
            f.write(f"{r[0]}\t{r[hdr.index('SEX')]}\t{rng.normal():.6f}\t"
                    f"{rng.normal():.6f}\n")
            g.write(f"{r[0]}\t{r[hdr.index('PHENO1')]}\t{rng.normal():.6f}\n")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("glmadjust")
    made = _run_all([_cmd("plink_tpu", ["--dummy", "200", "600", "0.05", "--seed",
                                        "7"], "p"),
                     _cmd("plink_torch", ["--dummy", "300", "150", "0.05",
                                          "dosage-freq=0.5", "--seed", "3"], "d")],
                    d)
    assert all(r[0] == 0 for r in made), [r[2][-2000:] for r in made]
    _side_files(d, "p", 11)
    _side_files(d, "d", 13)
    lines = (d / "p.pvar").read_text().splitlines()
    head = [ln for ln in lines if ln.startswith("#")]
    body = [ln.split("\t") for ln in lines if not ln.startswith("#")]
    sx = [["1" if i < 400 else "X" if i < 500 else "Y" if i < 550 else "MT"]
          + t[1:] for i, t in enumerate(body)]
    (d / "sx.pvar").write_text("\n".join(head + ["\t".join(t) for t in sx]) + "\n")
    for ext in (".pgen", ".psam"):
        (d / f"sx{ext}").write_bytes((d / f"p{ext}").read_bytes())
    cmds, keys = [], []
    for case, (args, _) in CASES.items():
        for pkg in ("plink_tpu", "plink_torch"):
            cmds.append(_cmd(pkg, args, f"{pkg}_{case}"))
            keys.append((case, pkg))
    out = {"dir": d}
    for (case, pkg), r in zip(keys, _run_all(cmds, d)):
        out.setdefault(case, {})[pkg] = r
    return out


def _lambdas(path):
    with open(path) as f:
        return [float(m.group(1)) for m in
                (re.search(r"lambda \(based on median chisq\) = (\S+)\.$", ln.strip())
                 for ln in f) if m]


@pytest.mark.parametrize("case", list(CASES))
def test_adjusted_matches_plink_tpu(runs, case):
    from plink_torch.testing import adjusted_close

    d = runs["dir"]
    for pkg in ("plink_tpu", "plink_torch"):
        assert runs[case][pkg][0] == 0, (pkg, runs[case][pkg][2][-3000:])
    for rep in CASES[case][1]:
        ref, got = (d / f"{pkg}_{case}.{rep}.adjusted"
                    for pkg in ("plink_tpu", "plink_torch"))
        assert adjusted_close(ref, got), (case, rep)
        with open(got) as f:
            assert sum(1 for _ in f) > 100
    lam = [_lambdas(d / f"{pkg}_{case}.log") for pkg in ("plink_tpu", "plink_torch")]
    assert len(lam[0]) == len(lam[1]) == len(CASES[case][1])
    np.testing.assert_allclose(lam[1], lam[0], rtol=1e-3)


def test_adjust_without_a_test_skips_as_plink_tpu(runs):
    """The linear `hetonly` report has none of plink_tpu's --adjust tests:
    no .adjusted, and the same log line."""
    d = runs["dir"]
    said = {}
    for pkg in ("plink_tpu", "plink_torch"):
        assert not (d / f"{pkg}_hetonly.{LIN}.adjusted").exists()
        with open(d / f"{pkg}_hetonly.log") as f:
            said[pkg] = [ln.strip() for ln in f if "no valid tests" in ln]
    assert said["plink_torch"] == said["plink_tpu"] == [
        "--adjust: no valid tests for QT; skipping."]
