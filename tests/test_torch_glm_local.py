"""--glm local-covar= / local-psam= / local-pvar=: plink_torch against
plink_tpu on the CPU.

The three cases of tests/test_glm_local.py on its panels, written here by
the port's --dummy (200 x 120, --seed 13; `gq` with `scalar-pheno`, `gp`
case/control), with the local .psam of every sample, the local .pvar of
every 30th variant (the analysis is restricted to it), two local
covariates a sample on each of its lines and a one-column .cov (numpy
seed 8).  Both packages fit every variant in f64 on the host (LOCAL1 and
LOCAL2 after the file covariates in the design, before them in the TEST
rows); the reports must be byte-identical, or else every float within
1e-3 relative (the GLM rule) with the other columns equal.  A case adds
--adjust (the host route's .adjusted) and one the cc-residualize refusal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCAL = ["--glm", "local-covar=loc.cov", "local-psam=loc.psam",
         "local-pvar=loc.pvar"]


def _env():
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PLINK_TPU_DEVICES="1",
               PLINK_TORCH_DEVICE="cpu", PYTHONPATH=REPO)
    return env


def _run(pkg, args, cwd):
    return subprocess.run([sys.executable, "-m", f"{pkg}.cli", *args, "--silent"],
                          env=_env(), cwd=cwd, capture_output=True, text=True)


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    d = tmp_path_factory.mktemp("glmlocal")
    for name, extra in (("gq", ["scalar-pheno"]), ("gp", [])):
        r = _run("plink_torch", ["--dummy", "200", "120", "0.04", *extra,
                                 "--seed", "13", "--out", name], d)
        assert r.returncode == 0, r.stderr[-2000:]
    rng = np.random.default_rng(8)
    ids = [ln.split()[0] for ln in (d / "gq.psam").read_text().splitlines()[1:]]
    (d / "loc.psam").write_text("#IID\n" + "".join(f"{i}\n" for i in ids))
    pvar = (d / "gq.pvar").read_text().splitlines()
    sel = pvar[1::30]
    (d / "loc.pvar").write_text(pvar[0] + "\n" + "\n".join(sel) + "\n")
    with open(d / "loc.cov", "w") as f:
        for _ in sel:
            f.write(" ".join(f"{rng.normal():.4f} {rng.normal():.4f}"
                             for _ in ids) + "\n")
    with open(d / "g.cov", "w") as f:
        f.write("#IID\tC1\n")
        for iid in ids:
            f.write(f"{iid}\t{rng.normal():.5f}\n")
    return d


def _compare(a, b, tol=1e-3):
    la = open(a).read().splitlines()
    lb = open(b).read().splitlines()
    assert la[0] == lb[0] and len(la) == len(lb) > 1
    for x, y in zip(la[1:], lb[1:]):
        for u, v in zip(x.split("\t"), y.split("\t")):
            if u != v:
                fu, fv = float(u), float(v)
                assert abs(fu - fv) <= tol * max(abs(fu), 1e-300), (x, y)
    return la == lb


@pytest.mark.parametrize(
    "pfx,extra,suffix",
    [
        ("gq", [], "PHENO1.glm.linear"),
        ("gp", [], "PHENO1.glm.logistic.hybrid"),
        ("gq", ["--covar", "g.cov"], "PHENO1.glm.linear"),
        ("gp", ["--covar", "g.cov", "--adjust"], "PHENO1.glm.logistic.hybrid"),
    ],
)
def test_glm_local_matches_plink_tpu(panel, pfx, extra, suffix):
    d = panel
    for pkg in ("plink_tpu", "plink_torch"):
        r = _run(pkg, ["--pfile", pfx, *LOCAL, *extra, "--out", pkg], d)
        assert r.returncode == 0, (pkg, r.stderr[-3000:])
    _compare(d / f"plink_tpu.{suffix}", d / f"plink_torch.{suffix}")
    hdr, *rows = (ln.split("\t") for ln in
                  open(d / f"plink_torch.{suffix}").read().splitlines())
    assert len({r[hdr.index("ID")] for r in rows}) == 4  # every 30th of 120
    assert {"LOCAL1", "LOCAL2"} <= {r[hdr.index("TEST")] for r in rows}
    if "--adjust" in extra:
        from plink_torch.testing import adjusted_close

        assert adjusted_close(d / f"plink_tpu.{suffix}.adjusted",
                              d / f"plink_torch.{suffix}.adjusted")


def test_local_covariates_refuse_cc_residualize(panel):
    """The residualize modifiers refuse local covariates, with plink_tpu's
    message."""
    args = ["--pfile", "gp", "--covar", "g.cov", *LOCAL, "cc-residualize",
            "hide-covar", "--out", "err"]
    tpu, got = (_run(pkg, args, panel) for pkg in ("plink_tpu", "plink_torch"))
    assert tpu.returncode != 0 and got.returncode == tpu.returncode
    assert got.stderr.strip().splitlines()[-1] == tpu.stderr.strip().splitlines()[-1]
