"""`--glm interaction` wider than d = 96: plink_torch against plink_tpu on the
CPU.

Forty-eight seeded Gaussian covariates (numpy seed 31) on a 1,500 x 8
`--dummy` panel (seed 30) make the design [1 | W0..W47 | ADD | ADD x W0..W47]
d = 98 wide, past the 96 columns the port's CUDA kernels once took (the
plain versions run here: K15 / K16 with their tile lists split over CTAs
and K4 in shared or device memory run on the card, tests/test_torch_cuda.py
and chip_smoke.py).  The phenotype file carries the case/control PHENO1
and a Gaussian QT (seed 32), so one run writes the logistic and the linear
report.  plink_tpu runs once for the module (about a minute: most of it is
tracing and compiling its unrolled d x d contractions).

Rules (tests/test_torch_glm_joint.py's): identity, count, FIRTH? and
ERRCODE columns equal; OR / SE / P within 1e-3 relative; BETA within 1e-3
of max(|BETA|, SE); T / Z within 1e-3 of max(|stat|, 1).  A variant whose
logistic floats differ beyond the rule is held to a numpy f64 fit of its
design at any stop an f32 fit can take (plink_torch.testing.f64_logit with
slack 10); HELD fixes how many.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M, K = 1500, 8, 48
TOL = 1e-3
STATS = ("Z_STAT", "T_STAT")
RELATIVE = ("OR", "LOG(OR)_SE", "BETA", "SE", "P")
REPORTS = ("PHENO1.glm.logistic.hybrid", "QT.glm.linear")
# variants held to f64: what the seeded panel shows (snp1, logistic)
HELD = {"PHENO1.glm.logistic.hybrid": 1, "QT.glm.linear": 0}


def _env():
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PLINK_TPU_DEVICES="1",
               PLINK_TORCH_DEVICE="cpu", PYTHONPATH=REPO)
    return env


def _cli(pkg, args, out, cwd):
    return subprocess.Popen([sys.executable, "-m", f"{pkg}.cli", *args, "--out",
                             out, "--silent"], env=_env(), cwd=cwd,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    d = tmp_path_factory.mktemp("glmwide")
    p = _cli("plink_tpu", ["--dummy", str(N), str(M), "0.02", "--seed", "30"],
             "w", d)
    assert p.wait() == 0, p.stderr.read()[-2000:]
    with open(d / "w.psam") as f:
        hdr = f.readline().rstrip("\n").split("\t")
        rows = [ln.rstrip("\n").split("\t") for ln in f]
    cov = np.random.default_rng(31).normal(size=(N, K))
    with open(d / "w.cov", "w") as f:
        f.write("#IID\t" + "\t".join(f"W{j}" for j in range(K)) + "\n")
        for r, c in zip(rows, cov):
            f.write(r[0] + "\t" + "\t".join(f"{x:.5f}" for x in c) + "\n")
    qt = np.random.default_rng(32).normal(size=N)
    with open(d / "w.both", "w") as f:
        f.write("#IID\tPHENO1\tQT\n")
        for r, q in zip(rows, qt):
            f.write(f"{r[0]}\t{r[hdr.index('PHENO1')]}\t{q:.6f}\n")
    args = ["--pfile", "w", "--pheno", "w.both", "--covar", "w.cov", "--glm",
            "interaction"]
    procs = {pkg: _cli(pkg, args, pkg, d) for pkg in ("plink_tpu", "plink_torch")}
    res = {pkg: (p.wait(), p.stderr.read()) for pkg, p in procs.items()}
    return d, res


def _read(path):
    with open(path) as f:
        hdr = f.readline().rstrip("\n").split("\t")
        return hdr, [ln.rstrip("\n").split("\t") for ln in f]


def _close(col, x, y, se):
    if x == y:
        return True
    scale = (max(abs(y), 1.0) if col in STATS
             else max(abs(y), se or 0.0) if col == "BETA" else abs(y))
    return abs(x - y) <= TOL * scale


def _f64_fits(d, rows, col):
    """{TEST: (OR, SE, Z, P)} of the variant's f64 logistic fits at every stop
    an f32 fit can take."""
    from scipy.special import ndtr

    from plink_torch.io.pgen_read import PgenReader
    from plink_torch.ops.planes import _unpack_np
    from plink_torch.testing import f64_logit

    r0 = rows[0]
    codes = _unpack_np(PgenReader(str(d / "w.pgen"), sample_ct=N)
                       .read_packed(int(r0[col["ID"]][3:]), 1))[0][:N]
    g = codes.astype(float)
    if r0[col["A1"]] != r0[col["ALT"]]:
        g = 2.0 - g
    cov = np.loadtxt(d / "w.cov", skiprows=1, usecols=range(1, K + 1))
    y = np.loadtxt(d / "w.both", skiprows=1, usecols=(1,))
    keep = (codes != 3) & (y > 0)
    X = np.column_stack([np.ones(N), cov, g, g[:, None] * cov])[keep]
    names = (["INTERCEPT"] + [f"W{j}" for j in range(K)] + ["ADD"]
             + [f"ADDxW{j}" for j in range(K)])
    out = []
    for b, se, _ in f64_logit(X, (y[keep] == 2).astype(float), slack=10.0):
        z = b / se
        out.append({n: (np.exp(b[i]), se[i], z[i], 2.0 * ndtr(-abs(z[i])))
                    for i, n in enumerate(names)})
    return out


@pytest.mark.parametrize("report", REPORTS)
def test_interaction_d98_matches_plink_tpu(wide, report):
    d, res = wide
    for pkg, (rc, err) in res.items():
        assert rc == 0, (pkg, err[-3000:])
    hdr, ref = _read(d / f"plink_tpu.{report}")
    h2, got = _read(d / f"plink_torch.{report}")
    assert h2 == hdr and len(got) == len(ref) == M * (2 * K + 1)
    col = {c: hdr.index(c) for c in hdr}
    se_c = "SE" if "SE" in col else "LOG(OR)_SE"
    differ = set()
    for a, b in zip(got, ref):
        for c, x, y in zip(hdr, a, b):
            if c in RELATIVE + STATS and "NA" not in (x, y):
                se = float(b[col[se_c]]) if b[col[se_c]] != "NA" else None
                if not _close(c, float(x), float(y), se):
                    differ.add(a[col["ID"]])
            else:
                assert x == y, (c, a, b)
    for vid in differ:
        assert "OR" in col, vid  # the linear report: f64 solves on both sides
        rows = [a for a in got if a[col["ID"]] == vid]
        fits = _f64_fits(d, rows, col)
        assert any(all(_close(c, float(a[col[c]]), w[a[col["TEST"]]][i],
                              w[a[col["TEST"]]][1])
                       for a in rows if a[col["ERRCODE"]] == "."
                       for i, c in ((0, "OR"), (1, "LOG(OR)_SE"), (2, "Z_STAT"),
                                    (3, "P")))
                   for w in fits), vid
    assert len(differ) == HELD[report]
    tests = [a[col["TEST"]] for a in got if a[col["ID"]] == got[0][col["ID"]]]
    assert tests[-1] == f"ADDxW{K - 1}" and len(tests) == 2 * K + 1
