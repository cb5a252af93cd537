"""The logistic-hybrid --glm main path: plink_torch against plink_tpu.

Both CLIs run as subprocesses on the CPU on the test_mesh_sharding panel
(--dummy 200 600 0.05 --seed 7, SEX + C1 + C2 covariates), with 64-variant
blocks so the scan crosses many blocks, and on a copy whose last 200
variants sit on chrX, chrY and MT (the per-ploidy passes).  Identity and
count columns, FIRTH? and ERRCODE must match exactly; OR / LOG(OR)_SE / P
within 1e-3 relative (bench.py's GLM parity rule: both sides fit in f32 on
the device and refit borderline rows in f64 on the host), Z_STAT within
1e-3 of max(|Z|, 1) (a Z near 0 comes from a beta near 0, whose f32 noise
is large relative to itself).
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = ("#CHROM", "POS", "ID", "REF", "ALT", "PROVISIONAL_REF?", "A1",
         "OMITTED", "A1_FREQ", "FIRTH?", "TEST", "OBS_CT", "ERRCODE")
FLOAT = ("OR", "LOG(OR)_SE", "Z_STAT", "P")
MODES = {"hybrid": ([], "glm.logistic.hybrid"), "firth": (["firth"], "glm.firth"),
         "no-firth": (["no-firth"], "glm.logistic"),
         "sexchr": ([], "glm.logistic.hybrid")}


def _env():
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PLINK_TPU_VB="64", PLINK_TPU_DEVICES="1",
               PLINK_TORCH_VB="64", PLINK_TORCH_DEVICE="cpu", PYTHONPATH=REPO)
    return env


def _start(pkg, args, out):
    return subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.cli", *args, "--out", out, "--silent"],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _wait(proc):
    out, err = proc.communicate()
    assert proc.returncode == 0, err[-2000:] + out[-2000:]


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """{mode: (plink_tpu report path, plink_torch report path)}; the six
    runs go in parallel."""
    d = tmp_path_factory.mktemp("glmcli")
    prefix = str(d / "p")
    _wait(_start("plink_tpu", ["--dummy", "200", "600", "0.05", "--seed", "7"],
                 prefix))
    rng = np.random.default_rng(11)
    with open(prefix + ".psam") as f:
        hdr = f.readline().rstrip("\n").split("\t")
        sex_i = hdr.index("SEX")
        rows = [ln.split("\t") for ln in f]
    with open(prefix + ".cov", "w") as f:
        f.write("#IID\tSEX\tC1\tC2\n")
        for r in rows:
            f.write(f"{r[0]}\t{r[sex_i]}\t{rng.normal():.6f}\t{rng.normal():.6f}\n")
    sexchr = str(d / "sx")
    for ext in (".pgen", ".psam", ".cov"):
        shutil.copy(prefix + ext, sexchr + ext)
    with open(prefix + ".pvar") as f, open(sexchr + ".pvar", "w") as g:
        g.write(f.readline())
        for i, ln in enumerate(f):
            chrom = "1" if i < 400 else "X" if i < 500 else "Y" if i < 550 else "MT"
            g.write(chrom + ln[ln.index("\t"):])
    procs, out = [], {}
    for mode, (mods, ext) in MODES.items():
        p = sexchr if mode == "sexchr" else prefix
        args = ["--pfile", p, "--glm", "hide-covar", *mods, "--covar",
                p + ".cov"]
        pair = []
        for pkg in ("plink_tpu", "plink_torch"):
            o = str(d / f"{pkg}_{mode}")
            procs.append(_start(pkg, args, o))
            pair.append(f"{o}.PHENO1.{ext}")
        out[mode] = tuple(pair)
    for p in procs:
        _wait(p)
    return out


def _read(path):
    with open(path) as f:
        hdr = f.readline().rstrip("\n").split("\t")
        return hdr, [ln.rstrip("\n").split("\t") for ln in f]


@pytest.mark.parametrize("mode", list(MODES))
def test_glm_report_matches_plink_tpu(reports, mode):
    h_ref, r_ref = _read(reports[mode][0])
    h_got, r_got = _read(reports[mode][1])
    assert h_got == h_ref
    assert len(r_got) == len(r_ref) == 600
    for a, b in zip(r_got, r_ref):
        for col, x, y in zip(h_ref, a, b):
            if col in FLOAT and "NA" not in (x, y):
                x, y = float(x), float(y)
                ref = max(abs(y), 1.0) if col == "Z_STAT" else abs(y)
                assert abs(x - y) <= 1e-3 * ref, (col, a, b)
            else:
                assert col in EXACT + FLOAT and x == y, (col, a, b)


def test_hybrid_takes_the_firth_fallback(reports):
    hdr, rows = _read(reports["hybrid"][1])
    fi = hdr.index("FIRTH?")
    assert sum(r[fi] == "Y" for r in rows) >= 1


def test_sexchr_passes_cover_every_ploidy(reports):
    hdr, rows = _read(reports["sexchr"][1])
    chroms = {r[0] for r in rows if r[-1] == "."}
    assert {"1", "Y", "MT"} <= chroms and any(r[0] == "X" for r in rows)
