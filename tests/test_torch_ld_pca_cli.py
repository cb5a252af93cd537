"""--indep-pairwise and --pca approx / allele-wts: plink_torch against
plink_tpu.

Both CLIs run as subprocesses on the CPU, with 64-variant blocks on both
sides (PLINK_TPU_VB / PLINK_TORCH_VB), all runs in parallel, one test case
per output file.  Panels: the test_mesh_sharding panel (--dummy 200 600 0.05
--seed 7, iid genotypes, 1-bp spacing) for the LD runs; a structured panel
(bench_gen.gen_panel(..., 400, 1000, seed=7, k=3)) for PCA.  Rules
(plink_torch/testing.py):
- .prune.in / .prune.out byte-identical (the r^2 decisions are exact);
- .eigenval within 1e-4 relative, .eigenvec and .eigenvec.allele within
  1e-4 absolute after matching each column's sign (the approx start matrix
  is the same numpy stream on both sides); .grm.bin within 2e-6;
- the .log lines that report what was removed, used or written equal.
Under --exclude, plink_tpu writes the r-th included variant's weights from
X's raw row r (plink_tpu/commands/pca.py:139-163); the port writes variant
v's, as plink2 does, and is held to a numpy reconstruction instead.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRUNE = (".prune.in", ".prune.out")
EIG = (".eigenval", ".eigenvec")
WTS = EIG + (".eigenvec.allele",)
# run: (panel, flags, outputs)
RUNS = {
    "ct": ("iid", ["--indep-pairwise", "50", "5", "0.2"], PRUNE),
    "kb": ("iid", ["--indep-pairwise", "20kb", "0.5"], PRUNE),
    "maf": ("iid", ["--maf", "0.05", "--indep-pairwise", "50", "5", "0.2"], PRUNE),
    # thresholds at which the walk removes a good share of the variants, and
    # a sample filter that makes the founder set a subset (compaction)
    "ct_low": ("iid", ["--indep-pairwise", "50", "5", "0.05"], PRUNE),
    "kb_low": ("iid", ["--indep-pairwise", "0.1kb", "0.02"], PRUNE),
    "mind": ("iid", ["--mind", "0.08", "--indep-pairwise", "50", "5", "0.05"], PRUNE),
    "approx": ("pca", ["--pca", "3", "approx", "--seed", "5"], EIG),
    "wts": ("pca", ["--pca", "3", "allele-wts"], WTS),
    "approx_wts": ("pca", ["--pca", "3", "approx", "allele-wts", "--seed", "5"], WTS),
    "stream": ("pca", ["--make-grm-bin", "--pca", "3", "approx", "--seed", "5"],
               (".grm.bin", ".grm.N.bin") + EIG),
}
CASES = [(run, ext) for run, (_, _, exts) in RUNS.items() for ext in exts + (".log",)]
LOG_KEYS = ("variants removed", "removed", "PCs extracted", "written to",
            "variants used")
EXCLUDED = ("snp3", "snp4", "snp5", "snp400")


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
def runs(tmp_path_factory):
    """{run: (plink_tpu out prefix, plink_torch out prefix)} and the panels;
    every run in parallel."""
    from plink_torch.bench_gen import gen_panel

    d = tmp_path_factory.mktemp("ldpca")
    panels = {"iid": str(d / "iid"), "pca": str(d / "pca")}
    _wait(_start("plink_tpu", ["--dummy", "200", "600", "0.05", "--seed", "7"],
                 panels["iid"]))
    gen_panel(panels["pca"], 400, 1000, seed=7, k=3)
    (d / "exclude.txt").write_text("\n".join(EXCLUDED) + "\n")
    out, procs = {}, []
    for run, (panel, flags, _) in RUNS.items():
        out[run] = tuple(str(d / f"{pkg}_{run}") for pkg in ("plink_tpu", "plink_torch"))
        procs += [_start(pkg, ["--pfile", panels[panel], *flags], o)
                  for pkg, o in zip(("plink_tpu", "plink_torch"), out[run])]
    excl = {pkg: str(d / f"{pkg}_exclude") for pkg in ("plink_tpu", "plink_torch")}
    procs += [_start(pkg, ["--pfile", panels["pca"], "--exclude",
                           str(d / "exclude.txt"), "--pca", "3", "allele-wts"], o)
              for pkg, o in excl.items()]
    for p in procs:
        _wait(p)
    return out, panels, excl


def _log_lines(prefix):
    name = os.path.basename(prefix)
    with open(prefix + ".log") as f:
        return [ln.replace(name, "OUT") for ln in f
                if any(k in ln for k in LOG_KEYS)]


@pytest.mark.parametrize("run,ext", CASES, ids=[f"{r}{e}" for r, e in CASES])
def test_output_matches_plink_tpu(runs, run, ext):
    from plink_torch.testing import relationship_output_close

    ref, got = (p + ext for p in runs[0][run])
    if ext == ".log":
        lines = _log_lines(runs[0][run][1])
        assert lines and lines == _log_lines(runs[0][run][0])
        return
    assert relationship_output_close(ext, ref, got), ext
    if ext == ".prune.out" and run.endswith("_low"):
        with open(got) as f:
            assert sum(1 for _ in f) > 50  # the walk did real work


def test_allele_wts_under_exclude_reconstruct(runs):
    """Under --exclude the port's .eigenvec.allele rows are the included
    variants' own weights: 0.5 (Z_v . u_k) / sqrt(lambda_k) from numpy, Z
    the GRM's standardised dosages (founder allele frequencies), u and
    lambda the run's own .eigenvec / .eigenval, within 1e-4.  plink_tpu's
    rows for snp6-snp8 (the 4th-6th included variants) hold raw rows 3-5,
    the excluded variants' zeros (ROADMAP C); its eigenvectors agree."""
    from plink_torch.io import read_pvar
    from plink_torch.testing import relationship_output_close

    _, panels, excls = runs
    excl = excls["plink_torch"]
    assert relationship_output_close(".eigenvec", excls["plink_tpu"] + ".eigenvec",
                                     excl + ".eigenvec")
    tpu = [ln.split("\t") for ln in open(excls["plink_tpu"] + ".eigenvec.allele")][1:]
    assert [r[1] for r in tpu[6:12:2]] == ["snp6", "snp7", "snp8"]
    assert all(float(x) == 0.0 for r in tpu[6:12] for x in r[-3:])
    prefix = panels["pca"]
    vi = read_pvar(prefix + ".pvar")
    keep = ~np.isin(vi.vid, EXCLUDED)
    with open(prefix + ".pgen", "rb") as f:
        head = f.read(12)
    M, N = (int(x) for x in np.frombuffer(head[3:11], "<u4"))
    pg = np.fromfile(prefix + ".pgen", np.uint8, offset=12).reshape(M, (N + 3) // 4)
    codes = ((pg[:, :, None] >> np.arange(0, 8, 2, dtype=np.uint8)) & 3).reshape(M, -1)[:, :N]
    codes = codes[keep].astype(np.float64)
    obs = codes != 3
    p = np.where(obs, codes, 0).sum(1) / (2 * obs.sum(1))
    z = np.where(obs, (codes - 2 * p[:, None]) / np.sqrt(2 * p * (1 - p))[:, None], 0.0)
    lam = np.loadtxt(excl + ".eigenval")
    u = np.loadtxt(excl + ".eigenvec", skiprows=1, usecols=(1, 2, 3))
    want = 0.5 * (z @ u) / np.sqrt(lam)
    rows = [ln.split("\t") for ln in open(excl + ".eigenvec.allele")][1:]
    assert [r[1] for r in rows[::2]] == list(vi.vid[keep])
    ref_rows = np.array([r[-3:] for r in rows[::2]], np.float64)
    alt_rows = np.array([r[-3:] for r in rows[1::2]], np.float64)
    np.testing.assert_array_equal(alt_rows, -ref_rows)
    assert float(np.abs(ref_rows - want).max()) <= 1e-4
    assert np.abs(ref_rows[3:6]).min() > 0.0


def test_ld_needs_50_founders(tmp_path):
    """Fewer than 50 samples: --indep-pairwise stops with plink_tpu's
    message; --bad-ld lets it run, with the same lists as plink_tpu."""
    from plink_torch.bench_gen import gen_panel

    prefix = str(tmp_path / "t")
    gen_panel(prefix, 40, 120, miss_rate=0.02, seed=3)
    args = ["--pfile", prefix, "--indep-pairwise", "20", "2", "0.1"]
    procs = {(pkg, bad): _start(pkg, args + (["--bad-ld"] if bad else []),
                                str(tmp_path / f"{pkg}{int(bad)}"))
             for pkg in ("plink_tpu", "plink_torch") for bad in (False, True)}
    res = {k: p.communicate() + (p.returncode,) for k, p in procs.items()}
    for pkg in ("plink_tpu", "plink_torch"):
        assert res[(pkg, False)][2] != 0
        assert "less than 50 samples" in res[(pkg, False)][1]
        assert res[(pkg, True)][2] == 0, res[(pkg, True)][1][-2000:]
    for ext in PRUNE:
        with open(tmp_path / f"plink_tpu1{ext}") as a, \
                open(tmp_path / f"plink_torch1{ext}") as b:
            assert a.read() == b.read()
