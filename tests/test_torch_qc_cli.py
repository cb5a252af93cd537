"""QC reports and the filter chain: plink_torch against plink_tpu.

Both CLIs run as subprocesses on the CPU, with 64-variant blocks, on the
test_mesh_sharding panel (--dummy 200 600 0.05 --seed 7; SEX + C1 + C2
covariates; QT1 from np.random.default_rng(3)) and on a copy whose last 200
variants sit on chrX, chrY and MT.  Counts are exact integers on both sides,
so every report must be byte-identical: .afreq/.acount (default columns,
`counts`, `cols=`), .gcount, .vmiss, .smiss, .hardy and .hardy.x (with and
without `midp`).  So must the filter chain's removal lines in the .log, and
the samples and variants that survive it: the samples through the reports
written after --mind, the variants through the --glm rows written after
--geno/--hwe/--maf.
"""

import filecmp
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILTERS = ["--mind", "0.08", "--geno", "0.06", "--hwe", "1e-2", "--maf", "0.05"]
# run: (fileset, flags, reports that must be byte-identical)
RUNS = {
    "reports": ("p", ["--freq", "--geno-counts", "--missing", "--hardy"],
                (".afreq", ".gcount", ".vmiss", ".smiss", ".hardy")),
    "sexchr": ("sx", ["--freq", "counts", "--geno-counts", "--missing",
                      "--hardy", "midp"],
               (".acount", ".gcount", ".vmiss", ".smiss", ".hardy", ".hardy.x")),
    "cols": ("sx", ["--freq", "cols=chrom,pos,ref,alt1,alt,reffreq,alt1freq,eq,nobs",
                    "--hardy"], (".afreq", ".hardy", ".hardy.x")),
    "chain": ("p", ["--pheno", "{d}/p.qt", "--pheno-name", "QT1", "--covar",
                    "{d}/p.cov", "--freq", "--missing", *FILTERS, "--glm",
                    "hide-covar"], (".afreq", ".vmiss", ".smiss")),
    "select": ("sx", ["--keep", "{d}/keep.txt", "--remove", "{d}/remove.txt",
                      "--keep-founders", "--extract", "{d}/extract.txt",
                      "--exclude", "{d}/exclude.txt", "--chr", "1,X,Y",
                      "--geno-counts", "--missing", "--hardy"],
               (".gcount", ".vmiss", ".smiss", ".hardy", ".hardy.x")),
    "bounds": ("sx", ["--extract", "bed1", "{d}/ranges.txt", "--not-chr", "MT",
                      "--autosome-par", "--freq", "counts", "--hardy", "midp",
                      "--hwe", "0.05", "midp", "--mac", "3", "--max-maf",
                      "0.45", "--geno-counts"], (".acount", ".hardy", ".gcount")),
}
CASES = [(run, ext) for run, (_, _, exts) in RUNS.items() for ext in exts]


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


def make_panels(d):
    """The test panel <d>/p (with p.cov and p.qt) and its sex-chromosome
    copy <d>/sx; returns the IIDs."""
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
    rng = np.random.default_rng(3)
    with open(prefix + ".qt", "w") as f:
        f.write("#IID\tQT1\n")
        for r in rows:
            f.write(f"{r[0]}\t{rng.normal():.6f}\n")
    sexchr = str(d / "sx")
    for ext in (".pgen", ".psam", ".cov", ".qt"):
        shutil.copy(prefix + ext, sexchr + ext)
    with open(prefix + ".pvar") as f, open(sexchr + ".pvar", "w") as g:
        g.write(f.readline())
        for i, ln in enumerate(f):
            chrom = "1" if i < 400 else "X" if i < 500 else "Y" if i < 550 else "MT"
            g.write(chrom + ln[ln.index("\t"):])
    return [r[0] for r in rows]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{run: (plink_tpu out prefix, plink_torch out prefix)}; all the runs
    go in parallel."""
    d = tmp_path_factory.mktemp("qccli")
    iids = make_panels(d)
    (d / "keep.txt").write_text("".join(f"{i}\n" for i in iids[:170]))
    (d / "remove.txt").write_text(f"0\t{iids[3]}\n0\t{iids[5]}\n")
    (d / "extract.txt").write_text(" ".join(f"snp{i}" for i in range(380, 560)))
    (d / "exclude.txt").write_text("snp400\nsnp401\nsnp520\n")
    (d / "ranges.txt").write_text("1\t50\t300\nX\t1\t1000\n")
    procs, out = [], {}
    for run, (fileset, flags, _) in RUNS.items():
        args = ["--pfile", str(d / fileset)] + [a.format(d=d) for a in flags]
        pair = []
        for pkg in ("plink_tpu", "plink_torch"):
            o = str(d / f"{pkg}_{run}")
            procs.append(_start(pkg, args, o))
            pair.append(o)
        out[run] = tuple(pair)
    for p in procs:
        _wait(p)
    return out


@pytest.mark.parametrize("run,ext", CASES, ids=[f"{r}{e}" for r, e in CASES])
def test_report_matches_plink_tpu(runs, run, ext):
    ref, got = runs[run]
    assert filecmp.cmp(ref + ext, got + ext, shallow=False), ext


def _filter_lines(prefix):
    with open(prefix + ".log") as f:
        return [ln for ln in f if "removed" in ln or "remaining" in ln]


@pytest.mark.parametrize("run", ["chain", "select", "bounds"])
def test_filter_log_lines_match(runs, run):
    ref, got = runs[run]
    lines = _filter_lines(got)
    assert lines == _filter_lines(ref)
    if run == "chain":  # every filter of the chain removes something
        assert len(lines) == 4 and all(int(ln.split()[ln.startswith("--")]) > 0
                                       for ln in lines), lines


def test_chain_survivors_match(runs):
    """The variants that survive --geno/--hwe/--maf are the --glm rows; the
    samples that survive --mind are the .smiss rows (byte-identical above)."""
    ref, got = runs["chain"]
    ids = []
    for prefix in (ref, got):
        with open(prefix + ".QT1.glm.linear") as f:
            f.readline()
            ids.append([ln.split("\t")[2] for ln in f])
        with open(prefix + ".smiss") as f:
            assert sum(1 for _ in f) - 1 < 200  # --mind removed samples
    assert ids[0] == ids[1] and 0 < len(ids[0]) < 600
