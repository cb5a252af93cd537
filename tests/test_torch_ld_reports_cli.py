"""The LD reports (--r2/--r tables and matrices, --ld, --clump) and
--indep-pairphase: plink_torch against plink_tpu.

Both CLIs run as subprocesses on the CPU, one pair of runs per flag set, at
most MAX_PROCS processes at a time, one test case per output file.  Panels
made by plink_tpu: `--dummy 400 250 0.04 --seed 37` (iid genotypes, 1-bp
spacing) with, in the same run, the `--glm allow-no-covars hide-covar`
report that --clump reads (the port does not run allow-no-covars yet); a
phased fileset that
`--vcf ... --make-pgen` imports from a seeded VCF of 100 samples x 60
variants with haplotype LD; and a 40-sample panel for the "< 50" refusals.
Rules: every .vcor / matrix / .bin / .vars / .clumps / .prune.* byte-
identical; the .log from the first blank line on equal, minus the
[phase]/[timing] and wall-clock lines, the out prefix masked (the --ld
block, the --clump summary, the written-to lines).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_PROCS = 12
REP = "{d}/p.PHENO1.glm.logistic.hybrid"
GENES = "1 20 60 ZGENE\n1 50 120 AGENE\n1 55 58 MGENE\n1 200 210 CGENE\n"
WIN = ["--ld-window-kb", "0.05", "--ld-window-r2", "0"]
CL = ["--clump", REP, "--clump-p1", "0.1", "--clump-p2", "0.4"]
# run: (panel, flags, outputs); the --clump parameter sets of
# tests/test_clump.py ride on the table runs
RUNS = {
    "r2u": ("p", ["--r2-unphased", "--ld", "snp10", "snp11", "--clump", REP,
                  "--clump-p1", "0.5", "--clump-p2", "0.8", "--clump-r2", "0.3",
                  "--clump-kb", "100"], (".vcor", ".clumps")),
    "r2p": ("p", ["--r2-phased", "--ld", "snp20", "snp40", "--clump", REP,
                  "--clump-p1", "0.2", "--clump-p2", "0.4", "--clump-r2", "0.5"],
            (".vcor", ".clumps")),
    "ru": ("p", ["--r-unphased", *CL, "--clump-range", "{d}/genes.txt"],
           (".vcor", ".clumps")),
    "rp": ("p", ["--r-phased", *CL, "--clump-range0", "{d}/genes.txt"],
           (".vcor", ".clumps")),
    "r2u_w": ("p", ["--r2-unphased", *WIN, *CL, "--clump-range", "{d}/genes.txt",
                    "--clump-range-border", "0.02"], (".vcor", ".clumps")),
    "r2p_w": ("p", ["--r2-phased", *WIN, *CL, "--clump-bins", "0.001,0.02,0.3"],
              (".vcor", ".clumps")),
    "ru_w": ("p", ["--r-unphased", *WIN, *CL, "--clump-allow-overlap"],
             (".vcor", ".clumps")),
    "rp_w": ("p", ["--r-phased", *WIN], (".vcor",)),
    # the matrix shapes of tests/test_vcor_matrix.py, then bin and bin4
    "m_r2u_sq": ("p", ["--r2-unphased", "square"],
                 (".unphased.vcor2", ".unphased.vcor2.vars")),
    "m_ru_sq": ("p", ["--r-unphased", "square"],
                (".unphased.vcor1", ".unphased.vcor1.vars")),
    "m_r2p_sq": ("p", ["--r2-phased", "square"],
                 (".phased.vcor2", ".phased.vcor2.vars")),
    "m_rp_sq": ("p", ["--r-phased", "square"], (".phased.vcor1", ".phased.vcor1.vars")),
    "m_r2u_tri": ("p", ["--r2-unphased", "triangle"],
                  (".unphased.vcor2", ".unphased.vcor2.vars")),
    "m_r2u_sq0": ("p", ["--r2-unphased", "square0"],
                  (".unphased.vcor2", ".unphased.vcor2.vars")),
    "m_ru_bin": ("p", ["--r-unphased", "bin"],
                 (".unphased.vcor1.bin", ".unphased.vcor1.vars")),
    "m_r2p_bin4": ("p", ["--r2-phased", "bin4"],
                   (".phased.vcor2.bin", ".phased.vcor2.vars")),
    "pairphase": ("ph", ["--indep-pairphase", "10", "3", "0.4"],
                  (".prune.in", ".prune.out")),
}
CASES = [(run, ext) for run, (_, _, exts) in RUNS.items() for ext in exts + (".log",)]
# refusals: (panel, flags, message both must print)
REFUSALS = {
    "few_ld": ("few", ["--ld", "snp1", "snp2"], "less than 50 samples"),
    "few_pairphase": ("few", ["--indep-pairphase", "10", "3", "0.4"],
                      "less than 50 samples"),
    "unphased_pairphase": ("p", ["--indep-pairphase", "10", "3", "0.4"],
                           "variant #0 is not fully phased"),
}


def _env():
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PLINK_TPU_DEVICES="1",
               PLINK_TORCH_DEVICE="cpu", PYTHONPATH=REPO,
               # small panels: one thread a process, many processes at once
               OMP_NUM_THREADS="1", XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=1")
    return env


def _start(pkg, args, out):
    return subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.cli", *args, "--out", out, "--silent"],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _run_all(jobs):
    """Run {key: (pkg, args, out)} at most MAX_PROCS at a time; returns
    {key: (returncode, stdout, stderr)}."""
    pending, running, done = list(jobs.items()), {}, {}
    while pending or running:
        while pending and len(running) < MAX_PROCS:
            key, (pkg, args, out) = pending.pop(0)
            running[key] = _start(pkg, args, out)
        for key in [k for k, p in running.items() if p.poll() is not None]:
            p = running.pop(key)
            out, err = p.communicate()
            done[key] = (p.returncode, out, err)
        time.sleep(0.05)
    return done


def _ok(res):
    rc, out, err = res
    assert rc == 0, err[-2000:] + out[-2000:]


def _phased_vcf(path):
    """100 samples x 60 variants of phased haplotypes with LD (each
    haplotype keeps its allele with probability 0.8 a step), numpy seed 7."""
    rng = np.random.default_rng(7)
    n, v = 100, 60
    haps = np.zeros((2 * n, v), np.int8)
    x = rng.random(2 * n) < 0.5
    for k in range(v):
        redraw = rng.random(2 * n) < 0.2
        x = np.where(redraw, rng.random(2 * n) < 0.5, x)
        haps[:, k] = x
    lines = ["##fileformat=VCFv4.2", "##contig=<ID=1>",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(f"s{i}" for i in range(n))]
    for k in range(v):
        gts = "\t".join(f"{haps[2 * s, k]}|{haps[2 * s + 1, k]}" for s in range(n))
        lines.append(f"1\t{100 + 3 * k}\tv{k}\tA\tC\t.\t.\t.\tGT\t{gts}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{run: (plink_tpu out prefix, plink_torch out prefix)}, the refusals'
    results, and the panels."""
    d = tmp_path_factory.mktemp("ldrep")
    panels = {"p": str(d / "p"), "ph": str(d / "ph"), "few": str(d / "few")}
    (d / "genes.txt").write_text(GENES)
    _phased_vcf(d / "ph.vcf")
    setup = _run_all({
        "p": ("plink_tpu", ["--dummy", "400", "250", "0.04", "--seed", "37",
                            "--glm", "allow-no-covars", "hide-covar"], panels["p"]),
        "ph": ("plink_tpu", ["--vcf", str(d / "ph.vcf"), "--make-pgen"],
               panels["ph"]),
        "few": ("plink_tpu", ["--dummy", "40", "120", "0.02", "--seed", "3"],
                panels["few"])})
    for res in setup.values():
        _ok(res)
    jobs, out = {}, {}
    for run, (panel, flags, _) in RUNS.items():
        out[run] = tuple(str(d / f"{pkg}_{run}") for pkg in ("plink_tpu", "plink_torch"))
        for pkg, o in zip(("plink_tpu", "plink_torch"), out[run]):
            jobs[(run, pkg)] = (pkg, ["--pfile", panels[panel],
                                      *(a.format(d=d) for a in flags)], o)
    for name, (panel, flags, _) in REFUSALS.items():
        for pkg in ("plink_tpu", "plink_torch"):
            jobs[(name, pkg)] = (pkg, ["--pfile", panels[panel], *flags],
                                 str(d / f"{pkg}_{name}"))
    res = _run_all(jobs)
    for run in RUNS:
        for pkg in ("plink_tpu", "plink_torch"):
            _ok(res[(run, pkg)])
    return out, res


def _log_lines(prefix):
    name = os.path.basename(prefix)
    with open(prefix + ".log") as f:
        text = f.read()
    body = text[text.index("\n\n") + 2:]
    return [ln.replace(name, "OUT") for ln in body.splitlines()
            if not ln.startswith(("[phase]", "[timing]", "End of run", "End time"))]


@pytest.mark.parametrize("run,ext", CASES, ids=[f"{r}{e}" for r, e in CASES])
def test_output_matches_plink_tpu(runs, run, ext):
    ref, got = runs[0][run]
    if ext == ".log":
        lines = _log_lines(got)
        assert lines and lines == _log_lines(ref)
        return
    with open(ref + ext, "rb") as a, open(got + ext, "rb") as b:
        want = a.read()
        assert b.read() == want
    assert len(want) > 0
    if run.startswith("m_") and ext.endswith(".bin"):
        width = 4 if "bin4" in run else 8
        assert len(want) == 250 * 250 * width


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusal_matches_plink_tpu(runs, name):
    """The "< 50 samples" guard of --ld and --indep-pairphase (before the
    phase check) and the "not fully phased" error on an unphased fileset:
    both CLIs stop with the same message."""
    msg = REFUSALS[name][2]
    for pkg in ("plink_tpu", "plink_torch"):
        rc, _, err = runs[1][(name, pkg)]
        assert rc != 0 and msg in err, (pkg, err[-2000:])


def test_reports_did_work(runs):
    """The window runs wrote rows, the --ld runs printed their block, the
    clump runs formed clumps and the phased pruning removed variants."""
    out = runs[0]
    with open(out["r2p_w"][1] + ".vcor") as f:
        assert sum(1 for _ in f) > 1000
    text = open(out["r2u"][1] + ".log").read()
    assert "--ld snp10 snp11:" in text and "valid samples" in text
    assert "clumps formed" in open(out["r2p"][1] + ".log").read()
    with open(out["pairphase"][1] + ".prune.out") as f:
        assert sum(1 for _ in f) > 5
