"""The sample reports and scoring: plink_torch against plink_tpu.

Both CLIs run as subprocesses on the CPU, with 64-variant blocks, the cases
of plink_torch.testing.SR_RUNS (chip_smoke.py's phase 17f runs the same
cases, card against CPU): on the 200 x 600 `--dummy` panel (seed 7) and on
a copy whose last 200 variants sit on chrX, chrY and MT and whose alleles
are transitions, transversions, indels and symbolic ALTs (so that every
.scount column counts something), on a dosage `--dummy` panel, and on
small panels for the frequency guard.  Every report must be
byte-identical: .het, .scount, .sexcheck, .sscore (.sscore.vars; one per
--q-score-range range), .vscore (.vscore.bin / .cols / .vars), and the
command lines of the .log; so must the frequency guard's errors and exit
codes.  The text reports' floats are formatted to 6 significant figures
from f64 sums that the two packages take in different orders; no row of
these panels sits on a rounding boundary.  Two outputs whose bytes depend
on the summation order are held to numpy f64 instead: the f64 .vscore.bin
(last bits), and `single-prec`'s f32 sums, which differ from plink_tpu's
in the last printed digits of many rows (f32 sums over the samples in
another order, up to ~2e-7 of sum |weight x dosage|; not a rounding
boundary), so its floats are held to 1e-5 of that sum and only its header
and variant columns byte for byte.
"""

import filecmp
import glob
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from plink_torch.testing import (SR_ERRORS, SR_ORDER_DEPENDENT, SR_RUNS,
                                 write_sample_report_inputs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(run, ext) for run, (_, _, exts) in SR_RUNS.items() for ext in exts
         if (run, ext) not in SR_ORDER_DEPENDENT]
# .log lines of the commands (not the banner, the timings or the [phase] lines)
LOG_TAGS = ("--het", "--sample-counts", "--check-sex", "--impute-sex", "--score",
            "--variant-score", "--read-freq", "Report written", "Warning",
            "Error")


def _env():
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PLINK_TPU_VB="64", PLINK_TPU_DEVICES="1",
               PLINK_TORCH_VB="64", PLINK_TORCH_DEVICE="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
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
    """<d>/p (the 200 x 600 panel), <d>/dp (a 200 x 300 dosage panel) and
    <d>/tiny (40 samples) by plink_tpu --dummy, plink_tpu's .afreq of p, and
    SR_RUNS's other filesets and files (write_sample_report_inputs)."""
    procs = [_start("plink_tpu", ["--dummy", "200", "600", "0.05", "--seed", "7"],
                    str(d / "p")),
             _start("plink_tpu", ["--dummy", "200", "300", "0.05",
                                  "dosage-freq=0.7", "--seed", "9"], str(d / "dp")),
             _start("plink_tpu", ["--dummy", "40", "100", "0.05", "--seed", "3"],
                    str(d / "tiny"))]
    for p in procs:
        _wait(p)
    _wait(_start("plink_tpu", ["--pfile", str(d / "p"), "--freq"], str(d / "f")))
    write_sample_report_inputs(str(d), str(d / "p"), str(d / "dp"),
                               str(d / "f.afreq"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{run: (plink_tpu out prefix, plink_torch out prefix, their results)};
    eight processes at a time."""
    d = tmp_path_factory.mktemp("samplereports")
    make_panels(d)
    jobs, out = [], {}
    for run, (fileset, flags, _) in SR_RUNS.items():
        args = ["--pfile", str(d / fileset)] + [a.format(d=d) for a in flags]
        out[run] = tuple(str(d / f"{pkg}_{run}") for pkg in ("plink_tpu",
                                                             "plink_torch"))
        jobs += [(run, pkg, args, o) for pkg, o in zip(("plink_tpu", "plink_torch"),
                                                       out[run])]
    results, running = {}, []
    while jobs or running:
        while jobs and len(running) < 8:
            run, pkg, args, o = jobs.pop(0)
            running.append((run, pkg, _start(pkg, args, o)))
        run, pkg, proc = running.pop(0)
        so, se = proc.communicate()
        results[run, pkg] = (proc.returncode, se)
    return {run: (*out[run], results[run, "plink_tpu"], results[run, "plink_torch"])
            for run in SR_RUNS}


def _read_rows(path):
    with open(path) as f:
        return [ln.rstrip("\n").split("\t") for ln in f]


@pytest.mark.parametrize("run,ext", CASES, ids=[f"{r}{e}" for r, e in CASES])
def test_report_matches_plink_tpu(runs, run, ext):
    ref, got, (rc_ref, err_ref), (rc_got, err_got) = runs[run]
    assert rc_ref == 0, err_ref[-2000:]
    assert rc_got == 0, err_got[-2000:]
    assert filecmp.cmp(ref + ext, got + ext, shallow=False), ext


def _vscore_f64(d):
    """numpy f64 .vscore of <d>/p with <d>/vs.txt: sum over samples of the
    weight times the ALT dosage, a missing call imputed as 2 x the ALT
    frequency; and sum |weight x dosage| (the scale of a sum's rounding)."""
    import torch

    from plink_torch.dataset import load_dataset
    from plink_torch.ops.planes import _unpack_np

    ds = load_dataset(str(d / "p"), torch.device("cpu"))
    codes = _unpack_np(ds.all_packed())[:, :ds.raw_sample_ct].astype(np.float64)
    miss = codes == 3
    g = np.where(miss, 0.0, codes)
    freq = g.sum(1) / (2.0 * (~miss).sum(1))
    dos = np.where(miss, 2.0 * freq[:, None], g)
    idx = {str(i): n for n, i in enumerate(ds.si.iid)}
    W = np.zeros((ds.raw_sample_ct, 3))
    with open(d / "vs.txt") as f:
        f.readline()
        for ln in f:
            t = ln.split()
            W[idx[t[0]]] = [float(x) for x in t[1:]]
    return dos @ W, np.abs(dos) @ np.abs(W)


@pytest.mark.parametrize("run,ext", sorted(SR_ORDER_DEPENDENT),
                         ids=[f"{r}{e}" for r, e in sorted(SR_ORDER_DEPENDENT)])
def test_vscore_sums_match_f64(runs, run, ext):
    """The .vscore values of both packages against numpy f64, within
    `tol` x sum |weight x dosage| (f64: 1e-12; the f32 sums of single-prec:
    1e-5, ~200 x f32 eps) plus the 6-significant-figure rounding of the
    text; the .cols / .vars beside the .bin are byte-identical above."""
    ref, got, (rc_ref, _), (rc_got, _) = runs[run]
    assert rc_ref == rc_got == 0
    if not ext.endswith(".bin"):  # the header and the variant columns exact
        assert [r[:5] for r in _read_rows(ref + ext)] == \
            [r[:5] for r in _read_rows(got + ext)]
    score, scale = _vscore_f64(pathlib.Path(ref).parent)
    tol = SR_ORDER_DEPENDENT[run, ext]
    for prefix in (ref, got):
        if ext.endswith(".bin"):
            vals = np.fromfile(prefix + ext, "<f8").reshape(score.shape)
            fmt = 0.0
        else:
            vals = np.array([[float(x) for x in r[5:]]
                             for r in _read_rows(prefix + ext)[1:]])
            fmt = 5e-6
        err = np.abs(vals - score) - fmt * np.abs(score)
        assert (err <= tol * scale).all(), (prefix, float((err / scale).max()))


def _log_lines(prefix):
    with open(prefix + ".log") as f:
        return [ln.replace(prefix, "<out>") for ln in f
                if ln.startswith(LOG_TAGS) and "End of run" not in ln]


@pytest.mark.parametrize("run", sorted(SR_RUNS))
def test_log_lines_match(runs, run):
    ref, got = runs[run][:2]
    lines = _log_lines(got)
    assert lines and lines == _log_lines(ref)


@pytest.mark.parametrize("run", SR_ERRORS)
def test_frequency_guard_errors(runs, run):
    """The guard refuses with plink_tpu's message and exit code."""
    _, _, (rc_ref, err_ref), (rc_got, err_got) = runs[run]
    assert rc_ref == rc_got == 1
    msg = err_got[err_got.index("ValueError: "):]
    assert msg == err_ref[err_ref.index("ValueError: "):]
    assert "decent allele frequencies" in msg


def test_outputs_cover_every_path(runs):
    """The runs did what they are there for: --q-score-range wrote one
    .sscore per numeric range (the 'bad' line skipped), --impute-sex imputed
    some sexes, the dosage panel scored dosage-track variants and the sx
    copy's alleles give every .scount class."""
    ref, got = runs["q_score_range"][:2]
    assert sorted(os.path.basename(p)[len("plink_torch_q_score_range."):]
                  for p in glob.glob(got + ".*.sscore")) == \
        ["all.sscore", "low.sscore", "mid.sscore"]
    with open(runs["impute"][1] + ".log") as f:
        assert any("sexes imputed" in ln and not ln.startswith("--impute-sex: 0 ")
                   for ln in f)
    rows = _read_rows(runs["scount"][1] + ".scount")
    cols = np.array([[int(x) for x in r[1:]] for r in rows[1:]])
    assert (cols[:, :7].sum(axis=0) > 0).all() and (cols[:, 9] > 0).any()
    rows = _read_rows(runs["dosage"][1] + ".sscore")
    assert any("." in r[rows[0].index("NAMED_ALLELE_DOSAGE_SUM")] for r in rows[1:])

