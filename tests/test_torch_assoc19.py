"""--assoc / --model (and their permutation tests) and --fst: plink_torch
against plink_tpu.

Both CLIs run as subprocesses on the CPU, the cases of
plink_torch.testing.A19_RUNS (chip_smoke.py's 17h runs the same cases,
card against CPU), with 64-variant blocks on both sides, on a 200 x 600
`--dummy` panel and its chr1/X/Y/MT copy (chrX's male haploid counts,
chrY's males, MT haploid; one run with the samples' sexes in force):
--assoc plain, counts, fisher, fisher-midp, --ci, perm (--aperm), mperm=,
perm-count; --model plain, fisher, fisher-midp, --cell and its dom / rec /
gen / trend / best permutation tests; --fst hudson and wc with
report-variants, blocksize= (the jackknife), cols=nobs, base= and ids=,
and the chrX pass.  Every report is byte-identical and the .log lines of
`pair_log_lines` are equal.  The quantitative --assoc, --within and the
set test are refused as not yet ported (exit code 2); plink_tpu runs the
first two and refuses the third for want of a set.
"""

import os
import subprocess
import sys

import pytest

from plink_torch.testing import (A19_NOT_PORTED, A19_RUNS, pair_log_lines,
                                 pair_output_same, write_epi_inputs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(label, ext) for label, _, _, exts in A19_RUNS for ext in exts]
LABELS = [label for label, _, _, exts in A19_RUNS if exts]


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


def run_all(d, runs, extra):
    """Both packages on each run (label, fileset, flags, outputs) of `runs`,
    eight processes at a time: {label: (plink_tpu prefix, plink_torch
    prefix, (rc, stderr) of each)}."""
    jobs, out = [], {}
    for label, fileset, flags, _ in runs:
        args = (["--pfile", str(d / fileset)] + [a.format(d=d) for a in flags]
                + extra(label))
        out[label] = tuple(str(d / f"{pkg}_{label}") for pkg in ("plink_tpu",
                                                                 "plink_torch"))
        jobs += [(label, pkg, args, o) for pkg, o in zip(("plink_tpu", "plink_torch"),
                                                         out[label])]
    results, running = {}, []
    while jobs or running:
        while jobs and len(running) < 8:
            label, pkg, args, o = jobs.pop(0)
            running.append((label, pkg, _start(pkg, args, o)))
        label, pkg, proc = running.pop(0)
        _, se = proc.communicate()
        results[label, pkg] = (proc.returncode, se)
    return {label: (*out[label], results[label, "plink_tpu"],
                    results[label, "plink_torch"]) for label, *_ in runs}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("assoc19")
    _wait(_start("plink_tpu", ["--dummy", "200", "600", "0.05", "--seed", "17"],
                 str(d / "p")))
    write_epi_inputs(str(d), str(d / "p"))
    return run_all(d, A19_RUNS,
                   lambda label: [] if label == "sx_sexed" else ["--allow-no-sex"])


@pytest.mark.parametrize("label,ext", CASES, ids=[f"{r}{e}" for r, e in CASES])
def test_output_matches_plink_tpu(runs, label, ext):
    ref, got, (rc_ref, err_ref), (rc_got, err_got) = runs[label]
    assert rc_ref == 0, err_ref[-2000:]
    assert rc_got == 0, err_got[-2000:]
    assert pair_output_same(ref + ext, got + ext), ext


@pytest.mark.parametrize("label", LABELS)
def test_log_lines_match(runs, label):
    ref, got = runs[label][:2]
    lines = pair_log_lines(got)
    assert lines and lines == pair_log_lines(ref)


@pytest.mark.parametrize("label", sorted(A19_NOT_PORTED))
def test_not_ported_refusals(runs, label):
    """The port refuses these runs up front or at the command (exit code 2,
    "not yet ported") and never falls back to plink_tpu."""
    _, got, _, (rc_got, err_got) = runs[label]
    assert rc_got == 2, err_got[-500:]
    msg = err_got.strip().splitlines()[-1]
    assert msg.startswith("Error: " + A19_NOT_PORTED[label]), msg
    assert msg.endswith("not yet ported to plink_torch."), msg


def _rows(path):
    with open(path) as f:
        return [ln.split() for ln in f]


def test_outputs_cover_every_path(runs):
    """The runs did what they are there for: the sx copy's .assoc holds
    chrX, chrY and MT rows and its .model skips chrY / MT, --cell 2 and
    the default threshold leave different GENO rows, the permutation
    reports have one row a variant, and the chrX --fst pass wrote its
    own summary."""
    sx = _rows(runs["sx_assoc_model"][1] + ".assoc")[1:]
    assert {r[0] for r in sx} == {"1", "23", "24", "26"}
    model = {r[0] for r in _rows(runs["sx_assoc_model"][1] + ".model")[1:]}
    assert model == {"1", "23"}
    with open(runs["sx_assoc_model"][1] + ".model") as a, \
            open(runs["sx_sexed"][1] + ".model") as b:
        assert a.read() != b.read()
    for label, ext in (("assoc_perm", ".assoc.perm"), ("assoc_mperm", ".assoc.mperm"),
                       ("model_mperm", ".model.best.mperm")):
        assert len(_rows(runs[label][1] + ext)) == 601, label
    assert len(_rows(runs["fst_block_x"][1] + ".x.fst.summary")) == 11


def test_cluster_permutations_match_plink_tpu():
    """perm19's cluster-restricted generator (reindex_clusters_19,
    generate_cc_cluster_perm through cc_perm_matrix) equals plink_tpu's
    draw for draw, over two threads."""
    import numpy as np

    from plink_torch.stats import perm19 as P
    from plink_torch.stats.sfmt import Sfmt
    from plink_tpu.stats import perm19 as R
    from plink_tpu.stats.sfmt import Sfmt as RSfmt

    rng = np.random.default_rng(8)
    case = rng.random(150) < 0.4
    assign = rng.integers(-1, 9, size=150)
    got = P.reindex_clusters_19(assign, case)
    want = R.reindex_clusters_19(assign, case)
    assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
    assert got[1] == want[1] and np.array_equal(got[2], want[2])
    assert np.array_equal(got[3], want[3])
    perms = P.cc_perm_matrix(case, 40, 2, Sfmt(7), (got[0], got[1], got[2]))
    ref = R.cc_perm_matrix(case, 40, 2, RSfmt(7), (want[0], want[1], want[2]))
    assert np.array_equal(perms, ref)


NEW_FIELDS = ("assoc", "assoc_mods", "model", "model_mods", "allow_no_sex", "cell",
              "ci", "fst")


def test_assoc_flags_are_ported():
    """Every flag of this slice's cases but the refused ones parses to
    ported Config fields."""
    from plink_torch.cli import parse_args
    from plink_torch.pipeline import _PORTED_FIELDS, _unported_flags

    assert set(NEW_FIELDS) <= _PORTED_FIELDS
    for label, _, flags, _ in A19_RUNS:
        argv = ["--pfile", "x", "--allow-no-sex"] + [a.format(d="d") for a in flags]
        assert (_unported_flags(parse_args(argv)) == []) == (label != "err_within"), \
            flags
