"""--fast-epistasis: plink_torch against plink_tpu.

Both CLIs run as subprocesses on the CPU, the cases of
plink_torch.testing.EPI_RUNS (chip_smoke.py's 17h runs the same cases,
card against CPU), with 64-variant blocks on both sides: every mode of
tests/test_epistasis.py (default, --epi1 / --epi2, no-ueki,
joint-effects with --je-cellmin, boost, nop, case-only with --gap,
set-by-set with one and two sets, set-by-all, boost with sets; the set
inputs --set with --set-names, --make-set-border with --set-collapse-all,
--gene and --complement-sets) on a 200 x
600 `--dummy` panel laid out on chr1 / chr2 at 150 kb spacing, the
default on its chr1/X/Y/MT copy (the screen drops the non-autosomes), and
one run on a 65,536 x 128 panel, above the product M * |group| = 2^22 from
which plink_tpu takes B8's device dot.  The .epi.cc / .epi.co and .summary
files are byte-identical, the .log lines that report skips, sets and the
test count are equal, and the refused runs exit with plink_tpu's code and
message.
"""

import os
import subprocess
import sys

import pytest

from plink_torch.testing import (EPI_ERRORS, EPI_RUNS, pair_log_lines,
                                 pair_output_same, write_epi_inputs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(label, ext) for label, _, _, exts in EPI_RUNS for ext in exts]
LABELS = [label for label, *_ in EPI_RUNS]


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
    d = tmp_path_factory.mktemp("epistasis")
    procs = [_start("plink_tpu", ["--dummy", "200", "600", "0.05", "--seed", "91"],
                    str(d / "p")),
             _start("plink_tpu", ["--dummy", "65536", "128", "0.02", "--seed", "5"],
                    str(d / "wide"))]
    for p in procs:
        _wait(p)
    write_epi_inputs(str(d), str(d / "p"))
    return run_all(d, EPI_RUNS, lambda label: ["--allow-no-sex"])


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


@pytest.mark.parametrize("label", sorted(EPI_ERRORS))
def test_refusals_match(runs, label):
    """A refused run exits 1 in both packages with the same exception (its
    class, less the package's module path) and message."""
    _, _, (rc_ref, err_ref), (rc_got, err_got) = runs[label]
    assert rc_ref == rc_got == 1, (err_ref[-500:], err_got[-500:])
    last = []
    for e in (err_ref, err_got):
        cls, msg = _exception(e)
        last.append(f"{cls}: {msg}")
    assert last[0] == last[1] and last[1].endswith(EPI_ERRORS[label]), last


def _exception(stderr):
    """(class name, message) of the traceback at the end of `stderr`; the
    message may span lines."""
    lines = stderr.rstrip("\n").splitlines()
    for k in range(len(lines) - 1, -1, -1):
        head, sep, msg = lines[k].partition(": ")
        if sep and head.replace(".", "").replace("_", "").isalnum() \
                and head.rsplit(".", 1)[-1].endswith("Error"):
            return head.rsplit(".", 1)[-1], "\n".join([msg] + lines[k + 1:])
    raise AssertionError(stderr[-500:])


def _rows(path):
    with open(path) as f:
        return [ln.split() for ln in f]


def test_outputs_cover_every_path(runs):
    """The runs did what they are there for: each report holds rows past
    --epi1 (and boost's DF takes more than one value), the case-only gap
    and the screen dropped pairs and sites, and set-by-all lists the set's
    rows alone."""
    for label in ("default", "no_ueki", "joint", "boost", "case_only_gap",
                  "set_one", "set_two", "set_all", "sx", "wide"):
        ext = runs[label][1] + (".epi.co" if label == "case_only_gap" else ".epi.cc")
        assert len(_rows(ext)) > 10, label
    assert len({r[5] for r in _rows(runs["boost"][1] + ".epi.cc")[1:]}) > 1
    logs = {k: "".join(pair_log_lines(runs[k][1])) for k in ("sx", "case_only_gap")}
    assert "monomorphic/non-autosomal site" in logs["sx"]
    total = 600 * 599 // 2
    valid = int(logs["case_only_gap"].split(" valid test")[0].split()[-1])
    assert valid < total
    ones = _rows(runs["set_all"][1] + ".epi.cc.summary")[1:]
    assert 10 < len(ones) < 600


NEW_FIELDS = ("fast_epistasis", "epi1", "epi2", "epi_gap", "je_cellmin", "set_file",
              "make_set", "set_names_list", "subset_file", "make_set_border",
              "make_set_collapse_group", "complement_sets", "set_collapse_all",
              "make_set_complement_all", "gene_all", "gene_list")


def test_epistasis_flags_are_ported():
    """Every flag of this slice's cases parses to ported Config fields, and
    --write-set / --set-table / --epistasis stay refused."""
    from plink_torch.cli import parse_args
    from plink_torch.pipeline import _PORTED_FIELDS, _unported_flags

    assert set(NEW_FIELDS) <= _PORTED_FIELDS
    for _, _, flags, _ in EPI_RUNS:
        argv = ["--pfile", "x", "--allow-no-sex"] + [a.format(d="d") for a in flags]
        assert _unported_flags(parse_args(argv)) == [], flags
    for extra in (["--write-set"], ["--set-table"], ["--epistasis"]):
        argv = ["--pfile", "x", "--make-set", "s.txt", *extra]
        assert _unported_flags(parse_args(argv)), extra
