"""The pair-count commands: plink_torch against plink_tpu.

Both CLIs run as subprocesses on the CPU, the cases of
plink_torch.testing.PD_RUNS (chip_smoke.py's pair-report parity runs the
same cases, card against CPU), with 64-variant blocks on both sides and
64-sample tiles in the port (PLINK_TORCH_TILE=64: four tiles a side, a
ragged last one, where plink_tpu takes the 200 samples as one tile): on
the 200 x 600 `--dummy` panel (seed 7, a case/control PHENO1), its
chr1/X/Y/MT copy, a dosage `--dummy` panel, and a `--make-bed` copy
(plink_tpu's) with two trios, a sib pair, a half-sib pair and unrelated
samples in its .fam.  Every report is byte-identical (a .gz by its text:
the gzip header names the file); the counts are exact integers and the
host's f64 operations are plink_tpu's.  The .log lines that report
exclusions, settings, results, warnings and errors are equal; for
--ibs-test, --groupdist and --regress-distance they are the results.  The
refused runs exit with plink_tpu's code and message.
"""

import os
import subprocess
import sys

import pytest

from plink_torch.testing import (PD_ERRORS, PD_RUNS, pair_log_lines,
                                 pair_output_same, write_pair_report_inputs,
                                 write_pedigree_fam)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(label, ext) for label, _, _, exts in PD_RUNS for ext in exts]
LABELS = [label for label, *_ in PD_RUNS]


def _env():
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PLINK_TPU_VB="64", PLINK_TPU_DEVICES="1",
               PLINK_TORCH_VB="64", PLINK_TORCH_TILE="64",
               PLINK_TORCH_DEVICE="cpu", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
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
    """<d>/p (200 x 600), <d>/dp (a 200 x 300 dosage panel) by plink_tpu
    --dummy; <d>/pedb, plink_tpu's --make-bed copy of p with PD_PEDIGREE's
    .fam; plink_tpu's .afreq of p; PD_RUNS's other files
    (write_pair_report_inputs)."""
    procs = [_start("plink_tpu", ["--dummy", "200", "600", "0.05", "--seed", "7"],
                    str(d / "p")),
             _start("plink_tpu", ["--dummy", "200", "300", "0.05",
                                  "dosage-freq=0.7", "--seed", "9"], str(d / "dp"))]
    for p in procs:
        _wait(p)
    procs = [_start("plink_tpu", ["--pfile", str(d / "p"), "--freq"], str(d / "f")),
             _start("plink_tpu", ["--pfile", str(d / "p"), "--make-bed"],
                    str(d / "pedb"))]
    for p in procs:
        _wait(p)
    write_pedigree_fam(str(d / "pedb.fam"))
    write_pair_report_inputs(str(d), str(d / "p"), str(d / "f.afreq"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{label: (plink_tpu out prefix, plink_torch out prefix, (rc, stderr)
    of each)}; eight processes at a time."""
    d = tmp_path_factory.mktemp("pairreports")
    make_panels(d)
    jobs, out = [], {}
    for label, fileset, flags, _ in PD_RUNS:
        inp = "--bfile" if fileset == "pedb" else "--pfile"
        args = [inp, str(d / fileset)] + [a.format(d=d) for a in flags]
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
                    results[label, "plink_torch"]) for label in LABELS}


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


@pytest.mark.parametrize("label", sorted(PD_ERRORS))
def test_refusals_match(runs, label):
    """A refused run exits 1 in both packages with the same exception (its
    class, less the package's module path) and message."""
    _, _, (rc_ref, err_ref), (rc_got, err_got) = runs[label]
    assert rc_ref == rc_got == 1, (err_ref[-500:], err_got[-500:])
    last = []
    for e in (err_ref, err_got):
        cls, msg = e.strip().splitlines()[-1].split(": ", 1)
        last.append(f"{cls.rsplit('.', 1)[-1]}: {msg}")
    assert last[0] == last[1] and last[1].endswith(PD_ERRORS[label]), last


def test_bed_copy_matches_plink_tpu(runs, tmp_path):
    """testing.write_bed_copy (chip_smoke's .bed copy: the card's machine
    has no plink_tpu) writes plink_tpu --make-bed's bytes."""
    import filecmp

    from plink_torch.testing import write_bed_copy

    d = os.path.dirname(runs["dist"][0])
    write_bed_copy(os.path.join(d, "p"), str(tmp_path / "b"))
    write_pedigree_fam(str(tmp_path / "b.fam"))
    for ext in (".bed", ".bim", ".fam"):
        assert filecmp.cmp(os.path.join(d, "pedb" + ext), str(tmp_path / ("b" + ext)),
                           shallow=False), ext


def _rows(path):
    with open(path) as f:
        return [ln.split() for ln in f]


def test_outputs_cover_every_path(runs):
    """The runs did what they are there for: --genome's RT took FS, HS, PO,
    OT and UN and EZ each of its values, PHE each of -1 / 0 / 1, and the
    small --ppc-gap kept more than one informative marker a pair (the
    default gap keeps one: the panel's variants are 1 bp apart); the sx
    copy excluded its non-autosomes; the weighted and flat rescales
    differ; --ppc and --ibm prevented merges; the permutation tests wrote
    their results, and the one-case / one-control phenotypes their
    warnings."""
    rows = _rows(runs["genome"][1] + ".genome")[1:]
    assert {r[4] for r in rows} == {"FS", "HS", "PO", "OT", "UN"}
    assert {r[5] for r in rows} == {"0.5", "0.25", "0", "NA"}
    assert {r[10] for r in rows} == {"-1", "0", "1"}
    wide = _rows(runs["genome"][1] + ".genome")[1:]
    gap = _rows(runs["genome_gap"][1] + ".genome")[1:]
    assert [r[12] for r in wide] != [r[12] for r in gap]
    with open(runs["dist_sx"][1] + ".log") as f:
        assert "on non-autosomes from distance matrix calc." in f.read()
    with open(runs["dist"][1] + ".dist") as a, open(runs["dist_flat"][1] + ".dist") as b:
        assert a.read() != b.read()
    with open(runs["cluster"][1] + ".cluster2") as a, \
            open(runs["cluster_ppc_ibm"][1] + ".cluster2") as b:
        assert a.read() != b.read()
    logs = {k: "".join(pair_log_lines(runs[k][1]))
            for k in ("ibs_test", "groupdist", "regress", "ibs_groupdist",
                      "few_cases", "few_controls")}
    assert "T12: Ctrl/ctrl more similar" in logs["ibs_test"]
    assert "AU mean - UU mean avg difference" in logs["groupdist"]
    assert "Jackknife s.e. (y = avg phenotype)" in logs["regress"]
    assert "T12" in logs["ibs_groupdist"] and "AU mean" in logs["ibs_groupdist"]
    for what in ("--ibs-test", "--groupdist"):
        assert f"Skipping {what} due to too few cases" in logs["few_cases"]
        assert f"Skipping {what} due to too few controls" in logs["few_controls"]


NEW_FIELDS = ("genome", "genome_mods", "distance", "distance_matrix", "ibs_matrix",
              "cluster", "cluster_k", "cluster_mc", "cluster_mcc", "cluster_ppc",
              "cluster_ibm", "ppc_gap", "neighbour", "mds_plot", "ibs_test",
              "groupdist", "regress_distance")


def test_pair_flags_are_ported():
    """Every flag of this slice's cases parses to ported Config fields."""
    from plink_torch.cli import parse_args
    from plink_torch.pipeline import _PORTED_FIELDS, _unported_flags

    assert set(NEW_FIELDS) <= _PORTED_FIELDS
    for _, _, flags, _ in PD_RUNS:
        argv = ["--pfile", "x"] + [a.format(d="d") for a in flags]
        assert _unported_flags(parse_args(argv)) == [], flags


@pytest.mark.parametrize("flags,name", [
    (["--within", "w.txt"], "--within"),
    (["--make-perm-pheno", "5"], "--make-perm-pheno"),
    (["--assoc", "--test-missing"], "--test-missing"),
    (["--fast-epistasis", "--epistasis"], "--epistasis"),
    (["--distance", "--homozyg"], "--homozyg"),
], ids=["within", "make-perm-pheno", "assoc", "fast-epistasis", "homozyg"])
def test_neighbouring_flags_still_refused(flags, name):
    """The flags beside this slice that plink_tpu runs with it are still
    refused: the cluster files of --within, --make-perm-pheno, --homozyg,
    and beside --assoc and --fast-epistasis (ported since) --test-missing
    and --epistasis."""
    from plink_torch.cli import parse_args
    from plink_torch.pipeline import _unported_flags

    bad = _unported_flags(parse_args(["--pfile", "x", *flags]))
    assert any(b.startswith(name) for b in bad), bad


G4_VALUES = (0.0, 1.9995038, -1.9995038, 9.9995, 99.995, 999.95, 9999.5,
             0.99995, 0.24375, 0.099995, 0.0099995, 9.9995e-5, 1.23456e-7,
             12345.678, -0.5, 3.0, float("nan"), float("inf"), float("-inf"))


@pytest.mark.parametrize("x", G4_VALUES, ids=[repr(v) for v in G4_VALUES])
def test_dtoa_g_wxp4_matches_plink_tpu(x):
    """--neighbour's 4-significant-figure writer is plink_tpu's
    assoc19._g4, the version every plink_tpu caller uses: a carried digit
    starts the next decade (1.9995 -> "2")."""
    from plink_torch.utils.fmt import dtoa_g_wxp4
    from plink_tpu.commands.assoc19 import _g4

    for width in (8, 12):
        assert dtoa_g_wxp4(x, width) == _g4(x, width)
    assert dtoa_g_wxp4(1.9995038, 8) == "       2"
