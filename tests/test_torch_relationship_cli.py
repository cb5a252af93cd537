"""KING, GRM, .rel and exact PCA: plink_torch against plink_tpu.

Both CLIs run as subprocesses on the CPU on the test_mesh_sharding panel
(--dummy 200 600 0.05 --seed 7), with 64-variant blocks on both sides and
64-sample tiles in the port (PLINK_TORCH_TILE=64: four tiles a side, a
ragged last one, where plink_tpu takes the 200 samples as one tile).  One
case per output file of each flag set; flags are combined in one
invocation where plink_tpu allows it.  Rules (plink_torch/testing.py,
which chip_smoke.py's card-vs-CPU parity shares):
- .kin0, .king, .king.bin, the id files, the --king-cutoff lists and
  .grm.N.bin byte-identical (integer counts; KING kinship in f64 from
  them);
- .grm.bin within 2e-6 absolute (f32 GRM entries, sums in another order);
- .grm and .rel: count columns exact, floats within 1e-5 relative (6
  significant digits printed);
- .eigenval within 1e-4 relative, .eigenvec columns within 1e-4 after
  matching each column's sign;
- the .log lines that report what was filtered, excluded or used equal.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBSET = "#IID1\tIID2\nper3\tper1\nper10\tper150\nnobody\tper2\nper7\tper9\n"
# run: (flags, outputs)
RUNS = {
    "king": (["--make-king-table", "--king-table-filter", "0.05", "--make-king",
              "triangle", "bin", "--make-grm-list", "--make-rel", "square",
              "--pca", "4"],
             (".kin0", ".king.bin", ".king.id", ".grm", ".grm.id", ".rel",
              ".rel.id", ".eigenval", ".eigenvec")),
    "parallel": (["--make-king-table", "--make-king", "square", "bin",
                  "--make-grm-bin", "--parallel", "2", "3"],
                 (".kin0.2", ".king.bin.2", ".king.id", ".grm.bin.2",
                  ".grm.N.bin.2")),
    "cutoff": (["--make-king", "square0", "bin4", "--king-cutoff", "0.05",
                "--make-grm-bin", "--make-rel", "square0"],
               (".king.bin", ".king.id", ".king.cutoff.in.id",
                ".king.cutoff.out.id", ".grm.bin", ".grm.N.bin", ".grm.id",
                ".rel", ".rel.id")),
    "stream": (["--make-king-table", "--make-king", "--make-grm-bin"],
               (".kin0", ".king", ".king.id", ".grm.bin", ".grm.N.bin",
                ".grm.id")),
    "chain": (["--mind", "0.08", "--maf", "0.05", "--make-king-table",
               "--make-grm-bin"], (".kin0", ".grm.bin", ".grm.N.bin", ".grm.id")),
    "subset": (["--make-king-table", "--king-table-subset", "{d}/subset.txt",
                "--make-rel"], (".kin0", ".rel", ".rel.id")),
    # after "king": resumes --king-cutoff from plink_tpu's triangle .king.bin
    "resume": (["--king-cutoff", "{d}/plink_tpu_king", "0.05"],
               (".king.cutoff.in.id", ".king.cutoff.out.id")),
}
CASES = [(run, ext) for run, (_, exts) in RUNS.items() for ext in exts + (".log",)]
LOG_KEYS = ("relationships reported", "Excluded", "variants used in GRM",
            "removed", "skipped", "written to", "PCs")


def _env():
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PLINK_TPU_VB="64", PLINK_TPU_DEVICES="1",
               PLINK_TORCH_VB="64", PLINK_TORCH_TILE="64",
               PLINK_TORCH_DEVICE="cpu", PYTHONPATH=REPO)
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
    """{run: (plink_tpu out prefix, plink_torch out prefix)}; the runs go in
    parallel, "resume" after the run whose .king.bin it reads."""
    d = tmp_path_factory.mktemp("relcli")
    prefix = str(d / "p")
    _wait(_start("plink_tpu", ["--dummy", "200", "600", "0.05", "--seed", "7"],
                 prefix))
    (d / "subset.txt").write_text(SUBSET)
    out = {}

    def launch(names):
        procs = []
        for run in names:
            args = ["--pfile", prefix] + [a.format(d=d) for a in RUNS[run][0]]
            out[run] = tuple(str(d / f"{pkg}_{run}")
                             for pkg in ("plink_tpu", "plink_torch"))
            procs += [_start(pkg, args, o)
                      for pkg, o in zip(("plink_tpu", "plink_torch"), out[run])]
        for p in procs:
            _wait(p)

    launch([r for r in RUNS if r != "resume"])
    launch(["resume"])
    return out


def _log_lines(prefix):
    name = os.path.basename(prefix)
    with open(prefix + ".log") as f:
        return [ln.replace(name, "OUT") for ln in f
                if any(k in ln for k in LOG_KEYS)]


@pytest.mark.parametrize("run,ext", CASES, ids=[f"{r}{e}" for r, e in CASES])
def test_output_matches_plink_tpu(runs, run, ext):
    from plink_torch.testing import relationship_output_close

    ref, got = (p + ext for p in runs[run])
    if ext == ".log":
        lines = _log_lines(runs[run][1])
        assert lines and lines == _log_lines(runs[run][0])
        return
    assert relationship_output_close(ext, ref, got), ext
    if ext == ".grm":
        with open(got) as f:
            assert sum(1 for _ in f) == 200 * 201 // 2
