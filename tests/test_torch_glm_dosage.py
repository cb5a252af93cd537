"""--glm on dosage data and --dummy: plink_torch against plink_tpu on the CPU.

Panels, made by each package's own --dummy (the two must be byte-identical,
which the first tests check): a 4,500 x 60 dosage panel (`--dummy 4500 60
0.02 dosage-freq=0.7 --seed 7`; n >= 4,096, so the additive rows come from
the device route: K17 / K18's plain versions in the port) and a 200 x 60 one
(`--seed 8`; n < 4,096: both packages refit every row in f64 on the host),
each with a SEX + C1 + C2 `.cov` (numpy seed 11) and a phenotype file with
the case/control PHENO1 and a Gaussian QT (seed 12), so each run writes the
logistic and the linear report.  Both CLIs run as subprocesses with 16-variant
blocks, one thread each, eight at a time.

Cases: the hybrid default, `firth`, `no-firth` (covariates shown),
`qt-residualize`, `cc-residualize` (which the dosage route ignores, as
plink_tpu's does), `log10 intercept`, and the host route's `genotypic` and
`interaction`.

Rules (tests/test_torch_glm_joint.py's): identity, count, FIRTH? and
ERRCODE columns equal; OR / SE / P within 1e-3 relative; BETA within 1e-3
of max(|BETA|, SE); the statistics within 1e-3 of max(|stat|, 1).  A
variant whose device-route floats differ beyond the rule is held to a
numpy f64 fit of its dosage design at any stop an f32 fit can take
(plink_torch.testing.f64_logit with slack 10); COUNTS fixes how many.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = ("#CHROM", "POS", "ID", "REF", "ALT", "PROVISIONAL_REF?", "A1",
         "OMITTED", "A1_FREQ", "FIRTH?", "TEST", "OBS_CT", "ERRCODE")
RELATIVE = ("OR", "LOG(OR)_SE", "BETA", "SE", "P", "NEG_LOG10_P")
STATS = ("Z_STAT", "T_STAT", "Z_OR_F_STAT", "T_OR_F_STAT")
TOL = 1e-3
PARALLEL = 8

LOGI, FIRTH, NOFIRTH = "glm.logistic.hybrid", "glm.firth", "glm.logistic"
PANELS = {"dv": ("4500", "7"), "dh": ("200", "8")}
# case: (--glm modifiers, logistic report suffix, other flags)
CASES = {
    "hybrid": (["hide-covar"], LOGI, []),
    "firth": (["firth", "hide-covar"], FIRTH, []),
    "no_firth": (["no-firth"], NOFIRTH, []),
    "qt_residualize": (["qt-residualize", "hide-covar"], LOGI, []),
    "cc_residualize": (["cc-residualize", "hide-covar"], LOGI, []),
    "log10_intercept": (["log10", "intercept", "hide-covar"], LOGI, []),
    "genotypic": (["genotypic", "hide-covar"], LOGI, []),
    "interaction": (["interaction"], LOGI, []),
    # --maf reads hard-call counts in both packages, dosage tracks or not
    "maf": (["hide-covar"], LOGI, ["--maf", "0.3"]),
}
DUMMY = {"plain": [], "scalar_pheno": ["scalar-pheno"],
         "phase": ["phase-freq=0.5"]}


def _env():
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PLINK_TPU_VB="16", PLINK_TPU_DEVICES="1",
               PLINK_TORCH_VB="16", PLINK_TORCH_DEVICE="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    return env


def _cmd(pkg, args, out):
    return [sys.executable, "-m", f"{pkg}.cli", *args, "--out", out, "--silent"]


def _run_all(cmds, cwd):
    results = [None] * len(cmds)
    running = {}
    todo = list(enumerate(cmds))
    while todo or running:
        while todo and len(running) < PARALLEL:
            i, cmd = todo.pop(0)
            running[i] = subprocess.Popen(
                cmd, env=_env(), cwd=cwd, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        for i in [i for i, p in running.items() if p.poll() is not None]:
            out, err = running[i].communicate()
            results[i] = (running.pop(i).returncode, out, err)
        time.sleep(0.05)
    return results


def _dummy_args(panel, extra=()):
    n, seed = PANELS[panel]
    return ["--dummy", n, "60", "0.02", "dosage-freq=0.7", *extra, "--seed", seed]


def _side_files(d, panel):
    with open(d / f"{panel}.psam") as f:
        hdr = f.readline().rstrip("\n").split("\t")
        rows = [ln.rstrip("\n").split("\t") for ln in f]
    si, pi = hdr.index("SEX"), hdr.index("PHENO1")
    cov = np.random.default_rng(11).normal(size=(len(rows), 2))
    with open(d / f"{panel}.cov", "w") as f:
        f.write("#IID\tSEX\tC1\tC2\n")
        for r, (c1, c2) in zip(rows, cov):
            f.write(f"{r[0]}\t{r[si]}\t{c1:.6f}\t{c2:.6f}\n")
    qt = np.random.default_rng(12).normal(size=len(rows))
    with open(d / f"{panel}.both", "w") as f:
        f.write("#IID\tPHENO1\tQT\n")
        for r, q in zip(rows, qt):
            f.write(f"{r[0]}\t{r[pi]}\t{q:.6f}\n")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of the module: {"dummy": {name: {pkg: result}},
    "case": {(panel, case): {pkg: result}}, "dir": path}."""
    d = tmp_path_factory.mktemp("glmdosage")
    cmds, keys = [], []
    for name, extra in DUMMY.items():
        for pkg in ("plink_tpu", "plink_torch"):
            cmds.append(_cmd(pkg, _dummy_args("dh", extra), f"{pkg}_dummy_{name}"))
            keys.append(("dummy", name, pkg))
    for panel in PANELS:
        cmds.append(_cmd("plink_tpu", _dummy_args(panel), panel))
        keys.append(("panel", panel, "plink_tpu"))
    out = {"dummy": {}, "case": {}, "dir": d}
    for (kind, name, pkg), r in zip(keys, _run_all(cmds, d)):
        out.setdefault(kind, {}).setdefault(name, {})[pkg] = r
    for panel in PANELS:
        assert out["panel"][panel]["plink_tpu"][0] == 0, \
            out["panel"][panel]["plink_tpu"][2][-2000:]
        _side_files(d, panel)
    cmds, keys = [], []
    for panel in PANELS:
        for case, (mods, _, extra) in CASES.items():
            argv = ["--pfile", panel, "--pheno", f"{panel}.both", "--covar",
                    f"{panel}.cov", "--glm", *mods, *extra]
            for pkg in ("plink_tpu", "plink_torch"):
                cmds.append(_cmd(pkg, argv, f"{pkg}_{panel}_{case}"))
                keys.append(((panel, case), pkg))
    for (key, pkg), r in zip(keys, _run_all(cmds, d)):
        out["case"].setdefault(key, {})[pkg] = r
    return out


@pytest.mark.parametrize("name", list(DUMMY))
def test_dummy_matches_plink_tpu_byte_for_byte(runs, name):
    d = runs["dir"]
    for pkg in ("plink_tpu", "plink_torch"):
        r = runs["dummy"][name][pkg]
        assert r[0] == 0, (pkg, r[2][-2000:])
    for ext in (".pgen", ".pvar", ".psam"):
        a = (d / f"plink_tpu_dummy_{name}{ext}").read_bytes()
        b = (d / f"plink_torch_dummy_{name}{ext}").read_bytes()
        assert a == b, ext


def test_dosage_rows_and_a1_freqs_match_plink_tpu(runs):
    """Dataset.dosage_row (NaN where missing) and the dosage-aware
    alt_allele_freqs equal plink_tpu's on the 4,500-sample panel."""
    import torch

    from plink_torch.commands.basic_reports import alt_allele_freqs
    from plink_torch.dataset import load_dataset
    from plink_tpu.commands.basic_reports import alt_allele_freqs as tpu_freqs
    from plink_tpu.dataset import load_dataset as tpu_load

    prefix = str(runs["dir"] / "dv")
    ds = load_dataset(prefix, torch.device("cpu"))
    ref = tpu_load(prefix)
    assert ds.has_dosage
    for v in range(ds.raw_variant_ct):
        np.testing.assert_array_equal(ds.dosage_row(v), ref.dosage_row(v))
    for founders in (True, False):
        np.testing.assert_array_equal(
            alt_allele_freqs(ds, founders, dosage=True), tpu_freqs(ref, founders))


@pytest.mark.parametrize("panel", list(PANELS))
def test_maf_filter_on_dosage_matches_plink_tpu(runs, panel):
    """--maf on a dosage fileset removes what plink_tpu removes (both read
    the hard-call counts there): the same log line (the report's rows are
    held by test_dosage_glm_report_matches_plink_tpu[maf-*])."""
    said = {}
    for pkg in ("plink_tpu", "plink_torch"):
        with open(runs["dir"] / f"{pkg}_{panel}_maf.log") as f:
            said[pkg] = [ln.strip() for ln in f if "allele frequency" in ln]
    assert said["plink_torch"] == said["plink_tpu"] and len(said["plink_tpu"]) == 1


def _read(path):
    with open(path) as f:
        hdr = f.readline().rstrip("\n").split("\t")
        return hdr, [ln.rstrip("\n").split("\t") for ln in f]


def _close(col, x, y, se=None):
    if x == y:
        return True
    if col in STATS:
        scale = max(abs(y), 1.0)
    elif col == "BETA":
        scale = max(abs(y), se if se is not None else 0.0)
    else:
        scale = abs(y)
    return abs(x - y) <= TOL * scale


def _row_ok(hdr, a, b):
    se_i = hdr.index("SE") if "SE" in hdr else None
    exact, close = True, True
    for col, x, y in zip(hdr, a, b):
        if col in RELATIVE + STATS and "NA" not in (x, y):
            se = float(b[se_i]) if se_i is not None and b[se_i] != "NA" else None
            close &= _close(col, float(x), float(y), se)
        else:
            exact &= col in EXACT + RELATIVE + STATS and x == y
    return exact, close


def _f64_fits(d, panel, hdr, group, firth):
    """numpy f64 fits of one variant's additive dosage design [1 | SEX |
    C1 | C2 | g]: [{TEST: (OR, SE, Z, P)}] at each stop an f32 fit can take
    (f64_logit, slack 10)."""
    import torch
    from scipy.special import ndtr

    from plink_torch.dataset import load_dataset
    from plink_torch.testing import f64_logit

    col = {c: hdr.index(c) for c in hdr}
    r0 = group[0]
    ds = load_dataset(str(d / panel), torch.device("cpu"))
    v = int(r0[col["ID"]][3:])
    g = ds.dosage_row(v)
    if r0[col["A1"]] != r0[col["ALT"]]:
        g = 2.0 - g
    cov = np.loadtxt(d / f"{panel}.cov", skiprows=1, usecols=(1, 2, 3))
    y = np.loadtxt(d / f"{panel}.both", skiprows=1, usecols=(1,))
    keep = np.isfinite(g) & (y > 0)
    X = np.column_stack([np.ones(keep.sum()), cov[keep], g[keep]])
    names = ["INTERCEPT", "SEX", "C1", "C2", "ADD"]
    out = []
    for b, se, _ in f64_logit(X, (y[keep] == 2).astype(float), firth=firth,
                              slack=10.0):
        z = b / se
        out.append({nm: (np.exp(b[i]), se[i], z[i], 2.0 * ndtr(-abs(z[i])))
                    for i, nm in enumerate(names)})
    return out


def _compare(d, panel, ref_path, got_path, firth):
    """The port's report against plink_tpu's; returns the count of
    variants held to f64."""
    h_ref, r_ref = _read(ref_path)
    h_got, r_got = _read(got_path)
    assert h_got == h_ref
    assert len(r_got) == len(r_ref) > 0
    col = {c: h_ref.index(c) for c in h_ref}
    ident = [col[c] for c in EXACT if c in col]
    differ = {}
    for a, b in zip(r_got, r_ref):
        assert [a[i] for i in ident] == [b[i] for i in ident], (a, b)
        exact, close = _row_ok(h_ref, a, b)
        assert exact, (a, b)
        if not close:
            differ.setdefault(a[col["ID"]], []).append(a)
    stat = next(c for c in STATS if c in col)
    p_col = "P" if "P" in col else "NEG_LOG10_P"
    for vid in differ:
        assert "OR" in col, (vid, differ[vid])  # linear reports: never
        group = [a for a in r_got if a[col["ID"]] == vid]
        use_firth = firth or ("FIRTH?" in col and group[0][col["FIRTH?"]] == "Y")
        fits = _f64_fits(d, panel, h_ref, group, use_firth)

        def ok(a, fit):
            eff, se, z, p = fit[a[col["TEST"]]]
            if p_col != "P":
                p = -np.log10(p)
            return all(_close(c, float(a[col[c]]), y_, se) for c, y_ in (
                ("OR", eff), ("LOG(OR)_SE", se), (stat, z), (p_col, p)))

        assert any(all(ok(a, fit) for a in group) for fit in fits), (group, fits)
    return len(differ)


# (logistic variants held to f64) of each (panel, case): what the seeded
# panels show
COUNTS = {}


@pytest.mark.parametrize("panel", list(PANELS))
@pytest.mark.parametrize("case", list(CASES))
def test_dosage_glm_report_matches_plink_tpu(runs, case, panel):
    d = runs["dir"]
    res = runs["case"][(panel, case)]
    for pkg in ("plink_tpu", "plink_torch"):
        assert res[pkg][0] == 0, (pkg, res[pkg][2][-3000:])
    sfx = CASES[case][1]
    held = _compare(d, panel, d / f"plink_tpu_{panel}_{case}.PHENO1.{sfx}",
                    d / f"plink_torch_{panel}_{case}.PHENO1.{sfx}",
                    firth=sfx == FIRTH)
    held_q = _compare(d, panel, d / f"plink_tpu_{panel}_{case}.QT.glm.linear",
                      d / f"plink_torch_{panel}_{case}.QT.glm.linear",
                      firth=False)
    assert (held, held_q) == COUNTS.get((panel, case), (0, 0))
    hdr, rows = _read(d / f"plink_torch_{panel}_{case}.PHENO1.{sfx}")
    tests = {r[hdr.index("TEST")] for r in rows}
    mods = CASES[case][0]
    if "genotypic" in mods:
        assert "GENO_2DF" in tests
    if "interaction" in mods:
        assert "ADDxC1" in tests
    if "intercept" in mods:
        assert "INTERCEPT" in tests and "NEG_LOG10_P" in hdr
