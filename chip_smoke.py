#!/usr/bin/env python3
"""On-card smoke test of plink_torch, the PyTorch + CUDA port.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. card report: name and power limit, torch / CUDA versions, TF32 off;
  2. build: every kernel under plink_torch/csrc with nvcc (in parallel);
  3. kernels: K1-K6 against their plain PyTorch versions on the
     card, at the main paths' shapes (500,000 samples, d = 13), with its
     time, the plain version's time, one library call's time and the card's
     bound;
  4. logistic main path: `--pfile P --glm hide-covar --covar P.cov` through
     plink_torch.cli.main on a 500,000-sample x 4,096-variant panel
     (`--variants 16384`: the headline); K1-K4 must have launched, and the
     report must equal plink2's; then once more under torch.profiler for
     the card's busy share;
  5. QC + linear path: `--mind --freq --geno-counts --missing --hardy
     --geno --hwe --maf --glm hide-covar` on a Gaussian QT1 of the same
     panel; K1, K5 and K6 must have launched and every filter must have
     removed something; the integer reports must equal a CPU run's byte for
     byte, and 64 report rows must agree with a numpy f64 least-squares
     fit; then once more under torch.profiler;
  6. pair kernels: K7 (KING) and K8 (GRM) against their plain versions on
     the 50,000 x 32,768 panel of bench.py's king_50k / grm_50k, timed beside
     their bound and one library call;
  7. relationship paths on that panel: `--make-king-table
     --king-table-filter 0.044` (the .kin0 must equal plink2's, header only)
     and `--make-grm-bin` (16 windows of plink2's .grm.bin, the first
     window's .grm.N.bin against numpy counts); K5, K7 and K8 must have
     launched; then the KING path and a `--parallel 1 4` GRM piece under
     torch.profiler.  The GRM phase writes ~10.1 GB to the temporary
     directory (its free space is printed first);
  8. PCA / LD kernels: K9 (X q at L = 20 and 220) and K10 (X^T b at L = 20)
     over every block of bench.py's pca_100k panel (100,000 x 32,768, 10
     planted axes) against their plain versions in f32 and in f64, with a
     TF32 control that must fail the f64 limit; K11 on the whole indep_10k
     subcontig (10,000 x 32,768, width 200), bits and counts exact; each
     timed beside its bound and one library call;
  9. PCA path: `--pca 10 approx --seed 13` on pca_100k against plink2's
     .eigenvec (every 5th row, |corr| > 0.98 per PC) and .eigenval (1%),
     then with allele-wts (64 variants' weights against numpy's f64); K1,
     K9 and K10 must have launched; then under torch.profiler;
 10. indep path: `--indep-pairwise 200 50 0.2` on indep_10k, the .prune.in
     set-equal to plink2's; K1 and K11 launched; then under torch.profiler;
 11. LD report kernels: K12 on the whole indep_10k subcontig at width 200
     and K13 over the 136 chunk pairs of the matrix cell, each exactly
     equal to its plain version, timed beside its bound and a bf16 matmul;
 12. LD tables on indep_10k: `--r2-unphased --ld-window-kb 0.2
     --ld-window-r2 0.001` (K12; then under torch.profiler) and
     `--r2-phased --ld-window-kb 0.01 --ld-window-r2 0.001` (K12, K13),
     64 rows of each against numpy;
 13. LD matrix: `--r-unphased square bin4 --extract bed1` of variants
     1..8,192 of indep_10k (K13), 64 rows against numpy's f64 r;
     in phases 12, 13 and 16 every K11-K13 launch of the path is run again
     on the inputs it got there and held exactly against the plain version;
 14. `--ld snp100 snp101` on indep_10k, against numpy's counts;
 15. `--clump` of phase 4's report on its panel (loading, K1 and the host's
     pair decodes: no member on an iid panel), the .clumps equal to one
     recomputed on the host from the report and numpy's codes;
 16. `--indep-pairphase 200 50 0.2` on a phased copy of the whole
     indep_10k: K11 on the 20,000 haplotype columns, checked against
     numpy's haplotypes of the copy;
 17. parity: a 2,000 x 1,200 panel through the port on the card and on the
     CPU (plain versions), hybrid, firth, QC + linear, KING + GRM, .rel +
     exact PCA, approx PCA + allele-wts (on a panel of that size with 5
     planted axes), --indep-pairwise and the LD reports (LD_PARITY, byte
     for byte), compared column by column; two card runs must give
     identical bytes.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device or
without the plink_torch package beside this script.
"""

from __future__ import annotations

import argparse
import contextlib
import filecmp
import gzip
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_SAMPLES = 500_000  # the headline configuration's sample width
N_VARIANTS = 4_096  # two 2,048-variant blocks; --variants up to 16,384
SMALL = (2_000, 1_200, 1)  # samples, variants, seed of the parity panel
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores
# kernel vs plain tolerances for f32 sums over 500,000 samples taken in
# another order; each entry is normalised by a Cauchy-Schwarz bound on its
# size (sqrt of the two diagonal entries; sqrt(sum x_j^2 * obs) for vectors)
TOL_VS_PLAIN = 2e-4  # the plain version's cuBLAS products run each 500,000-
# term sum in about one f32 sequence: ~sqrt(n) * eps = 4e-5, with headroom
TOL_VS_F64 = 2e-5  # the kernel sums <= 2,048-sample runs in f32 (drift ~5e-6)
# and adds the runs in f64; held against the plain version run in f64
TOL_LOGLIK = 1e-6  # relative; f32 per-sample terms summed in f64 on both sides
TOL_CHOL = 1e-3  # relative to the row's largest entry; cond(H) * f32 eps
GLM_FLOAT_RTOL = 1e-3  # report columns OR / BETA / SE / Z / T / P (bench.py's rule)
# QC thresholds of phase 5, chosen so that every filter removes something on
# the panel (iid genotypes, 2% missing calls, allele frequencies U(0, 1)):
# --mind 0.028 is ~3.7 sd above a sample's mean missing rate over 4,096
# variants, --geno 0.0204 ~2 sd above a variant's over 500,000 samples,
# --hwe 1e-2 removes ~1% of variants in HWE, --maf 0.05 ~10%
QC_FLAGS = ["--mind", "0.028", "--freq", "--geno-counts", "--missing",
            "--hardy", "--geno", "0.0204", "--hwe", "1e-2", "--maf", "0.05"]
QC_REPORTS = (".afreq", ".gcount", ".vmiss", ".smiss", ".hardy")
QC_REMOVALS = ("(--mind)", "(--geno)", "Hardy-Weinberg", "allele frequency")
N_OLS_ROWS = 64  # .glm.linear rows checked against numpy's f64 fit
LOGISTIC_KERNELS = ("geno_counts", "glm_moments", "glm_irls", "chol_small")
QC_KERNELS = ("geno_counts", "sample_counts", "linear_sums")
# the relationship cells: bench.py's king_50k / grm_50k panel (p50000x32768,
# seed 42, 2% missing calls; bench.py:455-463,593-596), full width
REL_PANEL = (50_000, 32_768, 42)
KING_FILTER = "0.044"
# bench_golden/o_king.kin0.zst decompressed (plink2's .kin0 on that panel at
# --king-table-filter 0.044: the header alone); the card's machine has no
# zstandard
KING_GOLDEN = "#IID1\tIID2\tNSNP\tHETHET\tIBS0\tKINSHIP\n"
GRM_GOLDEN = os.path.join(HERE, "bench_golden", "o_grm.samples.npz")
INT8_OPS_PER_S = 1979e12  # H100 SXM int8 tensor cores, dense
# K8 against its plain version and the plain version in f64, normalised as
# above: full-f32 products summed in <= 2,048-variant f32 runs measure
# 4.8e-7 from f64 at 50,000 x 32,768; the same runs with TF32 inputs must
# land above this (chip_smoke checks it)
TOL_K8 = 2e-6
REL_TILE, REL_CHUNK = 2048, 8192  # the commands' sample tile and GRM chunk
GRM_BYTES_NEEDED = 10.1e9  # .grm.bin + .grm.N.bin at 50,000 samples
# parity cases of the relationship commands: (label, flags, outputs); the
# port's tile cut to 512 samples so the 2,000-sample panel has four a side
REL_PARITY = (
    ("king_grm", ["--make-king-table", "--king-table-filter", "0.05",
                  "--make-king", "square", "bin", "--make-grm-bin"],
     (".kin0", ".king.bin", ".king.id", ".grm.bin", ".grm.N.bin", ".grm.id")),
    ("rel_pca", ["--make-grm-list", "--make-rel", "--pca", "4"],
     (".grm", ".grm.id", ".rel", ".rel.id", ".eigenval", ".eigenvec")),
)
# plink2's own report on the headline 500,000 x 16,384 panel (the panel
# generator is counter-based, so its first rows are a smaller panel's rows),
# kept as gzip because the card's machine has no zstandard: `--write-golden`
GOLDEN = os.path.join(HERE, "chip_smoke_golden.tsv.gz")
GOLDEN_SRC = os.path.join(HERE, "bench_golden",
                          "o_glm.PHENO1.glm.logistic.hybrid.zst")
# the PCA and LD cells: bench.py's pca_100k (`--pca 10 approx --seed 13` on
# p100000x32768s: seed 7, 10 planted structure axes, no missing calls;
# bench.py:464-466,597-598) and indep_10k (`--indep-pairwise 200 50 0.2` on
# p10000x32768: seed 42, 2% missing calls; bench.py:451-453,591-592), full
# width
PCA_PANEL = (100_000, 32_768, 7, 10)  # samples, variants, seed, axes
IND_PANEL = (10_000, 32_768, 42)
PCA_ARGS = ["--pca", "10", "approx", "--seed", "13"]
IND_ARGS = ["--indep-pairwise", "200", "50", "0.2"]
# plink2's outputs on those panels (bench_golden/o_pca.eigenvec.sub5.zst,
# every 5th row; o_indep.prune.in.zst), gzip copies for the card's machine
# (`--write-golden`); o_pca.eigenval is plain text
PCA_GOLDEN = os.path.join(HERE, "chip_smoke_golden_pca.eigenvec.sub5.gz")
IND_GOLDEN = os.path.join(HERE, "chip_smoke_golden_indep.prune.in.gz")
PCA_EIGENVAL = os.path.join(HERE, "bench_golden", "o_pca.eigenval")
# K9 / K10 against the plain version in f64, normalised as above: <= 2,048-
# term f32 runs added in f64 (K9 over samples, K10 over a block's variants);
# the same runs with TF32 inputs must land above it (chip_smoke checks it)
TOL_PCA_F64 = 2e-6
N_WTS_ROWS = 64  # .eigenvec.allele rows checked against numpy's f64 weights
# parity cases of the PCA / LD paths (the PCA case on a panel of the parity
# panel's size with 5 planted axes, so that all 4 PCs are planted: a PC in
# the noise bulk has no well-determined direction, and with 3 axes the 4th
# PC's weights differ by more than the 1e-4 rule between two f32 summation
# orders)
PCA_LD_PARITY = (
    ("pca_approx_wts", "structured", ["--pca", "4", "approx", "allele-wts",
                                      "--seed", "5"],
     (".eigenval", ".eigenvec", ".eigenvec.allele")),
    ("indep", "small", ["--indep-pairwise", "50", "5", "0.2"],
     (".prune.in", ".prune.out")),
)
# the LD report cells, all on indep_10k (positions 1..M, so a kb window of
# w / 1000 is a window of w variants): the unphased table at width 200
# (plink 1.9's `--r2 --ld-window 200`; r^2 >= 0.001 keeps ~0.2% of iid
# pairs, so the filter and the writer both run), the phased table at width
# 10 (plink 1.9's default --ld-window), the r matrix of a fine-mapping
# region (variants 1..8,192: 16 x 17 / 2 = 136 chunk pairs of 512), --ld on
# one pair, and --indep-pairphase on a phased copy of the whole panel
VCOR_TABLE_ARGS = {
    False: ["--r2-unphased", "--ld-window-kb", "0.2", "--ld-window-r2", "0.001"],
    True: ["--r2-phased", "--ld-window-kb", "0.01", "--ld-window-r2", "0.001"],
}
REGION_VARIANTS = 8_192
VCOR_MATRIX_ARGS = ["--r-unphased", "square", "bin4", "--extract", "bed1"]
LD_PAIR = ("snp100", "snp101")
# --clump of the logistic main path's own report (the step after every scan):
# index p <= 1e-3, members within 50 bp (variants 1 bp apart) of r^2 >= 0.5
# (the default), p <= 0.01 (the default) listed in SP2
CLUMP_ARGS = ["--clump-p1", "1e-3", "--clump-kb", "0.05"]
CLUMP_P1, CLUMP_P2, CLUMP_R2, CLUMP_RADIUS = 1e-3, 0.01, 0.5, 49
CLUMP_BINS = (0.0001, 0.001, 0.01, 0.05)  # the default S<b> columns
PAIRPHASE_ARGS = ["--indep-pairphase", "200", "50", "0.2"]
PHASE_SEED = 43  # each het's phase in the phased copies
N_LD_ROWS = 64  # table / matrix rows checked against numpy
# parity cases of the LD reports on the parity panel, byte for byte: (label,
# panel, flags, outputs); {region} is its first 300 variants (each phased
# matrix pair costs one host phased_r2), {report} the hybrid case's report
LD_PARITY = (
    ("r2u_ld", "small", ["--r2-unphased", "--ld", "snp5", "snp6"], (".vcor",)),
    ("r2u_all", "small", ["--r2-unphased", "--ld-window-r2", "0"], (".vcor",)),
    ("rp_w", "small", ["--r-phased", "--ld-window-kb", "0.05"], (".vcor",)),
    ("r2p_sq", "small", ["--r2-phased", "square", "--extract", "bed1", "{region}"],
     (".phased.vcor2", ".phased.vcor2.vars")),
    ("ru_tri_bin", "small", ["--r-unphased", "triangle", "bin"],
     (".unphased.vcor1.bin", ".unphased.vcor1.vars")),
    ("clump", "small", ["--clump", "{report}", "--clump-p1", "0.01", "--clump-p2",
                        "0.05"], (".clumps",)),
    ("pairphase", "phased", ["--indep-pairphase", "50", "5", "0.2"],
     (".prune.in", ".prune.out")),
)


_T0 = time.perf_counter()


def log(msg=""):
    print(msg, flush=True)


def stamp(label):
    log(f"[{time.perf_counter() - _T0:.0f}s] {label}")


def card_report(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    from plink_torch import resolve_device

    dev = resolve_device()
    assert dev.type == "cuda", dev
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    return dev, smi.splitlines()[0]


def build():
    """Build every kernel library; print per kernel entry (template
    arguments from the mangled name) its registers and spill bytes, for the
    untemplated kernels, the covariate width of the main path (dc = 12) and
    wherever ptxas spilled."""
    from plink_torch.ops import _cuda

    t0 = time.perf_counter()
    secs = _cuda.build_all()
    log(f"build: {time.perf_counter() - t0:.1f}s wall "
        + " ".join(f"{k}={v:.1f}s" for k, v in secs.items()))
    for name in secs:
        entry, spill = None, 0
        for line in _cuda.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                args = re.findall(r"Li(\d+)E", entry)
                short = re.search(r"\d+([a-z_]+_kernel)", entry)
                short = short.group(1) if short else entry
                if spill or not args or args[0] in ("12", "13", "15"):
                    log(f"  {short}<{','.join(args)}>: {m.group(1)} registers, "
                        f"{spill} bytes spilled")
                entry, spill = None, 0


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def chunked(torch, fn, n_rows, step, dim=0):
    """Run a row-independent plain version `fn(row_slice)` over row chunks
    (bounded [rows, n] temporaries) and concatenate each output along the
    variant axis `dim`."""
    outs = [fn(slice(r0, min(n_rows, r0 + step)))
            for r0 in range(0, n_rows, step)]
    if isinstance(outs[0], tuple):
        return tuple(None if o[0] is None else torch.cat(o, dim)
                     for o in zip(*outs))
    return torch.cat(outs, dim)


def norm_err(torch, k, p, scale):
    return float(((k - p).abs() / scale).max())


def mat_scale(torch, m):
    """sqrt(|m_jj m_kk|): a bound on |m_jk| for a sum of weighted x x^T."""
    dg = torch.diagonal(m, dim1=1, dim2=2).abs().clamp(min=1e-30)
    return torch.sqrt(dg[:, :, None] * dg[:, None, :])


def make_panel(prefix, n, m, seed):
    """The panel, its SEX + 10 PCs covariates (seed + 1) and <prefix>.qt,
    one Gaussian phenotype QT1 drawn with numpy (seed + 2)."""
    import numpy as np

    from plink_torch.bench_gen import gen_panel, make_cov

    gen_panel(prefix, n, m, miss_rate=0.02, seed=seed)
    make_cov(prefix, seed + 1)
    qt = np.random.default_rng(seed + 2).normal(size=n)
    with open(prefix + ".qt", "w") as f:
        f.write("#IID\tQT1\n")
        f.writelines(f"per{i}\t{v:.6f}\n" for i, v in enumerate(qt))


def qc_argv(prefix, out, glm=True):
    """The QC + linear path's argv (without --glm: its integer reports)."""
    return (["--pfile", prefix, "--pheno", prefix + ".qt", "--pheno-name",
             "QT1", "--covar", prefix + ".cov", *QC_FLAGS]
            + (["--glm", "hide-covar"] if glm else [])
            + ["--out", out, "--silent"])


def main_path_inputs(torch, prefix, dev):
    """The panel's packed genotypes on the card, its per-sample table and its
    (all, male, female) masks, as the main path builds them:
    c = [1 | SEX | PC1..PC10] (dc = 12), y = PHENO1, every sample in."""
    import numpy as np

    from plink_torch.dataset import load_dataset

    ds = load_dataset(prefix, dev)
    packed = ds.device_all_packed()
    n = ds.raw_sample_ct
    cov = np.loadtxt(prefix + ".cov", skiprows=1, usecols=range(1, 12),
                     dtype=np.float64)
    y = ds.si.phenos["PHENO1"].data
    feat = np.zeros((packed.shape[1] * 4, 14), np.float32)
    feat[:n, 0] = 1.0
    feat[:n, 1:12] = cov
    feat[:n, 12] = y
    feat[:n, 13] = 1.0
    sex = ds.si.sex
    masks = np.zeros((packed.shape[1] * 4, 3), np.float32)
    masks[:n, 0] = 1.0
    masks[:n, 1] = sex == 1
    masks[:n, 2] = sex == 2
    return (packed, torch.from_numpy(feat).to(dev),
            torch.from_numpy(masks).to(dev))


def unpack_codes(packed):
    from plink_torch.ops.planes import unpack_codes as unpack

    return unpack(packed)


def bf16_planes(torch, packed, fns, step=1024):
    """[len(fns) * V, 4 * NB] bf16 planes fn(codes) of packed [V, NB],
    decoded in row chunks (a library call's input; no large temporaries)."""
    V = packed.shape[0]
    out = torch.empty((len(fns) * V, 4 * packed.shape[1]), dtype=torch.bfloat16,
                      device=packed.device)
    for r0 in range(0, V, step):
        codes = unpack_codes(packed[r0 : r0 + step])
        for i, fn in enumerate(fns):
            out[i * V + r0 : i * V + r0 + codes.shape[0]] = fn(codes)
    return out


def check_kernels(torch, dev, prefix):
    from plink_torch.ops import counts as C
    from plink_torch.ops import glm as G

    packed_all, feat, masks = main_path_inputs(torch, prefix, dev)
    vb = 2048
    pk = packed_all[:vb]
    dc = feat.shape[1] - 2
    d = dc + 1
    rows = []

    # K1 over the whole panel, as _group_counts calls it
    k1 = C.geno_counts(packed_all, masks)
    V = packed_all.shape[0]
    plain1 = lambda sl: C.geno_counts_plain(packed_all[sl], masks)  # noqa: E731
    p1 = chunked(torch, plain1, V, 512, dim=1)
    err1 = int((k1 - p1).abs().max())
    assert err1 == 0, f"geno_counts differs from its plain version by {err1}"
    ms1 = time_ms(torch, lambda: C.geno_counts(packed_all, masks), 20)
    pms1 = time_ms(torch, lambda: chunked(torch, plain1, V, 512, dim=1), 1)
    # library: the bf16 planes (b0, b1, b0*b1) by the masks, one matmul, as
    # plink_tpu's _geno_counts_multimask computes the counts
    bplanes = bf16_planes(torch, packed_all, (lambda c: c & 1, lambda c: c >> 1,
                                              lambda c: (c & 1) & (c >> 1)))
    mbf = masks.to(torch.bfloat16)
    lib1 = time_ms(torch, lambda: torch.matmul(bplanes, mbf), 5)
    del bplanes
    bytes1 = packed_all.numel() + masks.numel() * 4 + k1.numel() * 4
    rows.append(dict(name="geno_counts", source="plink_torch/csrc/geno_counts.cu",
                     replaces="plink_tpu/ops/counts.py:98",
                     max_abs_err=float(err1), tol=0.0, ms=ms1, plain_ms=pms1,
                     bound_ms=1e3 * bytes1 / HBM_BYTES_PER_S, bound_by="bytes",
                     library_ms=lib1))
    log(f"K1 geno_counts [{packed_all.shape[0]}x{packed_all.shape[1]}B, G=3]: "
        f"exact; {ms1:.3f} ms, plain {pms1:.1f} ms, bf16 matmul {lib1:.3f} ms")

    # K2 on block 0, against the plain version in f32 and in f64
    gw = torch.zeros((vb, 3), dtype=torch.float32, device=dev)
    gw[:, 0], gw[:, 1] = 1.0, 2.0  # ADD with A1 = ALT
    gwm = torch.stack([gw, gw], dim=1).contiguous()
    feat64 = feat.double()
    k2 = G.glm_moments(pk, gwm, feat)
    plain2 = lambda sl: G.glm_moments_plain(pk[sl], gwm[sl], feat)  # noqa: E731
    p2 = chunked(torch, plain2, vb, 256)
    r2 = chunked(torch, lambda sl: G.glm_moments_plain(
        pk[sl], gwm[sl].double(), feat64), vb, 128)
    sc2 = mat_scale(torch, r2)
    e2, e2r, e2pr = (norm_err(torch, a, b, sc2)
                     for a, b in ((k2, p2), (k2, r2), (p2, r2)))
    ints = [0, dc, dc + 1, dc + 2]  # intercept, y, G, ADD: integer sums
    exact2 = bool(torch.equal(k2[:, ints][:, :, ints], p2[:, ints][:, :, ints]))
    assert e2 <= TOL_VS_PLAIN and e2r <= TOL_VS_F64 and exact2, (e2, e2r, exact2)
    ms2 = time_ms(torch, lambda: G.glm_moments(pk, gwm, feat), 5)
    pms2 = time_ms(torch, lambda: chunked(torch, plain2, vb, 256), 1)
    n_valid = float(k2[:, 0, 0].sum())
    D = dc + 3
    valid_f = (pk.unsqueeze(-1) >> torch.arange(0, 8, 2, dtype=torch.uint8,
                                                device=dev) & 3).reshape(vb, -1)
    valid_f = (valid_f != 3).to(torch.float32)
    cy = feat[:, : dc + 1]
    ccfl2 = (cy[:, :, None] * cy[:, None, :]).reshape(-1, (dc + 1) ** 2)
    lib2 = time_ms(torch, lambda: torch.matmul(valid_f, ccfl2), 5)
    ops2 = n_valid * 2 * D * (D + 1) / 2
    bytes2 = pk.numel() + feat.numel() * 4 + gwm.numel() * 4 + k2.numel() * 4
    rows.append(dict(name="glm_moments", source="plink_torch/csrc/glm_moments.cu",
                     replaces="plink_tpu/ops/glm.py:242",
                     max_abs_err=float((k2 - p2).abs().max()), max_norm_err=e2,
                     tol=TOL_VS_PLAIN, max_norm_err_f64=e2r, tol_f64=TOL_VS_F64,
                     ms=ms2, plain_ms=pms2, **_bound(ops2, bytes2),
                     library_ms=lib2))
    log(f"K2 glm_moments [{vb}x{feat.shape[0]}, D={D}]: norm err vs plain "
        f"{e2:.2e} (tol {TOL_VS_PLAIN:g}), vs f64 {e2r:.2e} (tol "
        f"{TOL_VS_F64:g}; plain vs f64 {e2pr:.2e}), integer entries exact; "
        f"{ms2:.3f} ms, plain {pms2:.1f} ms, matmul {lib2:.3f} ms")

    # K4 then K3 from the main path's own start: OLS init solve, one
    # logistic pass at it, and the Firth pass at beta = 0
    idx = list(range(dc)) + [dc + 1]
    h0 = k2[:, idx][:, :, idx].contiguous()
    rhs0 = (G._Z_INIT * (k2[:, idx, dc] - 0.5 * k2[:, idx, 0])).contiguous()
    beta0, _, _ = G.chol_small(h0, rhs=rhs0)
    active = torch.ones(vb, dtype=torch.bool, device=dev)
    vsc = torch.sqrt(torch.diagonal(h0, dim1=1, dim2=2).clamp(min=1e-30)
                     * k2[:, :1, 0])  # |sum r x_j| <= sqrt(sum x_j^2 * obs)

    def k3_check(label, beta, hinv):
        km, kv, kl = G.glm_irls_pass(pk, gw, feat, beta, active, hinv)
        pm, pv, pl = chunked(torch, lambda sl: G.glm_irls_pass_plain(
            pk[sl], gw[sl], feat, beta[sl], active[sl],
            None if hinv is None else hinv[sl]), vb, 256)
        rm, rv, rl = chunked(torch, lambda sl: G.glm_irls_pass_plain(
            pk[sl], gw[sl].double(), feat64, beta[sl].double(), active[sl],
            None if hinv is None else hinv[sl].double()), vb, 128)
        scm = mat_scale(torch, rm)
        em, emr, empr = (norm_err(torch, a, b, scm)
                         for a, b in ((km, pm), (km, rm), (pm, rm)))
        ev, evr = norm_err(torch, kv, pv, vsc), norm_err(torch, kv, rv, vsc)
        el = 0.0 if kl is None else float(((kl - pl).abs() / pl.abs()).max())
        if not (max(em, ev) <= TOL_VS_PLAIN and max(emr, evr) <= TOL_VS_F64
                and el <= TOL_LOGLIK):
            row = int(((km - rm).abs() / scm).amax((1, 2)).argmax())
            raise AssertionError(
                f"K3 {label}: vs plain H {em} vec {ev}, vs f64 H {emr} vec {evr}"
                f", loglik {el}; worst row {row}: obs {float(k2[row, 0, 0])} "
                f"ADD sum {float(k2[row, 0, dc + 2])} beta {beta[row].tolist()}")
        mae = max(float((km - pm).abs().max()), float((kv - pv).abs().max()))
        log(f"K3 glm_irls_pass {label} [{vb}x{feat.shape[0]}, d={d}]: norm err "
            f"vs plain H {em:.2e} vec {ev:.2e}, vs f64 H {emr:.2e} vec "
            f"{evr:.2e} (plain vs f64 H {empr:.2e}), loglik rel {el:.2e}")
        return km, kv, mae, max(em, ev), max(emr, evr)

    H, grad, mae3, err3, err3r = k3_check("logistic", beta0, None)
    zero = torch.zeros((vb, d), dtype=torch.float32, device=dev)
    Hz, _, _ = G.glm_irls_pass(pk, gw, feat, zero, active)
    _, hz_inv, _ = G.chol_small(Hz, inverse=True)
    _, _, mae3f, err3f, err3fr = k3_check("firth2", zero, hz_inv)
    ms3 = time_ms(torch, lambda: G.glm_irls_pass(pk, gw, feat, beta0, active), 5)
    ms3f = time_ms(torch, lambda: G.glm_irls_pass(pk, gw, feat, zero, active,
                                                  hz_inv), 3)
    pms3 = time_ms(torch, lambda: chunked(torch, lambda sl: G.glm_irls_pass_plain(
        pk[sl], gw[sl], feat, beta0[sl], active[sl]), vb, 256), 1)
    c = feat[:, :dc]
    ccfl3 = (c[:, :, None] * c[:, None, :]).reshape(-1, dc * dc)
    lib3 = time_ms(torch, lambda: torch.matmul(valid_f, ccfl3), 5)
    del valid_f
    ntri = d * (d + 1) // 2
    ops3 = n_valid * (2 * ntri + 4 * d + 12)  # H, gradient, eta, p / loglik
    ops3f = n_valid * (4 * ntri + 4 * d + 12)  # + the hat diagonal
    bytes3 = pk.numel() + feat.numel() * 4 + (vb * (d * d + 2 * d + 5)) * 4
    rows.append(dict(name="glm_irls_pass", source="plink_torch/csrc/glm_irls.cu",
                     replaces="plink_tpu/ops/glm.py:328",
                     max_abs_err=max(mae3, mae3f), max_norm_err=max(err3, err3f),
                     tol=TOL_VS_PLAIN, max_norm_err_f64=max(err3r, err3fr),
                     tol_f64=TOL_VS_F64, ms=ms3, plain_ms=pms3,
                     **_bound(ops3, bytes3), library_ms=lib3, firth2_ms=ms3f,
                     firth2_bound_ms=_bound(ops3f, bytes3 + vb * d * d * 4)["bound_ms"]))
    log(f"K3 glm_irls_pass: logistic {ms3:.3f} ms, firth2 {ms3f:.3f} ms, plain "
        f"{pms3:.1f} ms, matmul {lib3:.3f} ms")

    # K4 at [2048, 13, 13] on the logistic Hessian and gradient
    kx, ki, kd = G.chol_small(H, rhs=grad, inverse=True, logdet=True)
    px, pi, pdet = G.chol_small_plain(H, grad, True, True)
    ex = float(((kx - px).abs().amax(1) / px.abs().amax(1)).max())
    ei = float(((ki - pi).abs().amax((1, 2)) / pi.abs().amax((1, 2))).max())
    ed = float(((kd - pdet).abs() / pdet.abs().clamp(min=1.0)).max())
    assert max(ex, ei, ed) <= TOL_CHOL, (ex, ei, ed)
    ms4 = time_ms(torch, lambda: G.chol_small(H, rhs=grad, inverse=True,
                                              logdet=True), 50)
    pms4 = time_ms(torch, lambda: G.chol_small_plain(H, grad, True, True), 3)
    lib4 = time_ms(torch, lambda: torch.linalg.inv(H), 50)
    ops4 = vb * (d ** 3 / 3 + 2 * d * d + d ** 3)  # factor, solve, inverse
    bytes4 = vb * (2 * d * d + 2 * d + 1) * 4
    rows.append(dict(name="chol_small", source="plink_torch/csrc/chol_small.cu",
                     replaces="plink_tpu/ops/glm.py:125",
                     max_abs_err=float(max((kx - px).abs().max(), (ki - pi).abs().max())),
                     max_norm_err=max(ex, ei, ed), tol=TOL_CHOL, ms=ms4,
                     plain_ms=pms4, **_bound(ops4, bytes4), library_ms=lib4))
    log(f"K4 chol_small [{vb},{d},{d}]: rel err solve {ex:.2e} inverse {ei:.2e} "
        f"logdet {ed:.2e} (tol {TOL_CHOL:g}); {ms4:.4f} ms, plain {pms4:.2f} ms, "
        f"linalg.inv {lib4:.4f} ms")

    # B1d: the device screen and validity flags of one block (tensor ops)
    msd = time_ms(torch, lambda: (G._collin_screen_device(k2, dc),
                                  G._valid_params_flags(ki, d)), 20)
    bytesd = (k2.numel() + ki.numel()) * 4 + 2 * vb  # f32 in, two bool [vb] out
    log(f"B1d _collin_screen_device + _valid_params_flags [{vb}]: {msd:.4f} ms "
        f"per block (CUDA events), bound {1e3 * bytesd / HBM_BYTES_PER_S:.5f} ms "
        f"(bytes: {bytesd})")

    rows.append(check_sample_counts(torch, dev, packed_all))
    rows.append(check_linear_sums(torch, dev, prefix, pk, feat))
    return rows


def check_sample_counts(torch, dev, packed_all):
    """K5 over the whole panel, exact against its plain version with variant
    masks that drop rows; timed in the main path's form (missing, one
    mask)."""
    from plink_torch.ops import counts as C

    V = packed_all.shape[0]
    vid = torch.arange(V, device=dev)
    vm2 = torch.stack([vid % 7 != 3, vid % 3 == 0], 1).float().contiguous()
    vm1 = vm2[:, :1].contiguous()
    for m in (vm1, vm2):
        for het_hom in (False, True):
            k5 = C.sample_counts(packed_all, m, het_hom)
            assert torch.equal(k5, C.sample_counts_plain(packed_all, m, het_hom)), \
                ("sample_counts differs from its plain version", m.shape, het_hom)
    k5 = C.sample_counts(packed_all, vm1)
    ms5 = time_ms(torch, lambda: C.sample_counts(packed_all, vm1), 20)
    ms5f = time_ms(torch, lambda: C.sample_counts(packed_all, vm2, True), 20)
    pms5 = time_ms(torch, lambda: C.sample_counts_plain(packed_all, vm1), 1)
    # library: the variant mask by the decoded bf16 missing plane, one matmul,
    # as plink_tpu's _sample_miss_counts computes it
    miss = bf16_planes(torch, packed_all, (lambda c: c == 3,))
    vmb = vm1.t().to(torch.bfloat16).contiguous()
    lib5 = time_ms(torch, lambda: torch.matmul(vmb, miss), 5)
    del miss
    bytes5 = packed_all.numel() + vm1.numel() * 4 + k5.numel() * 4
    log(f"K5 sample_counts [{V}x{packed_all.shape[1]}B]: exact (G=1,2; missing "
        f"and het/hom modes); {ms5:.3f} ms (missing, G=1), {ms5f:.3f} ms "
        f"(het/hom, G=2), plain {pms5:.1f} ms, bf16 matmul {lib5:.3f} ms")
    return dict(name="sample_counts", source="plink_torch/csrc/sample_counts.cu",
                replaces="plink_tpu/ops/counts.py:72",
                also_replaces="plink_tpu/ops/counts.py:84", max_abs_err=0.0,
                tol=0.0, ms=ms5, plain_ms=pms5,
                bound_ms=1e3 * bytes5 / HBM_BYTES_PER_S, bound_by="bytes",
                library_ms=lib5, het_hom_g2_ms=ms5f)


def _chunked_dict(torch, fn, n_rows, step):
    outs = [fn(slice(r0, min(n_rows, r0 + step))) for r0 in range(0, n_rows, step)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def check_linear_sums(torch, dev, prefix, pk, feat):
    """K6 on block 0 at the QC + linear path's width (c = [1 | SEX | PC1..10],
    y = QT1, all 500,000 samples) against its plain version in f32 and in
    f64; every entry normalised by a Cauchy-Schwarz bound on its plane sum
    (sqrt(s_jj s_kk) for c_j c_k, sqrt(s_jj * sum y^2) for c_j y)."""
    import numpy as np

    from plink_torch.ops import glm as G

    vb, nb = pk.shape
    npad = 4 * nb
    dc = feat.shape[1] - 2
    qt = np.loadtxt(prefix + ".qt", skiprows=1, usecols=1, dtype=np.float64)
    n = qt.size
    y = torch.zeros(npad, dtype=torch.float64, device=dev)
    y[:n] = torch.from_numpy(qt).to(dev)
    c = feat[:, :dc].double()
    ins64 = ((c[:, :, None] * c[:, None, :]).reshape(npad, dc * dc),
             c * y[:, None], y * y)
    ins32 = tuple(t.float().contiguous() for t in ins64)
    k6 = G.linear_sums(pk, *ins32)
    p6 = _chunked_dict(torch, lambda sl: G.linear_sums_plain(pk[sl], *ins32), vb, 256)
    r6 = _chunked_dict(torch, lambda sl: G.linear_sums_plain(pk[sl], *ins64), vb, 128)
    # sum y^2 over each plane: the plain version with y^2 as its one-column
    # c c^T table (read back as ?cc)
    yy = _chunked_dict(torch, lambda sl: G.linear_sums_plain(
        pk[sl], ins64[2][:, None], ins64[2][:, None], ins64[2]), vb, 128)
    errs = {"plain": 0.0, "f64": 0.0, "plain_vs_f64": 0.0}
    mae = 0.0
    for pl in "ham":
        dg = torch.diagonal(r6[pl + "cc"].reshape(vb, dc, dc), dim1=1,
                            dim2=2).clamp(min=1e-30)
        scales = {pl + "cc": torch.sqrt(dg[:, :, None] * dg[:, None, :]).reshape(vb, -1),
                  pl + "cy": torch.sqrt(dg * yy[pl + "cc"].clamp(min=1e-30))}
        if pl == "m":
            scales["myy"] = r6["myy"].clamp(min=1e-30)
        for key, sc in scales.items():
            errs["plain"] = max(errs["plain"], norm_err(torch, k6[key], p6[key], sc))
            errs["f64"] = max(errs["f64"], norm_err(torch, k6[key], r6[key], sc))
            errs["plain_vs_f64"] = max(errs["plain_vs_f64"],
                                       norm_err(torch, p6[key], r6[key], sc))
            mae = max(mae, float((k6[key] - p6[key]).abs().max()))
    assert errs["plain"] <= TOL_VS_PLAIN and errs["f64"] <= TOL_VS_F64, errs
    again = G.linear_sums(pk, *ins32)
    assert all(torch.equal(k6[k], again[k]) for k in k6), "K6 is not deterministic"
    ms6 = time_ms(torch, lambda: G.linear_sums(pk, *ins32), 5)
    pms6 = time_ms(torch, lambda: _chunked_dict(
        torch, lambda sl: G.linear_sums_plain(pk[sl], *ins32), vb, 256), 1)
    # library: the decoded planes [3 vb, n] by the per-sample table
    # [n, dc^2 + dc + 1] (plink_tpu's three plane products), one matmul
    codes = unpack_codes(pk)
    nz = int((codes != 0).sum())  # (variant, sample) pairs that add a row
    planes = torch.cat([(codes == k).float() for k in (1, 2, 3)])
    del codes
    table = torch.cat([ins32[0], ins32[1], ins32[2][:, None]], 1)
    lib6 = time_ms(torch, lambda: torch.matmul(planes, table), 3)
    del planes, table
    nf = dc * (dc + 1) // 2 + dc + 1
    ops6 = nz * nf  # one FP32 add per feature entry of each such pair
    bytes6 = pk.numel() + npad * nf * 4 + 3 * vb * (dc * dc + dc + 1) * 8
    log(f"K6 linear_sums [{vb}x{npad}, dc={dc}, {nf} entries]: norm err vs "
        f"plain {errs['plain']:.2e} (tol {TOL_VS_PLAIN:g}), vs f64 "
        f"{errs['f64']:.2e} (tol {TOL_VS_F64:g}; plain vs f64 "
        f"{errs['plain_vs_f64']:.2e}), two runs identical; {ms6:.3f} ms, plain "
        f"{pms6:.1f} ms, matmul {lib6:.3f} ms; {nz} non-hom-REF pairs")
    return dict(name="linear_sums", source="plink_torch/csrc/linear_sums.cu",
                replaces="plink_tpu/ops/glm.py:46", max_abs_err=mae,
                max_norm_err=errs["plain"], tol=TOL_VS_PLAIN,
                max_norm_err_f64=errs["f64"], tol_f64=TOL_VS_F64, ms=ms6,
                plain_ms=pms6, **_bound(ops6, bytes6), library_ms=lib6)


def check_pair_kernels(torch, dev, prefix):
    """Phase 6: K7 on a diagonal tile and on the last (ragged) row tile, K8
    on the last strip's last chunk (ragged rows, padded columns, the anchor
    pulled back), each against its plain version on the relationship panel
    as the commands lay it out (compacted, padded to 2,048-sample tiles)."""
    import types

    from plink_torch.commands.grm import _grm_setup
    from plink_torch.dataset import load_dataset
    from plink_torch.ops import pairwise as P

    ds = load_dataset(prefix, dev)
    pd, coef, miss = _grm_setup(ds, types.SimpleNamespace(nonfounders=False))
    n, s, c, mv = pd.n, pd.tile, REL_CHUNK, pd.variant_ct
    assert s == REL_TILE and pd.npad > n, (s, pd.npad, n)
    thresh = float(KING_FILTER)
    rows = []

    def max_abs_diff(a, b):  # equal values (NaN with NaN, -inf with -inf) 0
        a, b = a.double(), b.double()
        same = (a == b) | (a.isnan() & b.isnan())
        return float(torch.where(same, 0.0, (a - b).abs()).max())

    # K7: every output exact (kin bit for bit), counters mode too
    passed, err7 = [], 0.0
    for r0, c0 in ((0, 0), (pd.npad - s, 0)):
        k = P.king_gram(pd.packed, pd.vmask, r0, c0, s, s, n=n, thresh=thresh)
        p = P.king_gram_plain(pd.packed, pd.vmask, r0, c0, s, s, n=n, thresh=thresh)
        kc = P.king_gram(pd.packed, pd.vmask, r0, c0, s, s, counts=True)
        pc = P.king_gram_plain(pd.packed, pd.vmask, r0, c0, s, s, counts=True)
        err7 = max([err7, max_abs_diff(kc, pc)]
                   + [max_abs_diff(a, b) for a, b in zip(k, p)])
        assert k[0].cpu().numpy().tobytes() == p[0].cpu().numpy().tobytes(), \
            ("king_gram kin differs from its plain version", r0, c0)
        assert all(torch.equal(a, b) for a, b in zip(k[1:], p[1:])), (r0, c0)
        assert torch.equal(kc, pc), (r0, c0)
        passed.append(int(k[5]))
    assert err7 == 0.0, err7
    ms7 = time_ms(torch, lambda: P.king_gram(pd.packed, pd.vmask, 0, 0, s, s,
                                             n=n, thresh=thresh), 5)
    pms7 = time_ms(torch, lambda: P.king_gram_plain(pd.packed, pd.vmask, 0, 0,
                                                    s, s, n=n, thresh=thresh), 1)
    # library: the decoded H/A/V planes [V, 3s] as bf16, one matmul to f32
    # (exact: 0/1 products, sums < 2^24)
    flat = pd.packed.reshape(-1, pd.packed.shape[2])[:, : s // 4]
    vmf = pd.vmask.reshape(-1, 1) != 0
    hav = torch.cat([bf16_planes(torch, flat, (
        lambda cd: (cd == 1), lambda cd: (cd == 2), lambda cd: (cd != 3)))
        .reshape(3, -1, s)[i] * vmf for i in range(3)], dim=1)
    lib7 = time_ms(torch, lambda: torch.mm(hav.t(), hav, out_dtype=torch.float32), 5)
    del hav
    # the six plane products the counters need on int8 tensor cores: HH, HV,
    # VH, VV and ibs0 = AR + RA (R = hom-REF = V - H - A)
    ops7 = 6 * s * s * mv * 2
    bytes7 = mv * (2 * s // 4 + 1) + s * s * (8 + 3 * 4 + 1)  # in: codes, vmask
    t_ops, t_bytes = 1e3 * ops7 / INT8_OPS_PER_S, 1e3 * bytes7 / HBM_BYTES_PER_S
    rows.append(dict(name="king_gram", source="plink_torch/csrc/king_gram.cu",
                     replaces="plink_tpu/ops/pairwise.py:60",
                     also_replaces="plink_tpu/ops/pairwise.py:173",
                     max_abs_err=err7, tol=0.0, ms=ms7, plain_ms=pms7,
                     bound_ms=max(t_ops, t_bytes),
                     bound_by="operations" if t_ops >= t_bytes else "bytes",
                     library_ms=lib7))
    log(f"K7 king_gram [{s}x{s} tile, V={mv}]: counters, kin (bit for bit), "
        f"pass mask and count ({passed}) = plain on a diagonal and the last "
        f"ragged row tile; {ms7:.3f} ms, plain {pms7:.1f} ms, bf16 matmul "
        f"{lib7:.3f} ms, bound {max(t_ops, t_bytes):.3f} ms")

    # K8: chunk mode against the plain version in f32 and in f64
    r0, a0 = pd.npad - s, pd.npad - c
    g, nm = P.grm_gram(pd.packed, coef, pd.vmask, miss, mv, r0, a0, s, c)
    pg, pnm = P.grm_gram_plain(pd.packed, coef, pd.vmask, miss, mv, r0, a0, s, c)
    rg, rnm = P.grm_gram_plain(pd.packed, coef.double(), pd.vmask, miss, mv,
                               r0, a0, s, c)
    assert torch.equal(nm, pnm) and torch.equal(nm, rnm)
    # each entry's error as a share of sqrt(sum Z_i^2 sum Z_j^2) / nm, a bound
    # on |g_ij| (Cauchy-Schwarz)
    d = torch.zeros(pd.npad, dtype=torch.float64, device=dev)
    flat = pd.packed.reshape(-1, pd.packed.shape[2])
    c2 = coef.reshape(-1, 3).double() ** 2
    for v0 in range(0, flat.shape[0], 512):
        cd = unpack_codes(flat[v0 : v0 + 512]).long()
        z2 = torch.gather(c2[v0 : v0 + 512], 1, cd.clamp(max=2))
        d += torch.where(cd == 3, 0.0, z2).sum(0)
    scale = (torch.sqrt(d[r0 : r0 + s, None] * d[None, a0 : a0 + c])
             .clamp(min=1e-30) / nm.double())
    e8, e8r, e8pr = (norm_err(torch, a.double(), b.double(), scale)
                     for a, b in ((g, pg), (g, rg), (pg, rg)))
    assert e8 <= TOL_K8 and e8r <= TOL_K8, (e8, e8r)
    again = P.grm_gram(pd.packed, coef, pd.vmask, miss, mv, r0, a0, s, c)
    assert torch.equal(g, again[0]), "K8 is not deterministic"
    ms8 = time_ms(torch, lambda: P.grm_gram(pd.packed, coef, pd.vmask, miss, mv,
                                            r0, a0, s, c), 3)
    pms8 = time_ms(torch, lambda: P.grm_gram_plain(pd.packed, coef, pd.vmask,
                                                   miss, mv, r0, a0, s, c), 1)

    def decoded(a, w):  # Z [V, w] f32 of samples [a, a + w)
        out = torch.empty((flat.shape[0], w), dtype=torch.float32, device=dev)
        cf = coef.reshape(-1, 3)
        for v0 in range(0, flat.shape[0], 512):
            cd = unpack_codes(flat[v0 : v0 + 512, a // 4 : (a + w) // 4]).long()
            z = torch.gather(cf[v0 : v0 + 512], 1, cd.clamp(max=2))
            out[v0 : v0 + 512] = torch.where(cd == 3, 0.0, z)
        return out

    zr, zc = decoded(r0, s), decoded(a0, c)
    lib8 = time_ms(torch, lambda: torch.matmul(zr.t(), zc), 3)
    # control: K8's run structure (<= 2,048-variant f32 products added in
    # f64) with TF32 inputs must fail TOL_K8, or the check could not tell a
    # TF32 kernel from a full-f32 one
    acc32 = torch.zeros((s, c), dtype=torch.float64, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for v0 in range(0, zr.shape[0], 2048):
            acc32 += torch.matmul(zr[v0 : v0 + 2048].t(), zc[v0 : v0 + 2048]).double()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    g32 = (acc32 / nm.double()).float()
    del acc32
    e8tf32 = norm_err(torch, g32.double(), rg.double(), scale)
    assert e8tf32 > TOL_K8, ("the TF32 control passes K8's limit", e8tf32)
    del zr, zc, g32
    ops8 = 2 * s * c * mv
    bytes8 = mv * (s + c) // 4 + mv * 13 + 4 * (s + c) + s * c * 5
    rows.append(dict(name="grm_gram", source="plink_torch/csrc/grm_gram.cu",
                     replaces="plink_tpu/ops/pairwise.py:355",
                     also_replaces="plink_tpu/ops/pairwise.py:215",
                     max_abs_err=float((g - pg).abs().nan_to_num(0.0).max()),
                     max_norm_err=e8, tol=TOL_K8, max_norm_err_f64=e8r,
                     tol_f64=TOL_K8, tf32_control_norm_err=e8tf32, ms=ms8,
                     plain_ms=pms8,
                     **_bound(ops8, bytes8), library_ms=lib8))
    log(f"K8 grm_gram [{s}x{c} chunk, V={mv}]: norm err vs plain {e8:.2e}, vs "
        f"f64 {e8r:.2e} (tol {TOL_K8:g} each; plain vs f64 {e8pr:.2e}; the TF32 "
        f"control {e8tf32:.2e} fails it), pair counts exact, two runs "
        f"identical; {ms8:.3f} ms, plain {pms8:.1f} ms, f32 matmul "
        f"{lib8:.3f} ms")
    del pd, coef, miss, ds
    return rows


def pca_operands(torch, prefix, dev):
    """The PCA path's operands on the card (commands/pca.py `_Operands`:
    packed blocks, coefficients from the founders' allele frequencies, the
    sample mask) and the per-variant / per-sample sums of Z^2 in f64."""
    import types

    from plink_torch.commands.pca import _Operands
    from plink_torch.dataset import load_dataset
    from plink_torch.ops.pca import _normed_block

    ops = _Operands(load_dataset(prefix, dev), types.SimpleNamespace(nonfounders=False))
    pk, cf, sm = ops.pd.packed, ops.coef, ops.smask
    nb, vb, _ = pk.shape
    z2v = torch.empty(nb * vb, dtype=torch.float64, device=dev)
    z2s = torch.zeros(sm.shape[0], dtype=torch.float64, device=dev)
    for k in range(nb):
        z2 = _normed_block(pk[k], cf[k].double(), sm) ** 2
        z2v[k * vb : (k + 1) * vb] = z2.sum(1)
        z2s += z2.sum(0)
        del z2
    return ops, z2v, z2s


def check_pca_kernels(torch, dev, prefix):
    """Phase 9a: K9 at L = 20 (the power iterations) and L = 220 (the
    projection) and K10 at L = 20, over every block of the pca_100k panel as
    the path lays it out, against the plain version in f32 (TOL_VS_PLAIN)
    and in f64 (TOL_PCA_F64), each entry normalised by its Cauchy-Schwarz
    scale sqrt(sum Z^2 * sum q^2) over the contracted axis; a TF32 control
    of the same runs must fail the f64 limit; two runs identical."""
    from plink_torch.ops import pca as P

    ops, z2v, z2s = pca_operands(torch, prefix, dev)
    pk, cf, sm = ops.pd.packed, ops.coef, ops.smask
    nb, vb, nbytes = pk.shape
    npad, n = sm.shape[0], ops.pd.n
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = []

    def errs(got, plain, ref, scale):
        return tuple(norm_err(torch, a.double(), b.double(), scale)
                     for a, b in ((got, plain), (got, ref), (plain, ref)))

    def tf32_runs(fn):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    z0 = P._normed_block(pk[0], cf[0], sm)  # the library calls' input
    for L in (20, 220):
        q = torch.randn((npad, L), generator=gen, device=dev)
        q[n:] = 0.0
        got = P.x_apply(pk, cf, sm, q)
        plain = P.x_apply_plain(pk, cf, sm, q)
        ref = P.x_apply_plain(pk, cf.double(), sm, q.double())
        scale = torch.sqrt(z2v[:, None] * (q.double() ** 2).sum(0)[None, :]
                           ).clamp(min=1e-30).reshape(nb, vb, L)
        e, er, epr = errs(got, plain, ref, scale)
        assert e <= TOL_VS_PLAIN and er <= TOL_PCA_F64, ("K9", L, e, er)
        assert torch.equal(got, P.x_apply(pk, cf, sm, q)), "K9 is not deterministic"
        line = ""
        extra = {}
        if L == 20:
            # K9's runs (2,048 samples in f32, added in f64) with TF32 inputs
            def ctl_x():
                out = torch.zeros_like(ref)
                for k in range(nb):
                    z = P._normed_block(pk[k], cf[k], sm)
                    for r0 in range(0, npad, P.RUN):
                        out[k] += (z[:, r0 : r0 + P.RUN] @ q[r0 : r0 + P.RUN]).double()
                return out
            ectl = norm_err(torch, tf32_runs(ctl_x), ref, scale)
            assert ectl > TOL_PCA_F64, ("the TF32 control passes K9's limit", ectl)
            extra = dict(tf32_control_norm_err=ectl)
            line = f"; the TF32 control {ectl:.2e} fails it"
        ms = time_ms(torch, lambda: P.x_apply(pk, cf, sm, q), 3) / nb
        pms = time_ms(torch, lambda: P.x_apply_plain(pk[:1], cf[:1], sm, q), 1)
        lib = time_ms(torch, lambda: torch.matmul(z0, q), 5)
        flops = 2 * vb * n * L
        nbytes_io = vb * nbytes + vb * 12 + npad * 4 + npad * L * 4 + vb * L * 4
        row = dict(name="pca_x", source="plink_torch/csrc/pca_apply.cu",
                   replaces="plink_tpu/ops/pca.py:64",
                   also_replaces="plink_tpu/ops/pca.py:37", L=L,
                   max_abs_err=float((got - plain).abs().max()),
                   max_norm_err=e, tol=TOL_VS_PLAIN, max_norm_err_f64=er,
                   tol_f64=TOL_PCA_F64, ms=ms, plain_ms=pms,
                   **_bound(flops, nbytes_io), library_ms=lib, **extra)
        if rows:  # the projection's width rides in the L = 20 row
            rows[0][f"at_L{L}"] = row
        else:
            rows.append(row)
        log(f"K9 pca_x [{vb}x{npad}, L={L}, {nb} blocks]: norm err vs plain "
            f"{e:.2e} (tol {TOL_VS_PLAIN:g}), vs f64 {er:.2e} (tol {TOL_PCA_F64:g};"
            f" plain vs f64 {epr:.2e}){line}, two runs identical; {ms:.3f} ms a "
            f"launch, plain {pms:.1f} ms, f32 matmul {lib:.3f} ms, bound "
            f"{row['bound_ms']:.3f} ms")
        del got, plain, ref, scale, q

    L = 20
    b = torch.randn((nb, vb, L), generator=gen, device=dev)
    got = P.xt_apply(pk, cf, sm, b)
    plain = P.xt_apply_plain(pk, cf, sm, b)
    ref = P.xt_apply_plain(pk, cf.double(), sm, b.double())
    scale = torch.sqrt(z2s[:, None] * (b.double().reshape(-1, L) ** 2).sum(0)[None, :]
                       ).clamp(min=1e-30)
    e, er, epr = errs(got, plain, ref, scale)
    assert e <= TOL_VS_PLAIN and er <= TOL_PCA_F64, ("K10", e, er)
    assert torch.equal(got, P.xt_apply(pk, cf, sm, b)), "K10 is not deterministic"

    def ctl_xt():  # K10's runs (one block's variants) with TF32 inputs
        out = torch.zeros_like(ref)
        for k in range(nb):
            out += (P._normed_block(pk[k], cf[k], sm).t() @ b[k]).double()
        return out
    ectl = norm_err(torch, tf32_runs(ctl_xt), ref, scale)
    assert ectl > TOL_PCA_F64, ("the TF32 control passes K10's limit", ectl)
    ms = time_ms(torch, lambda: P.xt_apply(pk, cf, sm, b), 3) / nb
    pms = time_ms(torch, lambda: P.xt_apply_plain(pk[:1], cf[:1], sm, b[:1]), 1)
    lib = time_ms(torch, lambda: torch.matmul(z0.t(), b[0]), 5)
    flops = 2 * vb * n * L
    nbytes_io = vb * nbytes + vb * 12 + npad * 4 + vb * L * 4 + 2 * npad * L * 8
    rows.append(dict(name="pca_xt", source="plink_torch/csrc/pca_apply.cu",
                     replaces="plink_tpu/ops/pca.py:82",
                     also_replaces="plink_tpu/ops/pca.py:37", L=L,
                     max_abs_err=float((got - plain).abs().max()), max_norm_err=e,
                     tol=TOL_VS_PLAIN, max_norm_err_f64=er, tol_f64=TOL_PCA_F64,
                     tf32_control_norm_err=ectl, ms=ms, plain_ms=pms,
                     **_bound(flops, nbytes_io), library_ms=lib))
    log(f"K10 pca_xt [{vb}x{npad}, L={L}, {nb} blocks]: norm err vs plain "
        f"{e:.2e} (tol {TOL_VS_PLAIN:g}), vs f64 {er:.2e} (tol {TOL_PCA_F64:g}; "
        f"plain vs f64 {epr:.2e}); the TF32 control {ectl:.2e} fails it, two "
        f"runs identical; {ms:.3f} ms a launch, plain {pms:.1f} ms, f32 matmul "
        f"{lib:.3f} ms, bound {rows[-1]['bound_ms']:.3f} ms")
    del ops, z2v, z2s, z0, got, plain, ref, scale, b
    return rows


def check_ld_kernel(torch, dev, prefix):
    """Phase 9b: K11 on the whole indep_10k subcontig (32,768 variants, all
    10,000 samples founders, width 200) against its plain version: bits and
    counts equal at r^2 0.2 (the path's threshold; iid genotypes, so few or
    no pairs pass) and at 0.001 (thousands pass, the f64 products past 2^53
    decide); two runs identical; timed at 0.2."""
    from plink_torch.ops import ld as LD

    rows, sm, n = indep_rows(torch, dev, prefix)
    V, npad = rows.shape[0], sm.shape[0]
    width = int(IND_ARGS[1])
    set_bits = {}
    for r2t in (float(IND_ARGS[3]), 0.001):
        got = LD.ld_band_bits(rows, sm, width, r2t)
        ref = LD.ld_band_bits_plain(rows, sm, width, r2t)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), ("K11", r2t)
        again = LD.ld_band_bits(rows, sm, width, r2t)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), "K11 not deterministic"
        set_bits[r2t] = int(got[0].sum())
    assert set_bits[0.001] > 1000, set_bits
    r2t = float(IND_ARGS[3])
    ms = time_ms(torch, lambda: LD.ld_band_bits(rows, sm, width, r2t), 5)
    pms = time_ms(torch, lambda: LD.ld_band_bits_plain(rows, sm, width, r2t), 1)
    lib = band_library_ms(torch, rows, sm)
    pairs = sum(min(width, V - 1 - i) for i in range(V))
    ops = 6 * 2 * pairs * n  # x x, x V, |x| V, V x, V |x|, V V on int8 cores
    nbytes_io = rows.numel() + npad + V * (width + 1) + 3 * 4 * V
    bound = _bound(ops, nbytes_io, INT8_OPS_PER_S)
    log(f"K11 ld_band_bits [{V} variants x {n} samples, w={width}]: bits and "
        f"counts = plain at r^2 0.2 ({set_bits[0.2]} pairs pass) and 0.001 "
        f"({set_bits[0.001]} pass), two runs identical; {ms:.3f} ms, plain "
        f"{pms:.1f} ms, bf16 bmm {lib:.3f} ms, bound {bound['bound_ms']:.3f} ms")
    return [dict(name="ld_band_bits", source="plink_torch/csrc/ld_band.cu",
                 replaces="plink_tpu/ops/ld.py:127", max_abs_err=0.0, tol=0.0,
                 pairs_set=set_bits, ms=ms, plain_ms=pms, **bound, library_ms=lib)]


def band_library_ms(torch, rows, sm, c=512):
    """The library call of the band kernels K11 / K12: plink_tpu's form, the
    bf16 RAV planes of each c-variant chunk against those of the chunk and
    the next, one batched matmul to f32."""
    from plink_torch.ops import ld as LD

    V, npad = rows.shape[0], sm.shape[0]
    nc = -(-V // c)
    pl = torch.zeros((nc + 1, 3 * c, npad), dtype=torch.bfloat16, device=rows.device)
    for k in range(nc):
        blk = LD._planes_rav(rows[k * c : (k + 1) * c], sm).to(torch.bfloat16)
        pl[k, : blk.shape[0]] = blk
    a = pl[:nc]
    bb = torch.cat([pl[:nc], pl[1:]], dim=1)
    return time_ms(torch, lambda: torch.bmm(a, bb.transpose(1, 2),
                                            out_dtype=torch.float32), 3)


def indep_rows(torch, dev, prefix):
    """indep_10k's one subcontig as the LD commands lay it out on the card:
    the packed rows of every variant with every sample (all founders), and
    the int8 sample mask."""
    import numpy as np

    from plink_torch.commands.ld import _subcontig_rows
    from plink_torch.dataset import load_dataset

    ds = load_dataset(prefix, dev)
    n, V = ds.raw_sample_ct, ds.raw_variant_ct
    npad = -(-n // 4) * 4
    smask = np.zeros(npad, np.int8)
    smask[:n] = 1
    rows = _subcontig_rows(ds, np.arange(V), np.arange(n), npad)
    return rows, torch.from_numpy(smask).to(dev), n


def check_ld_report_kernels(torch, dev, prefix):
    """K12 over the whole indep_10k subcontig at the unphased table's width
    (200: all six bands, d = 0 included, and the three count vectors) and
    K13 over every chunk pair of the matrix cell (the first REGION_VARIANTS
    variants in 512-variant chunks, as commands/vcor.py walks them), each
    exactly equal to its plain version, two runs identical; timed beside
    their bounds and one library call."""
    from plink_torch.commands.vcor import MATRIX_CHUNK
    from plink_torch.ops import ld as LD

    rows, sm, n = indep_rows(torch, dev, prefix)
    V, nbytes = rows.shape
    npad = sm.shape[0]
    width = 200
    got = LD.ld_band_stats(rows, sm, width)
    ref = LD.ld_band_stats_plain(rows, sm, width)
    assert all(torch.equal(a, b) for a, b in zip(got, ref)), "K12"
    again = LD.ld_band_stats(rows, sm, width)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "K12 not deterministic"
    nm_max = int(got[0][1].max())
    del ref, again
    ms = time_ms(torch, lambda: LD.ld_band_stats(rows, sm, width), 5)
    pms = time_ms(torch, lambda: LD.ld_band_stats_plain(rows, sm, width), 1)
    lib = band_library_ms(torch, rows, sm)
    cells = sum(min(width, V - 1 - i) + 1 for i in range(V))  # d = 0 included
    bound = _bound(6 * 2 * cells * n, rows.numel() + npad + 6 * 4 * V * (width + 1)
                   + 3 * 4 * V, INT8_OPS_PER_S)
    log(f"K12 ld_band_stats [{V} variants x {n} samples, w={width}]: the six "
        f"bands and three counts = plain ({cells} cells, nm <= {nm_max}), two "
        f"runs identical; {ms:.3f} ms, plain {pms:.1f} ms, bf16 bmm {lib:.3f} ms, "
        f"bound {bound['bound_ms']:.3f} ms")
    out = [dict(name="ld_band_stats", source="plink_torch/csrc/ld_band.cu",
                replaces="plink_tpu/ops/ld.py:73", max_abs_err=0.0, tol=0.0,
                ms=ms, plain_ms=pms, **bound, library_ms=lib)]
    del got

    c = MATRIX_CHUNK
    reg = rows[:REGION_VARIANTS]
    pairs = 0
    for a0 in range(0, REGION_VARIANTS, c):
        for b0 in range(0, a0 + c, c):
            g = LD.ld_gram_pair(reg[a0 : a0 + c], reg[b0 : b0 + c], sm)
            assert torch.equal(g, LD.ld_gram_pair_plain(reg[a0 : a0 + c],
                                                        reg[b0 : b0 + c], sm)), \
                ("K13", a0, b0)
            pairs += 1
    assert torch.equal(g, LD.ld_gram_pair(reg[a0 : a0 + c], reg[b0 : b0 + c], sm)), \
        "K13 not deterministic"
    pa, pb = reg[:c], reg[c : 2 * c]
    ms = time_ms(torch, lambda: LD.ld_gram_pair(pa, pb, sm), 20)
    pms = time_ms(torch, lambda: LD.ld_gram_pair_plain(pa, pb, sm), 3)
    qa = LD._planes_rav(pa, sm).to(torch.bfloat16)[None]
    qb = LD._planes_rav(pb, sm).to(torch.bfloat16).t()[None]
    lib = time_ms(torch, lambda: torch.bmm(qa, qb, out_dtype=torch.float32), 20)
    bound = _bound(9 * 2 * c * c * n, 2 * c * nbytes + npad + 9 * c * c * 4,
                   INT8_OPS_PER_S)
    log(f"K13 ld_gram_pair [{c}x{c} chunks x {n} samples]: = plain over all "
        f"{pairs} chunk pairs of the {REGION_VARIANTS}-variant region, two runs "
        f"identical; {ms:.3f} ms a launch, plain {pms:.2f} ms, bf16 matmul "
        f"{lib:.3f} ms, bound {bound['bound_ms']:.4f} ms")
    out.append(dict(name="ld_gram_pair", source="plink_torch/csrc/ld_band.cu",
                    replaces="plink_tpu/ops/ld.py:44", max_abs_err=0.0, tol=0.0,
                    chunk_pairs_checked=pairs, ms=ms, plain_ms=pms, **bound,
                    library_ms=lib))
    return out


def _bound(ops, nbytes, ops_per_s=FP32_FLOP_PER_S):
    t_ops = 1e3 * ops / ops_per_s
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def read_report(path, limit=None):
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        hdr = f.readline().rstrip("\n").split("\t")
        rows = [ln.rstrip("\n").split("\t") for ln, _ in zip(f, range(
            limit if limit is not None else 1 << 62))]
    return hdr, rows


def write_golden():
    """gzip copies (mtime 0) of the plink2 outputs chip_smoke reads, from
    bench_golden/'s zstandard files."""
    import zstandard

    for src, dst in ((GOLDEN_SRC, GOLDEN),
                     (os.path.join(HERE, "bench_golden", "o_pca.eigenvec.sub5.zst"),
                      PCA_GOLDEN),
                     (os.path.join(HERE, "bench_golden", "o_indep.prune.in.zst"),
                      IND_GOLDEN)):
        with open(src, "rb") as f:
            text = zstandard.ZstdDecompressor().stream_reader(f).read()
        with open(dst, "wb") as raw, \
                gzip.GzipFile(fileobj=raw, mode="wb", mtime=0) as g:
            g.write(text)


def float_allowed(col, y):
    """bench.py's GLM parity rule for P; OR, BETA and SE relative; Z and T
    relative to max(|Z|, 1), as a Z near 0 comes from a beta near 0 whose
    f32 noise is large relative to itself."""
    if col == "P":
        return GLM_FLOAT_RTOL * max(1e-8, abs(y)) + 1e-9
    return GLM_FLOAT_RTOL * (max(abs(y), 1.0) if col in ("Z_STAT", "T_STAT")
                             else abs(y))


def compare_reports(a, b):
    """Every column of report `a` against the same rows of `b`: exact, except
    OR / SE / Z / P within float_allowed.  Returns the largest float
    difference as a fraction of what is allowed (<= 1)."""
    ha, ra = read_report(a)
    hb, rb = read_report(b, limit=len(ra))
    assert ha == hb and len(ra) == len(rb), (a, b, ha, hb, len(ra), len(rb))
    floats = {"OR", "LOG(OR)_SE", "Z_STAT", "BETA", "SE", "T_STAT", "P"}
    worst, bad = 0.0, []
    for x, y in zip(ra, rb):
        for col, u, v in zip(ha, x, y):
            if col in floats and u != "NA" and v != "NA":
                frac = abs(float(u) - float(v)) / float_allowed(col, float(v))
                worst = max(worst, frac)
                ok = frac <= 1.0
            else:
                ok = u == v
            if not ok:
                bad.append((col, x, y))
    assert not bad, f"{len(bad)} cells differ; first: {bad[:3]}"
    return worst


def logistic_argv(prefix, out):
    return ["--pfile", prefix, "--glm", "hide-covar", "--covar",
            prefix + ".cov", "--out", out, "--silent"]


def drive(torch, argv, out):
    """One run of the CLI with PLINK_TORCH_TIMING=1, the launch counts set
    to 0 just before it and read just after; prints the log's [phase] and
    [timing] lines.  Returns (wall seconds, launches)."""
    from plink_torch import cli
    from plink_torch.ops import _cuda

    os.environ["PLINK_TORCH_TIMING"] = "1"
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        os.environ.pop("PLINK_TORCH_TIMING")
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    assert rc == 0, rc
    with open(out + ".log") as f:
        for ln in f:
            if ln.startswith(("[timing]", "[phase]")):
                log("  " + ln.rstrip())
    return wall, launches


def run_main_path(torch, prefix, out, card, n_variants):
    wall, launches = drive(torch, logistic_argv(prefix, out), out)
    hdr, rows = read_report(out + ".PHENO1.glm.logistic.hybrid")
    assert len(rows) == n_variants, len(rows)
    ie, ifi = hdr.index("ERRCODE"), hdr.index("FIRTH?")
    errs = {}
    for r in rows:
        assert r[ifi] in ("Y", "N"), r
        errs[r[ie]] = errs.get(r[ie], 0) + 1
    ip = hdr.index("P")
    finite = sum(1 for r in rows if r[ip] != "NA" and math.isfinite(float(r[ip])))
    assert finite > 0.9 * n_variants, finite
    assert all(launches[k] > 0 for k in LOGISTIC_KERNELS), launches
    log(f"main path: {N_SAMPLES} samples x {n_variants} variants, d=13: "
        f"{wall:.2f}s wall, {n_variants / wall:.0f} variants/s on {card}; "
        f"ERRCODE {errs}; launches {launches}")
    worst = compare_reports(out + ".PHENO1.glm.logistic.hybrid", GOLDEN)
    log(f"main path = plink2 ({os.path.basename(GOLDEN_SRC)}, first "
        f"{n_variants} rows): exact columns equal, floats within "
        f"{worst:.2f} of their tolerance")
    return launches


def trace_path(torch, argv, label):
    """A path once more under torch.profiler: the card's busy time (kernels
    and copies, one stream) against the wall, and the kernels that take
    it."""
    from torch.profiler import ProfilerActivity, profile

    from plink_torch import cli

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        assert cli.main(argv) == 0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, by_name = 0.0, {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = evt.time_range.elapsed_us()
            busy += us
            name = re.sub(r"^void |\(anonymous namespace\)::|[<(].*$", "",
                          evt.name)
            by_name[name] = by_name.get(name, 0.0) + us
    assert busy > 0, "the trace saw no device work"
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"trace {label}: wall {wall:.3f}s (under the profiler), device busy "
        f"{busy / 1e6:.3f}s, idle {100 * (1 - busy / 1e6 / wall):.1f}%; "
        + ", ".join(f"{k} {v / 1e3:.1f} ms" for k, v in top))


def removal_counts(log_path):
    """{tag: count} of the filter lines in a run's .log."""
    out = {}
    with open(log_path) as f:
        for ln in f:
            m = re.search(r"(\d+) (?:sample|variant)s? removed", ln)
            for tag in QC_REMOVALS:
                if m and tag in ln:
                    out[tag] = int(m.group(1))
    return out


def run_qc_linear(torch, prefix, out, card, n_variants):
    """Phase 5: the QC + linear path on the card, its integer reports
    against a CPU run of the same flags, and 64 report rows against numpy."""
    from plink_torch import cli

    wall, launches = drive(torch, qc_argv(prefix, out), out)
    assert all(launches[k] > 0 for k in QC_KERNELS), launches
    removed = removal_counts(out + ".log")
    assert len(removed) == len(QC_REMOVALS) and all(removed.values()), removed
    hdr, rows = read_report(out + ".QT1.glm.linear")
    kept = n_variants - sum(v for k, v in removed.items() if k != "(--mind)")
    assert len(rows) == kept, (len(rows), kept)
    ip = hdr.index("P")
    finite = sum(1 for r in rows if r[ip] != "NA" and math.isfinite(float(r[ip])))
    assert finite > 0.9 * kept, finite
    log(f"QC + linear path: {N_SAMPLES} samples x {n_variants} variants, d=13: "
        f"{wall:.2f}s wall on {card}; removed {removed}; {len(rows)} report "
        f"rows; launches {launches}")
    cpu_out = out + "_cpu"
    os.environ["PLINK_TORCH_DEVICE"] = "cpu"
    t0 = time.perf_counter()
    try:
        assert cli.main(qc_argv(prefix, cpu_out, glm=False)) == 0
    finally:
        os.environ.pop("PLINK_TORCH_DEVICE")
    for ext in QC_REPORTS:
        assert filecmp.cmp(out + ext, cpu_out + ext, shallow=False), ext
    log(f"QC reports {' '.join(QC_REPORTS)} = the CPU run's, byte for byte "
        f"(CPU run {time.perf_counter() - t0:.1f}s)")
    check_ols(prefix, out)
    return launches


def check_ols(prefix, out):
    """N_OLS_ROWS rows of <out>.QT1.glm.linear, spread over both variant
    blocks, against a numpy f64 least-squares fit of QT1 on [1 | SEX |
    PC1..PC10 | A1 dosage] over the variant's valid calls among the samples
    --mind kept (those of <out>.smiss); genotypes read straight from the
    fixed-width .pgen.  OBS_CT and A1_FREQ exact; BETA, SE, T, P by
    float_allowed."""
    import numpy as np
    from scipy.special import stdtr

    from plink_torch.utils.fmt import g6

    hdr, rows = read_report(out + ".QT1.glm.linear")
    col = {c: hdr.index(c) for c in ("ID", "ALT", "A1", "A1_FREQ", "OBS_CT",
                                     "BETA", "SE", "T_STAT", "P", "ERRCODE")}
    with open(prefix + ".psam") as f:
        f.readline()
        pos = {ln.split("\t", 1)[0]: k for k, ln in enumerate(f)}
    with open(out + ".smiss") as f:
        f.readline()
        idx = np.array([pos[ln.split("\t", 1)[0]] for ln in f])
    cov = np.loadtxt(prefix + ".cov", skiprows=1, usecols=range(1, 12))[idx]
    qt = np.loadtxt(prefix + ".qt", skiprows=1, usecols=1)[idx]
    with open(prefix + ".pgen", "rb") as f:
        head = f.read(12)
    assert head[:3] == b"\x6c\x1b\x02", head  # fixed-width 2-bit records
    M, N = (int(x) for x in np.frombuffer(head[3:11], "<u4"))
    pg = np.memmap(prefix + ".pgen", np.uint8, "r", offset=12,
                   shape=(M, (N + 3) // 4))
    shifts = np.arange(0, 8, 2, dtype=np.uint8)
    worst, blocks = 0.0, set()
    for r in np.linspace(0, len(rows) - 1, N_OLS_ROWS).round().astype(int):
        row = rows[r]
        v = int(row[col["ID"]][3:])  # snp<v>
        blocks.add(v // 2048)
        g = ((pg[v][:, None] >> shifts) & 3).reshape(-1)[:N][idx]
        ok = g != 3
        dos = g[ok].astype(np.float64)
        if row[col["A1"]] != row[col["ALT"]]:
            dos = 2.0 - dos
        X = np.column_stack([np.ones(dos.size), cov[ok], dos])
        xtx_inv = np.linalg.inv(X.T @ X)
        beta = xtx_inv @ (X.T @ qt[ok])
        resid = qt[ok] - X @ beta
        df = dos.size - X.shape[1]
        se = math.sqrt(resid @ resid / df * xtx_inv[-1, -1])
        t = beta[-1] / se
        ref = {"BETA": beta[-1], "SE": se, "T_STAT": t,
               "P": 2.0 * stdtr(df, -abs(t))}
        assert row[col["ERRCODE"]] == ".", row
        assert row[col["OBS_CT"]] == str(dos.size), (row, dos.size)
        assert row[col["A1_FREQ"]] == g6(dos.sum() / (2 * dos.size)), row
        for c, y in ref.items():
            frac = abs(float(row[col[c]]) - y) / float_allowed(c, y)
            assert frac <= 1.0, (c, row, y)
            worst = max(worst, frac)
    assert blocks == {0, 1} or M <= 2048, blocks
    log(f"{N_OLS_ROWS} .glm.linear rows = numpy f64 OLS: OBS_CT and A1_FREQ "
        f"exact, BETA/SE/T/P within {worst:.3f} of their tolerance")


def king_argv(prefix, out):
    return ["--pfile", prefix, "--make-king-table", "--king-table-filter",
            KING_FILTER, "--out", out, "--silent"]


def grm_argv(prefix, out):
    return ["--pfile", prefix, "--make-grm-bin", "--out", out, "--silent"]


def run_king_path(torch, prefix, out, card):
    """Phase 7a: the KING path; its .kin0 must equal plink2's."""
    from plink_torch.ops.pairwise import iter_lower_tiles

    n = REL_PANEL[0]
    wall, launches = drive(torch, king_argv(prefix, out), out)
    with open(out + ".kin0") as f:
        assert f.read() == KING_GOLDEN, "the .kin0 differs from plink2's"
    pairs = n * (n - 1) // 2
    with open(out + ".log") as f:
        text = f.read()
    want = f"0 relationships reported ({pairs} filtered out)"
    assert want in text, want
    tiles = len(list(iter_lower_tiles(-(-n // REL_TILE) * REL_TILE, REL_TILE)))
    assert launches["king_gram"] == tiles, (launches, tiles)
    log(f"KING path {n}x{REL_PANEL[1]}: {wall:.2f}s wall on {card}; .kin0 = "
        f"plink2's (header only), {want}; launches {launches}")
    return launches


def check_grm_outputs(prefix, out):
    """The .grm.bin's size and plink2's 16 sampled windows (bench.py's rule,
    rtol 2e-4 / atol 2e-5); the .grm.N.bin's first window against counts
    from the genotypes (numpy, from the fixed-width .pgen)."""
    import numpy as np

    rec = np.load(GRM_GOLDEN)
    n_entries = int(rec["n_entries"])
    assert os.path.getsize(out + ".grm.bin") == 4 * n_entries
    assert os.path.getsize(out + ".grm.N.bin") == 4 * n_entries
    offs, vals = rec["offsets"], rec["values"]
    stride = vals.shape[1]
    worst = 0.0
    with open(out + ".grm.bin", "rb") as f:
        for off, ref in zip(offs, vals):
            f.seek(int(off) * 4)
            got = np.frombuffer(f.read(stride * 4), np.float32)
            assert np.allclose(got, ref, rtol=2e-4, atol=2e-5), int(off)
            worst = max(worst, float((np.abs(got.astype(np.float64) - ref)
                                      / (2e-5 + 2e-4 * np.abs(ref))).max()))
    assert int(offs[0]) == 0
    rows = int(np.ceil((np.sqrt(8 * stride + 1) - 1) / 2)) + 1
    with open(prefix + ".pgen", "rb") as f:
        head = f.read(12)
    assert head[:3] == b"\x6c\x1b\x02", head  # fixed-width 2-bit records
    M, N = (int(x) for x in np.frombuffer(head[3:11], "<u4"))
    pg = np.memmap(prefix + ".pgen", np.uint8, "r", offset=12,
                   shape=(M, (N + 3) // 4))
    shifts = np.arange(0, 8, 2, dtype=np.uint8)
    codes = ((np.asarray(pg[:, : -(-rows // 4)])[:, :, None] >> shifts) & 3)
    valid = (codes.reshape(M, -1)[:, :rows] != 3).astype(np.int64)
    nvalid = valid.T @ valid
    ii, jj = np.tril_indices(rows)
    want = nvalid[ii, jj][:stride].astype(np.float32)
    got = np.fromfile(out + ".grm.N.bin", np.float32, count=stride)
    assert np.array_equal(got, want), "the .grm.N.bin differs from numpy's counts"
    return len(offs), worst


def run_grm_path(torch, prefix, out, card):
    """Phase 7b: the streaming --make-grm-bin path against plink2's windows;
    its 10 GB of output is deleted once checked."""
    free = shutil.disk_usage(os.path.dirname(out)).free
    assert free > GRM_BYTES_NEEDED, f"{free / 1e9:.1f} GB free"
    wall, launches = drive(torch, grm_argv(prefix, out), out)
    # one K8 launch per chunk of the streaming grid (2,048-row strips, 8,192-
    # column chunks, the last anchor pulled back inside the padded rows)
    n, npad = REL_PANEL[0], -(-REL_PANEL[0] // REL_TILE) * REL_TILE
    chunks = sum(len({min(a, npad - REL_CHUNK)
                      for a in range(0, min(r0 + REL_TILE, n), REL_CHUNK)})
                 for r0 in range(0, n, REL_TILE))
    assert launches["grm_gram"] == chunks and launches["sample_counts"] > 0, \
        (launches, chunks)
    try:
        windows, worst = check_grm_outputs(prefix, out)
    finally:
        for ext in (".grm.bin", ".grm.N.bin"):
            os.remove(out + ext)
    log(f"GRM path {REL_PANEL[0]}x{REL_PANEL[1]}: {wall:.2f}s wall on {card}; "
        f".grm.bin = plink2's in {windows} windows (within {worst:.3f} of "
        f"bench.py's tolerance), .grm.N.bin window 0 = numpy's counts; "
        f"launches {launches}")
    return launches


def pca_argv(prefix, out, wts=False):
    mods = ["allele-wts"] if wts else []  # a modifier of --pca: before --seed
    return (["--pfile", prefix, *PCA_ARGS[:3], *mods, *PCA_ARGS[3:], "--out",
             out, "--silent"])


def ind_argv(prefix, out):
    return ["--pfile", prefix, *IND_ARGS, "--out", out, "--silent"]


def check_pca_golden(out):
    """bench.py's rule (`_parity_pca`): every 5th .eigenvec row against
    plink2's, |corr| > 0.98 per PC, and each eigenvalue within 1% of
    plink2's.  Returns (smallest |corr|, largest eigenvalue error)."""
    import numpy as np

    with open(out + ".eigenvec") as f:
        f.readline()
        a = np.array([[float(x) for x in ln.split()[1:]]
                      for i, ln in enumerate(f) if i % 5 == 0])
    with gzip.open(PCA_GOLDEN, "rt") as f:
        f.readline()
        b = np.array([[float(x) for x in ln.split()[1:]] for ln in f])
    assert a.shape == b.shape, (a.shape, b.shape)
    corr = [abs(np.corrcoef(a[:, j], b[:, j])[0, 1]) for j in range(a.shape[1])]
    va, vb = np.loadtxt(out + ".eigenval"), np.loadtxt(PCA_EIGENVAL)
    rel = np.abs(va - vb) / np.abs(vb)
    assert min(corr) > 0.98 and rel.max() <= 0.01, (corr, rel)
    return min(corr), float(rel.max())


def check_allele_wts(prefix, out):
    """The .eigenvec.allele of the allele-wts run: two rows a variant (REF
    +w, ALT -w), and N_WTS_ROWS variants' weights equal to numpy's f64
    0.5 (Z_v . u) / sqrt(lambda) within 1e-4, Z from the fixed-width .pgen
    (every sample a founder), u and lambda the run's own outputs."""
    import numpy as np

    with open(out + ".eigenvec.allele") as f:
        rows = [ln.rstrip("\n").split("\t") for ln in f][1:]
    V, n = PCA_PANEL[1], PCA_PANEL[0]
    assert len(rows) == 2 * V, len(rows)
    with open(prefix + ".pgen", "rb") as f:
        head = f.read(12)
    assert head[:3] == b"\x6c\x1b\x02", head  # fixed-width 2-bit records
    M, N = (int(x) for x in np.frombuffer(head[3:11], "<u4"))
    pg = np.memmap(prefix + ".pgen", np.uint8, "r", offset=12, shape=(M, (N + 3) // 4))
    lam = np.loadtxt(out + ".eigenval")
    u = np.loadtxt(out + ".eigenvec", skiprows=1, usecols=range(1, 11))
    shifts = np.arange(0, 8, 2, dtype=np.uint8)
    worst = 0.0
    for v in np.linspace(0, V - 1, N_WTS_ROWS).round().astype(int):
        g = ((pg[v][:, None] >> shifts) & 3).reshape(-1)[:n].astype(np.float64)
        ok = g != 3
        p = g[ok].sum() / (2 * ok.sum())
        z = np.where(ok, (g - 2 * p) / np.sqrt(2 * p * (1 - p)), 0.0)
        want = 0.5 * (z @ u) / np.sqrt(lam)
        r, a = rows[2 * v], rows[2 * v + 1]
        assert r[1] == a[1] == f"snp{v}", (r[:2], v)
        got = np.array(r[-10:], np.float64)
        assert np.array_equal(np.array(a[-10:], np.float64), -got), v
        worst = max(worst, float(np.abs(got - want).max()))
    assert worst <= 1e-4, worst
    return worst


def run_pca_path(torch, prefix, out, card):
    """Phase 10: `--pca 10 approx --seed 13` on the pca_100k panel against
    plink2's goldens, then with allele-wts; K1, K9 and K10 launched."""
    n_blocks = -(-PCA_PANEL[1] // 2048)
    wall, launches = drive(torch, pca_argv(prefix, out), out)
    corr, rel = check_pca_golden(out)
    pc_ct = int(PCA_ARGS[1])
    assert launches["geno_counts"] > 0, launches
    assert launches["pca_x"] == n_blocks * (pc_ct + 1), launches
    assert launches["pca_xt"] == n_blocks * pc_ct, launches
    log(f"PCA path {PCA_PANEL[0]}x{PCA_PANEL[1]} ({' '.join(PCA_ARGS)}): "
        f"{wall:.2f}s wall on {card}; = plink2's (every 5th .eigenvec row, "
        f"|corr| >= {corr:.6f} per PC; eigenvalues within {100 * rel:.3f}%); "
        f"launches {launches}")
    wts_out = out + "_wts"
    wall_w, launches_w = drive(torch, pca_argv(prefix, wts_out, wts=True), wts_out)
    corr_w, _ = check_pca_golden(wts_out)
    worst = check_allele_wts(prefix, wts_out)
    assert launches_w["pca_x"] == n_blocks * (pc_ct + 2), launches_w
    log(f"PCA allele-wts path: {wall_w:.2f}s wall on {card}; .eigenvec "
        f"|corr| >= {corr_w:.6f}; {2 * PCA_PANEL[1]} .eigenvec.allele rows, "
        f"{N_WTS_ROWS} variants = numpy f64 within {worst:.2e}; launches "
        f"{launches_w}")
    return launches, launches_w


def run_indep_path(torch, prefix, out, card):
    """Phase 11: `--indep-pairwise 200 50 0.2` on the indep_10k panel; the
    .prune.in set-equal to plink2's; K1 and K11 launched."""
    wall, launches = drive(torch, ind_argv(prefix, out), out)
    with open(out + ".prune.in") as f:
        got = set(f.read().split())
    with gzip.open(IND_GOLDEN, "rt") as f:
        want = set(f.read().split())
    assert got == want, f"{len(got ^ want)} IDs differ from plink2's .prune.in"
    assert launches["ld_band_bits"] == 1 and launches["geno_counts"] > 0, launches
    log(f"indep path {IND_PANEL[0]}x{IND_PANEL[1]} ({' '.join(IND_ARGS)}): "
        f"{wall:.2f}s wall on {card}; .prune.in set-equal to plink2's "
        f"({len(got)} kept); launches {launches}")
    return launches


def pgen_codes(prefix, variants):
    """2-bit codes [len(variants), N] (0 hom-REF, 1 het, 2 hom-ALT, 3
    missing) of those variants of a fixed-width .pgen, read with numpy."""
    import numpy as np

    with open(prefix + ".pgen", "rb") as f:
        head = f.read(12)
    assert head[:3] == b"\x6c\x1b\x02", head  # fixed-width 2-bit records
    M, N = (int(x) for x in np.frombuffer(head[3:11], "<u4"))
    pg = np.memmap(prefix + ".pgen", np.uint8, "r", offset=12, shape=(M, (N + 3) // 4))
    packed = np.asarray(pg[np.asarray(variants)])
    shifts = np.arange(0, 8, 2, dtype=np.uint8)
    return ((packed[:, :, None] >> shifts) & 3).reshape(len(packed), -1)[:, :N]


def minor_counts(a, b):
    """PhasedLD's inputs for two variants' codes over the samples where both
    are called, in minor-allele space (each variant's major allele from its
    ALT frequency over its own calls, every sample a founder):
    (nmin1, nmin2, known minor-minor, double hets, valid)."""
    import numpy as np

    def major_is_alt(g):
        ok = g != 3
        return g[ok].sum() / (2 * ok.sum()) > 0.5

    ok = (a != 3) & (b != 3)
    x, y = a[ok].astype(np.int64), b[ok].astype(np.int64)
    xm = 2 - x if major_is_alt(a) else x
    ym = 2 - y if major_is_alt(b) else y
    dh = (x == 1) & (y == 1)
    return (float(xm.sum()), float(ym.sum()), float((np.minimum(xm, ym) * ~dh).sum()),
            float(dh.sum()), float(ok.sum()))


def vcor_argv(prefix, out, args):
    return ["--pfile", prefix, *args, "--out", out, "--silent"]


@contextlib.contextmanager
def spying(name, *modules):
    """Wrap the kernel wrapper `name` where each of `modules` looks it up,
    keeping the arguments of every call: the inputs the kernel gets on the
    path (the wrapper still counts its launches).  Yields (calls,
    wrapper)."""
    real, calls = getattr(modules[0], name), []
    assert all(getattr(m, name) is real for m in modules), name

    def spy(*args):
        calls.append(args)
        return real(*args)

    for m in modules:
        setattr(m, name, spy)
    try:
        yield calls, real
    finally:
        for m in modules:
            setattr(m, name, real)


def check_calls(torch, calls, kernel, plain, label):
    """Every kept call of a kernel's wrapper launched again on its inputs,
    exactly equal to the plain version on them.  Returns a note of the
    shapes checked."""
    shapes = set()
    for args in calls:
        got, want = kernel(*args), plain(*args)
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
            (label, [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)])
        shapes.add("x".join(str(a.shape[0]) for a in args[:-1]
                            if isinstance(a, torch.Tensor) and a.dim() == 2))
    return f"{label} = plain on all {len(calls)} launches ({', '.join(sorted(shapes))} rows)"


def check_table_rows(prefix, rows, phased, window):
    """N_LD_ROWS rows of a .vcor table, spread over it, against numpy: the
    unphased r^2 as numpy's f64 Pearson r^2 of the two ALT-dosage vectors
    over the samples where both are called (relative 1e-5: the 6 digits
    printed); the phased r^2 as g6 of plink_torch.stats.phased_ld's
    `phased_r2` on joint counts numpy takes from the codes, equal as
    printed. Returns the largest relative error."""
    import numpy as np

    from plink_torch.stats.phased_ld import phased_r2
    from plink_torch.utils.fmt import g6

    pick = [rows[k] for k in np.linspace(0, len(rows) - 1, N_LD_ROWS).round().astype(int)]
    ids = sorted({int(r[c][3:]) for r in pick for c in (2, 5)})  # snp<v>
    codes = dict(zip(ids, pgen_codes(prefix, ids)))
    worst = 0.0
    for r in pick:
        a, b = codes[int(r[2][3:])], codes[int(r[5][3:])]
        assert 1 <= int(r[4]) - int(r[1]) <= window and float(r[6]) >= 0.001, r
        if phased:
            want = phased_r2(*minor_counts(a, b)) ** 2
            assert r[6] == g6(want), (r, want)
        else:
            ok = (a != 3) & (b != 3)
            want = np.corrcoef(a[ok].astype(np.float64), b[ok].astype(np.float64))[0, 1] ** 2
        err = abs(float(r[6]) - want) / want
        assert err <= 1e-5, (r, want)
        worst = max(worst, err)
    return worst


def run_vcor_table(torch, prefix, out, card, phased):
    """The --r2 table on indep_10k (unphased at width 200, phased at width
    10) and N_LD_ROWS of its rows against numpy; K12 launched once (one
    subcontig); the phased table also launches K13 on each 256-variant chunk
    with itself and with the next (LdJointBand)."""
    from plink_torch.commands import vcor as VC
    from plink_torch.ops import ld as LD

    args = VCOR_TABLE_ARGS[phased]
    window = round(float(args[2]) * 1000)
    with spying("ld_band_stats", LD) as (k12, real12), \
            spying("ld_gram_pair", LD, VC) as (k13, real13):
        wall, launches = drive(torch, vcor_argv(prefix, out, args), out)
    assert launches["ld_band_stats"] == len(k12) == 1, launches
    nc = -(-IND_PANEL[1] // 256)
    assert launches["ld_gram_pair"] == len(k13) == (2 * nc - 1 if phased else 0), \
        launches
    held = [check_calls(torch, k12, real12, LD.ld_band_stats_plain,
                        f"K12 (width {k12[0][2]})")]
    if phased:
        held.append(check_calls(torch, k13, real13, LD.ld_gram_pair_plain, "K13"))
    del k12, k13
    hdr, rows = read_report(out + ".vcor")
    assert hdr[-1] == ("PHASED_R2" if phased else "UNPHASED_R2") \
        and len(rows) >= N_LD_ROWS, (hdr, len(rows))
    worst = check_table_rows(prefix, rows, phased, window)
    log(f"{args[0]} table {IND_PANEL[0]}x{IND_PANEL[1]} ({' '.join(args[1:])}): "
        f"{wall:.2f}s wall on {card}; {len(rows)} rows; {N_LD_ROWS} rows = numpy "
        f"({'phased_r2 of numpy joint counts, as printed' if phased else 'f64 Pearson'}"
        f"; relative error <= {worst:.2e}); {'; '.join(held)}; launches {launches}")
    return launches


def run_vcor_matrix(torch, prefix, tmp, card):
    """`--r-unphased square bin4` of the fine-mapping region (variants
    1..REGION_VARIANTS by `--extract bed1`): K13 on every 512-variant chunk
    pair; the .vars lists the region's IDs; N_LD_ROWS rows of the f32 .bin
    within 1e-6 of numpy's f64 r (pairwise-complete Pearson of the codes,
    the counts as exact f32 matrix products) after the major-allele signs,
    NaN where numpy's is NaN, 1 on the diagonal."""
    import numpy as np

    from plink_torch.commands import vcor as VC
    from plink_torch.ops import ld as LD

    R, c = REGION_VARIANTS, 512
    region = os.path.join(tmp, "region.bed")
    with open(region, "w") as f:
        f.write(f"1\t1\t{R}\n")
    out = os.path.join(tmp, "vcor_matrix")
    with spying("ld_gram_pair", LD, VC) as (k13, real13):
        wall, launches = drive(torch, vcor_argv(prefix, out, VCOR_MATRIX_ARGS + [region]),
                               out)
    nch = R // c
    assert launches["ld_gram_pair"] == len(k13) == nch * (nch + 1) // 2, launches
    held = check_calls(torch, k13, real13, LD.ld_gram_pair_plain, "K13")
    del k13
    base = out + ".unphased.vcor1"
    with open(base + ".vars") as f:
        assert f.read().split() == [f"snp{i}" for i in range(R)], "the .vars differs"
    assert os.path.getsize(base + ".bin") == 4 * R * R
    codes = pgen_codes(prefix, np.arange(R))
    valid = codes != 3
    x = np.where(valid, codes, 0).astype(np.float32)
    v = valid.astype(np.float32)
    ri = np.linspace(0, R - 1, N_LD_ROWS).round().astype(int)
    # pairwise-complete sums; f32 products of small integers are exact here
    nm, sx, sy = v[ri] @ v.T, x[ri] @ v.T, v[ri] @ x.T
    sxx, syy, sxy = (x[ri] ** 2) @ v.T, v[ri] @ (x ** 2).T, x[ri] @ x.T
    nm, sx, sy, sxx, syy, sxy = (m.astype(np.float64) for m in (nm, sx, sy, sxx, syy, sxy))
    with np.errstate(divide="ignore", invalid="ignore"):
        r = (nm * sxy - sx * sy) / np.sqrt((nm * sxx - sx * sx) * (nm * syy - sy * sy))
    sgn = np.where(x.sum(1) / (2 * v.sum(1)) > 0.5, -1.0, 1.0)
    want = r * sgn[ri, None] * sgn[None, :]
    want[np.arange(N_LD_ROWS), ri] = 1.0
    got = np.memmap(base + ".bin", np.float32, "r", shape=(R, R))[ri].astype(np.float64)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), "NaN entries differ from numpy's"
    err = float(np.abs(got - want)[~nan].max())
    assert err <= 1e-6, err
    log(f"--r-unphased square bin4 matrix {R}x{R} ({IND_PANEL[0]} samples): "
        f"{wall:.2f}s wall on {card}; .vars = the region's {R} IDs; {N_LD_ROWS} "
        f"rows of the f32 .bin = numpy f64 r within {err:.2e} ({int(nan.sum())} "
        f"NaN entries alike); {held}; launches {launches}")
    return launches


def ld_block(log_path):
    """The --ld report block of a run's .log: from its '--ld' line to its
    last in/out-of-phase line."""
    with open(log_path) as f:
        lines = f.read().splitlines()
    i0 = next(k for k, ln in enumerate(lines) if ln.startswith("--ld "))
    i1 = max(k for k, ln in enumerate(lines) if "alleles are" in ln)
    return lines[i0 : i1 + 1]


def run_ld_pair(torch, prefix, out, card):
    """`--ld snp100 snp101` on indep_10k: the log block printed, its valid
    sample count and best solution's r^2 equal to numpy's counts through
    phased_ld_detail."""
    from plink_torch.stats.phased_ld import phased_ld_detail
    from plink_torch.utils.fmt import g6

    wall, launches = drive(torch, ["--pfile", prefix, "--ld", *LD_PAIR, "--out", out,
                                   "--silent"], out)
    block = ld_block(out + ".log")
    a, b = pgen_codes(prefix, [int(v[3:]) for v in LD_PAIR])
    counts = minor_counts(a, b)
    sols, best, _ = phased_ld_detail(*counts)
    text = "\n".join(block)
    assert f"{int(counts[-1])} valid samples;" in text, text
    assert f"r^2 = {g6(sols[best]['r2'])}" in text, text
    log(f"--ld {' '.join(LD_PAIR)} on {IND_PANEL[0]}x{IND_PANEL[1]}: {wall:.2f}s "
        f"wall on {card}; valid samples and r^2 = numpy's; launches {launches}")
    for ln in block:
        log("  | " + ln)
    return launches


def expected_clumps(prefix, report):
    """The .clumps of CLUMP_ARGS recomputed on the host from the report's
    ADD rows and numpy's codes of the panel (every sample a founder): index
    candidates (p <= CLUMP_P1) in ascending p, each taking the variants within
    CLUMP_RADIUS bp that no clump holds yet and whose phased_r2 of numpy's
    joint counts has r^2 >= CLUMP_R2.  Returns (the file's text, or None
    without a clump; the pairs scored; their largest r^2)."""
    import numpy as np

    from plink_torch.stats.phased_ld import phased_r2
    from plink_torch.utils.fmt import g6

    eps = 1 + 2.0 ** -44  # plink2's kSmallEpsilon on every threshold
    hdr, rows = read_report(report)
    ic, ipos, iid, ip = (hdr.index(k) for k in ("#CHROM", "POS", "ID", "P"))
    it = hdr.index("TEST") if "TEST" in hdr else None
    var = {int(r[iid][3:]): (r[ic], int(r[ipos]), r[iid], float(r[ip])) for r in rows
           if r[ip] != "NA" and (it is None or r[it] == "ADD")}
    codes = {}

    def codes_of(v):
        if v not in codes:
            codes[v] = pgen_codes(prefix, [v])[0]
        return codes[v]

    assigned, clumps, pairs, r2max = set(), [], 0, 0.0
    for p, i in sorted((p, v) for v, (_, _, _, p) in var.items() if p <= CLUMP_P1 * eps):
        if i in assigned:
            continue
        assigned.add(i)
        members = []
        for j in sorted(var):
            if j in assigned or var[j][0] != var[i][0] \
                    or abs(var[j][1] - var[i][1]) > CLUMP_RADIUS:
                continue
            counts = minor_counts(codes_of(i), codes_of(j))
            if counts[-1] < 2:
                continue
            r = phased_r2(*counts)
            pairs += 1
            if np.isfinite(r):
                r2max = max(r2max, r * r)
                if r * r >= CLUMP_R2 * eps:
                    members.append(j)
        assigned.update(members)
        clumps.append((p, i, members))
    if not clumps:
        return None, pairs, r2max
    text = ["\t".join(["#CHROM", "POS", "ID", "P", "TOTAL", "NONSIG"]
                      + [f"S{b:g}" for b in reversed(CLUMP_BINS)] + ["SP2"])]
    for p, i, members in clumps:
        bins = [0] * (len(CLUMP_BINS) + 1)
        for j in members:
            bins[sum(var[j][3] < b for b in CLUMP_BINS)] += 1
        sp2 = ",".join(var[j][2] for j in members if var[j][3] <= CLUMP_P2 * eps)
        chrom, pos, vid, _ = var[i]
        text.append("\t".join([chrom, str(pos), vid, g6(p), str(len(members)),
                               *map(str, bins), sp2 or "."]))
    return "\n".join(text) + "\n", pairs, r2max


def run_clump(torch, prefix, report, out, card):
    """`--clump` of the logistic main path's report on its 500,000-sample
    panel: what it measures is loading, K1 and the host's pair decodes (no
    member on an iid panel).  The .clumps (or the "No significant --clump
    results" warning) equal to expected_clumps's."""
    wall, launches = drive(torch, ["--pfile", prefix, "--clump", report, *CLUMP_ARGS,
                                   "--out", out, "--silent"], out)
    assert launches["geno_counts"] >= 1, launches
    t0 = time.perf_counter()
    want, pairs, r2max = expected_clumps(prefix, report)
    host_s = time.perf_counter() - t0
    with open(out + ".log") as f:
        said = [ln.strip() for ln in f
                if "clumps formed" in ln or "No significant --clump" in ln]
    assert said, "the run logged no --clump result"
    if want is None:
        assert not os.path.exists(out + ".clumps") and "No significant" in said[0], said
        what = "no clump, as recomputed"
    else:
        with open(out + ".clumps") as f:
            assert f.read() == want, "the .clumps differs from the host's recomputation"
        what = ".clumps = the host's recomputation, byte for byte"
    log(f"--clump {' '.join(CLUMP_ARGS)} of the main path's report "
        f"({N_SAMPLES} samples): {wall:.2f}s wall on {card}; {said[0]}; {what} "
        f"({pairs} pairs scored, largest r^2 {r2max:.3g}; recomputed in "
        f"{host_s:.1f}s); launches {launches}")
    return launches


def write_phased_copy(src, dst, n_variants):
    """The first n_variants of the fixed-width fileset src as dst, written by
    the port's PgenWriter with every het call phased ("1|0", swapped, with
    probability 1/2 from numpy seed PHASE_SEED). Returns the haplotype codes
    [n_variants, 2 N] (sample s's in columns 2s and 2s + 1: 0 REF, 2 ALT, 3
    missing) that --indep-pairphase must hand K11."""
    import numpy as np

    from plink_torch.io.pgen_write import PgenWriter

    codes = pgen_codes(src, np.arange(n_variants))
    N = codes.shape[1]
    rng = np.random.default_rng(PHASE_SEED)
    everyone = np.ones(N, bool)
    haps = np.empty((n_variants, 2 * N), np.uint8)
    with PgenWriter(dst + ".pgen", N, n_variants, with_phase=True) as w:
        for v in range(n_variants):
            c = codes[v]
            swapped = rng.random(N) < 0.5
            w.append_codes_with_phase(c, everyone, swapped)
            het = c == 1
            h1 = np.where((c == 2) | (het & swapped), 2, 0).astype(np.uint8)
            h2 = np.where((c == 2) | (het & ~swapped), 2, 0).astype(np.uint8)
            h1[c == 3] = h2[c == 3] = 3
            haps[v, 0::2], haps[v, 1::2] = h1, h2
    shutil.copy(src + ".psam", dst + ".psam")
    with open(src + ".pvar") as f, open(dst + ".pvar", "w") as g:
        kept = 0
        for ln in f:
            if not ln.startswith("#"):
                if kept == n_variants:
                    break
                kept += 1
            g.write(ln)
    return haps


def run_pairphase(torch, prefix, tmp, card):
    """`--indep-pairphase 200 50 0.2` on a phased copy of the whole
    indep_10k: K11 launched once, on the 2 x 10,000 haplotype columns,
    which must be numpy's haplotypes of the copy; its decisions equal to
    its plain version's on them; .prune.in and .prune.out partition the
    IDs."""
    import numpy as np

    from plink_torch.ops import ld as LD

    V = IND_PANEL[1]
    ph = os.path.join(tmp, "phased")
    t0 = time.perf_counter()
    haps = write_phased_copy(prefix, ph, V)
    t_copy = time.perf_counter() - t0
    out = os.path.join(tmp, "pairphase")
    with spying("ld_band_bits", LD) as (k11, real11):
        wall, launches = drive(torch, ["--pfile", ph, *PAIRPHASE_ARGS, "--out", out,
                                       "--silent"], out)
    assert launches["ld_band_bits"] == len(k11) == 1, launches
    packed, smask = k11[0][:2]
    nh = int(smask.sum())
    assert nh == 2 * IND_PANEL[0] and packed.shape[0] == V, (nh, packed.shape)
    got = unpack_codes(packed)[:, :nh].cpu().numpy()
    assert np.array_equal(got, haps), "K11's haplotype columns differ from the copy's"
    del got, haps
    held = check_calls(torch, k11, real11, LD.ld_band_bits_plain, "K11")
    del k11, packed, smask
    ids = {}
    for ext in (".prune.in", ".prune.out"):
        with open(out + ext) as f:
            ids[ext] = f.read().split()
    assert sorted(ids[".prune.in"] + ids[".prune.out"], key=lambda s: int(s[3:])) \
        == [f"snp{i}" for i in range(V)]
    log(f"--indep-pairphase {' '.join(PAIRPHASE_ARGS[1:])} on a phased copy "
        f"({V} variants x {IND_PANEL[0]} samples, written in {t_copy:.1f}s): "
        f"{wall:.2f}s wall on {card}; K11 on {nh} haplotype columns = numpy's "
        f"haplotypes; {held}; {len(ids['.prune.out'])} removed; launches {launches}")
    return launches


def run_ld_parity(tmp, prefix, n, m):
    """The LD reports' parity cases on the parity panel (LD_PARITY): the
    port on the card twice and on the CPU, every output byte for byte, and
    the --ld block of the log."""
    from plink_torch import cli

    panels = {"small": prefix, "phased": os.path.join(tmp, "small_phased")}
    write_phased_copy(prefix, panels["phased"], m)
    subs = {"region": os.path.join(tmp, "small_region.bed"),
            "report": os.path.join(tmp, "cuda1_hybrid.PHENO1.glm.logistic.hybrid")}
    with open(subs["region"], "w") as f:
        f.write("1\t1\t300\n")
    for label, panel, flags, exts in LD_PARITY:
        outs = {}
        for tag, devname in (("cuda1", "cuda"), ("cpu", "cpu"), ("cuda2", "cuda")):
            os.environ["PLINK_TORCH_DEVICE"] = devname
            outs[tag] = os.path.join(tmp, f"{tag}_ld_{label}")
            t0 = time.perf_counter()
            rc = cli.main(["--pfile", panels[panel], *(a.format(**subs) for a in flags),
                           "--out", outs[tag], "--silent"])
            assert rc == 0, (label, tag, rc)
            outs[tag + "_s"] = time.perf_counter() - t0
        for ext in exts:
            a, b, c2 = (outs[t] + ext for t in ("cuda1", "cpu", "cuda2"))
            assert filecmp.cmp(a, b, shallow=False), ("CUDA differs from CPU", label, ext)
            assert filecmp.cmp(a, c2, shallow=False), ("two CUDA runs differ", label, ext)
        extra = ""
        if "--ld" in flags:
            blocks = [ld_block(outs[t] + ".log") for t in ("cuda1", "cpu", "cuda2")]
            assert blocks[0] == blocks[1] == blocks[2], (label, "--ld block")
            extra = f", the --ld block alike ({len(blocks[0])} lines)"
        log(f"parity ld {label} [{n}x{m}, {panel}]: CUDA = CPU = CUDA byte for "
            f"byte ({' '.join(exts)}{extra}; CUDA {outs['cuda1_s']:.1f}s, CPU "
            f"{outs['cpu_s']:.1f}s)")


def run_parity(tmp):
    """Phase 8: the 2,000 x 1,200 panel through the port on the card and on
    the CPU (plain versions): hybrid, firth, the QC + linear path, and the
    relationship commands (plink_torch.testing's rules, the text floats
    within 1e-5 of max(|x|, 1): the GRM's f32 sums are taken in another
    order on the card, and entries near 0 print few exact digits)."""
    from plink_torch import cli
    from plink_torch.testing import relationship_output_close

    n, m, seed = SMALL
    prefix = os.path.join(tmp, "small")
    make_panel(prefix, n, m, seed)
    cases = (
        ("hybrid", lambda o: logistic_argv(prefix, o), ["PHENO1.glm.logistic.hybrid"], ()),
        ("firth", lambda o: logistic_argv(prefix, o)[:3] + ["firth"]
         + logistic_argv(prefix, o)[3:], ["PHENO1.glm.firth"], ()),
        ("qc_linear", lambda o: qc_argv(prefix, o), ["QT1.glm.linear"],
         QC_REPORTS),
    )
    os.environ["PLINK_TORCH_VB"] = "256"
    try:
        for label, argv_of, glm_exts, exact_exts in cases:
            outs = {}
            for tag, devname in (("cuda1", "cuda"), ("cpu", "cpu"),
                                 ("cuda2", "cuda")):
                os.environ["PLINK_TORCH_DEVICE"] = devname
                outs[tag] = os.path.join(tmp, f"{tag}_{label}")
                rc = cli.main(argv_of(outs[tag]))
                assert rc == 0, (label, tag, rc)
            for ext in exact_exts:
                assert filecmp.cmp(outs["cuda1"] + ext, outs["cpu"] + ext,
                                   shallow=False), (label, ext)
            for ext in glm_exts:
                a, b, c2 = (f"{outs[t]}.{ext}" for t in ("cuda1", "cpu", "cuda2"))
                worst = compare_reports(a, b)
                assert filecmp.cmp(a, c2, shallow=False), "two CUDA runs differ"
                hdr, rows = read_report(a)
                firth_y = 0
                if "FIRTH?" in hdr:
                    firth_y = sum(r[hdr.index("FIRTH?")] == "Y" for r in rows)
                    assert firth_y > 0, "no Firth fallback row on the parity panel"
                log(f"parity {label} {ext} [{n}x{m}]: CUDA = CPU (exact columns"
                    f"{' and ' + ' '.join(exact_exts) if exact_exts else ''}, "
                    f"floats within {worst:.2f} of their tolerance), two CUDA "
                    f"runs byte-identical, {len(rows)} rows, FIRTH?=Y rows {firth_y}")
        os.environ["PLINK_TORCH_TILE"] = "512"
        for label, flags, exts in REL_PARITY:
            outs = {}
            for tag, devname in (("cuda1", "cuda"), ("cpu", "cpu"),
                                 ("cuda2", "cuda")):
                os.environ["PLINK_TORCH_DEVICE"] = devname
                outs[tag] = os.path.join(tmp, f"{tag}_{label}")
                t0 = time.perf_counter()
                rc = cli.main(["--pfile", prefix, *flags, "--out", outs[tag],
                               "--silent"])
                assert rc == 0, (label, tag, rc)
                outs[tag + "_s"] = time.perf_counter() - t0
            for ext in exts:
                a, b, c2 = (outs[t] + ext for t in ("cuda1", "cpu", "cuda2"))
                assert relationship_output_close(ext, b, a, text_floor=1.0), \
                    (label, ext)
                assert filecmp.cmp(a, c2, shallow=False), ("two CUDA runs differ", ext)
            with open(outs["cuda1"] + ".log") as f:
                said = [ln.strip() for ln in f if "relationships reported" in ln]
            log(f"parity {label} [{n}x{m}, tile 512]: CUDA = CPU ({' '.join(exts)}"
                f" by the relationship rules), two CUDA runs byte-identical; "
                f"{' '.join(said)} (CUDA {outs['cuda1_s']:.1f}s, CPU "
                f"{outs['cpu_s']:.1f}s)")
        os.environ.pop("PLINK_TORCH_TILE")
        from plink_torch.bench_gen import gen_panel

        panels = {"small": prefix, "structured": os.path.join(tmp, "small_k5")}
        gen_panel(panels["structured"], n, m, seed=7, k=5)
        for label, panel, flags, exts in PCA_LD_PARITY:
            outs = {}
            for tag, devname in (("cuda1", "cuda"), ("cpu", "cpu"),
                                 ("cuda2", "cuda")):
                os.environ["PLINK_TORCH_DEVICE"] = devname
                outs[tag] = os.path.join(tmp, f"{tag}_{label}")
                t0 = time.perf_counter()
                rc = cli.main(["--pfile", panels[panel], *flags, "--out",
                               outs[tag], "--silent"])
                assert rc == 0, (label, tag, rc)
                outs[tag + "_s"] = time.perf_counter() - t0
            for ext in exts:
                a, b, c2 = (outs[t] + ext for t in ("cuda1", "cpu", "cuda2"))
                assert relationship_output_close(ext, b, a), (label, ext)
                assert filecmp.cmp(a, c2, shallow=False), ("two CUDA runs differ", ext)
            with open(outs["cuda1"] + ".log") as f:
                said = [ln.strip() for ln in f if "variants removed" in ln]
            log(f"parity {label} [{n}x{m}, {panel}]: CUDA = CPU ({' '.join(exts)}"
                f" by the CLI tests' rules), two CUDA runs byte-identical; "
                f"{' '.join(said)} (CUDA {outs['cuda1_s']:.1f}s, CPU "
                f"{outs['cpu_s']:.1f}s)")
        run_ld_parity(tmp, prefix, n, m)
    finally:
        os.environ.pop("PLINK_TORCH_VB", None)
        os.environ.pop("PLINK_TORCH_TILE", None)
        os.environ.pop("PLINK_TORCH_DEVICE", None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", type=int, default=N_VARIANTS,
                    help="variants of the main path's panel (<= 16,384)")
    ap.add_argument("--write-golden", action="store_true",
                    help=f"rewrite {os.path.basename(GOLDEN)} from "
                         "bench_golden (needs zstandard; no card) and exit")
    args = ap.parse_args(argv)
    if args.write_golden:
        write_golden()
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    if not os.path.isdir(os.path.join(HERE, "plink_torch")):
        print("chip_smoke: the plink_torch package is not beside this script",
              file=sys.stderr)
        return 1
    dev, card = card_report(torch)
    build()
    tmp = tempfile.mkdtemp(prefix="plink_torch_smoke_")
    log(f"temporary directory {tmp}: {shutil.disk_usage(tmp).free / 1e9:.1f} GB "
        f"free (the GRM phase needs {GRM_BYTES_NEEDED / 1e9:.1f} GB)")
    try:
        prefix = os.path.join(tmp, "panel")
        t0 = time.perf_counter()
        make_panel(prefix, N_SAMPLES, args.variants, 42)
        log(f"panel {N_SAMPLES}x{args.variants}: {time.perf_counter() - t0:.1f}s")
        stamp("kernels")
        rows = check_kernels(torch, dev, prefix)
        torch.cuda.empty_cache()
        stamp("logistic main path")
        paths = {"logistic": run_main_path(torch, prefix, os.path.join(tmp, "main"),
                                           card, args.variants)}
        trace_path(torch, logistic_argv(prefix, os.path.join(tmp, "traced")),
                   "logistic")
        stamp("QC + linear path")
        paths["qc_linear"] = run_qc_linear(torch, prefix, os.path.join(tmp, "qc"),
                                           card, args.variants)
        trace_path(torch, qc_argv(prefix, os.path.join(tmp, "qc_traced")),
                   "QC + linear")
        stamp("pair kernels")
        from plink_torch.bench_gen import gen_panel

        rel = os.path.join(tmp, "rel")
        t0 = time.perf_counter()
        gen_panel(rel, REL_PANEL[0], REL_PANEL[1], miss_rate=0.02, seed=REL_PANEL[2])
        log(f"panel {REL_PANEL[0]}x{REL_PANEL[1]}: {time.perf_counter() - t0:.1f}s")
        rows += check_pair_kernels(torch, dev, rel)
        torch.cuda.empty_cache()
        stamp("KING path")
        paths["king"] = run_king_path(torch, rel, os.path.join(tmp, "king"), card)
        trace_path(torch, king_argv(rel, os.path.join(tmp, "king_traced")), "KING")
        stamp("GRM path")
        paths["grm"] = run_grm_path(torch, rel, os.path.join(tmp, "grm"), card)
        piece = os.path.join(tmp, "grm_traced")
        trace_path(torch, grm_argv(rel, piece) + ["--parallel", "1", "4"],
                   "GRM piece 1/4")
        for ext in (".grm.bin.1", ".grm.N.bin.1"):
            os.remove(piece + ext)
        stamp("PCA / LD kernels")
        p4, p2 = os.path.join(tmp, "pca"), os.path.join(tmp, "ind")
        t0 = time.perf_counter()
        gen_panel(p4, PCA_PANEL[0], PCA_PANEL[1], miss_rate=0.0, seed=PCA_PANEL[2],
                  k=PCA_PANEL[3])
        gen_panel(p2, IND_PANEL[0], IND_PANEL[1], miss_rate=0.02, seed=IND_PANEL[2])
        log(f"panels {PCA_PANEL[0]}x{PCA_PANEL[1]} (k={PCA_PANEL[3]}) and "
            f"{IND_PANEL[0]}x{IND_PANEL[1]}: {time.perf_counter() - t0:.1f}s")
        rows += check_pca_kernels(torch, dev, p4)
        rows += check_ld_kernel(torch, dev, p2)
        torch.cuda.empty_cache()
        stamp("PCA path")
        paths["pca"], paths["pca_wts"] = run_pca_path(
            torch, p4, os.path.join(tmp, "pca_out"), card)
        trace_path(torch, pca_argv(p4, os.path.join(tmp, "pca_traced")), "PCA approx")
        stamp("indep path")
        paths["indep"] = run_indep_path(torch, p2, os.path.join(tmp, "ind_out"), card)
        trace_path(torch, ind_argv(p2, os.path.join(tmp, "ind_traced")),
                   "indep-pairwise")
        stamp("LD report kernels")
        rows += check_ld_report_kernels(torch, dev, p2)
        torch.cuda.empty_cache()
        stamp("LD table, unphased")
        paths["r2_unphased"] = run_vcor_table(torch, p2, os.path.join(tmp, "r2u"),
                                              card, phased=False)
        trace_path(torch, vcor_argv(p2, os.path.join(tmp, "r2u_traced"),
                                    VCOR_TABLE_ARGS[False]), "r2-unphased table")
        stamp("LD table, phased")
        paths["r2_phased"] = run_vcor_table(torch, p2, os.path.join(tmp, "r2p"),
                                            card, phased=True)
        stamp("LD matrix")
        paths["r_matrix"] = run_vcor_matrix(torch, p2, tmp, card)
        stamp("--ld")
        paths["ld"] = run_ld_pair(torch, p2, os.path.join(tmp, "ld_pair"), card)
        stamp("--clump")
        paths["clump"] = run_clump(torch, prefix, os.path.join(
            tmp, "main.PHENO1.glm.logistic.hybrid"), os.path.join(tmp, "clump"), card)
        stamp("--indep-pairphase")
        paths["pairphase"] = run_pairphase(torch, p2, tmp, card)
        stamp("parity")
        run_parity(tmp)
        stamp("done")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lib_names = {"glm_irls_pass": "glm_irls"}
    for r in rows:
        r["route"] = "cuda"
        by_path = {p: ln[lib_names.get(r["name"], r["name"])]
                   for p, ln in paths.items()}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
