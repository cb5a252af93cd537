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
     removed something; 64 rows of .gcount, .vmiss, .afreq and .smiss must
     equal numpy counts (a CPU run of the whole path, ~46 s, was cut in
     slice 10: the parity panel holds every report CUDA = CPU), and 64
     report rows must agree with a numpy f64 least-squares fit; then once
     more under torch.profiler;
  6. pair kernels: K7 (KING; two runs identical) and K8 (GRM) against their
     plain versions on the 50,000 x 32,768 panel of bench.py's king_50k /
     grm_50k, timed beside their bound and one library call (K8, on the
     bf16 tensor cores since slice 16, beside both its tensor-core bound
     and the FP32 one);
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
     equal to its plain version, timed beside its bound and a bf16 matmul
     (K13 at 512 x 512 and at the phased table's 256 x 256);
 12. LD tables on indep_10k: `--r2-unphased --ld-window-kb 0.2
     --ld-window-r2 0.001` (K12; then under torch.profiler) and
     `--r2-phased --ld-window-kb 0.005 --ld-window-r2 0.001` (K12, K13),
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
 17. parity: a 2,000 x 800 panel through the port on the card and on the
     CPU (plain versions), hybrid, firth, QC + linear, KING + GRM, .rel +
     exact PCA, approx PCA + allele-wts (on a panel of that size with 5
     planted axes), --indep-pairwise and the LD reports (LD_PARITY, byte
     for byte), compared column by column; two card runs must give
     identical bytes.

Slice 6 (the --glm modifiers) adds, in the order they run:
  3b. K2 / K3 scaled (s = 0.5 for males) and K3 residualized (dc = 0, a
     seeded offset; logistic and firth2) against their plain versions in
     f32 and f64, and K14 `xm1_stats` exactly, on block 0 of phase 4's panel;
  4b. `--glm cc-residualize hide-covar` on phase 4's panel (K2 and the
     residualized K3 launched; 16 rows, FIRTH?=Y first, against numpy f64
     fits of the centred dosage with the null model's offset; traced);
  5b. `--xchr-model 1` on a copy whose variants n/2.. sit on chrX:
     logistic (`no-x-sex`: the .cov holds SEX; K14 and the scaled K2 / K3)
     and linear on QT1 (K6 three times on chrX), 16 chrX rows of each
     against numpy f64 fits with the males' dosages halved;
  17b. the modifiers on the parity panel, CUDA against CPU: the transforms,
     allow-no-covars + pheno-ids, sex, cc- + qt-residualize,
     firth-residualize (hybrid and with firth), --xchr-model 0 / 1 (and 1
     with the residualize modifiers) on a chrX copy with a .cov without
     SEX.

Slice 7 (the --glm joint models) adds, in the order they run:
  3c. K2 / K3 with two genotype columns (genotypic; K3 logistic, firth2
     and residualized at d = 2), K15 / K16 on the interaction designs
     d = 24 and 36, K4 at d = 36 and 64, each against its plain version in
     f32 (every row) and f64 (JOINT_F64_ROWS rows), on block 0 of phase
     4's panel; the library call of K2 / K3 / K16 is the valid plane by the
     products of K2's table (the moments part only: no single call does an
     IRLS pass), K15's one bmm that gives the d = 24 design's own moments;
  4c. on a 500,000 x 256 panel: `--glm genotypic hide-covar`, `--glm
     interaction`, `--glm dominant hide-covar --condition-list` (three
     variants) and `--glm genotypic cc-residualize hide-covar`, 8 rows
     (N_JOINT_ROWS) of each report against numpy f64 fits (GENO_2DF from the f64 joint
     test); `--glm genotypic interaction hide-covar --condition-list` of
     five (d = 51: K4's block mode); the interaction path traced;
  17c. nine joint cases on the parity panel, CUDA against CPU (a variant
     whose floats alone differ held to numpy f64 at one of the stops an
     f32 fit can take under plink2's rules).

Slice 8 (the dosage --glm, --dummy, widths past 96) adds, in the order they
run:
  3d. the port's own `--dummy 500000 256 0.02 dosage-freq=0.7 --seed 42`
     writes the dosage panel (SEX + 10 PCs .cov, seed 43; QT1, seed 44; the
     generator's time printed apart); K17 (dosage moments) and K18
     (logistic at the OLS start, firth2 at beta = 0) on its first 512
     variants against their plain versions in f32 (every row) and f64
     (JOINT_F64_ROWS rows); K15 / K16 at d = 128 (`interaction` over 63
     covariates, each variant's tiles split over two CTAs) on 8 variants of
     phase 4's panel and K4 at d = 128 and 250 (the device-memory
     workspace), against their plain versions;
  4d. `--glm hide-covar --covar` (logistic-hybrid) and the linear `--glm
     hide-covar` on QT1 over the 500,000 x 256 dosage panel: K17, K18 and
     K4 must have launched (K17 for the linear), every one of their
     launches is kept and run again against its plain version, 16 rows of
     each report against numpy f64 fits of the dosage design; the logistic
     path traced;
  17d. the dosage --glm on a 4,500 x 600 dosage panel, CUDA against CPU
     on 128 of its variants (hybrid, firth with K18's firth2, no-firth,
     qt-residualize; the host route's genotypic and interaction on 64), and
     `interaction` over 48 covariates (d = 98) on 64 variants of the parity
     panel; two card runs byte-identical.

Slice 9 (the --glm permutation tests, --adjust, local covariates) adds, in
the order they run:
  3e. K19 (the permuted X^T y and y^T y) and K20 (the t or joint F of each
     variant and permutation) on block 0 of phase 4's panel against 134
     permuted QT1 columns, at P = 1, genotypic (q = 2) and `interaction`:
     K19 against its plain version in f32 (every row) and f64
     (JOINT_F64_ROWS rows), K20 against its plain version in f64 on the
     same inputs; two runs identical; each timed beside its bound and one
     library call (K19, on the tensor cores since slice 14, beside both
     its tensor-core bound, three bf16 products a term, and the FP32 one;
     K20 and its torch.bmm yardstick also on the device alone, by
     torch.profiler, beside the CUDA events of a wrapper call);
  4e. on the joint-model panel (500,000 x 256): the linear `--glm
     hide-covar mperm=268 --seed 1` and `aperm --aperm 6 268` on a QT
     with two planted variants, and `--glm firth hide-covar mperm=33` on
     PHENO1: K19, K20, K2 and K4 (K3 for Firth) launched, every K19 / K20
     launch kept and held to its plain version, 64 linear and 8 Firth
     (variant, permutation) statistics of the first batch against numpy
     f64 fits of the rebuilt permuted phenotype, the planted variants at
     the EMP floor; the linear path traced on one batch;
  17e. permutation, --adjust and local-covariate cases on the parity
     panel, CUDA against CPU by plink_torch.testing's rules (the EMP
     columns byte-identical in >= 98% of the rows, within 3 / (N + 1)
     elsewhere); two card runs byte-identical.

Slice 10 (the sample reports and scoring: --het, --sample-counts,
--check-sex / --impute-sex, --score, --variant-score) adds, in the order
they run:
  3f. K21 (per-sample weighted plane sums; f64 at K = 3 and 5, f32 0/1
     selectors at K = 10) and K22 (per-variant; f64 at K = 2 and 6, f32 at
     K = 2) over phase 4's whole 500,000 x 4,096 matrix against their plain
     versions (f64 within 1e-12 of the sum of |terms|, f32 exact, NaN / Inf
     where the plain version has them), two runs identical, each timed
     beside its bound and one torch.matmul of the weights by the decoded
     planes; K21's f32 splits added in f64 past 2^24 (the split cap
     lowered to 4 variants: sums of 2^25 + 3 exact);
  4f. `--het --sample-counts --score <3-column score file> header
     --score-col-nums 3-5 --variant-score <2-column weight file>` on phase
     4's panel: K1, K21 and K22 launched; the integer columns exact against
     numpy counts of 64 samples, E(HOM), F and the score averages of 64
     samples and the .vscore of 64 variants held to numpy f64; traced;
  5f. `--check-sex` with four thresholds on a copy with variants n/2..7n/8
     on chrX and the rest on chrY, half its males haploid there: F and
     YRATE of 64 samples held to numpy f64, SNPSEX / STATUS by the
     thresholds, both SNPSEX classes among them;
  17f. plink_torch.testing.SR_RUNS (the cases of
     tests/test_torch_sample_reports.py) on the parity panel, its copies
     and the dosage parity panel, CUDA against CPU (byte for byte; the f64
     .vscore.bin and the f32 sums of `single-prec` within their
     tolerances; the frequency guard's refusals alike); two card runs
     byte-identical.

Slice 11 (the pair-count commands: --distance, --genome, --cluster /
--neighbour / --mds-plot, --ibs-test, --groupdist, --regress-distance)
adds, in the order they run:
  11b. K23 `wmiss_gram` on the diagonal tile and the ragged last row tile of
     the --distance layout of indep_10k (2,048-sample tiles, npad 10,240)
     with the path's own weights, torch.equal to its plain version (f64 on
     the card), two runs identical, timed beside its bound (the lesser of
     K23's AND words at the INT32 rate and four u8 limb products on the
     int8 tensor cores) and one f64 torch.matmul;
  11c. `--distance triangle bin4` on indep_10k at full width: K7 (counters)
     and K23 launched 15 times each, every K23 launch kept and held to its
     plain version, 64 .dist.bin entries against numpy (f64 from the codes
     and the weights in the reference's order, rounded to f32) and the
     .dist.id; traced;
  17g. plink_torch.testing.PD_RUNS (the cases of
     tests/test_torch_pair_reports.py) on a 300 x 600 panel (2% missing,
     seed 1), its chr1/X/Y/MT copy, a .bed copy with the test's pedigree
     and a 300 x 600 dosage panel (the port's --dummy), each cut by --keep
     to 250 samples, in 64-sample tiles, CUDA against CPU: outputs byte for
     byte, the .log result lines equal, the refusals alike; two card runs
     byte-identical.

Slice 12 (--fast-epistasis, --assoc / --model and --fst) adds, in the
order they run:
  4g. `--assoc --model --allow-no-sex` on phase 4's panel: K1 launched; 64
     variants of the .assoc and .model against numpy (allele and genotype
     counts exact, CHISQ / P / OR within 1e-12 relative as printed); traced;
  11d. K24 `epi_joint_counts` (and its packing pass) on indep_10k's first
     4,096 variants with PHENO1's cases and controls: the first row block
     of 256, a ragged block of 200, a boost block of 96 and a case-only
     block (one group), each torch.equal to its plain version, two runs
     identical; timed beside its bound (the lesser of its own popcounts and
     B8's int8 product) and torch._int_mm of the int8 split planes;
  12c. `--fast-epistasis --allow-no-sex` over variants 1..4,096 of
     indep_10k (`--extract bed1`; 8.4e6 pairs), then `--fast-epistasis
     boost` over 1..2,048: K1 and K24 launched (16 and 22 K24 launches,
     one packing pass each), every K24 launch kept and held to its plain
     version, 64 .epi.cc STATs against numpy f64 Ueki statistics of
     numpy's tables and 64 .summary N_TOT against M - 1; the default run
     traced;
  12d. `--fst POP method=hudson report-variants`, then `method=wc`, on
     indep_10k with a 5-category POP column (numpy seed 61): each
     .fst.summary and 64 rows of one .fst.var against numpy f64 of the
     per-population counts;
  17h. plink_torch.testing.EPI_RUNS and A19_RUNS (the cases of
     tests/test_torch_epistasis.py and tests/test_torch_assoc19.py) on a
     200 x 600 panel, its chr1 / chr2 and chr1/X/Y/MT copies and a 65,536 x
     128 panel, CUDA against CPU: outputs byte for byte, the .log result
     lines equal, the refusals alike; two card runs byte-identical.

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
# samples, variants, seed of the parity panel (variants cut 1,200 -> 800 for
# the script's time: its hybrid report keeps one FIRTH?=Y row)
SMALL = (2_000, 800, 1)
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
# the statistic columns (the joint models' hold a Z or T, or the joint F)
STAT_COLS = ("Z_STAT", "T_STAT", "Z_OR_F_STAT", "T_OR_F_STAT")
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
N_QC_ROWS = 64  # rows of each QC count report checked against numpy counts
LOGISTIC_KERNELS = ("geno_counts", "glm_moments", "glm_irls", "chol_small")
# the --glm modifiers' paths (slice 6): cc-residualize runs the plain K2 and
# the residualized K3; --xchr-model 1 logistic the plain modes on chr1 and the
# scaled modes + K14 on chrX
RESID_KERNELS = ("geno_counts", "glm_moments", "glm_irls_resid", "chol_small")
XM1_KERNELS = ("glm_moments", "glm_irls", "glm_moments_scaled", "glm_irls_scaled",
               "chol_small", "xm1_stats")
XM1_LINEAR_KERNELS = ("linear_sums",)
# report rows of the cc-residualize, --xchr-model 1 and dosage paths held to
# numpy f64 fits: cut 64 -> 32 in slice 10 and 32 -> 16 in slice 11 to make
# room for their phases
N_CHECK_ROWS = 16
# rows of each joint-model report (4c) held to numpy f64 fits: cut 64 -> 16
# in slice 10 and 16 -> 8 in slice 11 to make room for their phases in the
# script's time (each row's f64 fit at 500,000 samples is ~0.5-2 s of host
# time)
N_JOINT_ROWS = 8
# variants of the joint-model and permutation paths' panel (one block): cut
# 2,048 -> 1,024 -> 512 -> 256 for the script's time (the genotypic paths'
# host rechecks, the writers and the permutation counts grow with the
# variants)
JOINT_VARIANTS = 256
JOINT_F64_ROWS = 256  # rows of each joint-model kernel check also held to f64
# the dosage paths (slice 8): the port's own --dummy writes a 500,000-sample
# panel with dosage tracks on 70% of the calls; variants cut 16,384 -> 512,
# one block of the path (the generator and the host's per-variant dosage
# decode set the time: at 1,024 variants the script ran past 1,000 s), and
# 512 -> 256 in slice 12 for the script's time; the kernel checks take that
# block
DOSAGE_VARIANTS = 256
DOSAGE_DUMMY = ["--dummy", str(N_SAMPLES), str(DOSAGE_VARIANTS), "0.02",
                "dosage-freq=0.7", "--seed", "42"]
DOSAGE_BLOCK = 256  # variants a block of the dosage path at 500,000 samples
DOSAGE_KERNELS = ("geno_counts", "glm_dense_moments", "glm_dense_irls",
                  "chol_small")
DOSAGE_PARITY = (4_500, 600, 7)  # samples (>= 4,096: device rows), variants, seed
WIDE128_ROWS = 8  # variants of the d = 128 K15 / K16 checks
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
# H100 SXM 32-bit integer operations outside the tensor cores: 132 SMs x
# 64 INT32 lanes x 1.98 GHz (half the FP32 lanes; FP32_FLOP_PER_S counts
# an FMA as two)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# K8 against its plain version and the plain version in f64, normalised as
# above: full-f32 products summed in <= 2,048-variant f32 runs measure
# 4.8e-7 from f64 at 50,000 x 32,768 (K8's exact bf16 parts in 256-variant
# runs 7.2e-7, in the 128-variant runs it takes since); the same runs with
# TF32 inputs must land above this (chip_smoke checks it)
TOL_K8 = 2e-6
REL_TILE, REL_CHUNK = 2048, 8192  # the commands' sample tile and GRM chunk
GRM_BYTES_NEEDED = 10.1e9  # .grm.bin + .grm.N.bin at 50,000 samples
# parity cases of the relationship commands: (label, flags, outputs); the
# port's tile cut to 512 samples so the 2,000-sample panel has four a side;
# .rel + exact PCA on its first 1,000 samples ({keep}: two tiles a side; the
# host's n^2 text writers and eigensolver set that case's time)
REL_PARITY = (
    ("king_grm", ["--make-king-table", "--king-table-filter", "0.05",
                  "--make-king", "square", "bin", "--make-grm-bin"],
     (".kin0", ".king.bin", ".king.id", ".grm.bin", ".grm.N.bin", ".grm.id")),
    ("rel_pca", ["--make-grm-list", "--make-rel", "--pca", "4", "--keep", "{keep}"],
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
# 5 (plink 1.9's default --ld-window is 10: cut in slice 12 for the script's
# time, each phased pair one host phased_r2), the r matrix of a fine-mapping
# region (variants 1..8,192: 16 x 17 / 2 = 136 chunk pairs of 512), --ld on
# one pair, and --indep-pairphase on a phased copy of the whole panel
VCOR_TABLE_ARGS = {
    False: ["--r2-unphased", "--ld-window-kb", "0.2", "--ld-window-r2", "0.001"],
    True: ["--r2-phased", "--ld-window-kb", "0.005", "--ld-window-r2", "0.001"],
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
    now = time.perf_counter()
    log(f"[{now - _T0:.0f}s] {label}")
    return now


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
    untemplated kernels, the covariate width of the main path (dc = 12),
    K13's three copy widths and wherever ptxas spilled."""
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
                if (spill or not args or args[0] in ("12", "13", "15")
                        or "wide" in short or short == "ld_gram_kernel"):
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


def device_ms(torch, fn, reps=50):
    """Mean time on the device of the kernels one call of `fn` launches
    (torch.profiler's CUDA time), in ms: the host's time to enqueue a call
    is left out, where time_ms's events take whichever is longer."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / reps / 1e3


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
    # A1 = REF on a seeded half of the variants: their hom-REF plane is summed
    a1r = torch.from_numpy(np.random.default_rng(66).random(vb) < 0.5).to(dev)
    k6 = G.linear_sums(pk, *ins32, a1r)
    p6 = _chunked_dict(torch, lambda sl: G.linear_sums_plain(pk[sl], *ins32, a1r[sl]),
                       vb, 256)
    r6 = _chunked_dict(torch, lambda sl: G.linear_sums_plain(pk[sl], *ins64, a1r[sl]),
                       vb, 128)
    # sum y^2 over each plane: the plain version with y^2 as its one-column
    # c c^T table (read back as ?cc)
    yy = _chunked_dict(torch, lambda sl: G.linear_sums_plain(
        pk[sl], ins64[2][:, None], ins64[2][:, None], ins64[2], a1r[sl]), vb, 128)
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
    again = G.linear_sums(pk, *ins32, a1r)
    assert all(torch.equal(k6[k], again[k]) for k in k6), "K6 is not deterministic"
    ms6 = time_ms(torch, lambda: G.linear_sums(pk, *ins32, a1r), 5)
    pms6 = time_ms(torch, lambda: _chunked_dict(
        torch, lambda sl: G.linear_sums_plain(pk[sl], *ins32, a1r[sl]), vb, 256), 1)
    # library: the decoded planes [3 vb, n] by the per-sample table
    # [n, dc^2 + dc + 1] (plink_tpu's three plane products), one matmul
    codes = unpack_codes(pk)
    # (variant, sample) pairs that add a row: all but hom-REF, hom-ALT where
    # the codes are swapped
    nz = int(torch.where(a1r[:, None], codes != 2, codes != 0).sum())
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
        f"{errs['plain_vs_f64']:.2e}), two runs identical, A1 = REF on "
        f"{int(a1r.sum())} variants; {ms6:.3f} ms, plain {pms6:.1f} ms, matmul "
        f"{lib6:.3f} ms; {nz} non-hom-REF pairs")
    return dict(name="linear_sums", source="plink_torch/csrc/linear_sums.cu",
                replaces="plink_tpu/ops/glm.py:46", max_abs_err=mae,
                max_norm_err=errs["plain"], tol=TOL_VS_PLAIN,
                max_norm_err_f64=errs["f64"], tol_f64=TOL_VS_F64, ms=ms6,
                plain_ms=pms6, **_bound(ops6, bytes6), library_ms=lib6)


def check_modifier_kernels(torch, dev, prefix):
    """Phase 3b: the --glm modifiers' kernel modes at the main path's shapes
    (block 0, 2,048 variants x 500,000 samples, SEX + 10 PCs): K2 and K3 in
    the scaled mode (s = 0.5 for the panel's males, --xchr-model 1), K3 in
    the residualized mode (dc = 0, the mean from K2's sums, the offset of a
    seeded null model) in logistic and firth2, each against its plain
    version in f32 and in f64; K14 exactly against its plain version."""
    import numpy as np

    from plink_torch.ops import glm as G

    packed_all, feat, masks = main_path_inputs(torch, prefix, dev)
    vb = 2048
    pk = packed_all[:vb]
    dc = feat.shape[1] - 2
    d = dc + 1
    npad = feat.shape[0]
    n_s = int(masks[:, 0].sum())
    s = torch.ones(npad, dtype=torch.float32, device=dev)
    s[masks[:, 1] > 0] = 0.5  # the males' chrX dosages halved
    gw = torch.zeros((vb, 3), dtype=torch.float32, device=dev)
    gw[:, 0], gw[:, 1] = 1.0, 2.0  # ADD with A1 = ALT
    gwm = torch.stack([gw, gw], dim=1).contiguous()
    feat64, s64 = feat.double(), s.double()
    rows = []
    valid_f = (unpack_codes(pk) != 3).to(torch.float32)
    n_valid = float(valid_f.sum())

    # K2, scaled
    k2 = G.glm_moments(pk, gwm, feat, s)
    p2 = chunked(torch, lambda sl: G.glm_moments_plain(pk[sl], gwm[sl], feat, s),
                 vb, 256)
    r2 = chunked(torch, lambda sl: G.glm_moments_plain(
        pk[sl], gwm[sl].double(), feat64, s64), vb, 128)
    sc2 = mat_scale(torch, r2)
    e2, e2r = norm_err(torch, k2, p2, sc2), norm_err(torch, k2, r2, sc2)
    ints = [0, dc, dc + 1, dc + 2]  # sums of halves: exact
    exact2 = bool(torch.equal(k2[:, ints][:, :, ints], p2[:, ints][:, :, ints]))
    assert e2 <= TOL_VS_PLAIN and e2r <= TOL_VS_F64 and exact2, (e2, e2r, exact2)
    assert torch.equal(k2, G.glm_moments(pk, gwm, feat, s))
    ms2 = time_ms(torch, lambda: G.glm_moments(pk, gwm, feat, s), 5)
    pms2 = time_ms(torch, lambda: chunked(torch, lambda sl: G.glm_moments_plain(
        pk[sl], gwm[sl], feat, s), vb, 256), 1)
    cy = feat[:, : dc + 1]
    ccfl2 = (cy[:, :, None] * cy[:, None, :]).reshape(-1, (dc + 1) ** 2)
    lib2 = time_ms(torch, lambda: torch.matmul(valid_f, ccfl2), 5)
    D = dc + 3
    bytes2 = pk.numel() + (feat.numel() + npad + gwm.numel() + k2.numel()) * 4
    rows.append(dict(name="glm_moments_scaled", source="plink_torch/csrc/glm_moments.cu",
                     replaces="plink_tpu/ops/glm.py:313", max_abs_err=float(
                         (k2 - p2).abs().max()), max_norm_err=e2, tol=TOL_VS_PLAIN,
                     max_norm_err_f64=e2r, tol_f64=TOL_VS_F64, ms=ms2,
                     plain_ms=pms2, **_bound(n_valid * (D * (D + 1) + 2), bytes2),
                     library_ms=lib2))
    log(f"K2 glm_moments scaled [{vb}x{npad}, D={D}]: norm err vs plain {e2:.2e}, "
        f"vs f64 {e2r:.2e}, integer/half entries exact, two runs identical; "
        f"{ms2:.3f} ms, plain {pms2:.1f} ms, matmul {lib2:.3f} ms")

    def k3_check(label, design, feat_k, beta, hinv, vscale):
        """K3 in one mode against its plain version (f32 and f64)."""
        d64 = {k: None if v is None else v.double() for k, v in design.items()}
        active = torch.ones(vb, dtype=torch.bool, device=dev)
        km, kv, kl = G.glm_irls_pass(pk, gw, feat_k, beta, active, hinv, **design)
        pm, pv, pl = chunked(torch, lambda sl: G.glm_irls_pass_plain(
            pk[sl], gw[sl], feat_k, beta[sl], active[sl],
            None if hinv is None else hinv[sl],
            **{k: v[sl] if k == "gmean" else v for k, v in design.items()}),
            vb, 256)
        rm, rv, rl = chunked(torch, lambda sl: G.glm_irls_pass_plain(
            pk[sl], gw[sl].double(), feat_k.double(), beta[sl].double(),
            active[sl], None if hinv is None else hinv[sl].double(),
            **{k: v[sl] if k == "gmean" else v for k, v in d64.items()}),
            vb, 128)
        scm = mat_scale(torch, rm)
        em, emr = norm_err(torch, km, pm, scm), norm_err(torch, km, rm, scm)
        ev, evr = norm_err(torch, kv, pv, vscale), norm_err(torch, kv, rv, vscale)
        el = 0.0 if kl is None else float(((kl - pl).abs() / pl.abs()).max())
        assert (max(em, ev) <= TOL_VS_PLAIN and max(emr, evr) <= TOL_VS_F64
                and el <= TOL_LOGLIK), (label, em, ev, emr, evr, el)
        again = G.glm_irls_pass(pk, gw, feat_k, beta, active, hinv, **design)
        assert torch.equal(km, again[0]) and torch.equal(kv, again[1]), label
        ms = time_ms(torch, lambda: G.glm_irls_pass(pk, gw, feat_k, beta, active,
                                                    hinv, **design), 3)
        log(f"K3 glm_irls_pass {label} [{vb}x{npad}, d={beta.shape[1]}]: norm "
            f"err vs plain H {em:.2e} vec {ev:.2e}, vs f64 H {emr:.2e} vec "
            f"{evr:.2e}, loglik rel {el:.2e}, two runs identical; {ms:.3f} ms")
        return km, float(max((km - pm).abs().max(), (kv - pv).abs().max())), \
            max(em, ev), max(emr, evr), ms

    # K3, scaled: the OLS start of the main path, then firth2 at beta = 0
    idx = list(range(dc)) + [dc + 1]
    h0 = k2[:, idx][:, :, idx].contiguous()
    rhs0 = (G._Z_INIT * (k2[:, idx, dc] - 0.5 * k2[:, idx, 0])).contiguous()
    beta0, _, _ = G.chol_small(h0, rhs=rhs0)
    vsc = torch.sqrt(torch.diagonal(h0, dim1=1, dim2=2).clamp(min=1e-30)
                     * k2[:, :1, 0])
    act = torch.ones(vb, dtype=torch.bool, device=dev)
    sc = dict(sscale=s)
    _, mae_a, e_a, er_a, ms3 = k3_check("scaled logistic", sc, feat, beta0, None, vsc)
    zero = torch.zeros((vb, d), dtype=torch.float32, device=dev)
    Hz, _, _ = G.glm_irls_pass(pk, gw, feat, zero, act, sscale=s)
    _, hz_inv, _ = G.chol_small(Hz, inverse=True)
    _, mae_b, e_b, er_b, ms3f = k3_check("scaled firth2", sc, feat, zero, hz_inv, vsc)
    pms3 = time_ms(torch, lambda: chunked(torch, lambda sl: G.glm_irls_pass_plain(
        pk[sl], gw[sl], feat, beta0[sl], act[sl], sscale=s), vb, 256), 1)
    c = feat[:, :dc]
    ccfl3 = (c[:, :, None] * c[:, None, :]).reshape(-1, dc * dc)
    lib3 = time_ms(torch, lambda: torch.matmul(valid_f, ccfl3), 5)
    ntri = d * (d + 1) // 2
    bytes3 = pk.numel() + (feat.numel() + npad + vb * (d * d + 2 * d + 5)) * 4
    rows.append(dict(name="glm_irls_scaled", source="plink_torch/csrc/glm_irls_x.cu",
                     replaces="plink_tpu/ops/glm.py:313", max_abs_err=max(mae_a, mae_b),
                     max_norm_err=max(e_a, e_b), tol=TOL_VS_PLAIN,
                     max_norm_err_f64=max(er_a, er_b), tol_f64=TOL_VS_F64, ms=ms3,
                     plain_ms=pms3, **_bound(n_valid * (2 * ntri + 4 * d + 13), bytes3),
                     library_ms=lib3, firth2_ms=ms3f))

    # K3, residualized: mean and start from K2's sums, a seeded null offset
    rng = np.random.default_rng(61)
    bnull = torch.from_numpy(rng.normal(scale=0.2, size=dc)).float().to(dev)
    off = (feat[:, :dc] @ bnull).contiguous()  # 0 on the padding
    mean, h0r, rhs0r = G._resid_start(k2, dc)
    feat_r = feat[:, dc:].contiguous()
    rd = dict(offset=off, gmean=mean)
    beta_r, _, _ = G.chol_small(h0r, rhs=rhs0r)
    vscr = torch.sqrt(h0r[:, 0].clamp(min=1e-30) * k2[:, :1, 0])
    _, mae_c, e_c, er_c, ms3r = k3_check("residualized logistic", rd, feat_r,
                                         beta_r, None, vscr)
    zr = torch.zeros((vb, 1), dtype=torch.float32, device=dev)
    Hr, _, _ = G.glm_irls_pass(pk, gw, feat_r, zr, act, **rd)
    _, hr_inv, _ = G.chol_small(Hr, inverse=True)
    _, mae_d, e_d, er_d, ms3rf = k3_check("residualized firth2", rd, feat_r, zr,
                                          hr_inv, vscr)
    pms3r = time_ms(torch, lambda: chunked(torch, lambda sl: G.glm_irls_pass_plain(
        pk[sl], gw[sl], feat_r, beta_r[sl], act[sl], offset=off,
        gmean=mean[sl]), vb, 256), 1)
    table_r = torch.stack([feat_r[:, 0], feat_r[:, 1], off], 1)
    lib3r = time_ms(torch, lambda: torch.matmul(valid_f, table_r), 5)
    bytes3r = pk.numel() + (3 * npad + vb * 9) * 4
    rows.append(dict(name="glm_irls_resid", source="plink_torch/csrc/glm_irls_x.cu",
                     replaces="plink_tpu/ops/glm.py:623", max_abs_err=max(mae_c, mae_d),
                     max_norm_err=max(e_c, e_d), tol=TOL_VS_PLAIN,
                     max_norm_err_f64=max(er_c, er_d), tol_f64=TOL_VS_F64, ms=ms3r,
                     plain_ms=pms3r, **_bound(n_valid * 19, bytes3r),
                     library_ms=lib3r, firth2_ms=ms3rf))

    # K14 on block 0: w = [s, s y] over every sample
    w = torch.stack([s * feat[:, dc + 1], s * feat[:, dc]], 1).contiguous()
    mask = feat[:, dc + 1].contiguous()
    k14 = G.xm1_stats(pk, w, mask)
    p14 = chunked(torch, lambda sl: G.xm1_stats_plain(pk[sl], w, mask), vb, 256,
                  dim=1)
    assert torch.equal(k14, p14), float((k14 - p14).abs().max())
    assert torch.equal(k14, G.xm1_stats(pk, w, mask))
    ms14 = time_ms(torch, lambda: G.xm1_stats(pk, w, mask), 20)
    pms14 = time_ms(torch, lambda: chunked(
        torch, lambda sl: G.xm1_stats_plain(pk[sl], w, mask), vb, 256, dim=1), 1)
    # library: the decoded valid / het / hom planes [3 vb, n] f32 by w, one
    # matmul (as plink_tpu's dot_general)
    codes = unpack_codes(pk)
    pl3 = torch.cat([valid_f, (codes == 1).float(), (codes == 2).float()])
    del codes
    lib14 = time_ms(torch, lambda: torch.matmul(pl3, w), 3)
    del pl3, valid_f
    bytes14 = pk.numel() + npad * 12 + k14.numel() * 4
    rows.append(dict(name="xm1_stats", source="plink_torch/csrc/xm1_stats.cu",
                     replaces="plink_tpu/ops/glm.py:895", max_abs_err=0.0, tol=0.0,
                     ms=ms14, plain_ms=pms14, **_bound(2 * n_valid, bytes14),
                     library_ms=lib14))
    log(f"K14 xm1_stats [{vb}x{npad}]: exact ({n_s} samples, males at 0.5); "
        f"{ms14:.4f} ms, plain {pms14:.1f} ms, f32 matmul {lib14:.3f} ms, bound "
        f"{rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']})")
    return rows


def timed(torch, fn):
    """(fn(), its ms on the card by CUDA events): one run, no warm-up (the
    plain versions, whose time is recorded, not compared)."""
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def check_joint_kernels(torch, dev, prefix):
    """Phase 3c: the joint-model kernels at the main path's shapes (block 0,
    2,048 variants x 500,000 samples, SEX + 10 PCs, dc = 12): K2 / K3 with
    two genotype columns (genotypic: ADD, DOMDEV; K3 logistic, firth2 and
    residualized), K15 / K16 on the `interaction` designs d = 24 (additive)
    and d = 36 (genotypic), K4 at d = 36 and, on seeded SPD matrices, at
    d = 64 (the block-per-matrix kernel).  Each against its plain version
    in f32 on every row and in f64 on the first JOINT_F64_ROWS rows, timed
    beside its bound and one library call."""
    import numpy as np

    from plink_torch.ops import glm as G

    packed_all, feat, _ = main_path_inputs(torch, prefix, dev)
    vb = 2048
    pk = packed_all[:vb]
    dc = feat.shape[1] - 2
    npad = feat.shape[0]
    sub = slice(0, JOINT_F64_ROWS)
    feat64 = feat.double()
    valid_f = (unpack_codes(pk) != 3).to(torch.float32)
    n_valid = float(valid_f.sum())
    add = torch.zeros((vb, 3), dtype=torch.float32, device=dev)
    add[:, 0], add[:, 1] = 1.0, 2.0  # ADD with A1 = ALT
    dom = torch.zeros_like(add)
    dom[:, 0] = 1.0  # DOMDEV: the het indicator
    designs = {  # name: (gw [vb, P, 3], covj)
        "p2": (torch.stack([add, dom], 1).contiguous(), (0, 0)),
        "d24": (torch.stack([add] * dc, 1).contiguous(), tuple(range(dc))),
        "d36": (torch.stack([add, dom] + [add] * (dc - 1) + [dom] * (dc - 1), 1)
                .contiguous(), (0, 0) + tuple(range(1, dc)) * 2),
    }
    table = {"moments": feat[:, : dc + 1], "irls": feat[:, :dc]}

    def lib(kind):  # the decoded valid plane by the per-sample table
        t = table[kind]
        ccfl = (t[:, :, None] * t[:, None, :]).reshape(npad, -1)
        return time_ms(torch, lambda: torch.matmul(valid_f, ccfl), 3)

    def lib_wide(key):
        """K15's moments at a design whose predictors share one coding g:
        the valid, g and g^2 planes [3, vb, npad] by the per-sample products
        of the columns K15 forms (cy x cy, f_p x cy, f_p x f_q with f_p =
        cy[:, covj_p], or 1 at covj_p = 0; ADD appended as mom_check does),
        zero-padded to one width: one f32 torch.bmm."""
        gw3, covj = designs[key]
        assert bool((gw3 == add[:, None]).all()), key  # one coding: ADD
        cy = feat[:, : dc + 1]
        f = torch.stack([cy[:, j] if j else torch.ones_like(cy[:, 0])
                         for j in covj + (0,)], 1)
        prods = [cy[:, :, None] * cy[:, None, :], f[:, :, None] * cy[:, None, :],
                 f[:, :, None] * f[:, None, :]]
        width = max(p.shape[1] * p.shape[2] for p in prods)
        tables = torch.zeros((3, npad, width), dtype=torch.float32, device=dev)
        for i, p in enumerate(prods):
            tables[i, :, : p.shape[1] * p.shape[2]] = p.reshape(npad, -1)
        codes = unpack_codes(pk)
        planes3 = torch.empty((3, vb, npad), dtype=torch.float32, device=dev)
        planes3[0] = valid_f
        planes3[1] = codes == 1
        planes3[1].masked_fill_(codes == 2, 2.0)
        torch.mul(planes3[1], planes3[1], out=planes3[2])
        del codes
        ms = time_ms(torch, lambda: torch.bmm(planes3, tables), 3)
        del planes3, tables
        return ms

    def mom_check(name, gw3, covj, nrows=vb):
        """The plain version runs (and is timed) on the first `nrows`
        variants."""
        gwm = torch.cat([gw3, add[:, None]], 1).contiguous()
        cj = covj + (0,)
        step = max(16, 4096 // gwm.shape[1] // 8)
        k = G.glm_moments(pk, gwm, feat, None, cj)
        p, pms = timed(torch, lambda: chunked(torch, lambda sl: G.glm_moments_plain(
            pk[sl], gwm[sl], feat, None, cj), nrows, step))
        r = G.glm_moments_plain(pk[sub], gwm[sub].double(), feat64, None, cj)
        kp = k[:nrows]
        e = norm_err(torch, kp, p, mat_scale(torch, p.double()))  # f64: no underflow
        er = norm_err(torch, k[sub], r, mat_scale(torch, r))
        P = gw3.shape[1]
        ints = [0, dc, dc + 1 + P] + ([dc + 1, dc + 2] if not any(covj) else [])
        exact = bool(torch.equal(kp[:, ints][:, :, ints], p[:, ints][:, :, ints]))
        assert e <= TOL_VS_PLAIN and er <= TOL_VS_F64 and exact, (name, e, er, exact)
        assert torch.equal(k, G.glm_moments(pk, gwm, feat, None, cj)), name
        ms = time_ms(torch, lambda: G.glm_moments(pk, gwm, feat, None, cj), 3)
        D = k.shape[1]
        bound = _bound(n_valid * D * (D + 1),
                       pk.numel() + (feat.numel() + gwm.numel() + k.numel()) * 4)
        log(f"K2/K15 moments {name} [{vb}x{npad}, D={D}]: norm err vs plain "
            f"({nrows} rows) {e:.2e}, vs f64 ({JOINT_F64_ROWS} rows) {er:.2e}, "
            f"integer entries exact, two runs identical; {ms:.3f} ms, plain "
            f"{pms:.1f} ms ({nrows} rows), bound {bound['bound_ms']:.3f} ms "
            f"({bound['bound_by']})")
        return k, dict(max_abs_err=float((kp - p).abs().max()), max_norm_err=e,
                       tol=TOL_VS_PLAIN, max_norm_err_f64=er, tol_f64=TOL_VS_F64,
                       ms=ms, plain_ms=pms, **bound)

    def irls_check(name, gw3, covj, feat_k, beta, hinv, vscale, cond=None,
                   nrows=vb, **design):
        """The plain version runs (and is timed) on the first `nrows`
        variants."""
        # a variant with no hom-A1 (or hom-REF) call makes a genotypic design
        # singular: its start or Hinv0 is NaN, and it is left inactive
        active = torch.isfinite(beta).all(dim=1)
        if hinv is not None:
            active &= torch.isfinite(hinv).all(dim=2).all(dim=1)
        assert float(active.float().mean()) > 0.75, (name, int(active.sum()))
        kw = dict(design, covj=covj)
        step = max(16, 2048 // gw3.shape[1] // 8)
        km, kv, kl = G.glm_irls_pass(pk, gw3, feat_k, beta, active, hinv, **kw)

        def plain(sl, dt=torch.float32):
            kw_sl = {k_: (v_[sl] if k_ == "gmean" else v_) for k_, v_ in kw.items()}
            kw_sl = {k_: (v_.to(dt) if isinstance(v_, torch.Tensor) else v_)
                     for k_, v_ in kw_sl.items()}
            return G.glm_irls_pass_plain(
                pk[sl], gw3[sl].to(dt), feat_k.to(dt), beta[sl].to(dt), active[sl],
                None if hinv is None else hinv[sl].to(dt), **kw_sl)

        (pm, pv, pl), pms = timed(torch, lambda: chunked(torch, plain, nrows, step))
        rm, rv, rl = plain(sub, torch.float64)
        km_all, kv_all = km, kv
        km, kv, kl = km[:nrows], kv[:nrows], None if kl is None else kl[:nrows]
        on, son = active[:nrows], active[sub]
        if cond is not None:
            # firth2's hat value x^T Hinv0 x cancels terms of size cond(H0):
            # the f64 check takes the rows an f32 sum resolves (cond < 1e4)
            son = son & (cond[sub] < 1e4)
        em = norm_err(torch, km[on], pm[on], mat_scale(torch, pm[on].double()))
        ev = norm_err(torch, kv[on], pv[on], vscale[:nrows][on])
        emr = norm_err(torch, km_all[sub][son], rm[son], mat_scale(torch, rm[son]))
        evr = norm_err(torch, kv_all[sub][son], rv[son], vscale[sub][son])
        el = 0.0 if kl is None else float(((kl - pl).abs() / pl.abs())[on].max())
        assert not km_all[~active].any() and not kv_all[~active].any(), name
        assert (max(em, ev) <= TOL_VS_PLAIN and max(emr, evr) <= TOL_VS_F64
                and el <= TOL_LOGLIK), (name, em, ev, emr, evr, el)
        again = G.glm_irls_pass(pk, gw3, feat_k, beta, active, hinv, **kw)
        assert torch.equal(km_all, again[0]) and torch.equal(kv_all, again[1]), name
        ms = time_ms(torch, lambda: G.glm_irls_pass(pk, gw3, feat_k, beta, active,
                                                    hinv, **kw), 3)
        d = beta.shape[1]
        ntri = d * (d + 1) // 2
        ops = n_valid * (2 * ntri + 4 * d + 12 + (2 * ntri if hinv is not None else 0))
        nbytes = pk.numel() + (feat_k.numel() + vb * (d * d + 2 * d + 5)
                               + (vb * d * d if hinv is not None else 0)) * 4
        bound = _bound(ops, nbytes)
        log(f"K3/K16 {name} [{vb}x{npad}, d={d}, {int(active.sum())} rows "
            f"active]: norm err vs plain ({nrows} rows) H {em:.2e} "
            f"vec {ev:.2e}, vs f64 ({int(son.sum())} rows) H {emr:.2e} vec "
            f"{evr:.2e}, loglik rel {el:.2e}, two runs identical; {ms:.3f} ms, "
            f"plain {pms:.1f} ms ({nrows} rows), bound {bound['bound_ms']:.3f} ms "
            f"({bound['bound_by']})")
        return km_all, dict(max_abs_err=float(max((km - pm).abs().max(),
                                              (kv - pv).abs().max())),
                        max_norm_err=max(em, ev), tol=TOL_VS_PLAIN,
                        max_norm_err_f64=max(emr, evr), tol_f64=TOL_VS_F64,
                        ms=ms, plain_ms=pms, **bound)

    def fits(name, gw3, covj, momy, nrows=vb):
        """The OLS start, then the logistic pass at it and the firth2 pass
        at beta = 0, as glm_logistic_scan takes them."""
        P = gw3.shape[1]
        h0, rhs0 = G._ols_start(momy, dc, P)
        beta0, _, _ = G.chol_small(h0, rhs=rhs0)
        vsc = torch.sqrt(torch.diagonal(h0, dim1=1, dim2=2).clamp(min=1e-30)
                         * momy[:, :1, 0])
        H, la = irls_check(f"{name} logistic", gw3, covj, feat, beta0, None, vsc,
                           nrows=nrows)
        zero = torch.zeros_like(beta0)
        act = torch.ones(vb, dtype=torch.bool, device=dev)
        Hz, _, _ = G.glm_irls_pass(pk, gw3, feat, zero, act, covj=covj)
        _, hz_inv, _ = G.chol_small(Hz, inverse=True)
        _, lf = irls_check(f"{name} firth2", gw3, covj, feat, zero, hz_inv, vsc,
                           cond=torch.linalg.cond(Hz.double()), nrows=nrows)
        return H, la, lf

    rows = []
    gw_p2, cj_p2 = designs["p2"]
    k2, m_p2 = mom_check("genotypic (K2, P = 2)", gw_p2, cj_p2)
    rows.append(dict(name="glm_moments_p2", source="plink_torch/csrc/glm_moments_p2.cu",
                     replaces="plink_tpu/ops/glm.py:288", **m_p2,
                     library_ms=lib("moments")))
    _, la, lf = fits("genotypic (K3, P = 2)", gw_p2, cj_p2, k2)
    rows.append(dict(name="glm_irls_p2", source="plink_torch/csrc/glm_irls_p2.cu",
                     replaces="plink_tpu/ops/glm.py:383", **la,
                     firth2_ms=lf["ms"], firth2_bound_ms=lf["bound_ms"],
                     library_ms=lib("irls")))
    # residualized, two centred columns: means and start from K2's sums, the
    # offset of a seeded null model
    rng = np.random.default_rng(62)
    bnull = torch.from_numpy(rng.normal(scale=0.2, size=dc)).float().to(dev)
    off = (feat[:, :dc] @ bnull).contiguous()
    mean, h0r, rhs0r = G._resid_start(k2, dc, 2)
    feat_r = feat[:, dc:].contiguous()
    beta_r, _, _ = G.chol_small(h0r, rhs=rhs0r)
    vscr = torch.sqrt(torch.diagonal(h0r, dim1=1, dim2=2).clamp(min=1e-30)
                      * k2[:, :1, 0])
    rd = dict(offset=off, gmean=mean)
    _, ra = irls_check("genotypic residualized (K3, d = 2) logistic", gw_p2,
                       (0, 0), feat_r, beta_r, None, vscr, **rd)
    act = torch.ones(vb, dtype=torch.bool, device=dev)
    Hr, _, _ = G.glm_irls_pass(pk, gw_p2, feat_r, torch.zeros_like(beta_r), act, **rd)
    _, hr_inv, _ = G.chol_small(Hr, inverse=True)
    _, rf = irls_check("genotypic residualized (K3, d = 2) firth2", gw_p2, (0, 0),
                       feat_r, torch.zeros_like(beta_r), hr_inv, vscr,
                       cond=torch.linalg.cond(Hr.double()), **rd)
    table_r = torch.stack([feat_r[:, 0], feat_r[:, 1], off], 1)
    rows.append(dict(name="glm_irls_resid_p2", source="plink_torch/csrc/glm_irls_p2.cu",
                     replaces="plink_tpu/ops/glm.py:623", **ra, firth2_ms=rf["ms"],
                     library_ms=time_ms(torch, lambda: torch.matmul(valid_f, table_r), 3)))

    wide = {}
    # the d = 36 plain versions take 3-9 s on the whole block: they run (and
    # are timed) on its first 512 variants
    for key, nrows in (("d24", vb), ("d36", 512)):
        gw3, covj = designs[key]
        k15, m15 = mom_check(f"interaction {key} (K15)", gw3, covj, nrows)
        H, la, lf = fits(f"interaction {key} (K16)", gw3, covj, k15, nrows)
        wide[key] = (m15, la, lf, H)
    m24, la24, lf24, _ = wide["d24"]
    m36, la36, lf36, H36 = wide["d36"]
    lib15 = lib_wide("d24")
    log(f"K15 library (the d = 24 design's moments, one f32 bmm of the valid / "
        f"g / g^2 planes by the column products): {lib15:.3f} ms")
    rows.append(dict(name="glm_moments_wide", source="plink_torch/csrc/glm_wide.cu",
                     replaces="plink_tpu/ops/glm.py:288", **m24,
                     d36_ms=m36["ms"], d36_plain_512_ms=m36["plain_ms"],
                     d36_bound_ms=m36["bound_ms"], library_ms=lib15,
                     k2_table_library_ms=lib("moments")))
    rows.append(dict(name="glm_irls_wide", source="plink_torch/csrc/glm_wide.cu",
                     replaces="plink_tpu/ops/glm.py:383", **la24,
                     firth2_ms=lf24["ms"], d36_ms=la36["ms"],
                     d36_firth2_ms=lf36["ms"], d36_plain_512_ms=la36["plain_ms"],
                     d36_bound_ms=la36["bound_ms"], library_ms=lib("irls")))

    # K4: the d = 36 Hessians (one thread a matrix) and seeded SPD d = 64
    # matrices (one block a matrix)
    a = torch.from_numpy(np.random.default_rng(63).normal(size=(vb, 64, 64))).to(dev)
    spd64 = (a @ a.transpose(1, 2) / 64 + torch.eye(64, device=dev,
                                                     dtype=torch.float64)).float()
    for d, h in ((36, H36), (64, spd64)):
        rhs = h[:, :, 0].contiguous()
        kx, ki, kd = G.chol_small(h, rhs=rhs, inverse=True, logdet=True)
        (px, pi, pdet), pms = timed(torch, lambda: G.chol_small_plain(h, rhs, True,
                                                                      True))
        # rows an f32 factor resolves to the 1e-3 rule: cond < 1e4 (a
        # genotypic row with few hom-A1 carriers has DOMDEV ~ ADD)
        good = torch.linalg.cond(h.double()) < 1e4
        ex = float(((kx - px).abs().amax(1) / px.abs().amax(1))[good].max())
        ei = float(((ki - pi).abs().amax((1, 2)) / pi.abs().amax((1, 2)))[good].max())
        ed = float(((kd - pdet).abs() / pdet.abs().clamp(min=1.0))[good].max())
        assert max(ex, ei, ed) <= TOL_CHOL and bool(good.float().mean() > 0.5), \
            (d, ex, ei, ed, int(good.sum()))
        ms = time_ms(torch, lambda: G.chol_small(h, rhs=rhs, inverse=True,
                                                 logdet=True), 10)
        libms = time_ms(torch, lambda: torch.linalg.inv_ex(h), 10)  # no raise
        bound = _bound(vb * (d ** 3 / 3 + 2 * d * d + d ** 3),
                       vb * (2 * d * d + 2 * d + 1) * 4)
        log(f"K4 chol_small [{vb},{d},{d}]: rel err solve {ex:.2e} inverse "
            f"{ei:.2e} logdet {ed:.2e} (tol {TOL_CHOL:g}; {int(good.sum())} rows "
            f"with cond < 1e4); {ms:.4f} ms, plain "
            f"{pms:.2f} ms, linalg.inv_ex {libms:.4f} ms")
        if d == 64:
            rows.append(dict(name="chol_small_wide", source="plink_torch/csrc/chol_small.cu",
                             replaces="plink_tpu/ops/glm.py:125", max_abs_err=float(
                                 (ki - pi)[good].abs().max()), max_norm_err=max(ex, ei, ed),
                             tol=TOL_CHOL, ms=ms, plain_ms=pms, **bound,
                             library_ms=libms, d36_ms=d36_ms))
        else:
            d36_ms = ms
    del valid_f
    return rows


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
        again = P.king_gram(pd.packed, pd.vmask, r0, c0, s, s, n=n, thresh=thresh)
        assert k[0].cpu().numpy().tobytes() == again[0].cpu().numpy().tobytes() and \
            all(torch.equal(a, b) for a, b in zip(k[1:], again[1:])) and \
            torch.equal(kc, P.king_gram(pd.packed, pd.vmask, r0, c0, s, s, counts=True)), \
            ("king_gram: two runs differ", r0, c0)
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
    # the five int8 plane products the counters need on the tensor cores:
    # HH, HO, OH, OO and DD (H het, O hom, D = hom-ALT - hom-REF; ibs0 =
    # (OO - DD) / 2, nsnp = HH + HO + OH + OO)
    ops7 = 5 * s * s * mv * 2
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
        f"ragged row tile, two runs identical; {ms7:.3f} ms, plain {pms7:.1f} ms, "
        f"bf16 matmul {lib7:.3f} ms, bound {max(t_ops, t_bytes):.3f} ms (five "
        f"int8 products)")

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
    # K8's tensor-core form: each f32 product as P._K8_PRODUCTS exact bf16
    # part products, jm as one int8 product of the missing planes; the FP32
    # rate's bound kept beside it
    fp32_8 = _bound(ops8, bytes8)
    t_tc = 1e3 * (P._K8_PRODUCTS * ops8 / BF16_FLOP_PER_S + ops8 / INT8_OPS_PER_S)
    t_b = 1e3 * bytes8 / HBM_BYTES_PER_S
    bound8 = dict(bound_ms=max(t_tc, t_b), bound_by="operations" if t_tc >= t_b
                  else "bytes", fp32_bound_ms=fp32_8["bound_ms"])
    rows.append(dict(name="grm_gram", source="plink_torch/csrc/grm_gram.cu",
                     replaces="plink_tpu/ops/pairwise.py:355",
                     also_replaces="plink_tpu/ops/pairwise.py:215",
                     max_abs_err=float((g - pg).abs().nan_to_num(0.0).max()),
                     max_norm_err=e8, tol=TOL_K8, max_norm_err_f64=e8r,
                     tol_f64=TOL_K8, tf32_control_norm_err=e8tf32, ms=ms8,
                     plain_ms=pms8, products=P._K8_PRODUCTS, run=P._K8_RUN,
                     **bound8, library_ms=lib8))
    log(f"K8 grm_gram [{s}x{c} chunk, V={mv}, {P._K8_PRODUCTS} bf16 products, "
        f"{P._K8_RUN}-variant f32 runs]: norm err vs plain {e8:.2e}, vs "
        f"f64 {e8r:.2e} (tol {TOL_K8:g} each; plain vs f64 {e8pr:.2e}; the TF32 "
        f"control {e8tf32:.2e} fails it), pair counts exact, two runs "
        f"identical; {ms8:.3f} ms, plain {pms8:.1f} ms, f32 matmul "
        f"{lib8:.3f} ms, bound {bound8['bound_ms']:.3f} ms on the tensor cores, "
        f"{fp32_8['bound_ms']:.3f} ms at the FP32 rate")
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
    # timed on the matrix cell's 512 x 512 chunk pairs and on the phased
    # table's 256 x 256 (chunk = max(256, width): LdJointBand), each beside
    # one bf16 matmul of the RAV planes
    times = {}
    for cc in (c, 256):
        pa, pb = reg[:cc], reg[cc : 2 * cc]
        assert torch.equal(LD.ld_gram_pair(pa, pb, sm), LD.ld_gram_pair_plain(pa, pb, sm))
        ms = time_ms(torch, lambda: LD.ld_gram_pair(pa, pb, sm), 20)
        pms = time_ms(torch, lambda: LD.ld_gram_pair_plain(pa, pb, sm), 3)
        qa = LD._planes_rav(pa, sm).to(torch.bfloat16)[None]
        qb = LD._planes_rav(pb, sm).to(torch.bfloat16).t()[None]
        lib = time_ms(torch, lambda: torch.bmm(qa, qb, out_dtype=torch.float32), 20)
        bound = _bound(9 * 2 * cc * cc * n, 2 * cc * nbytes + npad + 9 * cc * cc * 4,
                       INT8_OPS_PER_S)
        times[cc] = dict(ms=ms, plain_ms=pms, library_ms=lib, **bound)
        log(f"K13 ld_gram_pair [{cc}x{cc} chunks x {n} samples]: {ms:.4f} ms a "
            f"launch, plain {pms:.2f} ms, bf16 matmul {lib:.4f} ms, bound "
            f"{bound['bound_ms']:.4f} ms")
    log(f"K13 ld_gram_pair: = plain over all {pairs} chunk pairs of the "
        f"{REGION_VARIANTS}-variant region and at 256 x 256, two runs identical")
    out.append(dict(name="ld_gram_pair", source="plink_torch/csrc/ld_gram.cu",
                    replaces="plink_tpu/ops/ld.py:44", max_abs_err=0.0, tol=0.0,
                    chunk_pairs_checked=pairs, **times[c],
                    **{f"c256_{k}": v for k, v in times[256].items()}))
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
    return GLM_FLOAT_RTOL * (max(abs(y), 1.0) if col in STAT_COLS
                             else abs(y))


def compare_reports(a, b, beta_by_se=False, refit=None):
    """Every column of report `a` against the same rows of `b`: exact, except
    OR / SE / Z / P within float_allowed.  With `beta_by_se` (the modifier
    parity cases) a BETA is held to GLM_FLOAT_RTOL of max(|BETA|, SE), as T
    is to max(|T|, 1): a BETA near 0 carries the f32 noise of the linear
    sums, large relative to itself and small against its SE.  With `refit`
    (the joint-model parity), a variant whose floats alone differ is passed
    as refit(rows of `a`, column index) to be held to an f64 fit instead:
    two f32 fits read plink2's loglik threshold through rounding of ~1e-7
    |ll| against the threshold's 1e-8 |ll|, so they may stop an iteration
    apart, and the SE then comes from different iterates (f64_variant).
    Returns the largest float difference as a fraction of what is allowed
    (<= 1), over the variants not held to f64."""
    ha, ra = read_report(a)
    hb, rb = read_report(b, limit=len(ra))
    assert ha == hb and len(ra) == len(rb), (a, b, ha, hb, len(ra), len(rb))
    floats = {"OR", "LOG(OR)_SE", "BETA", "SE", "P", *STAT_COLS}
    idc = ha.index("ID") if "ID" in ha else None
    worst, bad = {}, []  # worst: the largest fraction of each variant
    for x, y in zip(ra, rb):
        vid = x[idc] if idc is not None else None
        for col, u, v in zip(ha, x, y):
            if col in floats and u != "NA" and v != "NA" and u != v:
                allowed = float_allowed(col, float(v))
                if beta_by_se and col == "BETA" and y[ha.index("SE")] != "NA":
                    allowed = GLM_FLOAT_RTOL * max(abs(float(v)),
                                                   float(y[ha.index("SE")]))
                frac = abs(float(u) - float(v)) / allowed
                worst[vid] = max(worst.get(vid, 0.0), frac)
                ok = frac <= 1.0
            else:
                ok = u == v
            if not ok:
                bad.append((col, x, y))
    if refit is not None and bad:
        floats_only = {x[idc] for c, x, _ in bad if c in floats}
        floats_only -= {x[idc] for c, x, _ in bad if c not in floats}
        col = {c: ha.index(c) for c in ha}
        for vid in sorted(floats_only):
            refit([x for x in ra if x[idc] == vid], col)
            worst.pop(vid, None)
        bad = [(c, x, y) for c, x, y in bad if x[idc] not in floats_only]
    assert not bad, f"{len(bad)} cells differ; first: {bad[:3]}"
    return max(worst.values(), default=0.0)


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

    for attempt in (1, 2):
        # a short path's trace has come back once without its device
        # records (the untraced run's launch counts show the kernels ran):
        # such a trace is taken once more, and a second empty one fails
        torch.cuda.synchronize()
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
        if busy > 0:
            break
        log(f"trace {label}: attempt {attempt} recorded no device work")
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
    """Phase 5: the QC + linear path on the card, N_QC_ROWS rows of its
    count reports against numpy counts (check_qc_rows), and 64 report rows
    against numpy's least squares."""
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
    check_qc_rows(torch, prefix, out, n_variants)
    check_ols(prefix, out)
    return launches


def check_qc_rows(torch, prefix, out, n_variants):
    """N_QC_ROWS variants' .gcount / .vmiss / .afreq rows and N_QC_ROWS
    samples' .smiss rows of the QC path against numpy counts of the codes
    over the samples --mind kept (the .smiss rows; every sample a founder,
    all variants autosomal): counts exact, F_MISS and ALT_FREQS to the
    printed digits.  (This replaced a CPU run of the whole path, ~46 s;
    the parity panel's qc_linear case holds every report, .hardy too, CUDA
    against CPU byte for byte.)"""
    import numpy as np

    from plink_torch.dataset import load_dataset

    ds = load_dataset(prefix, torch.device("cpu"))
    hdr, srows = read_report(out + ".smiss")
    kept = np.isin(ds.si.iid.astype(str), [r[0] for r in srows])
    vidx = np.linspace(0, n_variants - 1, N_QC_ROWS).round().astype(np.int64)
    c = pgen_codes(prefix, vidx)[:, kept]
    cts = np.stack([(c == k).sum(1) for k in range(4)], 1)
    nonmiss = cts[:, :3].sum(1)
    for ext, cols in ((".gcount", {"HOM_REF_CT": cts[:, 0], "HET_REF_ALT_CTS": cts[:, 1],
                                   "TWO_ALT_GENO_CTS": cts[:, 2], "HAP_REF_CT": 0 * nonmiss,
                                   "HAP_ALT_CTS": 0 * nonmiss, "MISSING_CT": cts[:, 3]}),
                      (".vmiss", {"MISSING_CT": cts[:, 3], "OBS_CT": nonmiss + cts[:, 3]}),
                      (".afreq", {"OBS_CT": 2 * nonmiss})):
        h, rows = read_report(out + ext)
        r = [rows[v] for v in vidx]
        for col, want in cols.items():
            assert [int(x[h.index(col)]) for x in r] == want.tolist(), (ext, col)
        if ext == ".vmiss":
            _held(".vmiss F_MISS", [x[h.index("F_MISS")] for x in r],
                  cts[:, 3] / (nonmiss + cts[:, 3]), 1.0)
        if ext == ".afreq":
            _held(".afreq ALT_FREQS", [x[h.index("ALT_FREQS")] for x in r],
                  (cts[:, 1] + 2 * cts[:, 2]) / (2 * nonmiss), 1.0)
    sidx = np.linspace(0, len(srows) - 1, N_QC_ROWS).round().astype(np.int64)
    raw = np.flatnonzero(kept)[sidx]
    miss = (_sample_codes(ds, raw) == 3).sum(0)
    assert [int(srows[i][hdr.index("MISSING_CT")]) for i in sidx] == miss.tolist()
    assert {int(srows[i][hdr.index("OBS_CT")]) for i in sidx} == {n_variants}
    _held(".smiss F_MISS", [srows[i][hdr.index("F_MISS")] for i in sidx],
          miss / n_variants, 1.0)
    log(f"QC reports: {N_QC_ROWS} rows of .gcount / .vmiss / .afreq and "
        f"{N_QC_ROWS} of .smiss ({int(kept.sum())} samples kept) = numpy counts "
        f"(F_MISS, ALT_FREQS to the printed digits)")


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
    5) and N_LD_ROWS of its rows against numpy; K12 launched once (one
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


def resid_argv(prefix, out):
    return ["--pfile", prefix, "--glm", "cc-residualize", "hide-covar", "--covar",
            prefix + ".cov", "--out", out, "--silent"]


def xm1_argvs(xprefix, prefix, out):
    """The --xchr-model 1 paths on the chrX copy: logistic on PHENO1 and
    linear on QT1, 'no-x-sex' as the .cov already holds SEX."""
    base = ["--pfile", xprefix, "--covar", prefix + ".cov", "--xchr-model", "1"]
    return {"logistic": base + ["--glm", "hide-covar", "no-x-sex", "--out", out,
                                "--silent"],
            "linear": base + ["--pheno", prefix + ".qt", "--pheno-name", "QT1",
                              "--glm", "hide-covar", "no-x-sex", "--out",
                              out + "_qt", "--silent"]}


def _f64_logit(X, y, off=0.0, firth=False, with_hinv=False):
    """plink_torch.testing.f64_logit (plink2's logistic / Firth rules in
    numpy f64, with a fixed offset), which must converge.  Returns (beta,
    SE, P) of every column (and, `with_hinv`, the covariance the SE come
    from)."""
    import numpy as np
    from scipy.special import ndtr

    from plink_torch.testing import f64_logit

    b, se, hinv, conv = f64_logit(X, y, off, firth)
    assert conv, "the f64 reference fit did not converge"
    p = 2.0 * ndtr(-np.abs(b / se))
    return (b, se, p, hinv) if with_hinv else (b, se, p)


def _check_rows(label, rows, hdr, fit_row, n_rows):
    """n_rows rows of a report (every FIRTH?=Y row first, then rows spread
    over the report), each against `fit_row(row) -> (obs, a1_freq, beta,
    se, p)` computed in numpy f64: OBS_CT and A1_FREQ exact, OR / BETA, SE
    and P within float_allowed.  Rows with an ERRCODE other than '.' are
    skipped (their count is printed)."""
    from plink_torch.utils.fmt import g6

    col = {c: hdr.index(c) for c in hdr}
    ok = [r for r in rows if r[col["ERRCODE"]] == "."]
    fi = col.get("FIRTH?")
    pick = [r for r in ok if fi is not None and r[fi] == "Y"][: n_rows // 2]
    rest = [r for r in ok if r not in pick]
    step = max(1, len(rest) // max(1, n_rows - len(pick)))
    pick += rest[::step][: n_rows - len(pick)]
    worst = 0.0
    for r in pick:
        obs, a1f, beta, se, p = fit_row(r)
        assert r[col["OBS_CT"]] == str(obs), (label, r, obs)
        assert r[col["A1_FREQ"]] == g6(a1f), (label, r, a1f)
        eff = ("OR", math.exp(beta)) if "OR" in col else ("BETA", beta)
        se_col = "LOG(OR)_SE" if "OR" in col else "SE"
        for c, y in (eff, (se_col, se), ("P", p)):
            frac = abs(float(r[col[c]]) - y) / float_allowed(c, y)
            assert frac <= 1.0, (label, c, r, y)
            worst = max(worst, frac)
    firth_y = sum(1 for r in pick if fi is not None and r[fi] == "Y")
    log(f"{label}: {len(pick)} rows ({firth_y} FIRTH?=Y) = numpy f64: OBS_CT and "
        f"A1_FREQ exact, OR/BETA, SE, P within {worst:.3f} of their tolerance; "
        f"{len(rows) - len(ok)} rows with an ERRCODE skipped")


def _panel_design(prefix):
    """[1 | SEX | PC1..PC10] f64 and PHENO1 / QT1 of a main-path panel."""
    import numpy as np

    cov = np.loadtxt(prefix + ".cov", skiprows=1, usecols=range(1, 12))
    C = np.column_stack([np.ones(len(cov)), cov])
    with open(prefix + ".psam") as f:
        hdr = f.readline().rstrip("\n").split("\t")
        cols = [ln.rstrip("\n").split("\t") for ln in f]
    y = np.array([r[hdr.index("PHENO1")] == "2" for r in cols], float)  # 2 = case
    sex = np.array([int(r[hdr.index("SEX")]) for r in cols])
    qt = np.loadtxt(prefix + ".qt", skiprows=1, usecols=1)
    return C, y, sex, qt


def _a1_dosage(prefix, r, col):
    """(A1 dosage of the row's variant, every sample; its valid mask)."""
    g = pgen_codes(prefix, [int(r[col["ID"]][3:])])[0]  # ID snp<v>
    dos = g.astype(float)
    if r[col["A1"]] != r[col["ALT"]]:
        dos = 2.0 - dos
    return dos, g != 3


def run_resid_path(torch, prefix, out, card, n_variants):
    """Phase 4b: `--glm cc-residualize hide-covar` at 500,000 x n_variants:
    K2 and the residualized K3 (logistic, and firth2 for the fallback rows)
    must have launched; N_CHECK_ROWS rows against numpy f64 fits of the centred A1
    dosage with the null model's linear predictor as offset (the logistic
    null for FIRTH?=N rows, the Firth null for FIRTH?=Y)."""
    import numpy as np

    wall, launches = drive(torch, resid_argv(prefix, out), out)
    hdr, rows = read_report(out + ".PHENO1.glm.logistic.hybrid")
    assert len(rows) == n_variants, len(rows)
    col = {c: hdr.index(c) for c in hdr}
    errs = {}
    for r in rows:
        errs[r[col["ERRCODE"]]] = errs.get(r[col["ERRCODE"]], 0) + 1
    firth_y = sum(r[col["FIRTH?"]] == "Y" for r in rows)
    assert errs.get(".", 0) >= 0.9 * n_variants, errs
    assert all(launches[k] > 0 for k in RESID_KERNELS), launches
    assert launches["glm_irls"] == 0, launches  # no plain-design K3 here
    log(f"cc-residualize path: {N_SAMPLES} samples x {n_variants} variants: "
        f"{wall:.2f}s wall, {n_variants / wall:.0f} variants/s on {card}; ERRCODE "
        f"{errs}, FIRTH?=Y {firth_y}; launches {launches}")
    C, y, _sex, _qt = _panel_design(prefix)
    t0 = time.perf_counter()
    offs = {k: C @ _f64_logit(C, y, firth=k == "Y")[0] for k in "NY"}
    log(f"  null fits in numpy f64: {time.perf_counter() - t0:.1f}s")

    def fit_row(r):
        dos, ok = _a1_dosage(prefix, r, col)
        x = dos[ok] - dos[ok].mean()
        fit = _f64_logit(x[:, None], y[ok], offs[r[col["FIRTH?"]]][ok],
                         firth=r[col["FIRTH?"]] == "Y")
        return (int(ok.sum()), dos[ok].sum() / (2 * ok.sum()),
                *(v[-1] for v in fit))

    _check_rows("cc-residualize rows", rows, hdr, fit_row, N_CHECK_ROWS)
    return launches


def write_x_copy(prefix, dst, n_variants):
    """A copy of the panel whose second half of variants sits on chrX (the
    .pgen and .psam linked, the .pvar rewritten)."""
    for ext in (".pgen", ".psam"):
        os.symlink(prefix + ext, dst + ext)
    with open(prefix + ".pvar") as f, open(dst + ".pvar", "w") as g:
        g.write(f.readline())
        for i, ln in enumerate(f):
            g.write(("1" if i < n_variants // 2 else "X") + ln[ln.index("\t"):])


def run_xm1_paths(torch, prefix, tmp, card, n_variants):
    """Phase 5b: --xchr-model 1 on a copy with variants n/2.. on chrX:
    logistic (K14 and the scaled K2 / K3 on the chrX pass) and linear (K6
    three times on the chrX pass); N_CHECK_ROWS chrX rows of each against numpy f64
    fits with the males' A1 dosages halved."""
    import numpy as np

    xprefix = os.path.join(tmp, "xpanel")
    write_x_copy(prefix, xprefix, n_variants)
    out = os.path.join(tmp, "xm1")
    argvs = xm1_argvs(xprefix, prefix, out)
    C, y, sex, qt = _panel_design(prefix)
    s = np.where(sex == 1, 0.5, 1.0)
    found = {}
    for kind, argv in argvs.items():
        wall, launches = drive(torch, argv, argv[-2])
        ext = ".PHENO1.glm.logistic.hybrid" if kind == "logistic" else ".QT1.glm.linear"
        hdr, rows = read_report(argv[-2] + ext)
        assert len(rows) == n_variants, (kind, len(rows))
        col = {c: hdr.index(c) for c in hdr}
        errs = {}
        for r in rows:
            errs[r[col["ERRCODE"]]] = errs.get(r[col["ERRCODE"]], 0) + 1
        assert errs.get(".", 0) >= 0.9 * n_variants, (kind, errs)
        need = XM1_KERNELS if kind == "logistic" else XM1_LINEAR_KERNELS
        assert all(launches[k] > 0 for k in need), (kind, launches)
        log(f"--xchr-model 1 {kind} path: {N_SAMPLES} samples x {n_variants} "
            f"variants ({n_variants - n_variants // 2} on chrX): {wall:.2f}s wall "
            f"on {card}; ERRCODE {errs}; launches {launches}")
        xrows = [r for r in rows if r[0] == "X"]

        def fit_row(r, kind=kind, col=col):
            dos, ok = _a1_dosage(xprefix, r, col)
            g = (dos * s)[ok]
            X = np.column_stack([C[ok], g])
            a1f = g.sum() / (2 * s[ok].sum())
            if kind == "logistic":
                beta, se, p = (v[-1] for v in _f64_logit(
                    X, y[ok], firth=r[col["FIRTH?"]] == "Y"))
            else:
                from scipy.special import stdtr

                xtx_inv = np.linalg.inv(X.T @ X)
                b = xtx_inv @ (X.T @ qt[ok])
                res = qt[ok] - X @ b
                df = ok.sum() - X.shape[1]
                beta = b[-1]
                se = math.sqrt(res @ res / df * xtx_inv[-1, -1])
                p = 2.0 * stdtr(df, -abs(beta / se))
            return int(ok.sum()), a1f, beta, se, p

        _check_rows(f"--xchr-model 1 {kind} chrX rows", xrows, hdr, fit_row,
                    N_CHECK_ROWS)
        found[kind] = launches
    return found


def write_both(prefix, dst):
    """<dst>: the panel's PHENO1 (from its .psam) and QT1 (from its .qt) in
    one phenotype file, so one run fits the logistic and the linear report."""
    with open(prefix + ".psam") as f, open(prefix + ".qt") as q, \
            open(dst, "w") as g:
        hdr = f.readline().rstrip("\n").split("\t")
        q.readline()
        g.write("#IID\tPHENO1\tQT1\n")
        for ln, lq in zip(f, q):
            t = ln.rstrip("\n").split("\t")
            g.write(f"{t[0]}\t{t[hdr.index('PHENO1')]}\t{lq.split()[1]}\n")


def joint_argvs(prefix, both, cond, cond5, few):
    """The joint-model paths (slice 7): label -> (argv, report
    extensions)."""
    logi, lin = "PHENO1.glm.logistic.hybrid", "QT1.glm.linear"
    base = ["--pfile", prefix, "--covar", prefix + ".cov"]
    return {
        "genotypic": (base + ["--pheno", both, "--glm", "genotypic",
                              "hide-covar"], [logi, lin]),
        "interaction": (base + ["--pheno", both, "--glm", "interaction"],
                        [logi, lin]),
        "condition": (base + ["--pheno", both, "--glm", "dominant", "hide-covar",
                              "--condition-list", cond], [logi, lin]),
        "genotypic_cc_residualize": (base + ["--glm", "genotypic", "cc-residualize",
                                             "hide-covar"], [logi]),
        # d = 1 + 5 + 11 + 2 x 17 = 51 > 48: K4's block-per-matrix mode, on
        # 21 common variants (`few`: the host's f64 collinearity recheck of
        # a 500,000 x 51 design takes ~1 s a variant)
        "wide": (base + ["--glm", "genotypic", "interaction", "hide-covar",
                         "--condition-list", cond5, "--extract", few], [logi]),
    }


# plane weights (het, hom-ALT, valid) of each model column, A1 = ALT / REF
_MODEL_W = {"ADD": ((1, 2, 0), (-1, -2, 2)), "DOMDEV": ((1, 0, 0), (1, 0, 0)),
            "DOM": ((1, 1, 0), (0, -1, 1)), "REC": ((0, 1, 0), (-1, -1, 1)),
            "HET": ((1, 0, 0), (1, 0, 0)), "HOM": ((0, 1, 0), (-1, -1, 1))}
_MODELS = (("genotypic", ["ADD", "DOMDEV"]), ("hethom", ["HOM", "HET"]),
           ("dominant", ["DOM"]), ("recessive", ["REC"]), ("hetonly", ["HET"]))


def f64_variant(prefix, vrows, col, mods, C, cnames, keep, y, firth, offs=None,
                scale=None):
    """numpy f64 fits of one variant's report rows `vrows`: the logistic /
    Firth regression with plink2's stopping rules, at every stop an f32 fit
    can take under them (plink_torch.testing.f64_logit with slack 10; with
    `offs`, the residualized design [centred model columns] with the null
    model's offset {firth: offset}), or least squares, over [1 | C (columns
    `cnames`) | model columns | (interaction) model x covariate columns] and
    the samples in `keep` with the variant called, the model columns times
    the per-sample `scale` where one is given (--xchr-model 1 on chrX: 0.5
    for males).  Returns ([{TEST: (OR or
    BETA, SE, Z or T, P)}], obs), plink2's own stop first; GENO_2DF from the
    f64 joint test (Wald on the main effects' covariance for the logistic,
    the reduced model's F for the linear, P with (2, OBS_CT) degrees of
    freedom)."""
    import numpy as np
    from scipy.special import fdtrc, ndtr, stdtr

    from plink_torch.testing import f64_logit

    r = vrows[0]
    g = pgen_codes(prefix, [int(r[col["ID"]][3:])])[0]
    alt = r[col["A1"]] == r[col["ALT"]]
    ok_s = keep & (g != 3)
    g = g[ok_s]
    het, hom = (g == 1), (g == 2)
    model = next((m for k, m in _MODELS if k in mods), ["ADD"])
    Cs = C[ok_s]
    gcols = []
    for m in model:
        wm = _MODEL_W[m][0 if alt else 1]
        gcols.append((wm[0] * het + wm[1] * hom + wm[2])
                     * (1.0 if scale is None else scale[ok_s]))
    linear = "BETA" in col
    nobs = int(ok_s.sum())
    if offs is not None:
        names = list(model)
        X = np.column_stack(gcols)
        X = X - X.mean(axis=0)
        fits = f64_logit(X, y[ok_s], offs[firth][ok_s], firth=firth, slack=10.0)
    else:
        names = ["INTERCEPT", *cnames, *model]
        parts = [np.ones((g.size, 1)), Cs, np.column_stack(gcols)]
        if "interaction" in mods:
            names += [f"{m}x{c}" for m in model for c in cnames]
            parts += [gc[:, None] * Cs for gc in gcols]
        X = np.concatenate(parts, axis=1)
        if linear:
            xtx_inv = np.linalg.inv(X.T @ X)
            b = xtx_inv @ (X.T @ y[ok_s])
            res = y[ok_s] - X @ b
            sigma2 = res @ res / (X.shape[0] - X.shape[1])
            fits = [(b, np.sqrt(sigma2 * np.diag(xtx_inv)), None)]
        else:
            fits = f64_logit(X, y[ok_s], firth=firth, slack=10.0)
    out = []
    for b, se, hinv in fits:
        want = {}
        for i, n in enumerate(names):
            z = b[i] / se[i]
            p = 2.0 * stdtr(nobs - X.shape[1], -abs(z)) if linear \
                else 2.0 * ndtr(-abs(z))
            want[n] = (b[i] if linear else math.exp(b[i]), se[i], z, p)
        if len(model) == 2:
            mi = [names.index(m) for m in model]
            if linear:
                X0 = X[:, [i for i in range(len(names)) if i not in mi]]
                b0 = np.linalg.lstsq(X0, y[ok_s], rcond=None)[0]
                rss0 = float(((y[ok_s] - X0 @ b0) ** 2).sum())
                fstat = ((rss0 - float(res @ res)) / 2) / sigma2
            else:
                bm = b[mi]
                fstat = float(bm @ np.linalg.inv(hinv[np.ix_(mi, mi)]) @ bm) / 2
            want["GENO_2DF"] = (None, None, fstat, fdtrc(2, nobs, fstat))
        out.append(want)
    return out, nobs


def hold_to_f64(label, vrows, col, wants, nobs):
    """`vrows` against the f64 fits `wants` (f64_variant): OBS_CT exact;
    every row against one of the fits, OR / SE / P and the statistic within
    float_allowed, BETA within GLM_FLOAT_RTOL of max(|BETA|, SE).  Returns
    the largest difference as a fraction of what is allowed, under the fit
    that matches best."""
    linear = "BETA" in col
    eff_c, se_c = ("BETA", "SE") if linear else ("OR", "LOG(OR)_SE")
    stat_c = next(c for c in STAT_COLS if c in col)
    for r in vrows:
        assert r[col["OBS_CT"]] == str(nobs), (label, r, nobs)

    def worst(want):
        w = 0.0
        for r in vrows:
            eff, se_, stat, p = want[r[col["TEST"]]]
            for c, v in ((eff_c, eff), (se_c, se_), (stat_c, stat), ("P", p)):
                if v is None:
                    if r[col[c]] != "NA":
                        return math.inf
                    continue
                allowed = float_allowed(c, v)
                if c == "BETA":
                    allowed = GLM_FLOAT_RTOL * max(abs(v), se_)
                w = max(w, abs(float(r[col[c]]) - v) / allowed)
        return w

    best = min(worst(w) for w in wants)
    assert best <= 1.0, (label, best, vrows, wants[0])
    return best


def pmap(fn, items, workers=4):
    """[fn(x) for x in items] on a pool of threads: the numpy f64 reference
    fits spend their time in numpy calls on 500,000-row arrays, which
    release the interpreter lock (each reads its codes with its own
    memmap)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(fn, items))


def check_joint_rows(prefix, label, mods, path, C, cnames, keep, y, n_rows,
                     per_variant=4, offs=None):
    """n_rows rows of a joint-model report (per_variant rows from each of
    n_rows / per_variant variants spread over it, FIRTH?=Y variants first),
    each variant held to its numpy f64 fit (f64_variant, hold_to_f64)."""
    hdr, rows = read_report(path)
    col = {c: hdr.index(c) for c in hdr}
    by_vid = {}
    for r in rows:
        by_vid.setdefault(r[col["ID"]], []).append(r)
    ok = [v for v, rs in by_vid.items() if all(r[col["ERRCODE"]] == "." for r in rs)]
    fi = col.get("FIRTH?")
    firth_v = [v for v in ok if fi is not None and by_vid[v][0][fi] == "Y"]
    per_variant = min(per_variant, len(rows) // len(by_vid))
    n_var = n_rows // per_variant
    pick = firth_v[: n_var // 2]
    rest = [v for v in ok if v not in pick]
    pick += rest[:: max(1, len(rest) // max(1, n_var - len(pick)))][: n_var - len(pick)]
    worst, checked = 0.0, 0

    def fit(vid):
        vrows = by_vid[vid]
        return f64_variant(prefix, vrows, col, mods, C, cnames, keep, y,
                           fi is not None and vrows[0][fi] == "Y", offs)

    for vid, (wants, nobs) in zip(pick, pmap(fit, pick)):
        vrows = by_vid[vid]
        sel = vrows[:: max(1, len(vrows) // per_variant)][:per_variant]
        if "GENO_2DF" in wants[0] and vrows[-1] not in sel:
            sel[-1] = vrows[-1]
        worst = max(worst, hold_to_f64(label, sel, col, wants, nobs))
        checked += len(sel)
    assert checked >= n_rows * 3 // 4, (label, checked)
    log(f"{label}: {checked} rows of {len(pick)} variants ({len(firth_v)} FIRTH?=Y "
        f"variants in the report) = numpy f64 fits: OBS_CT exact, floats within "
        f"{worst:.3f} of their tolerance")


def run_joint_paths(torch, prefix, tmp, card, n_variants):
    """Phase 4c: the joint-model paths on a panel of the main one's width
    and n_variants variants (JOINT_VARIANTS: the host's f64 collinearity
    rechecks and emit of the genotypic models grow with the variants):
    genotypic (K2 / K3 with two columns), interaction (K15 / K16, d = 24),
    dominant with three --condition-list variants (dc = 15) and genotypic
    cc-residualize (K3 residualized at d = 2); each run writes the logistic
    and (but the residualized one) the linear report; 64 rows of each
    against numpy f64 fits.  Then genotypic interaction with five
    --condition-list variants on 21 of the panel's variants (d = 51: K15 /
    K16 and K4's block-per-matrix mode on the path; its wall and launches
    only).  The interaction path
    is traced.  Returns {label: launches}."""
    import numpy as np

    both = os.path.join(tmp, "joint.both")
    write_both(prefix, both)
    # common variants: those of the first 128 with an ALT frequency in
    # [0.3, 0.7] (the conditions, then the wide path's 16)
    codes = pgen_codes(prefix, list(range(128)))
    freq = np.array([g[g != 3].mean() / 2 for g in codes])
    common = [v for v in range(128) if 0.3 <= freq[v] <= 0.7]
    assert len(common) >= 21, len(common)
    cond_all, cond_v = common[:5], common[:3]
    cond, cond5, few = (os.path.join(tmp, f"joint.{x}") for x in ("cond", "cond5",
                                                                  "few"))
    # the wide path's --extract keeps the five conditioned variants (a
    # condition outside the variant set is "not found")
    for path, vs in ((cond, cond_v), (cond5, cond_all), (few, common[:21])):
        with open(path, "w") as f:
            f.writelines(f"snp{v}\n" for v in vs)
    C, y, sex, qt = _panel_design(prefix)
    cnames = ["SEX"] + [f"PC{i}" for i in range(1, 11)]
    argvs = joint_argvs(prefix, both, cond, cond5, few)
    expect = {"genotypic": ("glm_moments_p2", "glm_irls_p2", "chol_small",
                            "linear_sums"),
              "interaction": ("glm_moments_wide", "glm_irls_wide", "chol_small",
                              "linear_sums"),
              "condition": ("glm_moments", "glm_irls", "chol_small", "linear_sums"),
              "genotypic_cc_residualize": ("glm_moments_p2", "glm_irls_resid_p2",
                                           "chol_small"),
              "wide": ("glm_moments_wide", "glm_irls_wide", "chol_small_wide")}
    found = {}
    for label, (argv, exts) in argvs.items():
        out = os.path.join(tmp, f"joint_{label}")
        wall, launches = drive(torch, argv + ["--out", out, "--silent"], out)
        assert all(launches[k] > 0 for k in expect[label]), (label, launches)
        found[label] = launches
        errs = {}
        for e in exts:
            hdr, rows = read_report(f"{out}.{e}")
            for r in rows:
                errs[r[hdr.index("ERRCODE")]] = errs.get(r[hdr.index("ERRCODE")], 0) + 1
        log(f"{label} path: {N_SAMPLES} samples x "
            f"{21 if label == 'wide' else n_variants} variants: "
            f"{wall:.2f}s wall on {card}; ERRCODE {errs}; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        if label == "wide":  # its kernels' modes are held to plain in 3c
            continue
        mods = set(argv[argv.index("--glm") + 1:])
        keep = np.ones(len(y), bool)
        Cp, cn = C[:, 1:], list(cnames)
        if label == "condition":
            # the conditioned variants' A1 dosages lead the covariates (the
            # model is dominant, the conditions additive); a sample missing
            # any of them drops out
            hdr, rows = read_report(f"{out}.{exts[0]}")
            a1 = {r[hdr.index("ID")]: r[hdr.index("A1")] == r[hdr.index("ALT")]
                  for r in rows}
            ccols = []
            for v, g in zip(cond_v, pgen_codes(prefix, cond_v)):
                d = g.astype(float)
                if not a1[f"snp{v}"]:
                    d = 2.0 - d
                keep &= g != 3
                ccols.append(d * (g != 3))  # additive: no coding modifier
            Cp, cn = np.column_stack(ccols + [Cp]), [f"snp{v}" for v in cond_v] + cn
        offs = None
        if label == "genotypic_cc_residualize":
            Cn = np.column_stack([np.ones(len(y)), Cp])
            offs = {f: Cn @ _f64_logit(Cn, y, firth=f)[0] for f in (False, True)}
        for e in exts:
            yy = y if "PHENO1" in e else qt
            check_joint_rows(prefix, f"{label} {e.split('.', 1)[1]} rows", mods,
                             f"{out}.{e}", Cp, cn, keep, yy, N_JOINT_ROWS,
                             offs=offs)
    trace_path(torch, argvs["interaction"][0]
               + ["--out", os.path.join(tmp, "joint_traced"), "--silent"],
               "interaction")
    return found


def run_joint_parity(tmp, prefix, n, m):
    """The joint models on the parity panel, CUDA against CPU by
    compare_reports (BETA against its SE): each genotype model, the additive
    interaction design (d = 24, on chr1 and, scaled, on the chrX copy of the
    modifier parity), --condition-list and genotypic cc-residualize.  The
    d = 36 design runs in phase 3c only: its CPU run alone would take about
    a minute here."""
    from plink_torch import cli

    both, nosex, xprefix = prefix + ".both", prefix + ".nosex.cov", prefix + "_x"
    cond = prefix + ".cond"
    with open(cond, "w") as f:
        f.write("snp3\nsnp11\n")
    cov = ["--covar", prefix + ".cov"]
    logi, lin = "PHENO1.glm.logistic.hybrid", "QT1.glm.linear"
    cases = (
        ("genotypic", ["--glm", "genotypic", *cov], [logi, lin]),
        ("hethom", ["--glm", "hethom", "hide-covar", *cov], [logi, lin]),
        ("dominant_no_firth", ["--glm", "dominant", "no-firth", "hide-covar", *cov],
         ["PHENO1.glm.logistic", lin]),
        ("recessive", ["--glm", "recessive", "hide-covar", *cov], [logi]),
        ("hetonly", ["--glm", "hetonly", "hide-covar", *cov], [logi]),
        ("interaction", ["--glm", "interaction", "hide-covar", *cov], [logi, lin]),
        ("condition_recessive", ["--glm", "hide-covar", *cov, "--condition-list",
                                 cond, "recessive"], [logi, lin]),
        ("genotypic_cc_residualize", ["--glm", "genotypic", "cc-residualize",
                                      "hide-covar", *cov], [logi]),
        ("interaction_xchr1", ["--pfile", xprefix, "--pheno", both, "--covar", nosex,
                               "--glm", "interaction", "hide-covar", "--xchr-model",
                               "1"], [logi, lin]),
    )
    import numpy as np

    C, y, sex, qt = _panel_design(prefix)
    cnames = ["SEX"] + [f"PC{i}" for i in range(1, 11)]
    held = []

    def refit_of(label, args, ext):
        """The f64 reference of a parity case's variant: a CUDA row that
        differs from the CPU one must match it at one of the stops an f32
        fit can take (f64_variant).  The chrX copy's variants take the
        PCs, then SEX as the chrX pass adds it, over the samples of known
        sex, with male dosages halved under --xchr-model 1."""
        rest = args[args.index("--glm") + 1:]
        mods = set(rest[: next((i for i, a in enumerate(rest) if a.startswith("--")),
                               len(rest))])
        Cp, cn, keep = C[:, 1:], list(cnames), np.ones(len(y), bool)
        if args[0] == "--pfile":  # the chrX copy with the .nosex.cov
            assert args[1] == xprefix and "--xchr-model" in args, args
            Cp, cn = C[:, 2:], cnames[1:]
        if "--condition-list" in args:  # recessive-coded snp3, snp11 lead
            ccols = []
            hdr, rows = read_report(f"{os.path.join(tmp, 'joint_cuda_' + label)}.{ext}")
            a1 = {r[hdr.index("ID")]: r[hdr.index("A1")] == r[hdr.index("ALT")]
                  for r in rows}
            for v, g in zip((3, 11), pgen_codes(prefix, [3, 11])):
                d = g.astype(float) if a1[f"snp{v}"] else 2.0 - g
                keep &= g != 3
                ccols.append(np.maximum(d - 1.0, 0.0) * (g != 3))
            Cp, cn = np.column_stack(ccols + [Cp]), ["snp3", "snp11"] + cn
        offs = None
        if "cc-residualize" in mods:
            Cn = np.column_stack([np.ones(len(y)), Cp])
            offs = {f: Cn @ _f64_logit(Cn, y, firth=f)[0] for f in (False, True)}

        def refit(rows, col):
            fi = col.get("FIRTH?")
            firth = ext.endswith("glm.firth") or (fi is not None and rows[0][fi] == "Y")
            cp_, cn_, keep_, scale = Cp, cn, keep, None
            if rows[0][col["#CHROM"]] == "X":
                cp_, cn_ = np.column_stack([Cp, sex]), cn + ["SEX"]
                keep_, scale = keep & (sex != 0), np.where(sex == 1, 0.5, 1.0)
            wants, nobs = f64_variant(prefix, rows, col, mods, cp_, cn_, keep_,
                                      qt if "QT1" in ext else y, firth, offs,
                                      scale)
            hold_to_f64(f"parity {label} {rows[0][col['ID']]}", rows, col, wants,
                        nobs)
            held.append(rows[0][col["ID"]])

        return refit

    os.environ["PLINK_TORCH_VB"] = "256"
    try:
        for label, args, exts in cases:
            outs, secs = {}, {}
            full = args if args[0] == "--pfile" else \
                ["--pfile", prefix, "--pheno", both] + args
            for tag, devname in (("cuda", "cuda"), ("cpu", "cpu")):
                os.environ["PLINK_TORCH_DEVICE"] = devname
                outs[tag] = os.path.join(tmp, f"joint_{tag}_{label}")
                t0 = time.perf_counter()
                rc = cli.main(full + ["--out", outs[tag], "--silent"])
                assert rc == 0, (label, tag, rc)
                secs[tag] = time.perf_counter() - t0
            held.clear()
            worst = max(compare_reports(f"{outs['cuda']}.{e}", f"{outs['cpu']}.{e}",
                                        beta_by_se=True, refit=refit_of(label, args, e))
                        for e in exts)
            log(f"parity {label} [{n}x{m}]: CUDA = CPU ({' '.join(exts)}; floats "
                f"within {worst:.2f} of their tolerance; {len(held)} variants "
                f"whose floats differ held to numpy f64 instead {held}; CUDA "
                f"{secs['cuda']:.1f}s, CPU {secs['cpu']:.1f}s)")
    finally:
        os.environ.pop("PLINK_TORCH_VB", None)
        os.environ.pop("PLINK_TORCH_DEVICE", None)


def run_modifier_parity(tmp, prefix, n, m):
    """The --glm modifiers on the parity panel, CUDA against CPU: every
    report by compare_reports (BETA against its SE), the .id files byte for
    byte.  PHENO1 and QT1
    in one phenotype file, so each run fits both reports; the chrX cases run
    on a copy with variants m/2.. on chrX and a .cov without SEX (the
    automatic chrX SEX covariate)."""
    from plink_torch import cli

    both, nosex = prefix + ".both", prefix + ".nosex.cov"
    write_both(prefix, both)
    with open(prefix + ".cov") as f, open(nosex, "w") as g:
        for ln in f:
            t = ln.rstrip("\n").split("\t")
            g.write("\t".join(t[:1] + t[2:]) + "\n")
    xprefix = prefix + "_x"
    write_x_copy(prefix, xprefix, m)
    cov = ["--covar", prefix + ".cov"]
    xbase = ["--pfile", xprefix, "--pheno", both, "--covar", nosex]
    logi, lin = "PHENO1.glm.logistic.hybrid", "QT1.glm.linear"
    cases = (
        ("transforms1", ["--glm", "hide-covar", *cov, "--covar-variance-standardize",
                         "--pheno-quantile-normalize"], [logi, lin], []),
        ("transforms2", ["--glm", *cov, "--variance-standardize", "PC1", "PC2",
                         "--covar-quantile-normalize", "PC3"], [logi, lin], []),
        ("no_covars_ids", ["--glm", "allow-no-covars", "pheno-ids"], [logi, lin],
         [logi + ".id", lin + ".id"]),
        ("sex", ["--glm", "sex", "hide-covar", "--covar", nosex], [logi, lin], []),
        ("cc_qt_residualize", ["--glm", "cc-residualize", "qt-residualize",
                               "hide-covar", *cov], [logi, lin], []),
        ("firth_residualize", ["--glm", "firth-residualize", "hide-covar", *cov],
         [logi], []),
        ("firth_firth_residualize", ["--glm", "firth", "firth-residualize",
                                     "hide-covar", *cov], ["PHENO1.glm.firth"], []),
        ("xchr0", xbase + ["--glm", "hide-covar", "--xchr-model", "0"],
         [logi, lin], []),
        ("xchr1", xbase + ["--glm", "hide-covar", "--xchr-model", "1"], [logi, lin],
         []),
        ("xchr1_residualize", xbase + ["--glm", "cc-residualize", "qt-residualize",
                                       "hide-covar", "--xchr-model", "1"],
         [logi, lin], []),
    )
    os.environ["PLINK_TORCH_VB"] = "256"
    try:
        for label, args, exts, ids in cases:
            if args[0] != "--pfile":
                args = ["--pfile", prefix, "--pheno", both] + args
            outs, secs = {}, {}
            for tag, devname in (("cuda", "cuda"), ("cpu", "cpu")):
                os.environ["PLINK_TORCH_DEVICE"] = devname
                outs[tag] = os.path.join(tmp, f"mod_{tag}_{label}")
                t0 = time.perf_counter()
                rc = cli.main(args + ["--out", outs[tag], "--silent"])
                assert rc == 0, (label, tag, rc)
                secs[tag] = time.perf_counter() - t0
            worst = max(compare_reports(f"{outs['cuda']}.{e}", f"{outs['cpu']}.{e}",
                                        beta_by_se=True) for e in exts)
            for e in ids:
                assert filecmp.cmp(f"{outs['cuda']}.{e}", f"{outs['cpu']}.{e}",
                                   shallow=False), (label, e)
            hdr, rows = read_report(f"{outs['cuda']}.{exts[0]}")
            firth_y = sum(r[hdr.index("FIRTH?")] == "Y" for r in rows) \
                if "FIRTH?" in hdr else 0
            log(f"parity {label} [{n}x{m}]: CUDA = CPU ({' '.join(exts + ids)}; "
                f"floats within {worst:.2f} of their tolerance; FIRTH?=Y rows "
                f"{firth_y}; CUDA {secs['cuda']:.1f}s, CPU {secs['cpu']:.1f}s)")
    finally:
        os.environ.pop("PLINK_TORCH_VB", None)
        os.environ.pop("PLINK_TORCH_DEVICE", None)


# each parity case runs on the card, on the CPU and on the card again
PARITY_RUNS = (("cuda1", "cuda"), ("cpu", "cpu"), ("cuda2", "cuda"))


def same_again(outs, *exts):
    """Assert a parity case's two card runs wrote byte-identical outputs."""
    for ext in exts:
        assert filecmp.cmp(outs["cuda1"] + ext, outs["cuda2"] + ext,
                           shallow=False), ("two CUDA runs differ", ext)


def run_parity(tmp):
    """Phase 8: the 2,000 x 800 panel through the port on the card and on
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
            for tag, devname in PARITY_RUNS:
                os.environ["PLINK_TORCH_DEVICE"] = devname
                outs[tag] = os.path.join(tmp, f"{tag}_{label}")
                t0 = time.perf_counter()
                rc = cli.main(argv_of(outs[tag]))
                assert rc == 0, (label, tag, rc)
                outs[tag + "_s"] = time.perf_counter() - t0
            for ext in exact_exts:
                assert filecmp.cmp(outs["cuda1"] + ext, outs["cpu"] + ext,
                                   shallow=False), (label, ext)
            for ext in glm_exts:
                a, b = (f"{outs[t]}.{ext}" for t in ("cuda1", "cpu"))
                worst = compare_reports(a, b)
                same_again(outs, "." + ext)
                hdr, rows = read_report(a)
                firth_y = 0
                if "FIRTH?" in hdr:
                    firth_y = sum(r[hdr.index("FIRTH?")] == "Y" for r in rows)
                    assert firth_y > 0, "no Firth fallback row on the parity panel"
                log(f"parity {label} {ext} [{n}x{m}]: CUDA = CPU (exact columns"
                    f"{' and ' + ' '.join(exact_exts) if exact_exts else ''}, "
                    f"floats within {worst:.2f} of their tolerance), two CUDA "
                    f"runs byte-identical, "
                    f"{len(rows)} rows, FIRTH?=Y rows {firth_y} (CUDA "
                    f"{outs['cuda1_s']:.1f}s, CPU {outs['cpu_s']:.1f}s)")
        os.environ["PLINK_TORCH_TILE"] = "512"
        keep = prefix + ".keep1000"
        with open(keep, "w") as f:
            f.writelines(f"per{i}\n" for i in range(1000))
        for label, flags, exts in REL_PARITY:
            flags = [a.format(keep=keep) for a in flags]
            outs = {}
            for tag, devname in PARITY_RUNS:
                os.environ["PLINK_TORCH_DEVICE"] = devname
                outs[tag] = os.path.join(tmp, f"{tag}_{label}")
                t0 = time.perf_counter()
                rc = cli.main(["--pfile", prefix, *flags, "--out", outs[tag],
                               "--silent"])
                assert rc == 0, (label, tag, rc)
                outs[tag + "_s"] = time.perf_counter() - t0
            for ext in exts:
                a, b = (outs[t] + ext for t in ("cuda1", "cpu"))
                assert relationship_output_close(ext, b, a, text_floor=1.0), \
                    (label, ext)
            same_again(outs, *exts)
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
            for tag, devname in PARITY_RUNS:
                os.environ["PLINK_TORCH_DEVICE"] = devname
                outs[tag] = os.path.join(tmp, f"{tag}_{label}")
                t0 = time.perf_counter()
                rc = cli.main(["--pfile", panels[panel], *flags, "--out",
                               outs[tag], "--silent"])
                assert rc == 0, (label, tag, rc)
                outs[tag + "_s"] = time.perf_counter() - t0
            for ext in exts:
                a, b = (outs[t] + ext for t in ("cuda1", "cpu"))
                assert relationship_output_close(ext, b, a), (label, ext)
            same_again(outs, *exts)
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


# ---------------------------------------------------------------------------
# slice 8: the dosage --glm (K17 / K18), --dummy, and K15 / K16 / K4 past
# d = 96
# ---------------------------------------------------------------------------


def dosage_panel(tmp):
    """The dosage paths' panel, written by the port's own --dummy
    (DOSAGE_DUMMY: 500,000 x DOSAGE_VARIANTS, 2% missing calls, 70% of the
    calls with a dosage), its SEX + 10 PCs .cov (make_cov, seed 43) and
    <prefix>.qt with a Gaussian QT1 (numpy seed 44).  The generator loops
    over variants on the host; its time is printed apart (it is not the
    path's)."""
    import numpy as np

    from plink_torch import cli
    from plink_torch.bench_gen import make_cov

    dprefix = os.path.join(tmp, "dpanel")
    t0 = time.perf_counter()
    os.environ["PLINK_TORCH_DEVICE"] = "cpu"  # the generator is host-only
    try:
        assert cli.main(DOSAGE_DUMMY + ["--out", dprefix, "--silent"]) == 0
    finally:
        os.environ.pop("PLINK_TORCH_DEVICE")
    make_cov(dprefix, 43)
    qt = np.random.default_rng(44).normal(size=N_SAMPLES)
    with open(dprefix + ".qt", "w") as f:
        f.write("#IID\tQT1\n")
        f.writelines(f"per{i}\t{v:.6f}\n" for i, v in enumerate(qt))
    log(f"dosage panel (plink_torch {' '.join(DOSAGE_DUMMY)}): "
        f"{time.perf_counter() - t0:.1f}s (the generator, not a path)")
    return dprefix


def dosage_inputs(torch, dprefix, dev, n_variants):
    """The dosage design of the panel's first n_variants variants as the
    dosage path builds it: uint16 A1 dosages (A1 = ALT) [n_variants, npad]
    and the table [1 | SEX | PC1..PC10 | PHENO1 | mask] f32 [npad, 14]."""
    import numpy as np

    from plink_torch.commands.glm_dosage import a1_dosages
    from plink_torch.dataset import load_dataset

    ds = load_dataset(dprefix, torch.device("cpu"))
    n = ds.raw_sample_ct
    npad = -(-n // 128) * 128
    inc = np.arange(n)
    U = a1_dosages(ds, range(n_variants), inc, np.ones(n_variants, bool))
    dos = torch.full((n_variants, npad), 65535, dtype=torch.uint16)
    dos[:, :n] = torch.from_numpy(U)
    cov = np.loadtxt(dprefix + ".cov", skiprows=1, usecols=range(1, 12))
    feat = np.zeros((npad, 14), np.float32)
    feat[:n, 0] = 1.0
    feat[:n, 1:12] = cov
    feat[:n, 12] = ds.si.phenos["PHENO1"].data
    feat[:n, 13] = 1.0
    return dos.to(dev), torch.from_numpy(feat).to(dev)


def dense_errs(torch, G, dos, feat, kind, out, args, sub):
    """A K17 / K18 result `out` on (dos, feat, *args) against the plain
    version in f32 (every row; chunked) and in f64 (rows `sub`), each entry
    normalised by its Cauchy-Schwarz bound: (err vs plain, err vs f64,
    largest absolute difference)."""
    dc = feat.shape[1] - 2
    if kind == "moments":
        p = chunked(torch, lambda sl: G.glm_dense_moments_plain(dos[sl], feat),
                    dos.shape[0], 128)
        r = G.glm_dense_moments_plain(dos[sub], feat.double())
        return (norm_err(torch, out, p, mat_scale(torch, p.double())),
                norm_err(torch, out[sub], r, mat_scale(torch, r)),
                float((out - p).abs().max()))
    beta, active, hinv = args
    km, kv, kl = out

    def plain(sl, dt=torch.float32):
        return G.glm_dense_irls_plain(dos[sl], feat.to(dt), beta[sl].to(dt),
                                      active[sl],
                                      None if hinv is None else hinv[sl].to(dt))

    pm, pv, pl = chunked(torch, plain, dos.shape[0], 128)
    rm, rv, _ = plain(sub, torch.float64)
    # X^T r against sqrt(sum valid x_j^2 * obs) (|r| <= 1 + h)
    mom = G.glm_dense_moments_plain(dos, feat)
    idx = list(range(dc)) + [dc + 1]
    vscale = torch.sqrt(torch.diagonal(mom[:, idx][:, :, idx], dim1=1, dim2=2)
                        .clamp(min=1e-30) * mom[:, :1, 0])
    assert not km[~active].any() and not kv[~active].any()
    # rows with samples; a row whose beta is not finite (a fit that failed)
    # gives NaN on both sides
    on = active & (mom[:, 0, 0] > 0)
    fin = torch.isfinite(pm).flatten(1).all(1) & torch.isfinite(pv).all(1)
    assert torch.equal(fin[on], (torch.isfinite(km).flatten(1).all(1)
                                 & torch.isfinite(kv).all(1))[on])
    on &= fin
    son = on[sub].clone()
    if hinv is not None:  # the hat value cancels terms of size cond(H0)
        son &= torch.linalg.cond(hinv[sub].double()) < 1e4
    em = norm_err(torch, km[on], pm[on], mat_scale(torch, pm[on].double()))
    ev = norm_err(torch, kv[on], pv[on], vscale[on])
    emr = norm_err(torch, km[sub][son], rm[son], mat_scale(torch, rm[son]))
    evr = norm_err(torch, kv[sub][son], rv[son], vscale[sub][son])
    if kl is not None:
        el = float(((kl - pl).abs() / pl.abs().clamp(min=1.0))[on].max())
        assert el <= TOL_LOGLIK, el
    return (max(em, ev), max(emr, evr),
            float(max((km - pm)[on].abs().max(), (kv - pv)[on].abs().max())))


def check_dense_kernels(torch, dev, dprefix):
    """Phase 3d: K17 and K18 (logistic at the OLS start, firth2 at beta = 0)
    on the dosage panel's first DOSAGE_BLOCK variants x 500,000 samples,
    SEX + 10 PCs (dc = 12), against their plain versions in f32 (every row)
    and f64 (JOINT_F64_ROWS rows), two runs identical, timed beside their
    bound and one library call (the decoded valid plane and dosage block by
    the per-sample table)."""
    from plink_torch.ops import glm as G

    vb = DOSAGE_BLOCK
    dos, feat = dosage_inputs(torch, dprefix, dev, vb)
    dc = feat.shape[1] - 2
    npad = feat.shape[0]
    sub = slice(0, JOINT_F64_ROWS)
    valid, g = G._dense_cols(dos, feat[:, -1])
    n_valid = float(valid.sum())
    rows = []

    k = G.glm_dense_moments(dos, feat)
    (e, er, mx), pms = timed(torch, lambda: dense_errs(torch, G, dos, feat,
                                                       "moments", k, (), sub))
    ints = [0, dc]  # obs and the case counts: integers, exact both sides
    p = G.glm_dense_moments_plain(dos[:64], feat)
    assert torch.equal(k[:64][:, ints][:, :, ints], p[:, ints][:, :, ints])
    assert e <= TOL_VS_PLAIN and er <= TOL_VS_F64, ("K17", e, er)
    assert torch.equal(k, G.glm_dense_moments(dos, feat)), "K17 runs differ"
    ms = time_ms(torch, lambda: G.glm_dense_moments(dos, feat), 5)
    D = dc + 2
    bound = _bound(n_valid * D * (D + 1), dos.numel() * 2
                   + (feat.numel() + k.numel()) * 4)
    t = feat[:, : dc + 1]
    ccfl = (t[:, :, None] * t[:, None, :]).reshape(npad, -1)
    vg = torch.cat([valid, g])
    libms = time_ms(torch, lambda: torch.matmul(vg, ccfl), 3)
    log(f"K17 glm_dense_moments [{vb}x{npad}, D={D}]: norm err vs plain {e:.2e}, "
        f"vs f64 ({JOINT_F64_ROWS} rows) {er:.2e}, counts exact, two runs "
        f"identical; {ms:.3f} ms, plain {pms:.1f} ms (with the f64 rows), bound "
        f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}), library "
        f"{libms:.3f} ms")
    rows.append(dict(name="glm_dense_moments", source="plink_torch/csrc/glm_dense.cu",
                     replaces="plink_tpu/ops/glm.py:689", max_abs_err=mx,
                     max_norm_err=e, tol=TOL_VS_PLAIN, max_norm_err_f64=er,
                     tol_f64=TOL_VS_F64, ms=ms, plain_ms=pms, **bound,
                     library_ms=libms))

    h0, rhs0 = G._ols_start(k, dc, 1)
    beta0, _, _ = G.chol_small(h0, rhs=rhs0)
    active = torch.isfinite(beta0).all(dim=1)
    zero = torch.zeros_like(beta0)
    Hz, _, _ = G.glm_dense_irls(dos, feat, zero, active)
    _, hz_inv, _ = G.chol_small(Hz, inverse=True)
    active &= torch.isfinite(hz_inv).flatten(1).all(dim=1)
    assert float(active.float().mean()) > 0.9, int(active.sum())
    out = {}
    tc = feat[:, :dc]
    cc = (tc[:, :, None] * tc[:, None, :]).reshape(npad, -1)
    libi = time_ms(torch, lambda: torch.matmul(vg, cc), 3)
    for mode, beta, hinv in (("logistic", beta0, None), ("firth2", zero, hz_inv)):
        res = G.glm_dense_irls(dos, feat, beta, active, hinv)
        (e, er, mx), pms = timed(torch, lambda: dense_errs(
            torch, G, dos, feat, "irls", res, (beta, active, hinv), sub))
        assert e <= TOL_VS_PLAIN and er <= TOL_VS_F64, ("K18", mode, e, er)
        again = G.glm_dense_irls(dos, feat, beta, active, hinv)
        assert torch.equal(res[0], again[0]) and torch.equal(res[1], again[1])
        ms = time_ms(torch, lambda: G.glm_dense_irls(dos, feat, beta, active,
                                                     hinv), 3)
        d = dc + 1
        ntri = d * (d + 1) // 2
        ops = n_valid * (2 * ntri + 4 * d + 12 + (2 * ntri if hinv is not None else 0))
        nbytes = dos.numel() * 2 + (feat.numel() + vb * (d * d + 2 * d + 5)
                                    + (vb * d * d if hinv is not None else 0)) * 4
        bound = _bound(ops, nbytes)
        log(f"K18 glm_dense_irls {mode} [{vb}x{npad}, d={d}, {int(active.sum())} "
            f"rows active]: norm err vs plain {e:.2e}, vs f64 {er:.2e}, two runs "
            f"identical; {ms:.3f} ms, plain {pms:.1f} ms (with the f64 rows), "
            f"bound {bound['bound_ms']:.3f} ms ({bound['bound_by']}), library "
            f"{libi:.3f} ms")
        out[mode] = dict(max_abs_err=mx, max_norm_err=e, max_norm_err_f64=er,
                         ms=ms, plain_ms=pms, **bound)
    la, lf = out["logistic"], out["firth2"]
    rows.append(dict(name="glm_dense_irls", source="plink_torch/csrc/glm_dense.cu",
                     replaces="plink_tpu/ops/glm.py:655", **la, tol=TOL_VS_PLAIN,
                     tol_f64=TOL_VS_F64, firth2_ms=lf["ms"],
                     firth2_plain_ms=lf["plain_ms"], firth2_bound_ms=lf["bound_ms"],
                     firth2_max_norm_err=lf["max_norm_err"], library_ms=libi))
    return rows


def check_wide128(torch, dev, prefix):
    """Phase 3d, the widths past 96: K15 / K16 (logistic and firth2) on the
    `interaction` design over 63 seeded Gaussian covariates (dc = 64, d =
    128: each variant's tile list split over two CTAs) for the main panel's
    first WIDE128_ROWS variants x 500,000 samples, and K4 at d = 128 and
    250 (the device-memory workspace) on seeded SPD matrices, against their
    plain versions.  Returns {row name: fields to add}."""
    import numpy as np

    from plink_torch.ops import glm as G

    packed_all, feat12, _ = main_path_inputs(torch, prefix, dev)
    vb = WIDE128_ROWS
    pk = packed_all[:vb].contiguous()
    npad = feat12.shape[0]
    n = N_SAMPLES
    rng = np.random.default_rng(64)
    cov = np.zeros((npad, 63), np.float32)
    cov[:n] = rng.normal(size=(n, 63))
    feat = torch.cat([feat12[:, :1], torch.from_numpy(cov).to(dev),
                      feat12[:, 12:]], 1).contiguous()  # [1 | 63 | y | mask]
    dc = 64
    add = torch.zeros((vb, 3), dtype=torch.float32, device=dev)
    add[:, 0], add[:, 1] = 1.0, 2.0
    gw3 = torch.stack([add] * dc, 1).contiguous()
    covj = tuple(range(dc))
    gwm = torch.cat([gw3, add[:, None]], 1).contiguous()
    out = {}
    k = G.glm_moments(pk, gwm, feat, None, covj + (0,))
    p, pms = timed(torch, lambda: G.glm_moments_plain(pk, gwm, feat, None,
                                                      covj + (0,)))
    e = norm_err(torch, k, p, mat_scale(torch, p.double()))
    assert e <= TOL_VS_PLAIN and torch.equal(
        k, G.glm_moments(pk, gwm, feat, None, covj + (0,))), ("K15 d=128", e)
    ms = time_ms(torch, lambda: G.glm_moments(pk, gwm, feat, None, covj + (0,)), 3)
    n_valid = float((unpack_codes(pk) != 3).sum())
    D = k.shape[1]
    bound = _bound(n_valid * D * (D + 1), pk.numel() + (feat.numel() + k.numel()) * 4)
    log(f"K15 moments d=128 [{vb}x{npad}, D={D}]: norm err vs plain {e:.2e}, "
        f"two runs identical; {ms:.3f} ms, plain {pms:.1f} ms, bound "
        f"{bound['bound_ms']:.3f} ms")
    out["glm_moments_wide"] = dict(d128_ms=ms, d128_plain_ms=pms,
                                   d128_bound_ms=bound["bound_ms"],
                                   d128_max_norm_err=e)
    h0, rhs0 = G._ols_start(k, dc, dc)
    beta0, _, _ = G.chol_small(h0, rhs=rhs0)
    act = torch.ones(vb, dtype=torch.bool, device=dev)
    zero = torch.zeros_like(beta0)
    Hz, _, _ = G.glm_irls_pass(pk, gw3, feat, zero, act, covj=covj)
    _, hz_inv, _ = G.chol_small(Hz, inverse=True)
    vscale = torch.sqrt(torch.diagonal(h0, dim1=1, dim2=2).clamp(min=1e-30)
                        * k[:, :1, 0])
    fields = {}
    for mode, beta, hinv in (("logistic", beta0, None), ("firth2", zero, hz_inv)):
        km, kv, kl = G.glm_irls_pass(pk, gw3, feat, beta, act, hinv, covj=covj)
        (pm, pv, pl), pms = timed(torch, lambda: G.glm_irls_pass_plain(
            pk, gw3, feat, beta, act, hinv, covj=covj))
        em = norm_err(torch, km, pm, mat_scale(torch, pm.double()))
        ev = norm_err(torch, kv, pv, vscale)
        el = 0.0 if kl is None else float(((kl - pl).abs() / pl.abs()).max())
        assert max(em, ev) <= TOL_VS_PLAIN and el <= TOL_LOGLIK, (mode, em, ev, el)
        again = G.glm_irls_pass(pk, gw3, feat, beta, act, hinv, covj=covj)
        assert torch.equal(km, again[0]) and torch.equal(kv, again[1]), mode
        ms = time_ms(torch, lambda: G.glm_irls_pass(pk, gw3, feat, beta, act, hinv,
                                                    covj=covj), 3)
        d = 128
        ntri = d * (d + 1) // 2
        ops = n_valid * (2 * ntri + 4 * d + 12 + (2 * ntri if hinv is not None else 0))
        bound = _bound(ops, pk.numel() + (feat.numel() + vb * (2 * d * d + 2 * d + 5))
                       * 4)
        log(f"K16 {mode} d=128 [{vb}x{npad}]: norm err vs plain H {em:.2e} vec "
            f"{ev:.2e}, loglik rel {el:.2e}, two runs identical; {ms:.3f} ms, "
            f"plain {pms:.1f} ms, bound {bound['bound_ms']:.3f} ms")
        pre = "d128_" if mode == "logistic" else "d128_firth2_"
        fields.update({pre + "ms": ms, pre + "plain_ms": pms,
                       pre + "bound_ms": bound["bound_ms"]})
    out["glm_irls_wide"] = fields
    for d, nm in ((128, 2048), (250, 256)):
        a = torch.from_numpy(np.random.default_rng(d).normal(size=(nm, d, d))).to(dev)
        h = (a @ a.transpose(1, 2) / d + torch.eye(d, device=dev,
                                                    dtype=torch.float64)).float()
        rhs = h[:, :, 0].contiguous()
        kx, ki, kd = G.chol_small(h, rhs=rhs, inverse=True, logdet=True)
        (px, pi, pdet), pms = timed(torch, lambda: G.chol_small_plain(h, rhs, True,
                                                                      True))
        ex = float(((kx - px).abs().amax(1) / px.abs().amax(1)).max())
        ei = float(((ki - pi).abs().amax((1, 2)) / pi.abs().amax((1, 2))).max())
        ed = float(((kd - pdet).abs() / pdet.abs().clamp(min=1.0)).max())
        assert max(ex, ei, ed) <= TOL_CHOL, (d, ex, ei, ed)
        ms = time_ms(torch, lambda: G.chol_small(h, rhs=rhs, inverse=True,
                                                 logdet=True), 3)
        bound = _bound(nm * (d ** 3 / 3 + 2 * d * d + d ** 3),
                       nm * (2 * d * d + 2 * d + 1) * 4)
        log(f"K4 chol_small [{nm},{d},{d}]{' (device-memory workspace)' if d > 240 else ''}"
            f": rel err solve {ex:.2e} inverse {ei:.2e} logdet {ed:.2e}; "
            f"{ms:.4f} ms, plain {pms:.1f} ms, bound {bound['bound_ms']:.4f} ms")
        out.setdefault("chol_small_wide", {}).update(
            {f"d{d}_ms": ms, f"d{d}_plain_ms": pms, f"d{d}_bound_ms": bound["bound_ms"]})
    return out


@contextlib.contextmanager
def keeping(torch, module, names):
    """Wrap the kernel wrappers `names` where `module` looks them up,
    keeping a copy of every call's arguments (a large tensor that several
    calls share unchanged is copied once).  Yields {name: [(args, kwargs)]}.
    Unlike `spying`, it copies: the dosage path refills one device buffer
    for every block."""
    real = {n: getattr(module, n) for n in names}
    calls = {n: [] for n in names}
    big = {}

    def keep(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.numel() * t.element_size() < 1 << 26:
            return t.clone()
        key = (t.data_ptr(), t._version, tuple(t.shape), t.dtype)
        if key not in big:
            big[key] = t.clone()
        return big[key]

    def wrap(n):
        def spy(*args, **kw):
            calls[n].append(([keep(a) for a in args],
                             {k: keep(v) for k, v in kw.items()}))
            return real[n](*args, **kw)
        return spy

    for n in names:
        setattr(module, n, wrap(n))
    try:
        yield calls
    finally:
        for n in names:
            setattr(module, n, real[n])


def check_dense_calls(torch, calls, label):
    """Every K17 / K18 / K4 launch a dosage path made, launched again on
    its inputs: K17 / K18 against the plain version in f32 (every row) and
    f64 (JOINT_F64_ROWS rows), K4 against its plain version on the rows an
    f32 factor resolves (cond < 1e4).  Returns a note."""
    from plink_torch.ops import glm as G

    sub = slice(0, JOINT_F64_ROWS)
    worst = {"K17": 0.0, "K18": 0.0, "K4": 0.0}
    for args, kw in calls["glm_dense_moments"]:
        e, er, _ = dense_errs(torch, G, *args, "moments",
                              G.glm_dense_moments(*args), (), sub)
        assert e <= TOL_VS_PLAIN and er <= TOL_VS_F64, (label, "K17", e, er)
        worst["K17"] = max(worst["K17"], e, er)
    for args, kw in calls["glm_dense_irls"]:
        dos, feat, beta, active = args[:4]
        hinv = kw.get("hinv", args[4] if len(args) > 4 else None)
        res = G.glm_dense_irls(dos, feat, beta, active, hinv)
        e, er, _ = dense_errs(torch, G, dos, feat, "irls", res,
                              (beta, active, hinv), sub)
        assert e <= TOL_VS_PLAIN and er <= TOL_VS_F64, (label, "K18", e, er)
        worst["K18"] = max(worst["K18"], e, er)
    for args, kw in calls["chol_small"]:
        h = args[0]
        rhs = kw.get("rhs", args[1] if len(args) > 1 else None)
        inv, ld = kw.get("inverse", False), kw.get("logdet", False)
        k = G.chol_small(h, rhs, inv, ld)
        p = G.chol_small_plain(h, rhs, inv, ld)
        fh = torch.isfinite(h).flatten(1).all(1)  # a failed fit's H is NaN
        eye = torch.eye(h.shape[1], dtype=torch.float64, device=h.device)
        good = fh & (torch.linalg.cond(torch.where(fh[:, None, None], h.double(),
                                                   eye)) < 1e4)
        for a, b in zip(k, p):
            if a is None or not good.any():
                continue
            a, b = a[good].flatten(1), b[good].flatten(1)
            e = float(((a - b).abs().amax(1) / b.abs().amax(1).clamp(min=1e-30)).max())
            assert e <= TOL_CHOL, (label, "K4", e)
            worst["K4"] = max(worst["K4"], e)
    n = {k: len(v) for k, v in calls.items()}
    return (f"{label}: every launch held to its plain version (K17 {n['glm_dense_moments']}"
            f", K18 {n['glm_dense_irls']}, K4 {n['chol_small']} calls; worst norm "
            f"err {worst['K17']:.2e} / {worst['K18']:.2e}, K4 rel {worst['K4']:.2e})")


def dosage_fits(ds, C, r, col, y, firth):
    """numpy f64 fits of a dosage report row's variant over [C | A1 dosage]
    and its valid samples: ([{"ADD": (OR or BETA, SE, Z or T, P)}] at every
    stop an f32 fit can take (f64_logit, slack 10; least squares for a
    linear row), OBS_CT, A1 dosage sum)."""
    import numpy as np
    from scipy.special import ndtr, stdtr

    from plink_torch.testing import f64_logit

    g = ds.dosage_row(int(r[col["ID"]][3:]))  # ID snp<v>
    if r[col["A1"]] != r[col["ALT"]]:
        g = 2.0 - g
    keep = np.isfinite(g)
    nobs = int(keep.sum())
    X = np.column_stack([C[keep], g[keep]])
    if "BETA" in col:
        xtx_inv = np.linalg.inv(X.T @ X)
        b = xtx_inv @ (X.T @ y[keep])
        res = y[keep] - X @ b
        se = np.sqrt(res @ res / (nobs - X.shape[1]) * np.diag(xtx_inv))
        t = b[-1] / se[-1]
        wants = [{"ADD": (b[-1], se[-1], t, 2.0 * stdtr(nobs - X.shape[1], -abs(t)))}]
    else:
        wants = [{"ADD": (math.exp(b[-1]), se[-1], b[-1] / se[-1],
                          2.0 * ndtr(-abs(b[-1] / se[-1])))}
                 for b, se, _ in f64_logit(X, y[keep], firth=firth, slack=10.0)]
    return wants, nobs, float(g[keep].sum())


def dosage_design(dprefix):
    """(the panel's Dataset on the CPU, [1 | SEX | PC1..PC10] f64)."""
    import numpy as np
    import torch

    from plink_torch.dataset import load_dataset

    cov = np.loadtxt(dprefix + ".cov", skiprows=1, usecols=range(1, 12))
    return (load_dataset(dprefix, torch.device("cpu")),
            np.column_stack([np.ones(len(cov)), cov]))


def check_dosage_rows(dprefix, label, path, y, n_rows):
    """n_rows rows of a dosage report (FIRTH?=Y rows first, then rows spread
    over it) against numpy f64 fits of [1 | SEX | PC1..PC10 | A1 dosage]
    over the variant's valid samples (dosage_fits): OBS_CT and A1_FREQ
    exact, the floats by hold_to_f64's rule."""
    from plink_torch.utils.fmt import g6

    ds, C = dosage_design(dprefix)
    hdr, rows = read_report(path)
    col = {c: hdr.index(c) for c in hdr}
    ok = [r for r in rows if r[col["ERRCODE"]] == "."]
    fi = col.get("FIRTH?")
    pick = [r for r in ok if fi is not None and r[fi] == "Y"][: n_rows // 2]
    rest = [r for r in ok if r not in pick]
    pick += rest[:: max(1, len(rest) // max(1, n_rows - len(pick)))][: n_rows - len(pick)]
    worst = 0.0
    for r in pick:
        wants, nobs, gsum = dosage_fits(ds, C, r, col, y,
                                        fi is not None and r[fi] == "Y")
        assert r[col["A1_FREQ"]] == g6(gsum / (2 * nobs)), (label, r)
        worst = max(worst, hold_to_f64(label, [r], col, wants, nobs))
    firth_y = sum(1 for r in pick if fi is not None and r[fi] == "Y")
    log(f"{label}: {len(pick)} rows ({firth_y} FIRTH?=Y) = numpy f64 fits of the "
        f"dosage design: OBS_CT and A1_FREQ exact, floats within {worst:.3f} of "
        f"their tolerance; {len(rows) - len(ok)} rows with an ERRCODE skipped")


def dosage_argvs(dprefix):
    """The dosage paths: label -> (argv, report extension, kernels that
    must launch)."""
    base = ["--pfile", dprefix, "--covar", dprefix + ".cov"]
    return {
        "dosage_logistic": (base + ["--glm", "hide-covar"],
                            "PHENO1.glm.logistic.hybrid", DOSAGE_KERNELS),
        "dosage_linear": (base + ["--pheno", dprefix + ".qt", "--glm", "hide-covar"],
                          "QT1.glm.linear", ("glm_dense_moments",)),
    }


def run_dosage_paths(torch, dprefix, tmp, card):
    """Phase 4d: `--glm hide-covar --covar` (logistic-hybrid on PHENO1) and
    the linear `--glm hide-covar` on QT1 over the 500,000 x
    DOSAGE_VARIANTS dosage panel: their kernels must have launched, every
    K17 / K18 / K4 launch is kept and held to its plain version, N_CHECK_ROWS rows of
    each report against numpy f64 fits; the logistic path is traced.
    Returns {label: launches}."""
    import numpy as np

    from plink_torch.ops import glm as G

    y = np.loadtxt(dprefix + ".psam", skiprows=1, usecols=2, dtype=str)
    ys = {"dosage_logistic": (y == "2").astype(float),
          "dosage_linear": np.loadtxt(dprefix + ".qt", skiprows=1, usecols=1)}
    found = {}
    for label, (argv, ext, expect) in dosage_argvs(dprefix).items():
        out = os.path.join(tmp, label)
        with keeping(torch, G, ("glm_dense_moments", "glm_dense_irls",
                                "chol_small")) as calls:
            wall, launches = drive(torch, argv + ["--out", out, "--silent"], out)
        assert all(launches[k] > 0 for k in expect), (label, launches)
        found[label] = launches
        hdr, rows = read_report(f"{out}.{ext}")
        assert len(rows) == DOSAGE_VARIANTS, len(rows)
        errs = {}
        for r in rows:
            errs[r[hdr.index("ERRCODE")]] = errs.get(r[hdr.index("ERRCODE")], 0) + 1
        firth_y = sum(r[hdr.index("FIRTH?")] == "Y" for r in rows) \
            if "FIRTH?" in hdr else 0
        log(f"{label} path: {N_SAMPLES} samples x {DOSAGE_VARIANTS} variants: "
            f"{wall:.2f}s wall, {DOSAGE_VARIANTS / wall:.0f} variants/s on {card}; "
            f"ERRCODE {errs}, FIRTH?=Y {firth_y}; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        t0 = time.perf_counter()
        log("  " + check_dense_calls(torch, calls, label)
            + f" ({time.perf_counter() - t0:.1f}s)")
        del calls
        torch.cuda.empty_cache()
        check_dosage_rows(dprefix, f"{label} rows", f"{out}.{ext}", ys[label],
                          N_CHECK_ROWS)
    trace_path(torch, dosage_argvs(dprefix)["dosage_logistic"][0]
               + ["--out", os.path.join(tmp, "dosage_traced"), "--silent"],
               "dosage logistic")
    return found


def run_dosage_parity(tmp):
    """Phase 17d: the dosage --glm on the first 128 variants of a
    DOSAGE_PARITY dosage panel (n >= 4,096: the device rows are reported),
    CUDA against CPU by compare_reports (BETA against its SE): hybrid, firth
    (K18's firth2 must launch), no-firth, qt-residualize and the host
    route's genotypic and interaction, each writing the logistic and the
    linear report; then `interaction` over 48 covariates (d = 98) on the
    hard-call parity panel's first 64 variants (the panel generator is
    counter-based: a 64-variant panel of its seed; the port scans every
    variant of a fileset, so an --extract of the whole panel would cost the
    d = 98 CPU reference ~800 variants' plain fits).  Two card runs of
    each give the same bytes."""
    import numpy as np

    from plink_torch import cli
    from plink_torch.bench_gen import make_cov

    n, m, seed = DOSAGE_PARITY
    prefix = os.path.join(tmp, "dsmall")
    os.environ["PLINK_TORCH_DEVICE"] = "cpu"
    try:
        assert cli.main(["--dummy", str(n), str(m), "0.02", "dosage-freq=0.7",
                         "--seed", str(seed), "--out", prefix, "--silent"]) == 0
    finally:
        os.environ.pop("PLINK_TORCH_DEVICE")
    make_cov(prefix, seed + 1)
    qt = np.random.default_rng(seed + 2).normal(size=n)
    with open(prefix + ".qt", "w") as f:
        f.write("#IID\tQT1\n")
        f.writelines(f"per{i}\t{v:.6f}\n" for i, v in enumerate(qt))
    write_both(prefix, prefix + ".both")
    small = os.path.join(tmp, "small64")
    make_panel(small, SMALL[0], 64, SMALL[2])
    write_both(small, small + ".both")
    rng = np.random.default_rng(65)
    with open(small + ".psam") as f:
        ids = [ln.split("\t", 1)[0] for ln in f][1:]
    with open(small + ".wide48.cov", "w") as f:
        f.write("#IID\t" + "\t".join(f"W{j}" for j in range(48)) + "\n")
        for i in ids:
            f.write(i + "\t" + "\t".join(f"{x:.5f}" for x in rng.normal(size=48))
                    + "\n")
    # the dosage cases take 128 of the panel's variants (cut from 200), for
    # the script's time (the host route fits every variant in f64 on both
    # sides)
    with open(prefix + ".ext128", "w") as f:
        f.writelines(f"snp{v}\n" for v in range(128))
    # the host route's cases (genotypic, interaction: the same f64 fits on
    # the card's machine and on the CPU) take 64 of them: cut 200 -> 64 in
    # slice 10, for the script's time
    with open(prefix + ".ext64", "w") as f:
        f.writelines(f"snp{v}\n" for v in range(64))
    ds, C = dosage_design(prefix)
    both = {p: np.loadtxt(p + ".both", skiprows=1, usecols=(1, 2))
            for p in (prefix, small)}
    C48 = np.loadtxt(small + ".wide48.cov", skiprows=1, usecols=range(1, 49))
    held = []

    def refit_of(label, ext):
        """A variant whose CUDA floats alone differ from the CPU run's is held
        to numpy f64 at one of the stops an f32 fit can take: the additive
        dosage design (dosage_fits), or the hard-call interaction design
        over the 48 covariates (f64_variant)."""
        yb = both[small if label == "interaction_d98" else prefix]
        y = yb[:, 1] if "QT1" in ext else (yb[:, 0] == 2).astype(float)

        def refit(rows, col):
            fi = col.get("FIRTH?")
            firth = ext.endswith("glm.firth") or (fi is not None and rows[0][fi] == "Y")
            if label == "interaction_d98":
                wants, nobs = f64_variant(small, rows, col, {"interaction"}, C48,
                                          [f"W{j}" for j in range(48)],
                                          np.ones(len(y), bool), y, firth)
            else:
                assert label not in ("genotypic", "interaction"), (label, rows)
                wants, nobs, _ = dosage_fits(ds, C, rows[0], col, y, firth)
            hold_to_f64(f"parity dosage {label} {rows[0][col['ID']]}", rows, col,
                        wants, nobs)
            held.append(rows[0][col["ID"]])

        return refit

    logi, lin = "PHENO1.glm.logistic.hybrid", "QT1.glm.linear"
    base = ["--pfile", prefix, "--pheno", prefix + ".both", "--covar", prefix + ".cov",
            "--extract", prefix + ".ext128"]
    base64 = base[:-1] + [prefix + ".ext64"]
    cases = (
        ("hybrid", base + ["--glm", "hide-covar"], [logi, lin], ()),
        ("firth", base + ["--glm", "firth", "hide-covar"], ["PHENO1.glm.firth", lin],
         ("glm_dense_firth",)),
        ("no_firth", base + ["--glm", "no-firth"], ["PHENO1.glm.logistic", lin], ()),
        ("qt_residualize", base + ["--glm", "qt-residualize", "hide-covar"],
         [logi, lin], ()),
        ("genotypic", base64 + ["--glm", "genotypic", "hide-covar"], [logi, lin], ()),
        ("interaction", base64 + ["--glm", "interaction"], [logi, lin], ()),
        ("interaction_d98", ["--pfile", small, "--pheno", small + ".both", "--covar",
                             small + ".wide48.cov", "--glm", "interaction",
                             "hide-covar"],
         [logi, lin], ("glm_moments_wide", "glm_irls_wide", "chol_small_wide")),
    )
    # 64-variant blocks: two blocks of the dosage panel's 128 variants, and
    # one of the d = 98 case's 64 (a block of the
    # default 2,048 rows would make its CPU reference 32 times longer)
    os.environ["PLINK_TORCH_VB"] = "64"
    try:
        for label, args, exts, must in cases:
            run_dosage_parity_case(tmp, label, args, exts, must, refit_of, held)
    finally:
        os.environ.pop("PLINK_TORCH_VB")


def run_dosage_parity_case(tmp, label, args, exts, must, refit_of, held):
    """One case of phase 17d: two card runs and a CPU run of `args`, the
    kernels `must` launched, the reports `exts` compared."""
    from plink_torch import cli
    from plink_torch.ops import _cuda

    outs, secs, launches = {}, {}, {}
    for tag, devname in (("cuda1", "cuda"), ("cpu", "cpu"), ("cuda2", "cuda")):
        os.environ["PLINK_TORCH_DEVICE"] = devname
        outs[tag] = os.path.join(tmp, f"dosage_{tag}_{label}")
        _cuda.reset_launches()
        t0 = time.perf_counter()
        try:
            rc = cli.main(args + ["--out", outs[tag], "--silent"])
        finally:
            os.environ.pop("PLINK_TORCH_DEVICE")
        assert rc == 0, (label, tag, rc)
        secs[tag] = time.perf_counter() - t0
        launches[tag] = dict(_cuda.LAUNCHES)
    assert all(launches["cuda1"][k] > 0 for k in must), (label, launches["cuda1"])
    held.clear()
    worst = max(compare_reports(f"{outs['cuda1']}.{e}", f"{outs['cpu']}.{e}",
                                beta_by_se=True, refit=refit_of(label, e))
                for e in exts)
    for e in exts:
        assert filecmp.cmp(f"{outs['cuda1']}.{e}", f"{outs['cuda2']}.{e}",
                           shallow=False), ("two CUDA runs differ", label, e)
    log(f"parity dosage {label}: CUDA = CPU ({' '.join(exts)}; floats within "
        f"{worst:.2f} of their tolerance; {len(held)} variants whose floats "
        f"differ held to numpy f64 instead {held}), two CUDA runs "
        f"byte-identical; "
        f"launches {({k: v for k, v in launches['cuda1'].items() if v})}; "
        f"CUDA {secs['cuda1']:.1f}s, CPU {secs['cpu']:.1f}s")


# ---------------------------------------------------------------------------
# slice 9: the --glm permutation tests (K19 / K20), --adjust, local
# covariates
# ---------------------------------------------------------------------------

PERM_B = 134  # permutations a linear batch at 500,000 samples: plink_tpu's
# max(16, min(256, 2^26 // n)); the Firth batch is max(4, min(64, 2^24 // n))
PERM_EFFECT = 0.05  # planted QT effect a genotype copy (t ~ 20 at 500,000)
PERM_MPERM = 268  # the linear mperm path: 2 batches of PERM_B (1,000 = 8
# batches until slice 11 and 536 = 4 until slice 12, cut for the script's
# time)
PERM_FIRTH_MPERM = 33  # the Firth path: one batch (66 = two until slice 11)
PERM_N_LINEAR = 64  # (variant, permutation) pairs held to numpy f64 OLS
PERM_N_FIRTH = 8  # (variant, permutation) pairs held to numpy f64 Firth (and
# the Firth path's variants: 16 -> 8 in slice 10, ~0.6 s of host refit each)
TOL_PERM_STAT = 1e-5  # K20 (f64 inside) vs its plain version in f64 on the
# same f32 inputs: the final rounding to f32, relative to max(|stat|, 1)
BF16_FLOP_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense: K19 runs each
# f32 product as three exact bf16 products there (csrc/linear_perm.cu)


def _perm_xty_scale(torch, G, pk, gw, c, Y, mask, covj, sscale=None):
    """Cauchy-Schwarz bounds on K19's outputs: sqrt(sum_s L_j^2 * sum_s
    Y_b^2) for xty [vb, d, B] and sum_s mask Y_b^2 for yy [vb, B]
    (decoded 128 rows at a time)."""
    def sq_of(sl):
        valid, gcols = G._plane_cols(pk[sl], G._gw3(gw[sl]), c, mask,
                                     G._covj(covj, gw.shape[1]), sscale)
        return torch.cat([valid @ (c * c)] + [(g * g).sum(1, keepdim=True)
                                              for g in gcols], 1)

    sq = chunked(torch, sq_of, pk.shape[0], 128)
    y2 = (Y * Y * mask[:, None]).sum(0)
    return torch.sqrt(sq[:, :, None] * y2[None, None, :]), y2[None, :]


def _xty_err(torch, k, p, scale):
    """Max |k - p| / scale over xty and yy (a zero column of Y, as the
    permutation paths pad it to K19's width, has scale 0 and reads 0 here
    when k = p = 0)."""
    return max(float(((k[0] - p[0]).abs() / scale[0].clamp(min=1e-30)).max()),
               float(((k[1] - p[1]).abs() / scale[1].clamp(min=1e-30)).max()))


def _stat_err(torch, k, p):
    """(max |k - p| / max(|p|, 1) over the finite entries, NaN where both
    are NaN)."""
    assert torch.equal(torch.isnan(k), torch.isnan(p)), "NaN places differ"
    fin = torch.isfinite(p)
    return float(((k - p).abs() / p.abs().clamp(min=1.0))[fin].max())


def check_perm_kernels(torch, dev, prefix):
    """Phase 3e: K19 (the permuted X^T y, y^T y) and K20 (t or joint F) on
    block 0 of phase 4's panel (2,048 variants x 500,000 samples, SEX + 10
    PCs, dc = 12) against PERM_B = 134 permuted QT1 columns (numpy seed
    71), at three designs: the additive model (P = 1), genotypic (P = 2,
    joint F over q = 2) and `interaction` (ADD and ADD x each covariate,
    the t of ADD).  K19 against its plain version in f32 on every row and
    in f64 on JOINT_F64_ROWS rows, each entry normalised by a
    Cauchy-Schwarz bound; K20 (which works in f64 on its f32 inputs)
    against its plain version in f64 on the same inputs, on every row.
    Two runs identical; each timed beside its bound and one library call
    (K19: an f32 torch.matmul, TF32 off, of the decoded valid plane by
    [c (*) Y | Y^2], 13 of its 14 rows at P = 1; K20: torch.bmm of the
    inverses by X^T y, its first product).  K19's bound is that of its
    tensor-core form (each f32 product as three exact bf16 products at the
    dense bf16 rate); the FP32 rate's is kept beside it."""
    import numpy as np

    from plink_torch.ops import glm as G

    packed_all, feat, _ = main_path_inputs(torch, prefix, dev)
    vb = 2048
    pk = packed_all[:vb]
    dc = feat.shape[1] - 2
    npad = feat.shape[0]
    c, mask = feat[:, :dc].contiguous(), feat[:, dc + 1].contiguous()
    qt = np.loadtxt(prefix + ".qt", skiprows=1, usecols=1).astype(np.float32)
    rng = np.random.default_rng(71)
    Yn = np.zeros((npad, PERM_B), np.float32)
    for b in range(PERM_B):
        Yn[:N_SAMPLES, b] = rng.permutation(qt)
    Y = torch.from_numpy(Yn).to(dev)
    del Yn
    add = torch.zeros((vb, 3), dtype=torch.float32, device=dev)
    add[:, 0], add[:, 1] = 1.0, 2.0  # ADD with A1 = ALT
    dom = torch.zeros_like(add)
    dom[:, 0] = 1.0
    designs = {  # name: (gw [vb, P, 3], covj, q)
        "additive": (add[:, None].contiguous(), (0,), 0),
        "genotypic": (torch.stack([add, dom], 1).contiguous(), (0, 0), 2),
        "interaction": (torch.stack([add] * dc, 1).contiguous(), tuple(range(dc)), 0),
    }
    sub = slice(0, JOINT_F64_ROWS)
    n_valid = float(unpack_codes(pk).ne(3).sum())
    res = {}
    for name, (gw, covj, q) in designs.items():
        P = gw.shape[1]
        k = G.linear_perm_xty(pk, gw, c, Y, mask, covj)
        again = G.linear_perm_xty(pk, gw, c, Y, mask, covj)
        assert torch.equal(k[0], again[0]) and torch.equal(k[1], again[1]), name
        del again
        p, pms = timed(torch, lambda: chunked(torch, lambda sl: G.linear_perm_xty_plain(
            pk[sl], gw[sl], c, Y, mask, covj), vb, 128))
        scale = _perm_xty_scale(torch, G, pk, gw, c, Y, mask, covj)
        e = _xty_err(torch, k, p, scale)
        max_abs = max(float((k[0] - p[0]).abs().max()), float((k[1] - p[1]).abs().max()))
        del p
        r = chunked(torch, lambda sl: G.linear_perm_xty_plain(
            pk[sub][sl], gw[sub][sl].double(), c.double(), Y.double(), mask.double(),
            covj), JOINT_F64_ROWS, 64)
        er = _xty_err(torch, (k[0][sub], k[1][sub]), r,
                      (scale[0][sub].double(), scale[1].double()))
        del r
        assert e <= TOL_VS_PLAIN and er <= TOL_VS_F64, (name, e, er)
        ms = time_ms(torch, lambda: G.linear_perm_xty(pk, gw, c, Y, mask, covj), 3)
        rows = dc + P + 1
        nbytes = pk.numel() + (gw.numel() + c.numel() + Y.numel() + mask.numel()
                               + k[0].numel() + k[1].numel()) * 4
        fp32 = _bound(2.0 * PERM_B * rows * n_valid, nbytes)
        bound = _bound(3 * 2.0 * PERM_B * rows * n_valid, nbytes, BF16_FLOP_PER_S)
        bound["fp32_bound_ms"] = fp32["bound_ms"]
        # K20 on the K2 / K15 and K4 inverses of the design
        (inv, inv0, nm), = G.perm_inverses(pk[None], gw[None], c, mask, covj, q)
        st = G.linear_perm_stat(inv, *k, nm, dc, q, inv0)
        st2 = G.linear_perm_stat(inv, *k, nm, dc, q, inv0)
        assert torch.equal(st.view(torch.int32), st2.view(torch.int32)), name
        dbl = (lambda t: None if t is None else t.double())
        ps, sms = timed(torch, lambda: G.linear_perm_stat_plain(
            inv.double(), k[0].double(), k[1].double(), nm.double(), dc, q, dbl(inv0)))
        es = _stat_err(torch, st, ps)
        assert es <= TOL_PERM_STAT, (name, es)
        e32 = _stat_err(torch, st, G.linear_perm_stat_plain(inv, *k, nm, dc, q, inv0))
        sms_ = time_ms(torch, lambda: G.linear_perm_stat(inv, *k, nm, dc, q, inv0), 10)
        sdev = device_ms(torch, lambda: G.linear_perm_stat(inv, *k, nm, dc, q, inv0))
        d = inv.shape[1]
        d0 = d - q
        sbound = _bound(vb * PERM_B * 2.0 * (d * d + d + (d0 * d0 + d0 if q else 0)),
                        (inv.numel() + (inv0.numel() if q else 0) + k[0].numel()
                         + 3 * k[1].numel() + nm.numel()) * 4)
        slib = time_ms(torch, lambda: torch.bmm(inv, k[0]), 10)
        sldev = device_ms(torch, lambda: torch.bmm(inv, k[0]))
        log(f"K19 linear_perm_xty {name} [{vb}x{npad}, P={P}, B={PERM_B}]: norm err "
            f"vs plain {e:.2e}, vs f64 ({JOINT_F64_ROWS} rows) {er:.2e}, two runs "
            f"identical; {ms:.3f} ms, plain {pms:.1f} ms, bound on the tensor "
            f"cores {bound['bound_ms']:.3f} ms ({bound['bound_by']}), at the FP32 "
            f"rate {fp32['bound_ms']:.3f} ms; K20 [{name}, d={d}, "
            f"q={q}]: err vs plain in f64 {es:.2e} (tol {TOL_PERM_STAT:g}), vs the "
            f"f32 plain {e32:.2e}, {int(torch.isnan(st[:, 0]).sum())} singular rows "
            f"NaN in both; {sms_:.4f} ms a wrapper call (device {sdev:.4f} ms), "
            f"plain {sms:.2f} ms, bound {sbound['bound_ms']:.4f} ms "
            f"({sbound['bound_by']}), bmm {slib:.4f} ms (device {sldev:.4f} ms)")
        res[name] = (dict(max_abs_err=max_abs, max_norm_err=e, tol=TOL_VS_PLAIN,
                          max_norm_err_f64=er, tol_f64=TOL_VS_F64, ms=ms,
                          plain_ms=pms, **bound),
                     dict(max_abs_err=float((st - ps).abs()[torch.isfinite(ps)].max()),
                          max_norm_err=es, tol=TOL_PERM_STAT, f32_plain_err=e32,
                          ms=sms_, device_ms=sdev, plain_ms=sms, **sbound,
                          library_ms=slib, library_device_ms=sldev))
        del k, st, st2, ps, scale, inv, inv0
        torch.cuda.empty_cache()
    # the library yardstick of K19: the valid plane by [c (*) Y | Y^2]
    valid_f = (unpack_codes(pk) != 3).to(torch.float32) * mask[None, :]
    cyy = torch.cat([c[:, j:j + 1] * Y for j in range(dc)] + [Y * Y], 1)
    lib = time_ms(torch, lambda: torch.matmul(valid_f, cyy), 3)
    del valid_f, cyy
    torch.cuda.empty_cache()
    x_add, s_add = res["additive"]
    extra = {f"{nm_}_{key}": res[nm_][0][key] for nm_ in ("genotypic", "interaction")
             for key in ("ms", "plain_ms", "bound_ms", "fp32_bound_ms")}
    sextra = {f"{nm_}_{key}": res[nm_][1][key] for nm_ in ("genotypic", "interaction")
              for key in ("ms", "device_ms", "bound_ms", "library_device_ms")}
    return [dict(name="linear_perm_xty", source="plink_torch/csrc/linear_perm.cu",
                 replaces="plink_tpu/ops/glm.py:1031", **x_add, library_ms=lib,
                 **extra),
            dict(name="linear_perm_stat", source="plink_torch/csrc/linear_perm.cu",
                 replaces="plink_tpu/ops/glm.py:1137", **s_add, **sextra)]


@contextlib.contextmanager
def recording(module, name):
    """Wrap `name` where `module` looks it up, keeping every call's
    (arguments, result).  Yields (calls, the real function)."""
    real, calls = getattr(module, name), []

    def rec(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out

    setattr(module, name, rec)
    try:
        yield calls, real
    finally:
        setattr(module, name, real)


def perm_argvs(prefix, permqt, firth_rows):
    """The permutation paths (slice 9): label -> argv.  The Firth path runs
    on the variants listed in `firth_rows`: at 500,000 samples no f32 Firth
    fit meets plink2's score test (|U*| < 1e-5; the f32 sums of U* carry
    more rounding than that), so the report refits every row in f64 on the
    host (as plink_tpu does), ~0.25 s a row."""
    base = ["--pfile", prefix, "--covar", prefix + ".cov"]
    lin = base + ["--pheno", permqt, "--glm", "hide-covar"]
    return {"linear_mperm": lin + [f"mperm={PERM_MPERM}", "--seed", "1"],
            "linear_aperm": lin + ["aperm", "--aperm", "6", "268", "--seed", "1"],
            "firth_mperm": base + ["--glm", "firth", "hide-covar",
                                   f"mperm={PERM_FIRTH_MPERM}",
                                   "--extract", firth_rows, "--seed", "1"]}


def check_perm_linear_pairs(prefix, stat, y, variants, perms, a1_alt):
    """PERM_N_LINEAR (variant, permutation) pairs of the path's first batch
    held to numpy f64 OLS: |t| of the A1 dosage in [1 | SEX | PC1..PC10 |
    g] over the variant's valid samples, on the permuted phenotype rebuilt
    from the seed (plink_tpu's stream: default_rng(1), one permutation a
    column of the f32 phenotype).  Within GLM_FLOAT_RTOL of max(|t|, 1)."""
    import numpy as np

    rng = np.random.default_rng(1)
    yt = np.stack([rng.permutation(y.astype(np.float32)) for _ in range(PERM_B)])
    C, *_ = _panel_design(prefix)

    def fit(vg):  # the variant's f64 OLS t on each permuted phenotype
        v, g = vg
        ok = g != 3
        gv = g[ok].astype(float) if a1_alt[v] else 2.0 - g[ok]
        X = np.column_stack([C[ok], gv])
        inv = np.linalg.inv(X.T @ X)
        ts = []
        for b in perms:
            yp = yt[b][ok].astype(np.float64)
            beta = inv @ (X.T @ yp)
            rss = float(yp @ yp - beta @ (X.T @ yp))
            ts.append(beta[-1] / np.sqrt(rss / (ok.sum() - X.shape[1]) * inv[-1, -1]))
        return ts

    worst = 0.0
    for v, ts in zip(variants, pmap(fit, list(zip(variants,
                                                  pgen_codes(prefix, variants))))):
        for b, t in zip(perms, ts):
            got = float(stat[v, b])
            frac = abs(abs(got) - abs(t)) / (GLM_FLOAT_RTOL * max(abs(t), 1.0))
            assert frac <= 1.0, ("perm t", v, b, got, t)
            worst = max(worst, frac)
    return worst


def check_perm_firth_pairs(prefix, stats, y, pairs, a1_alt):
    """PERM_N_FIRTH (variant, permutation) pairs of the Firth path's first
    batch held to numpy f64 Firth fits (plink_torch.testing.f64_logit, at
    any stop an f32 fit can take under plink2's rules: slack 10, and the
    converged f64 fit, which the f32 fit approaches without meeting the
    score test): |z| of the A1 dosage, within GLM_FLOAT_RTOL of max(|z|,
    1)."""
    import numpy as np

    from plink_torch.testing import f64_logit

    B = stats.shape[0]
    rng = np.random.default_rng(1)
    yt = np.stack([rng.permutation(y.astype(np.float32)) for _ in range(B)])
    C, *_ = _panel_design(prefix)

    def fit(pg):
        (v, b), g = pg
        ok = g != 3
        gv = g[ok].astype(float) if a1_alt[v] else 2.0 - g[ok]
        X = np.column_stack([C[ok], gv])
        return f64_logit(X, yt[b][ok].astype(np.float64), firth=True, slack=10)

    worst = 0.0
    codes = pgen_codes(prefix, [v for v, _ in pairs])
    for (v, b), fits in zip(pairs, pmap(fit, list(zip(pairs, codes)))):
        got = float(stats[b, v])
        fr = [abs(got - abs(bb[-1] / se[-1])) / (GLM_FLOAT_RTOL * max(
            abs(bb[-1] / se[-1]), 1.0)) for bb, se, _ in fits]
        assert min(fr) <= 1.0, ("perm Firth |z|", v, b, got, fits[0][:2])
        worst = max(worst, min(fr))
    return worst


def run_perm_paths(torch, prefix, tmp, card):
    """Phase 4e: the permutation paths on the joint-model panel (500,000 x
    JOINT_VARIANTS: one block; SEX + 10 PCs): the linear `--glm hide-covar
    mperm=268 --seed 1` (PERM_MPERM) and the same with `aperm --aperm 6
    268` (two
    batches: the planted variants run to the maximum) on QTP =
    QT1 + PERM_EFFECT x the ALT count of two common variants (the planted
    ones), and `--glm firth hide-covar mperm=33 --seed 1` on PHENO1 (the
    Firth IRLS at 500,000 samples on a path; on the PERM_N_FIRTH variants
    of `--extract`, see perm_argvs).  K19, K20, K2 and K4 (K3 for the Firth
    path) must have launched; every K19 / K20 launch of the
    linear paths is kept and run again against its plain version (K19 in
    f32 on the first JOINT_F64_ROWS rows of each launch; K20 against its
    f64 plain version on every row);
    PERM_N_LINEAR linear and PERM_N_FIRTH Firth (variant, permutation)
    pairs of the first batch against numpy f64 fits of the rebuilt
    permuted phenotype; the planted variants' EMP1 (and EMP2) at the floor
    1 / (N + 1).
    The linear mperm path is traced on one batch (mperm=134).  Returns
    {label: launches}."""
    import numpy as np

    from plink_torch.ops import glm as G
    from plink_torch.utils.fmt import g6

    codes = pgen_codes(prefix, list(range(64)))
    freq = np.array([gg[gg != 3].mean() / 2 for gg in codes])
    planted = [v for v in range(64) if 0.3 <= freq[v] <= 0.7][:2]
    C, y, sex, qt = _panel_design(prefix)
    qtp = qt + sum(PERM_EFFECT * np.where(codes[v] == 3, 0.0, codes[v])
                   for v in planted)
    permqt = os.path.join(tmp, "perm.qt")
    with open(permqt, "w") as f:
        f.write("#IID\tQTP\n")
        f.writelines(f"per{i}\t{v:.6f}\n" for i, v in enumerate(qtp))
    qtp = np.loadtxt(permqt, skiprows=1, usecols=1)  # as the CLI reads it
    firth_vars = [v for v in range(64) if 0.05 <= freq[v] <= 0.95][:PERM_N_FIRTH]
    firth_rows = os.path.join(tmp, "perm.firth_rows")
    with open(firth_rows, "w") as f:
        f.writelines(f"snp{v}\n" for v in firth_vars)
    argvs = perm_argvs(prefix, permqt, firth_rows)
    expect = {"linear_mperm": ("linear_perm_xty", "linear_perm_stat", "glm_moments",
                               "chol_small", "linear_sums"),
              "linear_aperm": ("linear_perm_xty", "linear_perm_stat", "glm_moments",
                               "chol_small", "linear_sums"),
              "firth_mperm": ("glm_irls", "chol_small", "glm_moments")}
    found = {}
    for label, argv in argvs.items():
        out = os.path.join(tmp, f"perm_{label}")
        with contextlib.ExitStack() as st:
            if label.startswith("linear"):
                xcalls = st.enter_context(recording(G, "linear_perm_xty"))[0]
                scalls = st.enter_context(recording(G, "linear_perm_stat"))[0]
            else:
                fcalls = st.enter_context(recording(G, "firth_perm_multi_scan"))[0]
            wall, launches = drive(torch, argv + ["--out", out, "--silent"], out)
        assert all(launches[k] > 0 for k in expect[label]), (label, launches)
        found[label] = launches
        suffix = {"linear_mperm": "QTP.glm.linear.mperm",
                  "linear_aperm": "QTP.glm.linear.aperm",
                  "firth_mperm": "PHENO1.glm.firth.mperm"}[label]
        hdr, rows = read_report(f"{out}.{suffix}")
        assert len(rows) == (JOINT_VARIANTS if label.startswith("linear")
                             else PERM_N_FIRTH), len(rows)
        col = {c_: hdr.index(c_) for c_ in hdr}
        a1_alt = {int(r[col["ID"]][3:]): r[col["A1"]] == r[col["ALT"]] for r in rows}
        note = ""
        if label.startswith("linear"):
            n_perm = 268 if "aperm" in label else PERM_MPERM
            floor = g6(1.0 / (n_perm + 1))  # no permutation reached the original
            for v in planted:
                r = rows[v]
                assert r[col["EMP1"]] == floor, (label, r)
                assert (r[col["PERM_CT"]] == str(n_perm) if "aperm" in label
                        else r[col["EMP2"]] == floor), (label, r)
            # every launch of the path against the plain version on its
            # inputs: K19 on its first JOINT_F64_ROWS rows, K20 (f64 inside)
            # against the f64 plain version on every row
            sub = slice(0, JOINT_F64_ROWS)
            e19 = e20 = 0.0
            for args, kw, k in xcalls:
                pk, gw, c_, Y, mask, covj, ss = args
                p = G.linear_perm_xty_plain(pk[sub], gw[sub], c_, Y, mask, covj, ss)
                scale = _perm_xty_scale(torch, G, pk[sub], gw[sub], c_, Y, mask, covj,
                                        ss)
                e19 = max(e19, _xty_err(torch, (k[0][sub], k[1][sub]), p, scale))
            for args, kw, out_ in scalls:
                inv, xty, yy, nm, tc, q, inv0 = args
                dbl = (lambda t: None if t is None else t.double())
                p = G.linear_perm_stat_plain(inv.double(), xty.double(), yy.double(),
                                             nm.double(), tc, q, dbl(inv0))
                e20 = max(e20, _stat_err(torch, out_, p))
            assert e19 <= TOL_VS_PLAIN and e20 <= TOL_PERM_STAT, (label, e19, e20)
            note = (f"; every launch held to its plain version (K19 {len(xcalls)}, "
                    f"worst norm err {e19:.2e}; K20 {len(scalls)}, worst err "
                    f"{e20:.2e})")
            if label == "linear_mperm":
                stat = scalls[0][2].cpu().numpy()
                variants = planted + [v for v in range(100, JOINT_VARIANTS,
                                                       (JOINT_VARIANTS - 100) // 12)
                                      if 0.05 <= freq_of(prefix, v) <= 0.95][:6]
                perms = list(range(0, PERM_B, PERM_B // 8))[:8]
                assert len(variants) * len(perms) == PERM_N_LINEAR
                worst = check_perm_linear_pairs(prefix, stat, qtp, variants, perms,
                                                a1_alt)
                note += (f"; {PERM_N_LINEAR} (variant, permutation) t = numpy f64 "
                         f"OLS within {worst:.3f} of their tolerance")
        else:
            args, kw, stats = fcalls[0]
            stats = stats[:, 0].cpu().numpy()  # [B, vb] of the one block
            pairs = [(v, (7 * i) % stats.shape[0]) for i, v in enumerate(firth_vars)]
            assert len(pairs) == PERM_N_FIRTH
            worst = check_perm_firth_pairs(prefix, stats, y, pairs, a1_alt)
            per_perm = launches["glm_irls"] / PERM_FIRTH_MPERM
            note = (f"; {PERM_N_FIRTH} (variant, permutation) |z| = numpy f64 Firth "
                    f"within {worst:.3f} of their tolerance; K3 {per_perm:.1f} "
                    f"launches a permutation (logistic + firth2 each iteration)")
        log(f"{label} path: {N_SAMPLES} samples x {len(rows)} variants: "
            f"{wall:.2f}s wall on {card}; launches "
            f"{ {k: v for k, v in launches.items() if v} }{note}")
    trace_path(torch, argvs["linear_mperm"][:-3] + ["mperm=134", "--seed", "1",
                                                     "--out", os.path.join(
                                                         tmp, "perm_traced"),
                                                     "--silent"],
               "linear mperm (one batch)")
    return found


def freq_of(prefix, v):
    """Variant v's ALT frequency over its calls."""
    g = pgen_codes(prefix, [v])[0]
    return float(g[g != 3].mean() / 2)


def run_perm_parity(tmp, prefix, n, m):
    """Phase 17e: the permutation tests, --adjust and local covariates on
    the parity panel, CUDA against CPU: linear mperm=200 (+ --adjust),
    aperm (--aperm 6 400), genotypic mperm with perm-count, interaction
    mperm, linear mperm on the chrX copy with the SEX-less .cov (ploidy
    groups), local covariates (every 30th variant, two local columns; +
    --adjust), and firth mperm=20 (+ --adjust) on a 2,000 x 256 panel of
    the same generator (seed 5): its CPU run took ~1 s a permutation on
    the parity panel's 1,200 variants (800 since slice 16).  Permutation
    reports by plink_torch.testing.perm_report_close, .adjusted by
    adjusted_close, the local-covariate report by compare_reports; two card
    runs byte-identical."""
    import numpy as np

    from plink_torch import cli
    from plink_torch.testing import adjusted_close, perm_report_close

    nosex, xprefix = prefix + ".nosex.cov", prefix + "_x"
    qt = ["--pheno", prefix + ".qt", "--pheno-name", "QT1"]
    cov = ["--covar", prefix + ".cov"]
    # the local covariates: every 30th variant, two columns a sample
    rng = np.random.default_rng(91)
    with open(prefix + ".psam") as f:
        ids = [ln.split()[0] for ln in f.readlines()[1:]]
    with open(prefix + ".pvar") as f:
        pv = [ln for ln in f if not ln.startswith("##")]
    with open(prefix + ".loc.psam", "w") as f:
        f.write("#IID\n" + "".join(f"{i}\n" for i in ids))
    with open(prefix + ".loc.pvar", "w") as f:
        f.writelines([pv[0]] + pv[1::30])
    with open(prefix + ".loc.cov", "w") as f:
        for _ in pv[1::30]:
            f.write(" ".join(f"{a:.4f} {b:.4f}" for a, b in
                             rng.normal(size=(len(ids), 2))) + "\n")
    local = [f"local-covar={prefix}.loc.cov", f"local-psam={prefix}.loc.psam",
             f"local-pvar={prefix}.loc.pvar"]
    fprefix = prefix + "_f256"
    make_panel(fprefix, n, 256, 5)
    lin, fir = "QT1.glm.linear", "PHENO1.glm.firth"
    cases = (  # label, argv after the fileset, [(file, kind, N)]
        ("linear_mperm_adjust", qt + cov + ["--glm", "hide-covar", "mperm=200",
                                            "--seed", "2", "--adjust"],
         [(f"{lin}.mperm", "perm", 200), (f"{lin}.adjusted", "adjusted", 0)]),
        ("aperm", qt + cov + ["--glm", "hide-covar", "aperm", "--aperm", "6", "400",
                              "--seed", "2"], [(f"{lin}.aperm", "perm", 400)]),
        ("firth_mperm_adjust", ["--pfile", fprefix, "--covar", fprefix + ".cov",
                                "--glm", "firth", "hide-covar", "mperm=20",
                                "--seed", "2", "--adjust"],
         [(f"{fir}.mperm", "perm", 20), (f"{fir}.adjusted", "adjusted", 0)]),
        ("genotypic_perm_count", qt + cov + ["--glm", "genotypic", "hide-covar",
                                             "mperm=50", "perm-count", "--seed", "2"],
         [(f"{lin}.mperm", "perm", 50)]),
        ("interaction", qt + cov + ["--glm", "interaction", "hide-covar", "mperm=50",
                                    "--seed", "2"], [(f"{lin}.mperm", "perm", 50)]),
        ("chrx_groups", ["--pfile", xprefix] + qt + ["--covar", nosex, "--glm",
                                                     "hide-covar", "mperm=100",
                                                     "--seed", "2"],
         [(f"{lin}.mperm", "perm", 100)]),
        ("local_adjust", cov + ["--glm", *local, "--adjust"],
         [("PHENO1.glm.logistic.hybrid", "report", 0),
          ("PHENO1.glm.logistic.hybrid.adjusted", "adjusted", 0)]),
    )
    os.environ["PLINK_TORCH_VB"] = "256"
    try:
        for label, args, files in cases:
            full = args if args[0] == "--pfile" else ["--pfile", prefix] + args
            outs, secs = {}, {}
            for tag, devname in (("cuda1", "cuda"), ("cpu", "cpu"), ("cuda2", "cuda")):
                os.environ["PLINK_TORCH_DEVICE"] = devname
                outs[tag] = os.path.join(tmp, f"perm_{tag}_{label}")
                t0 = time.perf_counter()
                rc = cli.main(full + ["--out", outs[tag], "--silent"])
                assert rc == 0, (label, tag, rc)
                secs[tag] = time.perf_counter() - t0
            notes = []
            for ext, kind, n_perm in files:
                a, b, c2 = (f"{outs[t]}.{ext}" for t in ("cuda1", "cpu", "cuda2"))
                assert filecmp.cmp(a, c2, shallow=False), ("two CUDA runs differ", ext)
                if kind == "perm":
                    ok, frac = perm_report_close(b, a, n_perm)
                    assert ok, (label, ext, frac)
                    notes.append(f"{ext} EMP rows identical {100 * frac:.1f}%")
                elif kind == "adjusted":
                    assert adjusted_close(b, a), (label, ext)
                    notes.append(f"{ext} by the --adjust rule")
                else:
                    worst = compare_reports(a, b, beta_by_se=True)
                    notes.append(f"{ext} floats within {worst:.2f} of their tolerance")
            log(f"parity {label} [{n}x{m}]: CUDA = CPU ({'; '.join(notes)}), two CUDA "
                f"runs byte-identical (CUDA {secs['cuda1']:.1f}s, CPU "
                f"{secs['cpu']:.1f}s)")
    finally:
        os.environ.pop("PLINK_TORCH_VB", None)
        os.environ.pop("PLINK_TORCH_DEVICE", None)


# ---------------------------------------------------------------------------
# slice 10: the sample reports and scoring (--het, --sample-counts,
# --check-sex / --impute-sex, --score, --variant-score; K21 / K22)
# ---------------------------------------------------------------------------

FP64_FLOP_PER_S = 34e12  # H100 SXM FP64 outside the tensor cores; K21's
# work is one add a sample, variant and weight set (the weight of the
# sample's class), K22's one multiply-add by a 0/1 plane a sample, variant,
# weight set and plane (het, hom-ALT, valid), each counted as one operation
SPW_SETS = ((5, True), (3, True), (10, False))  # K21: (weight sets, f64):
# the score path's 3 columns + 2, --het's 3 (--check-sex's 4) in f64; the ten
# --sample-counts selectors in f32
VPW_SETS = ((2, True), (6, True), (2, False))  # K22: a 2-column weight file;
# 6 = W, W_y and W_x1 of one launch with chrY and --xchr-model 1 variants
TOL_WEIGHTED = 1e-12  # K21 / K22 f64 against the plain version, relative to
# the sum of the terms' magnitudes (the two sum in different orders)
N_SAMPLE_ROWS = 64  # report rows of the sample-report paths held to numpy
XY_CHECK = ["max-female-xf=0.2", "min-male-xf=0.7", "max-female-yrate=0.7",
            "min-male-yrate=0.6"]
SR_KERNELS = ("geno_counts", "sample_plane_weighted", "variant_plane_weighted")


def plane_library_ms(torch, pk, w, per_sample, f64, step=128):
    """One torch.matmul a chunk of `step` variants of the weights by the
    decoded 0/1 planes (decoded beforehand, untimed), the chunks' CUDA-event
    times summed: K21's [K, 4 step] x [4 step, npad], K22's [3 step, npad]
    x [npad, K]."""
    dt = torch.float64 if f64 else torch.float32
    total = 0.0
    for r0 in range(0, pk.shape[0], step):
        codes = unpack_codes(pk[r0:r0 + step])
        if per_sample:
            planes = torch.cat([(codes == c).to(dt) for c in range(4)])
            wc = w[r0:r0 + step].permute(2, 1, 0).reshape(w.shape[2], -1).contiguous()
            _, ms = timed(torch, lambda: torch.matmul(wc, planes))
        else:
            planes = torch.cat([(codes == 1).to(dt), (codes == 2).to(dt),
                                (codes != 3).to(dt)])
            _, ms = timed(torch, lambda: torch.matmul(planes, w))
        total += ms
        del planes, codes
    return total


def check_weighted_kernels(torch, dev, prefix):
    """Phase 3f: K21 (f64 at K = 3 and 5, f32 0/1 selectors at K = 10) and
    K22 (f64 at K = 2 and 6, f32 0/1 weights at K = 2) over phase 4's whole
    500,000 x 4,096 matrix against their plain versions (f64 within
    TOL_WEIGHTED of the sum of |terms|, f32 exact, NaN / Inf where the plain
    version has them), two runs identical, each timed beside its bound
    (bytes over 3.35 TB/s, or the operations of FP64_FLOP_PER_S's note over
    the FP64 / FP32 peak) and one torch.matmul of the weights by the
    decoded planes."""
    import numpy as np

    from plink_torch.dataset import load_dataset
    from plink_torch.ops import counts as C

    ds = load_dataset(prefix, dev)
    pk = ds.device_all_packed()
    V, nb = pk.shape
    n, npad = ds.raw_sample_ct, 4 * nb
    rng = np.random.default_rng(71)
    rows = []
    for name, sets in (("sample_plane_weighted", SPW_SETS),
                       ("variant_plane_weighted", VPW_SETS)):
        per_sample = name == "sample_plane_weighted"
        kern = C.sample_plane_weighted if per_sample else C.variant_plane_weighted
        plain = C.sample_plane_weighted_plain if per_sample \
            else C.variant_plane_weighted_plain
        row = None
        for K, f64 in sets:
            dt, esz = (np.float64, 8) if f64 else (np.float32, 4)
            shape = (V, 4, K) if per_sample else (npad, K)
            wn = rng.normal(size=shape) if f64 else rng.random(shape) < 0.5
            if not per_sample:
                wn[n:] = 0.0
            w = torch.from_numpy(wn.astype(dt)).to(dev)
            k = kern(pk, w)
            bits = torch.int64 if k.dtype == torch.float64 else torch.int32
            assert torch.equal(k.view(bits), kern(pk, w).view(bits)), \
                (name, K, "two runs differ")
            p, plain_ms = timed(torch, lambda: plain(pk, w))
            if f64:
                a = plain(pk, w.abs())
                err = float(((k - p).abs() / a.clamp(min=1e-300)).max())
                assert err <= TOL_WEIGHTED, (name, K, err)
            else:
                err = float((k - p).abs().max())
                assert err == 0.0, (name, K, err)
            mae = float((k - p).abs().max())
            ms = time_ms(torch, lambda: kern(pk, w), 10)
            lib = plane_library_ms(torch, pk, w, per_sample, f64)
            per_entry = 1 if per_sample else 3
            nbytes = V * nb + w.numel() * esz + k.numel() * k.element_size()
            bound = _bound(per_entry * K * V * n, nbytes,
                           FP64_FLOP_PER_S if f64 else FP32_FLOP_PER_S)
            log(f"{'K21' if per_sample else 'K22'} {name} [{V}x{n}] K={K} "
                f"{'f64' if f64 else 'f32'}: {ms:.3f} ms, plain {plain_ms:.1f} ms, "
                f"matmul {lib:.3f} ms, bound {bound['bound_ms']:.3f} ms "
                f"({bound['bound_by']}); vs plain {err:.2e}, two runs identical")
            del p, k
            if row is None:
                row = dict(name=name, source="plink_torch/csrc/plane_weighted.cu",
                           replaces="plink_tpu/ops/counts.py:195" if per_sample
                           else "plink_tpu/ops/counts.py:237",
                           max_abs_err=mae, tol=f"{TOL_WEIGHTED} relative to "
                           "sum |terms| (f64); exact (f32)", ms=ms,
                           plain_ms=plain_ms, library_ms=lib, K=K, **bound)
            else:
                row[f"ms_K{K}_{'f64' if f64 else 'f32'}"] = ms
                row[f"bound_ms_K{K}_{'f64' if f64 else 'f32'}"] = bound["bound_ms"]
                row["max_abs_err"] = max(row["max_abs_err"], mae)
        if per_sample:
            # f32 splits added in f64: with the split cap lowered to 4
            # variants, weights of 2^22 on 8 variants and 1 on 3 sum to
            # 2^25 + 3 (no f32 holds it) for every sample
            cap, C.F32_SPLIT_ROWS = C.F32_SPLIT_ROWS, 4
            try:
                w = torch.ones((11, 4, 1), dtype=torch.float32, device=dev)
                w[:8] = 2.0 ** 22
                k = kern(pk[:11], w)
            finally:
                C.F32_SPLIT_ROWS = cap
            assert k.dtype == torch.float64 and bool((k == 2.0 ** 25 + 3).all())
            log(f"  {name}: f32 splits of <= 4 variants added in f64 give 2^25 + 3 "
                "exactly")
        # one NaN and one +Inf weight: NaN / Inf exactly where the plain
        # version (plink_tpu's products) has them
        if per_sample:
            wn = rng.normal(size=(V, 4, 3))
            wn[V // 3, 3, 0], wn[V // 2, 2, 2] = np.nan, np.inf
        else:
            wn = np.zeros((npad, 3))
            wn[:n] = rng.normal(size=(n, 3))
            wn[n // 3, 1], wn[n // 2, 0] = np.nan, np.inf  # set 2 stays finite
        w = torch.from_numpy(wn).to(dev)
        k, p = kern(pk, w), plain(pk, w)
        for f in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(f(k), f(p)), (name, f.__name__)
        assert torch.isnan(k).any() and torch.isinf(k).any()
        fin = torch.isfinite(p)
        a = plain(pk, torch.nan_to_num(w.abs(), posinf=0.0))
        assert float(((k - p).abs() / a.clamp(min=1e-300))[fin].max()) <= TOL_WEIGHTED
        log(f"  {name}: NaN / Inf weights give NaN / Inf where the plain version "
            f"does ({int(torch.isnan(k).sum())} NaN, {int(torch.isinf(k).sum())} Inf)")
        del k, p, a, w
        rows.append(row)
    torch.cuda.empty_cache()
    return rows


def _device_counts(torch, pk, masks, step=256):
    """Per-variant (hom-REF, het, hom-ALT, missing) counts [G, V, 4] over
    each sample mask, from the packed matrix by torch comparisons (not K1)."""
    import numpy as np

    out = []
    for m in masks:
        mt = torch.from_numpy(np.asarray(m, bool)).to(pk.device)
        rows = []
        for r0 in range(0, pk.shape[0], step):
            c = unpack_codes(pk[r0:r0 + step])[:, :mt.numel()][:, mt]
            rows.append(torch.stack([(c == k).sum(1) for k in range(4)], 1))
        out.append(torch.cat(rows).cpu().numpy().astype(np.float64))
    return out


def _sample_codes(ds, idx):
    """2-bit codes [V, len(idx)] of those samples, from the host matrix."""
    import numpy as np

    pk = ds.all_packed()
    return (pk[:, idx // 4] >> (2 * (idx % 4)).astype(np.uint8)) & 3


def _held(label, got, want, scale):
    """Printed 6-significant-figure floats against numpy f64: within the
    printing's rounding (5e-6 relative) plus 1e-12 of `scale`."""
    import numpy as np

    got = np.array([float(x) for x in got])
    err = np.abs(got - want) - 5e-6 * np.abs(want)
    assert (err <= 1e-12 * scale).all(), (label, got[err > 1e-12 * scale][:4],
                                          want[err > 1e-12 * scale][:4])


def sr_argv(prefix, out, sfile, vfile):
    return ["--pfile", prefix, "--het", "--sample-counts", "--score", sfile, "header",
            "--score-col-nums", "3-5", "--variant-score", vfile, "--out", out,
            "--silent"]


def run_sample_report_path(torch, dev, prefix, tmp, card):
    """Phase 4f: `--het --sample-counts --score <3-column score file> header
    --score-col-nums 3-5 --variant-score <2-column weight file>` on phase
    4's panel (every variant scored, the named allele ALT and REF in turn):
    K1, K21 and K22 launched; the integer columns (O(HOM), OBS_CT, the
    .scount columns, ALLELE_CT, NAMED_ALLELE_DOSAGE_SUM) exact against
    numpy counts of N_SAMPLE_ROWS samples, E(HOM), F and the score averages
    held to numpy f64, the .vscore to numpy f64 on N_SAMPLE_ROWS variants;
    then the run once more under torch.profiler."""
    import numpy as np

    from plink_torch.dataset import load_dataset

    ds = load_dataset(prefix, torch.device("cpu"))
    n, V = ds.raw_sample_ct, ds.raw_variant_ct
    rng = np.random.default_rng(72)
    W3 = rng.normal(size=(V, 3))
    named_alt = np.arange(V) % 2 == 0
    sfile, vfile = os.path.join(tmp, "sr.score"), os.path.join(tmp, "sr.vs")
    with open(sfile, "w") as f:
        f.write("ID\tA1\tW1\tW2\tW3\n")
        f.writelines(f"{ds.vi.vid[v]}\t{ds.vi.alt[v] if named_alt[v] else ds.vi.ref[v]}"
                     f"\t{W3[v, 0]:.6f}\t{W3[v, 1]:.6f}\t{W3[v, 2]:.6f}\n"
                     for v in range(V))
    W3 = np.array([[float(x) for x in ln.split("\t")[2:]] for ln in
                   open(sfile).read().splitlines()[1:]])
    WS = np.round(rng.normal(size=(n, 2)), 6)
    with open(vfile, "w") as f:
        f.write("#IID\tV1\tV2\n")
        f.writelines(f"{ds.si.iid[i]}\t{WS[i, 0]:.6f}\t{WS[i, 1]:.6f}\n"
                     for i in range(n))
    out = os.path.join(tmp, "sr")
    wall, launches = drive(torch, sr_argv(prefix, out, sfile, vfile), out)
    assert all(launches[k] > 0 for k in SR_KERNELS), launches
    log(f"sample-report path: {n} samples x {V} variants: {wall:.2f}s wall on "
        f"{card}; launches {launches}")

    # numpy: whole-panel counts by torch comparisons on the card, the codes
    # of N_SAMPLE_ROWS samples from the host matrix
    pk = torch.from_numpy(ds.all_packed()).to(dev)
    cts = _device_counts(torch, pk, [np.ones(n, bool)])[0]
    del pk
    alt = cts[:, 1] + 2 * cts[:, 2]
    obs = 2 * (cts[:, 0] + cts[:, 1] + cts[:, 2])
    freq = alt / obs
    idx = np.linspace(0, n - 1, N_SAMPLE_ROWS).round().astype(np.int64)
    c = _sample_codes(ds, idx)
    miss, het, hom_alt = c == 3, c == 1, c == 2
    # .het
    ehet = 2 * freq * (1 - freq)
    sel = (ehet >= 2.0 ** -35)[:, None]
    OBS = (sel & ~miss).sum(0)
    O_HOM = OBS - (sel & het).sum(0)
    E_HOM = OBS - (np.where(sel & ~miss, ehet[:, None], 0.0)).sum(0)
    F = (O_HOM - E_HOM) / (OBS - E_HOM)
    hdr, rows = read_report(out + ".het")
    r = [rows[i] for i in idx]
    assert [int(x[hdr.index("O(HOM)")]) for x in r] == O_HOM.tolist()
    assert [int(x[hdr.index("OBS_CT")]) for x in r] == OBS.tolist()
    _held(".het E(HOM)", [x[hdr.index("E(HOM)")] for x in r], E_HOM, OBS.max())
    _held(".het F", [x[hdr.index("F")] for x in r], F, 1.0)
    # .scount (the panel's alleles are B / A: one-base, not base pairs)
    hdr, rows = read_report(out + ".scount")
    singleton = (cts[:, 1] + cts[:, 2]) == 1
    want = {"HOM_REF_CT": (c == 0).sum(0), "HOM_ALT_SNP_CT": hom_alt.sum(0),
            "HET_SNP_CT": het.sum(0),
            "DIPLOID_SINGLETON_CT": ((het | hom_alt) & singleton[:, None]).sum(0),
            "MISSING_INCL_FEMALE_Y_CT": miss.sum(0)}
    for col in hdr[1:]:
        got = [int(rows[i][hdr.index(col)]) for i in idx]
        assert got == want.get(col, np.zeros(len(idx), int)).tolist(), col
    # .sscore: named dosage, a missing call imputed as 2 x the named freq
    hdr, rows = read_report(out + ".sscore")
    nf = np.where(named_alt, freq, 1 - freq)
    nd = np.where(named_alt[:, None], c, 2 - c).astype(np.float64)
    contrib = np.where(miss, 2 * nf[:, None], nd)
    avg = contrib.T @ W3 / (2.0 * V)
    r = [rows[i] for i in idx]
    assert [x[hdr.index("ALLELE_CT")] for x in r] == \
        [str(2 * V - 2 * int(m)) for m in miss.sum(0)]
    assert [x[hdr.index("NAMED_ALLELE_DOSAGE_SUM")] for x in r] == \
        [str(int(d)) for d in np.where(miss, 0.0, nd).sum(0)]
    avg_cols = [h for h in hdr if h.endswith("_AVG")]
    assert len(avg_cols) == 3, hdr
    for k, col in enumerate(avg_cols):
        _held(f".sscore {col}", [x[hdr.index(col)] for x in r], avg[:, k],
              np.abs(W3[:, k]).sum() / V)
    # .vscore on N_SAMPLE_ROWS variants over every sample
    vidx = np.linspace(0, V - 1, N_SAMPLE_ROWS).round().astype(np.int64)
    pkv = ds.all_packed()[vidx]
    cv = ((pkv[:, :, None] >> np.arange(0, 8, 2, dtype=np.uint8)) & 3
          ).reshape(len(vidx), -1)[:, :n]
    dos = np.where(cv == 3, 2 * freq[vidx, None], cv)
    want = dos @ WS
    hdr, rows = read_report(out + ".vscore")
    for k in range(2):
        _held(f".vscore VSCORE{k + 1}", [rows[v][5 + k] for v in vidx], want[:, k],
              2 * np.abs(WS[:, k]).sum())
    log(f"sample-report path: .het / .scount / .sscore integer columns exact, "
        f"E(HOM), F, SCORE_AVG ({N_SAMPLE_ROWS} samples) and .vscore "
        f"({N_SAMPLE_ROWS} variants) = numpy f64 to the printed digits")
    trace_path(torch, sr_argv(prefix, os.path.join(tmp, "sr_traced"), sfile, vfile),
               "sample reports")
    return launches


def write_xy_copy(torch, dev, prefix, dst, n_variants):
    """A copy of the panel (the .psam linked) whose variants n/2..7n/8 sit on
    chrX and the last n/8 on chrY, with a seeded half of the males haploid
    there: their het calls on chrX and chrY rewritten as hom-REF or hom-ALT
    (seeded, on the card), so that both SNPSEX classes occur."""
    import numpy as np

    os.symlink(prefix + ".psam", dst + ".psam")
    with open(prefix + ".pvar") as f, open(dst + ".pvar", "w") as g:
        g.write(f.readline())
        for i, ln in enumerate(f):
            chrom = "1" if i < n_variants // 2 else "X" if i < n_variants * 7 // 8 \
                else "Y"
            g.write(chrom + ln[ln.index("\t"):])
    with open(prefix + ".psam") as f:
        col = f.readline().rstrip("\n").split("\t").index("SEX")
        sex = np.array([ln.rstrip("\n").split("\t")[col] for ln in f])
    n = sex.size
    nb = (n + 3) // 4
    shutil.copyfile(prefix + ".pgen", dst + ".pgen")
    assert os.path.getsize(dst + ".pgen") == 12 + n_variants * nb  # mode 0x02
    hap = np.zeros(4 * nb, bool)
    hap[:n] = (sex == "1") & (np.random.default_rng(74).random(n) < 0.5)
    hmask = torch.from_numpy(hap.reshape(nb, 4)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(75)
    mm = np.memmap(dst + ".pgen", np.uint8, "r+", offset=12, shape=(n_variants, nb))
    for r0 in range(n_variants // 2, n_variants, 256):
        x = torch.from_numpy(np.array(mm[r0:r0 + 256])).to(dev).to(torch.int32)
        codes = torch.stack([(x >> (2 * j)) & 3 for j in range(4)], -1)
        hom = 2 * torch.randint(0, 2, codes.shape, generator=gen, device=dev,
                                dtype=torch.int32)
        codes = torch.where(hmask & (codes == 1), hom, codes)
        packed = codes[..., 0] | codes[..., 1] << 2 | codes[..., 2] << 4 \
            | codes[..., 3] << 6
        mm[r0:r0 + 256] = packed.to(torch.uint8).cpu().numpy()
    mm.flush()
    del mm
    return int(hap.sum())


def run_check_sex_path(torch, dev, prefix, tmp, card, n_variants):
    """Phase 5f: `--check-sex` with four thresholds on a copy with chrX and
    a chrY tail (YRATE computed) and half its males haploid there: K1 and
    K21 launched; F and YRATE of
    N_SAMPLE_ROWS samples held to numpy f64 (chrX frequencies with the
    males haploid, as plink2 counts them), SNPSEX and STATUS by the
    thresholds."""
    import numpy as np

    from plink_torch.dataset import load_dataset

    xy = os.path.join(tmp, "xy")
    n_hap = write_xy_copy(torch, dev, prefix, xy, n_variants)
    out = os.path.join(tmp, "sexcheck")
    argv = ["--pfile", xy, "--check-sex", *XY_CHECK, "--out", out, "--silent"]
    wall, launches = drive(torch, argv, out)
    assert launches["geno_counts"] > 0 and launches["sample_plane_weighted"] > 0, \
        launches
    log(f"--check-sex path: {N_SAMPLES} samples x {n_variants} variants "
        f"({n_variants * 3 // 8} chrX, {n_variants // 8} chrY; {n_hap} males "
        f"haploid there): {wall:.2f}s wall "
        f"on {card}; launches {launches}")
    ds = load_dataset(xy, torch.device("cpu"))
    n, V = ds.raw_sample_ct, ds.raw_variant_ct
    male = ds.si.sex == 1
    pk = torch.from_numpy(ds.all_packed()).to(dev)
    a, m = _device_counts(torch, pk, [np.ones(n, bool), male])
    del pk
    nm = a - m
    x_alt = nm[:, 1] + 2 * nm[:, 2] + m[:, 2] + 0.5 * m[:, 1]
    x_obs = 2 * (nm[:, 0] + nm[:, 1] + nm[:, 2]) + m[:, 0] + m[:, 1] + m[:, 2]
    freq = x_alt / x_obs
    isx, isy = ds.vi.chrom == 23, ds.vi.chrom == 24
    ehet = 2 * freq * (1 - freq)
    sel = (isx & (ehet >= 2.0 ** -35))[:, None]
    idx = np.linspace(0, n - 1, N_SAMPLE_ROWS).round().astype(np.int64)
    c = _sample_codes(ds, idx)
    OBS = (sel & (c != 3)).sum(0)
    O_HOM = OBS - (sel & (c == 1)).sum(0)
    E_HOM = OBS - np.where(sel & (c != 3), ehet[:, None], 0.0).sum(0)
    F = (O_HOM - E_HOM) / (OBS - E_HOM)
    YRATE = (isy[:, None] & ((c == 0) | (c == 2))).sum(0) / isy.sum()
    hdr, rows = read_report(out + ".sexcheck")
    r = [rows[i] for i in idx]
    _held(".sexcheck F", [x[hdr.index("F")] for x in r], F, 1.0)
    _held(".sexcheck YRATE", [x[hdr.index("YRATE")] for x in r], YRATE, 1.0)
    th = dict(a.split("=") for a in XY_CHECK)
    is_m = (F >= float(th["min-male-xf"])) & (YRATE >= float(th["min-male-yrate"]))
    is_f = (F <= float(th["max-female-xf"])) & (YRATE <= float(th["max-female-yrate"]))
    snp = np.where(is_m & ~is_f, "1", np.where(is_f & ~is_m, "2", "NA"))
    assert {"1", "2"} <= set(snp.tolist()), snp  # both sides of the thresholds
    assert [x[hdr.index("SNPSEX")] for x in r] == snp.tolist()
    assert [x[hdr.index("STATUS")] for x in r] == [
        "OK" if s != "NA" and s == x[hdr.index("PEDSEX")] else "PROBLEM"
        for s, x in zip(snp, r)]
    os.remove(xy + ".pgen")
    log(f"--check-sex path: F and YRATE of {N_SAMPLE_ROWS} samples = numpy f64 to "
        f"the printed digits, SNPSEX / STATUS by the thresholds "
        f"({dict(zip(*np.unique(snp, return_counts=True)))})")
    return launches


def run_sample_parity(tmp, prefix, dprefix):
    """Phase 17f: plink_torch.testing.SR_RUNS, the cases of
    tests/test_torch_sample_reports.py, on the parity panel (2,000 x 800;
    its chr1/X/Y/MT copy with every .scount allele class; a copy with 40
    founders) and the dosage parity panel (4,500 x 600), CUDA against CPU:
    reports byte-identical, but SR_ORDER_DEPENDENT's (the f64 .vscore.bin,
    last bits; `single-prec`'s f32 sums) held within their tolerance x 2
    sum |weight| of the CPU run; the guard's refusals the same message on
    both; two card runs byte-identical."""
    import numpy as np

    from plink_torch import cli
    from plink_torch.testing import (SR_ERRORS, SR_ORDER_DEPENDENT, SR_RUNS,
                                     write_sample_report_inputs)

    d = os.path.join(tmp, "sr")
    os.makedirs(d)
    os.environ["PLINK_TORCH_DEVICE"] = "cpu"
    try:  # the .afreq for --read-freq and a 40-sample panel for the guard
        assert cli.main(["--pfile", prefix, "--freq", "--out",
                         os.path.join(d, "f"), "--silent"]) == 0
        assert cli.main(["--dummy", "40", "100", "0.05", "--seed", "3", "--out",
                         os.path.join(d, "tiny"), "--silent"]) == 0
    finally:
        os.environ.pop("PLINK_TORCH_DEVICE")
    write_sample_report_inputs(d, prefix, dprefix, os.path.join(d, "f.afreq"))
    filesets = {"p": prefix, "dp": dprefix, "sx": os.path.join(d, "sx"),
                "fam": os.path.join(d, "fam"), "tiny": os.path.join(d, "tiny")}
    with open(os.path.join(d, "vs.txt")) as f:
        scale = 2 * np.abs(np.array([[float(x) for x in ln.split()[1:]]
                                     for ln in f.readlines()[1:]])).sum(0)
    os.environ["PLINK_TORCH_VB"] = "256"
    try:
        for run, (fs, flags, exts) in SR_RUNS.items():
            argv = ["--pfile", filesets[fs]] + [a.format(d=d) for a in flags]
            outs, secs, errs = {}, {}, {}
            for tag, devname in (("cuda1", "cuda"), ("cpu", "cpu"), ("cuda2", "cuda")):
                os.environ["PLINK_TORCH_DEVICE"] = devname
                outs[tag] = os.path.join(d, f"{tag}_{run}")
                t0 = time.perf_counter()
                if run in SR_ERRORS:
                    try:
                        cli.main(argv + ["--out", outs[tag], "--silent"])
                    except ValueError as e:
                        errs[tag] = str(e)
                    assert "decent allele frequencies" in errs.get(tag, ""), \
                        (run, tag, "the frequency guard did not refuse")
                else:
                    rc = cli.main(argv + ["--out", outs[tag], "--silent"])
                    assert rc == 0, (run, tag, rc)
                secs[tag] = time.perf_counter() - t0
            assert len(set(errs.values())) <= 1, (run, errs)
            tols = []
            for ext in exts:
                a, b, c2 = (outs[t] + ext for t in ("cuda1", "cpu", "cuda2"))
                assert filecmp.cmp(a, c2, shallow=False), ("two CUDA runs differ",
                                                           run, ext)
                tol = SR_ORDER_DEPENDENT.get((run, ext))
                if tol is None:
                    assert filecmp.cmp(a, b, shallow=False), (run, ext)
                    continue
                tols.append(ext)
                if ext.endswith(".bin"):
                    x, y = np.fromfile(a, "<f8"), np.fromfile(b, "<f8")
                    fmt = 0.0
                else:
                    ra, rb = read_report(a)[1], read_report(b)[1]
                    assert [r[:5] for r in ra] == [r[:5] for r in rb], (run, ext)
                    x = np.array([[float(v) for v in r[5:]] for r in ra])
                    y = np.array([[float(v) for v in r[5:]] for r in rb])
                    fmt = 5e-6
                dv = (np.abs(x - y) - fmt * np.abs(y)).reshape(-1, len(scale))
                assert (dv <= tol * scale).all(), (run, ext, float(dv.max()))
            same = [e for e in exts if e not in tols]
            said = ([f"{' '.join(same)} byte for byte"] if same else []) \
                + ([f"{' '.join(tols)} within its tolerance"] if tols else []) \
                + ([f"refused alike: {errs['cpu'][:60]}"] if errs else [])
            log(f"parity sample reports {run}: CUDA = CPU ({'; '.join(said)}), two "
                f"CUDA runs byte-identical (CUDA {secs['cuda1']:.1f}s, CPU "
                f"{secs['cpu']:.1f}s)")
    finally:
        os.environ.pop("PLINK_TORCH_VB", None)
        os.environ.pop("PLINK_TORCH_DEVICE", None)


# ---------------------------------------------------------------------------
# slice 11: the pair-count commands (--distance, --genome, --cluster and the
# IBS permutation / jackknife tests; K23 and K7's counters)
# ---------------------------------------------------------------------------

# the --distance cell: plink 1.9's IBS distance matrix (its default weighted
# missingness) on indep_10k at full width, in 2,048-sample tiles: 5 a side,
# 15 lower tiles, each one K7 counters launch and one K23 launch
DIST_ARGS = ["--distance", "triangle", "bin4"]
DIST_TILES = 15
N_DIST_PAIRS = 64  # .dist.bin entries held to numpy
# the pair-report parity: plink_torch.testing.PD_RUNS on a panel of its own
# (2% missing calls; seed 1, the parity panel's) and a dosage `--dummy`
# panel of the same width, each cut by a --keep to PD_KEEP samples (the
# compaction on the card), in tiles of PD_TILE samples (4 a side, the last
# ragged): the --genome / --cluster / permutation hosts loop per pair, and
# on the parity panel's 2,000 x 1,200 the CPU's plain versions of K7 and K8
# take 6.7 s over its 10 lower tiles of 512 (the king_grm parity case)
PD_PANEL = (300, 600, 1)  # samples, variants, seed
PD_KEEP = 250
PD_TILE = 64

def distance_inputs(torch, dev, prefix):
    """indep_10k as --distance lays it out (PackedDevice.for_pairs: 2,048-
    sample tiles, npad 10,240) and the path's own weights
    (distance_weights of the founders' ALT frequencies)."""
    import numpy as np

    from plink_torch.commands.basic_reports import alt_allele_freqs
    from plink_torch.dataset import load_dataset
    from plink_torch.ops.pairwise import PackedDevice, distance_weights

    ds = load_dataset(prefix, dev)
    vmask = ds.variant_mask & ds.vi.chr_info.is_autosomal(ds.vi.chrom)
    pd = PackedDevice.for_pairs(ds, vmask)
    wi, wsum = distance_weights(alt_allele_freqs(ds, dosage=True), vmask)
    wt = torch.zeros(pd.nblocks * pd.vb, dtype=torch.int64)
    wt[: wi.size] = torch.from_numpy(wi)
    return pd, wt.to(dev), wsum


def check_wmiss_kernel(torch, dev, prefix):
    """K23 on the diagonal tile (0, 0) and the ragged last row tile (npad -
    2,048, 0) of the --distance layout of indep_10k, with the path's own
    weights: torch.equal to its plain version (f64 on the card, exact:
    the weights sum below 2^32), two runs identical; timed beside its bound
    and one f64 torch.matmul of the decoded weighted missing plane by the
    missing plane."""
    from plink_torch.ops import pairwise as P

    pd, wt, wsum = distance_inputs(torch, dev, prefix)
    s, npad, V = pd.tile, pd.npad, pd.variant_ct
    assert (s, npad) == (2048, 10240), (s, npad)
    joint = []
    for r0, c0 in ((0, 0), (npad - s, 0)):
        k = P.wmiss_gram(pd.packed, pd.vmask, wt, r0, c0, s, s)
        assert torch.equal(k, P.wmiss_gram_plain(pd.packed, pd.vmask, wt, r0, c0, s, s)), \
            ("K23 differs from its plain version", r0, c0)
        assert torch.equal(k, P.wmiss_gram(pd.packed, pd.vmask, wt, r0, c0, s, s)), \
            "K23 is not deterministic"
        joint.append(int((k > 0).sum()))
    ms = time_ms(torch, lambda: P.wmiss_gram(pd.packed, pd.vmask, wt, 0, 0, s, s), 5)
    pms = time_ms(torch, lambda: P.wmiss_gram_plain(pd.packed, pd.vmask, wt, 0, 0, s, s), 1)
    flat = pd.packed.reshape(-1, pd.packed.shape[2])[:, : s // 4]
    miss = torch.empty((flat.shape[0], s), dtype=torch.float64, device=dev)
    for v0 in range(0, flat.shape[0], 2048):
        miss[v0 : v0 + 2048] = (unpack_codes(flat[v0 : v0 + 2048]) == 3).double()
    miss *= (pd.vmask.reshape(-1, 1) != 0).double()
    joint_bits = int((miss.sum(1) ** 2).sum())  # jointly missing (pair, variant)
    wmiss = miss * wt.double()[:, None]
    lib = time_ms(torch, lambda: torch.matmul(wmiss.t(), miss), 3)
    del miss, wmiss
    # the least work of a correct formulation, whichever is less: the
    # products of four u8 limbs of the weights by the 0/1 missing plane on
    # the int8 tensor cores (IMMA takes u8; exact in int32 below 2^23
    # variants), or K23's own: one 32-bit AND a pair and 32-variant word,
    # and one add a jointly missing (pair, variant)
    nbytes = V * (2 * s // 4 + 1 + 8) + 8 * s * s
    and_words = s * s * (-(-V // 32))
    limbs = _bound(4 * 2 * s * s * V, nbytes, INT8_OPS_PER_S)
    words = _bound(and_words + joint_bits, nbytes, INT32_OPS_PER_S)
    bound = min(limbs, words, key=lambda b: b["bound_ms"])
    log(f"K23 wmiss_gram [{s}x{s} tile, V={V}]: = plain on the diagonal and the "
        f"last ragged row tile (pairs jointly missing: {joint}), two runs "
        f"identical; {ms:.3f} ms, plain {pms:.1f} ms, f64 matmul {lib:.3f} ms, "
        f"bound {bound['bound_ms']:.3f} ms: {and_words} AND words + "
        f"{joint_bits} adds at the INT32 rate {words['bound_ms']:.3f} ms, four "
        f"u8 limb products {limbs['bound_ms']:.3f} ms")
    return [dict(name="wmiss_gram", source="plink_torch/csrc/wmiss_gram.cu",
                 replaces="plink_tpu/ops/pairwise.py:89",
                 also_replaces="plink_tpu/ops/pairwise.py:128",
                 max_abs_err=0.0, tol=0.0, and_words=and_words,
                 joint_bits=joint_bits, limb_bound_ms=limbs["bound_ms"], ms=ms,
                 plain_ms=pms, **bound, library_ms=lib)]


def dist_argv(prefix, out):
    return ["--pfile", prefix, *DIST_ARGS, "--out", out, "--silent"]


def check_dist_pairs(prefix, out):
    """N_DIST_PAIRS seeded pairs of the triangle .dist.bin against numpy:
    the allele differences over the jointly called variants, rescaled by
    wsum / (wsum - wmiss_i - wmiss_j + wjoint_ij) with the reference's
    order of f64 operations, rounded to f32; and the .dist.id.  The weights
    are computed here from the codes, sharing no code with the path: w =
    p(1 - p)(p^2 - p + 1) of the ALT frequency p (1 where p is 0 or 1),
    scaled by (2^32 - V) / sum w and rounded half up."""
    import numpy as np

    n, V = IND_PANEL[:2]
    codes = pgen_codes(prefix, np.arange(V))
    miss = codes == 3
    alt = np.where(miss, 0, codes).sum(1, dtype=np.int64)
    p = alt / (2.0 * (~miss).sum(1))  # every sample a founder
    w = np.where((p <= 0.0) | (p >= 1.0), 1.0, p * (1.0 - p) * (p * p - p + 1.0))
    wi = np.floor(w * ((4294967296.0 - V) / w.sum()) + 0.5).astype(np.int64)
    wsum = int(wi.sum())
    got = np.fromfile(out + ".dist.bin", np.float32)
    assert got.size == n * (n - 1) // 2, got.size
    rng = np.random.default_rng(11)
    worst = 0.0
    for _ in range(N_DIST_PAIRS):
        i, j = sorted(rng.choice(n, 2, replace=False))[::-1]
        both = ~miss[:, i] & ~miss[:, j]
        idist = int(np.abs(codes[both, i].astype(np.int64) - codes[both, j]).sum())
        denom = (wsum - int(wi[miss[:, i]].sum()) - int(wi[miss[:, j]].sum())
                 + int(wi[miss[:, i] & miss[:, j]].sum()))
        want = np.float32(idist * (wsum / float(denom)))
        have = got[i * (i - 1) // 2 + j]
        assert have == want, (i, j, have, want)
        worst = max(worst, abs(float(have) - float(want)))
    with open(out + ".dist.id") as f:
        assert f.read() == "".join(f"0\tper{i}\n" for i in range(n)), ".dist.id"
    return worst


def run_distance_path(torch, prefix, out, card):
    """The --distance path on indep_10k: K7 (counters) and K23 launched
    DIST_TILES times each; every K23 launch of the path kept and held to
    its plain version; N_DIST_PAIRS entries of the .dist.bin against
    numpy."""
    from plink_torch.commands import distance as D
    from plink_torch.ops import pairwise as P

    with spying("wmiss_gram", D) as (calls, real):
        wall, launches = drive(torch, dist_argv(prefix, out), out)
    assert launches["wmiss_gram"] == launches["king_gram"] == DIST_TILES, launches
    note = check_calls(torch, calls, real, P.wmiss_gram_plain, "K23")
    del calls
    check_dist_pairs(prefix, out)
    log(f"--distance path {IND_PANEL[0]}x{IND_PANEL[1]} ({' '.join(DIST_ARGS)}): "
        f"{wall:.2f}s wall on {card}; {note}; {N_DIST_PAIRS} .dist.bin entries "
        f"= numpy (f64 from the codes and weights, rounded to f32), .dist.id "
        f"exact; launches {dict((k, v) for k, v in launches.items() if v)}")
    os.remove(out + ".dist.bin")
    return launches


def run_pair_parity(tmp):
    """plink_torch.testing.PD_RUNS, the cases of
    tests/test_torch_pair_reports.py, on the PD_PANEL panel, its
    chr1/X/Y/MT copy, a .bed copy with the test's pedigree and a dosage
    panel (the port's --dummy), each run with a --keep of the first
    PD_KEEP samples, in tiles of PD_TILE samples, CUDA against CPU: every
    output byte for byte (a .gz by its text), the .log's result lines
    equal, the refusals' messages equal; a second card run the same."""
    from plink_torch import cli
    from plink_torch.bench_gen import gen_panel
    from plink_torch.testing import (PD_ERRORS, PD_RUNS, pair_log_lines,
                                     pair_output_same, write_bed_copy,
                                     write_pair_report_inputs, write_pedigree_fam)

    d = os.path.join(tmp, "pd")
    os.makedirs(d)
    n, m, seed = PD_PANEL
    prefix, dprefix = os.path.join(d, "p"), os.path.join(d, "dp")
    gen_panel(prefix, n, m, miss_rate=0.02, seed=seed)
    os.environ["PLINK_TORCH_DEVICE"] = "cpu"
    try:
        assert cli.main(["--pfile", prefix, "--freq", "--out", os.path.join(d, "f"),
                         "--silent"]) == 0
        assert cli.main(["--dummy", str(n), str(m), "0.02", "dosage-freq=0.7",
                         "--seed", str(seed), "--out", dprefix, "--silent"]) == 0
    finally:
        os.environ.pop("PLINK_TORCH_DEVICE")
    write_pair_report_inputs(d, prefix, os.path.join(d, "f.afreq"))
    write_bed_copy(prefix, os.path.join(d, "pedb"))
    write_pedigree_fam(os.path.join(d, "pedb.fam"))
    keep = os.path.join(d, "keep.txt")
    with open(keep, "w") as f:
        f.writelines(f"per{i}\n" for i in range(PD_KEEP))
    filesets = {"p": prefix, "sx": os.path.join(d, "sx"), "dp": dprefix,
                "pedb": os.path.join(d, "pedb")}
    os.environ["PLINK_TORCH_VB"] = "256"
    os.environ["PLINK_TORCH_TILE"] = str(PD_TILE)
    secs = {"cuda": 0.0, "cpu": 0.0, "cuda2": 0.0}
    try:
        for label, fs, flags, exts in PD_RUNS:
            inp = "--bfile" if fs == "pedb" else "--pfile"
            argv = [inp, filesets[fs], *(a.format(d=d) for a in flags), "--keep", keep]
            outs, errs = {}, {}
            for tag in ("cuda", "cpu", "cuda2"):
                os.environ["PLINK_TORCH_DEVICE"] = tag.rstrip("2")
                outs[tag] = os.path.join(d, f"{tag}_{label}")
                t0 = time.perf_counter()
                try:
                    rc = cli.main(argv + ["--out", outs[tag], "--silent"])
                    assert rc == 0, (label, tag, rc)
                except ValueError as e:  # FlagError is one
                    errs[tag] = str(e)
                secs[tag] += time.perf_counter() - t0
            if label in PD_ERRORS:
                assert (errs.get("cuda") == errs.get("cpu") == errs.get("cuda2")
                        == PD_ERRORS[label]), (label, errs)
            else:
                assert not errs, (label, errs)
            for ext in exts:
                assert pair_output_same(outs["cpu"] + ext, outs["cuda"] + ext), (label, ext)
                assert pair_output_same(outs["cuda2"] + ext, outs["cuda"] + ext), \
                    ("two CUDA runs differ", label, ext)
            lines = pair_log_lines(outs["cuda"])
            assert lines and lines == pair_log_lines(outs["cpu"]), label
            assert lines == pair_log_lines(outs["cuda2"]), ("two CUDA runs differ", label)
        log(f"pair-report parity [{PD_KEEP} of {n}x{m}, tile {PD_TILE}]: "
            f"{len(PD_RUNS)} runs of testing.PD_RUNS CUDA = CPU (outputs byte for "
            f"byte, .log result lines, {len(PD_ERRORS)} refusals alike), two CUDA "
            f"runs byte-identical; CUDA {secs['cuda']:.1f}s, CPU {secs['cpu']:.1f}s")
    finally:
        for k in ("PLINK_TORCH_VB", "PLINK_TORCH_TILE", "PLINK_TORCH_DEVICE"):
            os.environ.pop(k, None)


# ---------------------------------------------------------------------------
# Slice 12: --fast-epistasis (K24), --assoc / --model and --fst over K1
# ---------------------------------------------------------------------------

# the --fast-epistasis cells on indep_10k (10,000 samples, PHENO1's cases and
# controls as the two groups): the CASSI Ueki statistic over variants
# 1..EPI_VARIANTS (8.4e6 pairs; the host's f64 statistics at ~1 us a pair set
# the wall), and boost over 1..EPI_BOOST_VARIANTS; K24 launches once a row
# block of 256 (96 with boost)
EPI_VARIANTS = 4_096
EPI_BOOST_VARIANTS = 2_048
EPI_LAUNCHES = {"default": -(-EPI_VARIANTS // 256), "boost": -(-EPI_BOOST_VARIANTS // 96)}
N_EPI_ROWS = 64  # .epi.cc STATs and .summary rows held to numpy
# H100 SXM popcounts outside the tensor cores: 132 SMs x 16 a clock x 1.98 GHz
POPC_PER_S = 132 * 16 * 1.98e9
ASSOC_ARGS = ["--assoc", "--model", "--allow-no-sex"]
N_ASSOC_ROWS = 64  # variants of the .assoc / .model held to numpy
FST_SEED = 61  # the 5-category POP column of the --fst cells
N_FST_ROWS = 64


def _psam_cc(prefix):
    """PHENO1 of a gen_panel .psam: (case, ctrl) boolean masks."""
    import numpy as np

    with open(prefix + ".psam") as f:
        hdr = f.readline().rstrip("\n").split("\t")
        ph = np.array([ln.rstrip("\n").split("\t")[hdr.index("PHENO1")] for ln in f])
    return ph == "2", ph == "1"


def _a1_is_alt(codes):
    """1.9's A1 (the minor allele by the ALT frequency of the called
    samples, every sample a founder): True where A1 = ALT."""
    import numpy as np

    called = codes != 3
    alt = np.where(called, codes, 0).sum(1, dtype=np.int64)
    return ~(alt / (2.0 * called.sum(1)) > 0.5)


def check_epi_kernel(torch, dev, prefix):
    """K24 on indep_10k's first EPI_VARIANTS variants (the path's kept
    variants and A1 orientation, PHENO1's cases and controls): the first
    row block of 256, a ragged block of 200, a boost block of 96 (two
    groups) and a case-only block of 256 (one group), each torch.equal to
    its plain version (float32 0/1 planes, one matmul a group: exact below
    2^24 samples) and run twice alike; timed beside its bound (the lesser of
    K24's own popcounts and B8's int8 product on the tensor cores) and one
    torch._int_mm of the int8 split planes padded to multiples of 8."""
    import numpy as np

    from plink_torch.dataset import load_dataset
    from plink_torch.ops import epistasis as E

    ds = load_dataset(prefix, dev)
    pk = ds.device_all_packed()
    vidx = np.arange(EPI_VARIANTS)
    a1 = _a1_is_alt(pgen_codes(prefix, vidx))
    case, ctrl = _psam_cc(prefix)
    groups = [np.flatnonzero(case), np.flatnonzero(ctrl)]
    m = EPI_VARIANTS
    planes = E.split_planes(pk, vidx, a1, groups)
    dense = E.epi_planes_plain(pk, vidx, a1, groups)
    one = E.split_planes(pk, vidx, a1, groups[:1])
    dense1 = E.epi_planes_plain(pk, vidx, a1, groups[:1])
    blocks = (("256", planes, dense, np.arange(256)),
              ("ragged 200", planes, dense, np.arange(m - 200, m)),
              ("boost 96", planes, dense, np.arange(96)),
              ("case-only 256", one, dense1, np.arange(256)))
    for label, pl, dn, rows in blocks:
        k = E.joint_tables(pl, rows)
        assert torch.equal(k, E.joint_tables_plain(dn, rows)), \
            ("K24 differs from its plain version", label)
        assert torch.equal(k, E.joint_tables(pl, rows)), ("K24 is not deterministic", label)
    rows = np.arange(256)
    ms = time_ms(torch, lambda: E.joint_tables(planes, rows), 5)
    pack_ms = time_ms(torch, lambda: E.split_planes(pk, vidx, a1, groups), 3)
    pms = time_ms(torch, lambda: E.joint_tables_plain(dense, rows), 3)
    # the library yardstick: B8's own int8 product, one a group
    ops8, libs = [], []
    for p in dense.dense:
        s8 = -(-p.shape[2] // 8) * 8
        cols = torch.zeros((3 * m, s8), dtype=torch.int8, device=dev)
        cols[:, : p.shape[2]] = p.reshape(3 * m, -1).to(torch.int8)
        r8 = cols.reshape(3, m, s8)[:, : rows.size].reshape(3 * rows.size, s8).contiguous()
        libs.append((r8, cols.t().contiguous()))
        ops8.append(2 * 3 * rows.size * 3 * m * p.shape[2])
    lib = time_ms(torch, lambda: [torch._int_mm(a, b) for a, b in libs], 3)
    del libs, dense, dense1
    words = sum(-(-len(g) // 32) for g in groups)  # 32-sample words of both groups
    out_bytes = 4 * 9 * rows.size * m * len(groups)
    popc = 9 * rows.size * m * words
    own = _bound(popc, 4 * 3 * words * (m + rows.size) + out_bytes, POPC_PER_S)
    s_tot = sum(len(g) for g in groups)
    int8 = _bound(sum(ops8), 3 * s_tot * (m + rows.size) + out_bytes, INT8_OPS_PER_S)
    bound = min(own, int8, key=lambda b: b["bound_ms"])
    log(f"K24 epi_joint_counts [{rows.size} x {m} pairs, groups "
        f"{[len(g) for g in groups]}, {words} words]: = plain on blocks "
        f"{', '.join(b[0] for b in blocks)}, two runs identical; {ms:.3f} ms, "
        f"packing pass {pack_ms:.3f} ms, plain {pms:.2f} ms, torch._int_mm "
        f"{lib:.3f} ms, bound {bound['bound_ms']:.3f} ms: {popc} popcounts "
        f"{own['bound_ms']:.3f} ms, int8 product {int8['bound_ms']:.3f} ms")
    return [dict(name="epi_joint_counts", source="plink_torch/csrc/epi_counts.cu",
                 replaces="plink_tpu/commands/epistasis.py:596", max_abs_err=0.0,
                 tol=0.0, popcounts=popc, popcount_bound_ms=own["bound_ms"],
                 int8_bound_ms=int8["bound_ms"], pack_ms=pack_ms, ms=ms,
                 plain_ms=pms, **bound, library_ms=lib)]


def epi_argv(prefix, out, region, mods=()):
    return ["--pfile", prefix, "--extract", "bed1", region, "--fast-epistasis",
            *mods, "--allow-no-sex", "--out", out, "--silent"]


def _ueki_z2(tabs):
    """CASSI's Ueki-adjusted z^2 (1.9 fepi_counts_to_stats) of a pair from
    its two 3 x 3 tables [hom A1, het, hom A2], in numpy f64."""
    import numpy as np

    lor, var = 0.0, 0.0
    for sign, n in ((1.0, tabs[0]), (-1.0, tabs[1])):
        n = n.astype(np.float64)
        c = [4 * n[0] + 2 * (n[1] + n[3]) + n[4], 4 * n[2] + 2 * (n[1] + n[5]) + n[4],
             4 * n[6] + 2 * (n[3] + n[7]) + n[4], 4 * n[8] + 2 * (n[5] + n[7]) + n[4]]
        adj = 0.0 if (n != 0).all() else 4.5
        r = [1.0 / (x + adj) for x in c]
        h = 0.0 if adj == 0.0 else 0.5
        b2, b3, b5 = r[0] - r[1], r[0] - r[2], r[0] - r[1] - r[2] + r[3]
        b6, b8 = r[3] - r[1], r[3] - r[2]
        lor += sign * math.log((c[0] + adj) * (c[3] + adj) * r[1] * r[2])
        var += (4 * (4 * (r[0] ** 2 * (n[0] + h) + r[1] ** 2 * (n[2] + h)
                          + r[2] ** 2 * (n[6] + h) + r[3] ** 2 * (n[8] + h))
                     + b2 * b2 * (n[1] + h) + b3 * b3 * (n[3] + h)
                     + b6 * b6 * (n[5] + h) + b8 * b8 * (n[7] + h))
                + b5 * b5 * (n[4] + h))
    return lor * lor / var


def check_epi_rows(prefix, out, m):
    """N_EPI_ROWS rows of the .epi.cc (spread over the file): STAT within the
    printed 6 digits of numpy's f64 Ueki z^2 of the pair's tables, counted
    from numpy's codes; N_EPI_ROWS rows of the .summary: N_TOT = M - 1 over
    the M variants that are not monomorphic (the Ueki statistic is finite
    for every pair) and N_SIG <= N_TOT."""
    import numpy as np

    codes = pgen_codes(prefix, np.arange(m))
    case, ctrl = _psam_cc(prefix)
    both = codes[:, case | ctrl]
    kept = int((((both == 1) | (both == 2)).any(1) & ((both == 0) | (both == 1)).any(1))
               .sum())
    del both
    a1 = _a1_is_alt(codes)
    eff = np.where(a1[:, None], codes, np.where(codes == 3, 3, 2 - codes))
    planes = np.stack([eff == 2, eff == 1, eff == 0])  # [3, m, n]
    with open(out + ".epi.cc") as f:
        rows = [ln.split() for ln in f][1:]
    assert len(rows) >= N_EPI_ROWS, len(rows)
    worst = 0.0
    for r in (rows[k] for k in np.linspace(0, len(rows) - 1, N_EPI_ROWS).astype(int)):
        i, j = int(r[1][3:]), int(r[3][3:])
        tabs = [np.array([(planes[a, i, g] & planes[b, j, g]).sum()
                          for a in range(3) for b in range(3)]) for g in (case, ctrl)]
        want = _ueki_z2(tabs)
        err = abs(float(r[4]) - want) / want
        assert err <= 6e-6, (r, want)  # 6 printed digits
        worst = max(worst, err)
    with open(out + ".epi.cc.summary") as f:
        summ = [ln.split() for ln in f][1:]
    assert len(summ) == kept, (len(summ), kept)
    for r in (summ[k] for k in np.linspace(0, kept - 1, N_EPI_ROWS).astype(int)):
        assert int(r[3]) == kept - 1 and int(r[2]) <= kept - 1, r
    return len(rows), worst


def run_epi_paths(torch, prefix, tmp, card):
    """12c: `--fast-epistasis` (the CASSI Ueki statistic) over variants
    1..EPI_VARIANTS of indep_10k by `--extract bed1`, then `--fast-epistasis
    boost` over 1..EPI_BOOST_VARIANTS: K1 (the monomorphic screen and the A1
    frequencies) and K24 launched, K24 once a row block (EPI_LAUNCHES) and
    its packing pass once a run; every K24 launch kept and held to its plain
    version; N_EPI_ROWS STATs and .summary rows against numpy; the default
    run traced."""
    import numpy as np

    from plink_torch.commands import epistasis as EC
    from plink_torch.ops import epistasis as E

    paths = {}
    for label, m, mods in (("default", EPI_VARIANTS, ()),
                           ("boost", EPI_BOOST_VARIANTS, ("boost",))):
        region = os.path.join(tmp, f"epi_{label}.bed")
        with open(region, "w") as f:
            f.write(f"1\t1\t{m}\n")
        out = os.path.join(tmp, f"epi_{label}")
        with spying("split_planes", EC) as (packs, _), \
                spying("joint_tables", EC) as (calls, real):
            wall, launches = drive(torch, epi_argv(prefix, out, region, mods), out)
        assert launches["epi_joint_counts"] == len(calls) == EPI_LAUNCHES[label], launches
        assert launches["epi_split_planes"] == len(packs) == 1, launches
        assert launches["geno_counts"] > 0, launches
        dense = E.epi_planes_plain(*packs[0])
        for planes, rows in calls:
            assert torch.equal(real(planes, rows), E.joint_tables_plain(dense, rows)), \
                ("K24 differs from its plain version on the path", label, rows[0])
        del calls, packs, dense
        if label == "default":
            n_rows, worst = check_epi_rows(prefix, out, m)
            note = (f"{n_rows} rows past --epi1; {N_EPI_ROWS} STATs = numpy f64 "
                    f"(relative error <= {worst:.1e}), {N_EPI_ROWS} .summary rows "
                    f"N_TOT = M - 1")
        else:
            with open(out + ".epi.cc") as f:
                hdr = f.readline().split()
                rows = [ln.split() for ln in f]
            assert hdr[4:6] == ["STAT", "DF"] and all(
                math.isfinite(float(r[4])) for r in rows), hdr
            with open(out + ".epi.cc.summary") as f:
                assert 0.9 * m < sum(1 for _ in f) <= m + 1
            note = f"{len(rows)} rows, finite STAT and DF"
        pairs = m * (m - 1) // 2
        log(f"--fast-epistasis {label} path {IND_PANEL[0]} samples x {m} variants "
            f"({pairs} pairs): {wall:.2f}s wall on {card}, {pairs / wall:.3g} pairs/s; "
            f"K24 {launches['epi_joint_counts']} launches, each = plain; {note}; "
            f"launches {dict((k, v) for k, v in launches.items() if v)}")
        paths[f"epistasis_{label}"] = launches
    region = os.path.join(tmp, "epi_default.bed")
    trace_path(torch, epi_argv(prefix, os.path.join(tmp, "epi_traced"), region),
               "--fast-epistasis")
    return paths


def _g4_near(printed, x):
    """The 4-digit .assoc / .model field `printed` is the port's rendering
    of a value within 1e-12 relative of numpy's x."""
    from plink_torch.utils.fmt import dtoa_g_wxp4

    return printed in {dtoa_g_wxp4(v, 12).strip()
                       for v in (x * (1 - 1e-12), x, x * (1 + 1e-12))}


def check_assoc_rows(prefix, out, n_variants):
    """N_ASSOC_ROWS variants of the .assoc and .model against numpy: the
    allele and genotype counts exact (F_A / F_U and every AFF / UNAFF
    count), CHISQ / P / OR of the .assoc and CHISQ / P of the ALLELIC and
    TREND rows within 1e-12 relative of numpy f64 (as printed)."""
    import numpy as np

    from plink_torch.utils.fmt import dtoa_g_wxp4

    with open(out + ".assoc") as f:
        arows = [ln.split() for ln in f][1:]
    with open(out + ".model") as f:
        mrows = [ln.split() for ln in f][1:]
    assert len(arows) == n_variants and len(mrows) == 5 * n_variants
    vs = np.linspace(0, n_variants - 1, N_ASSOC_ROWS).astype(int)
    codes = pgen_codes(prefix, vs)
    a1 = _a1_is_alt(codes)
    case, ctrl = _psam_cc(prefix)
    for k, v in enumerate(vs):
        g = codes[k] if a1[k] else np.where(codes[k] == 3, 3, 2 - codes[k])
        cls = [[int((g[s] == c).sum()) for c in (2, 1, 0)] for s in (case, ctrl)]
        (uoo, unn, umm), (ukk, ujj, uii) = cls  # hom A1, het, hom A2
        a, b = 2.0 * uoo + unn, 2.0 * umm + unn
        c, d = 2.0 * ukk + ujj, 2.0 * uii + ujj
        r = arows[v]
        assert r[1] == f"snp{v}" and r[4] == dtoa_g_wxp4(a / (a + b), 8).strip() \
            and r[5] == dtoa_g_wxp4(c / (c + d), 8).strip(), (r, a, b, c, d)
        n = a + b + c + d
        chisq = n * (a * d - b * c) ** 2 / ((a + b) * (c + d) * (a + c) * (b + d))
        assert _g4_near(r[7], chisq) and _g4_near(r[8], math.erfc(math.sqrt(chisq / 2))) \
            and _g4_near(r[9], (a * d) / (c * b)), (r, chisq)
        m5 = mrows[5 * v : 5 * v + 5]
        want = {"GENO": (f"{uoo}/{unn}/{umm}", f"{ukk}/{ujj}/{uii}"),
                "TREND": (f"{int(a)}/{int(b)}", f"{int(c)}/{int(d)}"),
                "ALLELIC": (f"{int(a)}/{int(b)}", f"{int(c)}/{int(d)}"),
                "DOM": (f"{uoo + unn}/{umm}", f"{ukk + ujj}/{uii}"),
                "REC": (f"{uoo}/{unn + umm}", f"{ukk}/{ujj + uii}")}
        for row in m5:
            assert row[1] == f"snp{v}" and (row[5], row[6]) == want[row[4]], (row, want)
        # the trend test (1.9 ca_trend_evalx) on the A2 side, as 1.9 counts it
        tot = uoo + unn + umm + ukk + ujj + uii
        case_ct, het, homdom = uoo + unn + umm, unn + ujj, umm + uii
        dom = float(het + 2 * homdom)
        cat = (2 * umm + unn) * float(tot) - dom * case_ct
        dxx = (tot * float(het + 4 * homdom) - dom * dom) * (case_ct * float(tot - case_ct))
        trend = cat * cat * tot / dxx
        for row, x in ((m5[1], trend), (m5[2], chisq)):
            assert _g4_near(row[7], x) and _g4_near(row[9], math.erfc(math.sqrt(x / 2))), \
                (row, x)


def run_assoc_path(torch, prefix, out, card, n_variants):
    """4g: `--assoc --model --allow-no-sex` on phase 4's panel: K1 launched
    (the case / control counts and the A1 frequencies); N_ASSOC_ROWS
    variants of each report against numpy; traced."""
    argv = ["--pfile", prefix, *ASSOC_ARGS, "--out", out, "--silent"]
    wall, launches = drive(torch, argv, out)
    assert launches["geno_counts"] > 0, launches
    check_assoc_rows(prefix, out, n_variants)
    log(f"--assoc --model path {N_SAMPLES}x{n_variants}: {wall:.2f}s wall on {card}; "
        f"{N_ASSOC_ROWS} variants of .assoc and .model = numpy (counts exact, "
        f"CHISQ / P / OR within 1e-12 as printed); launches "
        f"{dict((k, v) for k, v in launches.items() if v)}")
    trace_path(torch, argv[:-3] + ["--out", out + "_traced", "--silent"], "--assoc --model")
    return launches


def _fst_numpy(c1, c2, method):
    """Per-variant (numer, denom, valid) of Hudson's or Weir-Cockerham's
    Fst from two populations' genotype counts [V, 3] (hom-REF, het,
    hom-ALT), in numpy f64 (2.0 FstThread)."""
    import numpy as np

    with np.errstate(divide="ignore", invalid="ignore"):
        if method == "hudson":
            ref1, alt1 = 2 * c1[:, 0] + c1[:, 1], 2 * c1[:, 2] + c1[:, 1]
            ref2, alt2 = 2 * c2[:, 0] + c2[:, 1], 2 * c2[:, 2] + c2[:, 1]
            n1, n2 = ref1 + alt1, ref2 + alt2
            n_diff = n1 * n2 - (ref1 * ref2 + alt1 * alt2)

            def within(r, a, n):
                return (n * (n - 1) / 2 - (r * r + a * a - n) / 2) / (n * (n - 1))

            denom = n_diff / (n1 * n2)
            numer = denom - within(ref1, alt1, n1) - within(ref2, alt2, n2)
            return numer, denom, (n_diff > 0) & np.isfinite(numer) & (denom != 0)
        n1, n2 = c1.sum(1), c2.sum(1)
        nt = n1 + n2
        p1, p2 = (2 * c1[:, 0] + c1[:, 1]) / (2 * n1), (2 * c2[:, 0] + c2[:, 1]) / (2 * n2)
        pb = (2 * c1[:, 0] + c1[:, 1] + 2 * c2[:, 0] + c2[:, 1]) / (2 * nt)
        nbar = nt / 2
        nc = nt - (n1 * n1 + n2 * n2) / nt
        s2 = (n1 * (p1 - pb) ** 2 + n2 * (p2 - pb) ** 2) * 2 / nt
        hb = (c1[:, 1] + c2[:, 1]) / nt
        pq = pb * (1 - pb)
        a = nbar / nc * (s2 - (pq - s2 / 2 - hb / 4) / (nbar - 1))
        b = nbar / (nbar - 1) * (pq - s2 / 2 - (0.5 - 0.5 / nt) * hb)
        c = hb / 2
        mono = (pb == 0) | (pb == 1)
        a, b, c = (np.where(mono, 0.0, x) for x in (a, b, c))
        denom = a + b + c
        return a, denom, (denom != 0) & np.isfinite(a)


def run_fst_paths(torch, prefix, tmp, card):
    """12d: `--fst POP method=hudson report-variants`, then `method=wc`, on
    indep_10k with a 5-category POP column (numpy seed FST_SEED): K1
    launched (five masks: two launches); each .fst.summary (ten pairs)
    within its printed 6 digits of numpy f64 from numpy's per-population
    counts, and N_FST_ROWS rows of the first pair's .fst.var likewise."""
    import numpy as np

    from plink_torch.testing import FST_POPS

    n, m = IND_PANEL[:2]
    rng = np.random.default_rng(FST_SEED)
    pop = rng.integers(0, len(FST_POPS), n)
    popf = os.path.join(tmp, "pop.txt")
    with open(popf, "w") as f:
        f.write("#IID\tPOP\n")
        f.writelines(f"per{i}\t{FST_POPS[k]}\n" for i, k in enumerate(pop))
    codes = pgen_codes(prefix, np.arange(m))
    cts = []
    for k in range(len(FST_POPS)):
        sub = codes[:, pop == k]
        cts.append(np.stack([(sub == c).sum(1) for c in range(3)], 1).astype(np.float64))
    del codes, sub
    launches = {}
    for method in ("hudson", "wc"):
        out = os.path.join(tmp, f"fst_{method}")
        wall, launches[method] = drive(torch, [
            "--pfile", prefix, "--pheno", popf, "--fst", "POP", f"method={method}",
            "report-variants", "--out", out, "--silent"], out)
        assert launches[method]["geno_counts"] >= 2, launches[method]  # 3 + 2 masks
        with open(out + ".fst.summary") as f:
            summ = [ln.split() for ln in f][1:]
        assert len(summ) == 10, summ
        worst = 0.0
        for a, b, v in summ:
            num, den, ok = _fst_numpy(cts[FST_POPS.index(a)], cts[FST_POPS.index(b)],
                                      method)
            want = num[ok].sum() / den[ok].sum()
            worst = max(worst, abs(float(v) - want) / abs(want))
        a, b = summ[0][:2]
        num, den, ok = _fst_numpy(cts[FST_POPS.index(a)], cts[FST_POPS.index(b)], method)
        with open(f"{out}.{a}.{b}.fst.var") as f:
            var = [ln.split() for ln in f][1:]
        assert len(var) == m
        for k in np.linspace(0, m - 1, N_FST_ROWS).astype(int):
            got = var[k][-1]
            if not ok[k]:
                assert got == "nan", var[k]
                continue
            worst = max(worst, abs(float(got) - num[k] / den[k]) / abs(num[k] / den[k]))
        assert worst <= 6e-6, worst  # 6 printed digits
        log(f"--fst POP method={method} report-variants {n}x{m}: {wall:.2f}s wall on "
            f"{card}; 10 pair summaries and {N_FST_ROWS} .fst.var rows = numpy f64 "
            f"(relative error <= {worst:.1e}); launches "
            f"{dict((k, v) for k, v in launches[method].items() if v)}")
    return {"fst_hudson": launches["hudson"], "fst_wc": launches["wc"]}


def run_epi_assoc_parity(tmp):
    """17h: plink_torch.testing.EPI_RUNS and A19_RUNS, the cases of
    tests/test_torch_epistasis.py and tests/test_torch_assoc19.py, on a
    200 x 600 panel (seed 91), its chr1 / chr2 and chr1/X/Y/MT copies and a
    65,536 x 128 panel, CUDA against CPU: every output byte for byte, the
    .log result lines equal, the refusals alike (FlagError messages; exit
    code 2 for the runs not yet ported); a second card run the same."""
    from plink_torch import cli
    from plink_torch.bench_gen import gen_panel
    from plink_torch.testing import (A19_NOT_PORTED, A19_RUNS, EPI_ERRORS, EPI_RUNS,
                                     pair_log_lines, pair_output_same, write_epi_inputs)

    d = os.path.join(tmp, "epi")
    os.makedirs(d)
    gen_panel(os.path.join(d, "p"), 200, 600, miss_rate=0.05, seed=91)
    gen_panel(os.path.join(d, "wide"), 65_536, 128, miss_rate=0.02, seed=5)
    write_epi_inputs(d, os.path.join(d, "p"))
    os.environ["PLINK_TORCH_VB"] = "64"
    secs = {"cuda": 0.0, "cpu": 0.0, "cuda2": 0.0}
    n_runs = 0
    try:
        for runs, errors in ((EPI_RUNS, EPI_ERRORS), (A19_RUNS, {})):
            for label, fs, flags, exts in runs:
                argv = (["--pfile", os.path.join(d, fs), *(a.format(d=d) for a in flags)]
                        + ([] if label == "sx_sexed" else ["--allow-no-sex"]))
                outs, errs = {}, {}
                for tag in ("cuda", "cpu", "cuda2"):
                    os.environ["PLINK_TORCH_DEVICE"] = tag.rstrip("2")
                    outs[tag] = os.path.join(d, f"{tag}_{label}")
                    t0 = time.perf_counter()
                    try:
                        errs[tag] = cli.main(argv + ["--out", outs[tag], "--silent"])
                    except ValueError as e:  # FlagError is one
                        errs[tag] = str(e)
                    secs[tag] += time.perf_counter() - t0
                want = errors.get(label, 2 if label in A19_NOT_PORTED else 0)
                assert errs["cuda"] == errs["cpu"] == errs["cuda2"] == want, (label, errs)
                for ext in exts:
                    assert pair_output_same(outs["cpu"] + ext, outs["cuda"] + ext), \
                        (label, ext)
                    assert pair_output_same(outs["cuda2"] + ext, outs["cuda"] + ext), \
                        ("two CUDA runs differ", label, ext)
                if exts:
                    lines = pair_log_lines(outs["cuda"])
                    assert lines and lines == pair_log_lines(outs["cpu"]), label
                    assert lines == pair_log_lines(outs["cuda2"]), label
                n_runs += 1
        log(f"epistasis / assoc parity: {n_runs} runs of testing.EPI_RUNS and "
            f"A19_RUNS CUDA = CPU (outputs byte for byte, .log result lines, "
            f"{len(EPI_ERRORS)} refusals and {len(A19_NOT_PORTED)} not-ported runs "
            f"alike), two CUDA runs byte-identical; CUDA {secs['cuda']:.1f}s, CPU "
            f"{secs['cpu']:.1f}s")
    finally:
        for k in ("PLINK_TORCH_VB", "PLINK_TORCH_DEVICE"):
            os.environ.pop(k, None)


def joint_panel(tmp):
    """The joint-model paths' panel: 500,000 x JOINT_VARIANTS, made as the
    main panel (seed 42, its covariates and QT1)."""
    jprefix = os.path.join(tmp, "jpanel")
    t0 = time.perf_counter()
    make_panel(jprefix, N_SAMPLES, JOINT_VARIANTS, 42)
    log(f"panel {N_SAMPLES}x{JOINT_VARIANTS}: {time.perf_counter() - t0:.1f}s")
    return jprefix


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
    phase_secs = {}
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
        t0 = stamp("joint-model kernels")
        rows += check_joint_kernels(torch, dev, prefix)
        torch.cuda.empty_cache()
        phase_secs["joint-model kernels"] = time.perf_counter() - t0
        t0 = stamp("permutation kernels")
        rows += check_perm_kernels(torch, dev, prefix)
        torch.cuda.empty_cache()
        phase_secs["permutation kernels"] = time.perf_counter() - t0
        t0 = stamp("dosage kernels and widths past 96")
        dprefix = dosage_panel(tmp)
        rows += check_dense_kernels(torch, dev, dprefix)
        torch.cuda.empty_cache()
        wide128 = check_wide128(torch, dev, prefix)
        for r in rows:
            r.update(wide128.get(r["name"], {}))
        torch.cuda.empty_cache()
        phase_secs["dosage kernels"] = time.perf_counter() - t0
        t0 = stamp("--glm modifier kernel modes")
        rows += check_modifier_kernels(torch, dev, prefix)
        torch.cuda.empty_cache()
        phase_secs["modifier kernels"] = time.perf_counter() - t0
        t0 = stamp("weighted plane kernels")
        rows += check_weighted_kernels(torch, dev, prefix)
        phase_secs["weighted plane kernels"] = time.perf_counter() - t0
        stamp("logistic main path")
        paths = {"logistic": run_main_path(torch, prefix, os.path.join(tmp, "main"),
                                           card, args.variants)}
        trace_path(torch, logistic_argv(prefix, os.path.join(tmp, "traced")),
                   "logistic")
        t0 = stamp("cc-residualize path")
        paths["cc_residualize"] = run_resid_path(
            torch, prefix, os.path.join(tmp, "resid"), card, args.variants)
        trace_path(torch, resid_argv(prefix, os.path.join(tmp, "resid_traced")),
                   "cc-residualize")
        phase_secs["cc-residualize path"] = time.perf_counter() - t0
        stamp("QC + linear path")
        paths["qc_linear"] = run_qc_linear(torch, prefix, os.path.join(tmp, "qc"),
                                           card, args.variants)
        trace_path(torch, qc_argv(prefix, os.path.join(tmp, "qc_traced")),
                   "QC + linear")
        t0 = stamp("--xchr-model 1 paths")
        xm = run_xm1_paths(torch, prefix, tmp, card, args.variants)
        paths["xm1_logistic"], paths["xm1_linear"] = xm["logistic"], xm["linear"]
        phase_secs["--xchr-model 1 paths"] = time.perf_counter() - t0
        t0 = stamp("sample-report path")
        paths["sample_reports"] = run_sample_report_path(torch, dev, prefix, tmp, card)
        phase_secs["sample-report path"] = time.perf_counter() - t0
        t0 = stamp("--check-sex path")
        paths["check_sex"] = run_check_sex_path(torch, dev, prefix, tmp, card,
                                                args.variants)
        torch.cuda.empty_cache()
        phase_secs["--check-sex path"] = time.perf_counter() - t0
        t0 = stamp("--assoc / --model path")
        paths["assoc_model"] = run_assoc_path(torch, prefix, os.path.join(tmp, "assoc"),
                                              card, args.variants)
        phase_secs["--assoc / --model path"] = time.perf_counter() - t0
        t0 = stamp("joint-model paths")
        jprefix = joint_panel(tmp)
        paths.update(run_joint_paths(torch, jprefix, tmp, card, JOINT_VARIANTS))
        phase_secs["joint-model paths"] = time.perf_counter() - t0
        t0 = stamp("permutation paths")
        paths.update(run_perm_paths(torch, jprefix, tmp, card))
        torch.cuda.empty_cache()
        phase_secs["permutation paths"] = time.perf_counter() - t0
        t0 = stamp("dosage paths")
        paths.update(run_dosage_paths(torch, dprefix, tmp, card))
        phase_secs["dosage paths"] = time.perf_counter() - t0
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
        t0 = stamp("K23 wmiss_gram")
        rows += check_wmiss_kernel(torch, dev, p2)
        torch.cuda.empty_cache()
        phase_secs["K23 check"] = time.perf_counter() - t0
        t0 = stamp("--distance path")
        paths["distance"] = run_distance_path(torch, p2, os.path.join(tmp, "dist"),
                                              card)
        trace_path(torch, dist_argv(p2, os.path.join(tmp, "dist_traced")), "--distance")
        os.remove(os.path.join(tmp, "dist_traced.dist.bin"))
        torch.cuda.empty_cache()
        phase_secs["--distance path"] = time.perf_counter() - t0
        t0 = stamp("K24 epi_joint_counts")
        rows += check_epi_kernel(torch, dev, p2)
        torch.cuda.empty_cache()
        phase_secs["K24 check"] = time.perf_counter() - t0
        t0 = stamp("--fast-epistasis paths")
        paths.update(run_epi_paths(torch, p2, tmp, card))
        torch.cuda.empty_cache()
        phase_secs["--fast-epistasis paths"] = time.perf_counter() - t0
        t0 = stamp("--fst paths")
        paths.update(run_fst_paths(torch, p2, tmp, card))
        phase_secs["--fst paths"] = time.perf_counter() - t0
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
        t0 = stamp("--glm modifier parity")
        run_modifier_parity(tmp, os.path.join(tmp, "small"), *SMALL[:2])
        phase_secs["modifier parity"] = time.perf_counter() - t0
        t0 = stamp("joint-model parity")
        run_joint_parity(tmp, os.path.join(tmp, "small"), *SMALL[:2])
        phase_secs["joint-model parity"] = time.perf_counter() - t0
        t0 = stamp("dosage parity")
        run_dosage_parity(tmp)
        phase_secs["dosage parity"] = time.perf_counter() - t0
        t0 = stamp("permutation parity")
        run_perm_parity(tmp, os.path.join(tmp, "small"), *SMALL[:2])
        phase_secs["permutation parity"] = time.perf_counter() - t0
        t0 = stamp("sample-report parity")
        run_sample_parity(tmp, os.path.join(tmp, "small"), os.path.join(tmp, "dsmall"))
        phase_secs["sample-report parity"] = time.perf_counter() - t0
        t0 = stamp("pair-report parity")
        run_pair_parity(tmp)
        phase_secs["pair-report parity"] = time.perf_counter() - t0
        t0 = stamp("epistasis / assoc parity")
        run_epi_assoc_parity(tmp)
        phase_secs["epistasis / assoc parity"] = time.perf_counter() - t0
        stamp("done")
        log("slice-6 to 12 phases: " + ", ".join(f"{k} {v:.1f}s"
                                              for k, v in phase_secs.items()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lib_names = {"glm_irls_pass": "glm_irls"}
    for r in rows:
        r["route"] = "cuda"
        by_path = {p: ln[lib_names.get(r["name"], r["name"])]
                   for p, ln in paths.items()}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
        if r["name"] == "glm_dense_irls":  # K18's firth2 mode on the paths
            r["firth2_launches"] = sum(ln["glm_dense_firth"] for ln in paths.values())
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
