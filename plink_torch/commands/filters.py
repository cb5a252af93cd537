"""Sample/variant filters (ref: 2.0/plink2_filter.cc), as far as this port
runs them; port of plink_tpu/commands/filters.py.

Each filter narrows ds.sample_mask / ds.variant_mask, and every sample
filter drops the dataset's cached counts.  The application order follows
the reference's fixed Plink2Core sequence (2.0/plink2.cc:1325-1770) and is
kept by pipeline.py: sample filters (keep/remove, founders, mind) before
variant filters (extract/exclude/chr, geno, hwe, maf/mac).
"""

from __future__ import annotations

import numpy as np

from ..dataset import Dataset
from ..ops.counts import sample_missing_counts
from ..stats.hwe import hwe_exact_thresh
from ..utils.chrom import MT_CODE, X_CODE, XY_CODE, Y_CODE
from ..utils.logging import RunLogger
from .basic_reports import allele_counts_and_obs


def keep_remove_samples(ds: Dataset, path: str, keep: bool, log: RunLogger) -> None:
    """--keep / --remove: FID IID (or IID-only) files."""
    wanted_raw = []
    with open(path) as f:
        for ln in f:
            t = ln.split()
            if not t or t[0].startswith("#"):
                continue
            wanted_raw.append(t)
    # Match on FID+IID when two columns present, else IID alone.
    two_col = {f"{t[0]}\t{t[1]}" for t in wanted_raw if len(t) >= 2}
    one_col = {t[0] for t in wanted_raw if len(t) == 1}
    fid_iid = np.array([f"{f}\t{i}" for f, i in zip(ds.si.fid, ds.si.iid)], dtype=object)
    hit = np.isin(fid_iid, list(two_col)) | np.isin(ds.si.iid, list(one_col))
    before = ds.sample_ct
    ds.sample_mask &= hit if keep else ~hit
    ds.invalidate_counts()
    log.log(
        f"--{'keep' if keep else 'remove'}: {ds.sample_ct} sample"
        f"{'s' if ds.sample_ct != 1 else ''} remaining (was {before})."
    )


def _interval_hit(ds: Dataset, files, one_based: bool) -> np.ndarray:
    """Variant membership in any interval of the given bed0/bed1 files
    (bed1/range: pos in [start, end]; bed0: pos in [start+1, end],
    matching the reference's interval handling in plink2_set.cc)."""
    hit = np.zeros(ds.raw_variant_ct, bool)
    ci = ds.vi.chr_info
    for path in files:
        with open(path) as f:
            for ln in f:
                t = ln.split()
                if len(t) < 3 or t[0].lower() in ("chr", "#chrom"):
                    continue
                try:
                    start, end = int(t[1]), int(t[2])
                except ValueError:
                    continue
                code = ci.code(t[0])
                lo = start if one_based else start + 1
                hit |= (
                    (ds.vi.chrom == code)
                    & (ds.vi.pos >= lo)
                    & (ds.vi.pos <= end)
                )
    return hit


def _token_hit(ds: Dataset, files) -> np.ndarray:
    ids = set()
    for path in files:
        with open(path) as f:
            for ln in f:
                ids.update(ln.split())
    return np.isin(ds.vi.vid.astype(str), list(ids))


def extract_exclude_variants(ds: Dataset, args, extract: bool,
                             log: RunLogger) -> None:
    """--extract / --exclude: variant-ID token files, or interval files with
    a leading bed0/bed1/range modifier (plink2_filter.cc token path,
    plink2_set.cc interval path)."""
    if isinstance(args, str):
        args = (args,)
    mode = None
    if args and args[0] in ("bed0", "bed1", "range"):
        mode, args = args[0], args[1:]
    flag = "extract" if extract else "exclude"
    if mode is None:
        hit = _token_hit(ds, args)
        tag = f"--{flag}"
    else:
        hit = _interval_hit(ds, args, one_based=mode != "bed0")
        tag = f"--{flag} {mode}"
    ds.variant_mask &= hit if extract else ~hit
    log.log(f"{tag}: {ds.variant_ct} variants remaining.")


def filter_chr(ds: Dataset, chr_names: list[str], log: RunLogger, keep: bool = True) -> None:
    """--chr / --not-chr."""
    codes = set()
    for name in chr_names:
        if "-" in name and not name.lower().startswith("chr"):
            lo, hi = name.split("-")
            codes.update(range(int(lo), int(hi) + 1))
        else:
            codes.add(ds.vi.chr_info.code(name))
    hit = np.isin(ds.vi.chrom, list(codes))
    ds.variant_mask &= hit if keep else ~hit
    log.log(f"--{'chr' if keep else 'not-chr'}: {ds.variant_ct} variants remaining.")


def filter_autosomes(ds: Dataset, log: RunLogger,
                     include_par: bool = False) -> None:
    keep = ds.vi.chr_info.is_autosomal(ds.vi.chrom)
    if include_par:
        # --autosome-par additionally keeps the XY pseudo-autosomal code
        keep = keep | (ds.vi.chrom == XY_CODE)
    ds.variant_mask &= keep
    flag = "--autosome-par" if include_par else "--autosome"
    log.log(f"{flag}: {ds.variant_ct} variants remaining.")


def keep_founders_filter(ds: Dataset, founders: bool, log: RunLogger) -> None:
    """--keep-founders / --keep-nonfounders."""
    before = ds.sample_ct
    if founders:
        ds.sample_mask &= ds.founder_mask
    else:
        ds.sample_mask &= ~ds.founder_mask
    ds.invalidate_counts()
    flag = "--keep-founders" if founders else "--keep-nonfounders"
    log.log(f"{flag}: {ds.sample_ct} samples remaining ({before - ds.sample_ct} removed).")


def mind_filter(ds: Dataset, thresh: float, log: RunLogger) -> None:
    """--mind: remove samples with missing-call rate > thresh
    (ref: MindFilter, 2.0/plink2_filter.h:112); the per-sample missing
    counts are one K5 launch."""
    vmask = ds.variant_mask.astype(np.float32)
    miss = sample_missing_counts(ds.count_matrix(), ds.raw_sample_ct, [vmask])[0]
    obs = int(ds.variant_mask.sum())
    before = ds.sample_ct
    if obs:
        keep = miss <= thresh * obs
        ds.sample_mask &= keep
        ds.invalidate_counts()
    removed = before - ds.sample_ct
    log.log(f"{removed} sample{'s' if removed != 1 else ''} removed due to "
            f"missing genotype data (--mind).")


def geno_filter(ds: Dataset, thresh: float, log: RunLogger) -> None:
    """--geno: remove variants with missing-call rate > thresh."""
    cts = ds.geno_counts()
    n = cts.sum(axis=1)
    before = ds.variant_ct
    with np.errstate(invalid="ignore", divide="ignore"):
        ok = np.where(n > 0, cts[:, 3] / np.maximum(n, 1) <= thresh, True)
    ds.variant_mask &= ok
    removed = before - ds.variant_ct
    log.log(f"{removed} variant{'s' if removed != 1 else ''} removed due to "
            f"missing genotype data (--geno).")


def maf_filter(
    ds: Dataset,
    log: RunLogger,
    min_af: float | None = None,
    max_af: float | None = None,
    min_ac: float | None = None,
    max_ac: float | None = None,
    nonfounders: bool = False,
) -> None:
    """--maf/--max-maf/--mac/--max-mac (founders-based by default)."""
    alt, obs = allele_counts_and_obs(ds, founders_only=not nonfounders)
    with np.errstate(invalid="ignore", divide="ignore"):
        af = np.where(obs > 0, alt / obs, np.nan)
    maf = np.minimum(af, 1 - af)
    mac = np.minimum(alt, obs - alt)
    before = ds.variant_ct
    ok = np.ones(ds.raw_variant_ct, dtype=bool)
    if min_af is not None:
        ok &= ~(maf < min_af) & ~np.isnan(maf)
    if max_af is not None:
        ok &= ~(maf > max_af) & ~np.isnan(maf)
    if min_ac is not None:
        ok &= mac >= min_ac
    if max_ac is not None:
        ok &= mac <= max_ac
    ds.variant_mask &= ok
    removed = before - ds.variant_ct
    log.log(f"{removed} variant{'s' if removed != 1 else ''} removed due to "
            f"allele frequency threshold(s).")


def hwe_filter(ds: Dataset, thresh: float, midp: bool, log: RunLogger) -> None:
    """--hwe: remove variants failing the HWE exact test
    (ref: EnforceHweThresh, 2.0/plink2_filter.h:118; founders-based,
    chrX female-only).  Founders and founder females count in one K1
    launch."""
    base = ds.sample_mask & ds.founder_mask
    is_x = ds.vi.chrom == X_CODE
    cts, cts_f = ds.counts([base, base & ds.female_mask()])
    cts = np.where(is_x[:, None], cts_f, cts)
    fails = hwe_exact_thresh(cts[:, 0], cts[:, 1], cts[:, 2], thresh, midp=midp)
    # No HWE test on haploid chromosomes.
    fails &= ~np.isin(ds.vi.chrom, (Y_CODE, MT_CODE))
    before = ds.variant_ct
    ds.variant_mask &= ~fails
    removed = before - ds.variant_ct
    log.log(f"--hwe: {removed} variant{'s' if removed != 1 else ''} removed due to "
            f"Hardy-Weinberg exact test (founders only).")
