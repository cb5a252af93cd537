"""Allele counts and frequencies (the parts of plink_tpu's
commands/basic_reports.py that --glm reads), counted by kernel K1.

Sex-chromosome conventions (matching the reference):
- chrX: females contribute 2 alleles, males 1 (het male X = "hethap",
  treated as missing); chrY: only males, haploid; MT: haploid for all.
"""

from __future__ import annotations

import numpy as np

from .. import NotPortedError
from ..dataset import Dataset
from ..ops.counts import _np_counts_masked, geno_counts_multimask_all
from ..utils.chrom import MT_CODE, X_CODE, Y_CODE


def _group_counts(ds: Dataset, founders_only: bool) -> dict[str, np.ndarray]:
    """Counts [M,4] for 'all', 'male', 'female' subsets of included samples
    (single pass over all three masks)."""
    base = ds.sample_mask & (ds.founder_mask if founders_only else True)
    masks = [base, base & ds.male_mask(), base & ds.female_mask()]
    if ds.raw_variant_ct * ds.raw_sample_ct <= 1 << 22:
        # tiny panel: the exact host count is cheaper than a device pass
        pk = ds.all_packed()
        padm = [np.pad(m.astype(np.float32), (0, pk.shape[1] * 4 - m.size))
                for m in masks]
        cat = [_np_counts_masked(pk, m) for m in padm]
    else:
        cat = geno_counts_multimask_all(ds.device_all_packed(), ds.raw_sample_ct,
                                        masks, ds.raw_variant_ct)
    return {"all": cat[0], "male": cat[1], "female": cat[2]}


def allele_counts_and_obs(ds: Dataset, founders_only: bool = False):
    """Per-variant (alt_allele_ct, obs_allele_ct) honoring X/Y/MT ploidy.

    Rules verified against LoadAlleleAndGenoCountsThread
    (2.0/plink2_data.cc:2540-2660):
    - chrX: nonmales (incl. unknown sex) diploid; males haploid with EVERY
      nonmissing male counted and a het male contributing half an ALT;
    - chrY: nonfemales only, haploid, het = half an ALT;
    - chrMT: all samples haploid, het = half an ALT.
    Returns (alt_ct, obs_ct) float64 [M] (half-allele granularity).
    """
    cts = _group_counts(ds, founders_only)
    chrom = ds.vi.chrom
    is_x = chrom == X_CODE
    is_y = chrom == Y_CODE
    is_mt = chrom == MT_CODE
    a = cts["all"].astype(np.float64)
    m = cts["male"].astype(np.float64)
    f = cts["female"].astype(np.float64)
    nm = a - m  # nonmales (females + unknown sex)
    nf = a - f  # nonfemales (males + unknown sex)
    # Diploid default.
    alt = a[:, 1] + 2 * a[:, 2]
    obs = 2 * (a[:, 0] + a[:, 1] + a[:, 2])
    # chrX: nonmales diploid + males haploid with het = 0.5.
    x_alt = (nm[:, 1] + 2 * nm[:, 2]) + (m[:, 2] + 0.5 * m[:, 1])
    x_obs = 2 * (nm[:, 0] + nm[:, 1] + nm[:, 2]) + (m[:, 0] + m[:, 1] + m[:, 2])
    alt = np.where(is_x, x_alt, alt)
    obs = np.where(is_x, x_obs, obs)
    # chrY: nonfemales haploid, het = 0.5.
    alt = np.where(is_y, nf[:, 2] + 0.5 * nf[:, 1], alt)
    obs = np.where(is_y, nf[:, 0] + nf[:, 1] + nf[:, 2], obs)
    # MT: all samples haploid, het = 0.5.
    alt = np.where(is_mt, a[:, 2] + 0.5 * a[:, 1], alt)
    obs = np.where(is_mt, a[:, 0] + a[:, 1] + a[:, 2], obs)
    return alt, obs


def alt_allele_freqs(ds: Dataset, founders_only: bool = True) -> np.ndarray:
    """ALT allele frequencies (founders by default, the reference's
    MAF-filter convention); hardcalls only."""
    if ds.has_dosage:
        raise NotPortedError("dosage tracks are not yet ported to plink_torch")
    alt, obs = allele_counts_and_obs(ds, founders_only)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(obs > 0, alt / obs, np.nan)


def _provref_strs(ds: Dataset):
    hdr = ds.reader.header
    if hdr.all_provisional:
        return "\tPROVISIONAL_REF?", lambda i: "\tY"
    if hdr.provisional_ref is not None:
        pr = hdr.provisional_ref
        # maybeprovref semantics: the column appears only when at least one
        # INCLUDED variant has a provisional REF (ref ProvrefCol,
        # 2.0/plink2_common.h:1549-1561)
        if bool(pr[ds.variant_mask].any()):
            return "\tPROVISIONAL_REF?", lambda i: "\tY" if pr[i] else "\tN"
        return "", lambda i: ""
    if ds.reader.header.mode == 0x01:
        return "\tPROVISIONAL_REF?", lambda i: "\tY"
    return "", lambda i: ""
