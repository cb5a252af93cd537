"""--sample-counts: per-sample genotype class counts.

Port of plink_tpu/commands/sample_counts.py.  Behavior reference:
SampleCounts (2.0/plink2_misc.cc:7000-area; header table :6979).  Default
columns:
  HOM_REF_CT                      hom-ref genotypes, all variants
  HOM_ALT_SNP_CT / HET_SNP_CT     hom-alt / het at SNPs (both alleles len-1,
                                  non-symbolic)
  DIPLOID_TRANSITION_CT           genotypes carrying >=1 ALT at A<->G / C<->T
                                  SNPs (genotype count, not allele count)
  DIPLOID_TRANSVERSION_CT         same at other base-pair SNPs
  DIPLOID_NONSNP_NONSYMBOLIC_CT   ALT-carrying genotypes at non-SNP variants
  DIPLOID_SINGLETON_CT            het calls where the minor allele count is 1
  HAP_REF/HAP_ALT/MISSING_INCL_FEMALE_Y_CT

Sex-chromosome haploid accounting is not implemented, as in plink_tpu (the
HAP_* columns are only correct for autosomal data).

The ten columns' weights are 0/1 variant selectors, so one K21 launch sums
them in f32 (plink_tpu's f64=False) within splits of at most 2^24 variants
and adds the splits in f64, as plink_tpu adds its f32 blocks on the host:
exact integers at any variant count.
"""

from __future__ import annotations

import numpy as np

from ..dataset import Dataset
from ..ops.counts import weighted_sample_sums
from ..utils.logging import RunLogger

_TS = {("A", "G"), ("G", "A"), ("C", "T"), ("T", "C")}
_BASES = {"A", "C", "G", "T"}


def write_sample_counts(ds: Dataset, out_prefix: str, log: RunLogger) -> None:
    vi = ds.vi
    alt1 = vi.alt1()
    is_snp = np.array(
        [len(str(r)) == 1 and len(str(a)) == 1 and not str(a).startswith("<")
         for r, a in zip(vi.ref, alt1)]
    )
    is_ts = np.array(
        [(str(r).upper(), str(a).upper()) in _TS for r, a in zip(vi.ref, alt1)]
    )
    is_base_pair = np.array(
        [str(r).upper() in _BASES and str(a).upper() in _BASES
         for r, a in zip(vi.ref, alt1)]
    )
    is_tv = is_snp & is_base_pair & ~is_ts
    is_ts = is_snp & is_ts
    is_nonsnp = ~is_snp & ~np.array([str(a).startswith("<") for a in alt1])

    gc = ds.geno_counts()
    # ref GetSingletonIdx (:6016-6034): a singleton variant has exactly ONE
    # sample with a non-ref non-missing genotype (het or hom-alt); that
    # carrier gets the count
    singleton = (gc[:, 1] + gc[:, 2]) == 1

    vmask = ds.variant_mask
    specs = {
        # name -> (homref w, het w, homalt w, miss w) variant selectors
        "HOM_REF_CT": (vmask, None, None, None),
        "HOM_ALT_SNP_CT": (None, None, vmask & is_snp, None),
        "HET_SNP_CT": (None, vmask & is_snp, None, None),
        "DIPLOID_TRANSITION_CT": (None, vmask & is_ts, vmask & is_ts, None),
        "DIPLOID_TRANSVERSION_CT": (None, vmask & is_tv, vmask & is_tv, None),
        "DIPLOID_NONSNP_NONSYMBOLIC_CT": (
            None, vmask & is_nonsnp, vmask & is_nonsnp, None,
        ),
        "DIPLOID_SINGLETON_CT": (None, vmask & singleton, vmask & singleton, None),
        "HAP_REF_INCL_FEMALE_Y_CT": (None, None, None, None),
        "HAP_ALT_INCL_FEMALE_Y_CT": (None, None, None, None),
        "MISSING_INCL_FEMALE_Y_CT": (None, None, None, vmask),
    }
    wts = np.zeros((ds.raw_variant_ct, 4, len(specs)))
    for k, sels in enumerate(specs.values()):
        for p, s in enumerate(sels):
            if s is not None:
                wts[:, p, k] = s
    sums = dict(zip(specs, weighted_sample_sums(
        ds.device_all_packed(), ds.raw_sample_ct, wts, f64=False)))

    inc = np.flatnonzero(ds.sample_mask)
    si = ds.si
    use_fid = si.has_fid and any(str(si.fid[i]) != "0" for i in inc)
    path = out_prefix + ".scount"
    with open(path, "w") as f:
        f.write(
            ("#FID\tIID" if use_fid else "#IID") + "\t" + "\t".join(specs) + "\n"
        )
        cts = np.rint(np.stack([sums[k] for k in specs], 1)).astype(np.int64)
        for i, row in zip(inc.tolist(), cts[inc].tolist()):
            idp = f"{si.fid[i]}\t{si.iid[i]}" if use_fid else str(si.iid[i])
            f.write(idp + "".join(f"\t{v}" for v in row) + "\n")
    log.log(f"--sample-counts: Results written to {path} .")
