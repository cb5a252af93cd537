"""--het: method-of-moments inbreeding / heterozygosity report.

Port of plink_tpu/commands/het.py.  Behavior reference: HetReport /
HetThread (2.0/plink2_misc.cc:10389, :9819):
- autosomal biallelic variants only; monomorphic variants (2*p*q < 2^-35)
  are skipped entirely (do not contribute to OBS_CT);
- E(HET)_i = sum over observed polymorphic variants of 2*ref_freq*alt_freq
  (founder-based freqs), E(HOM) = OBS - E(HET);
- F = (O(HOM) - E(HOM)) / (OBS - E(HOM)).
Output: <out>.het with #[FID\t]IID O(HOM) E(HOM) OBS_CT F.

'small-sample' (HetThread allele_freqs == nullptr branch, :9930-9940):
per-variant E(HET) becomes Nei's 2*n1*n2/(d*(d-1)) over FOUNDER hardcall
allele counts, with zero-count variants skipped as monomorphic.

The three per-sample sums (missing calls, het calls and the missing calls'
E(HET)) are one K21 launch over the device-resident matrix.
"""

from __future__ import annotations

import numpy as np

from ..dataset import Dataset
from ..ops.counts import weighted_sample_sums
from ..utils.fmt import g6
from ..utils.logging import RunLogger
from .basic_reports import _group_counts, alt_allele_freqs


def write_het(ds: Dataset, out_prefix: str, log: RunLogger,
              small_sample: bool = False) -> None:
    auto = ds.vi.chr_info.is_autosomal(ds.vi.chrom)
    if small_sample:
        if not int(ds.founder_mask.sum()):
            raise ValueError(
                "--het small-sample requires at least one founder.")
        cts = _group_counts(ds, True)["all"].astype(np.float64)
        n1 = 2.0 * cts[:, 0] + cts[:, 1]   # founder REF allele count
        n2 = cts[:, 1] + 2.0 * cts[:, 2]   # founder ALT allele count
        denom = n1 + n2
        with np.errstate(invalid="ignore", divide="ignore"):
            ehet = 2.0 * n1 * n2 / (denom * (denom - 1.0))
        ehet = np.nan_to_num(ehet)
        vsel = ds.variant_mask & auto & (n1 > 0) & (n2 > 0)
    else:
        freqs = alt_allele_freqs(ds, founders_only=True, dosage=True)
        with np.errstate(invalid="ignore"):
            ehet = 2.0 * freqs * (1.0 - freqs)
        ehet = np.nan_to_num(ehet)
        vsel = ds.variant_mask & auto & (ehet >= 2.0 ** -35)

    n = ds.raw_sample_ct
    # exact f64 totals on host; the device only sums the (sparse) missing
    # corrections
    total_sel = float(vsel.sum())
    total_ehet = float(ehet[vsel].sum())
    sel = vsel.astype(np.float64)
    z = np.zeros_like(sel)
    # weights per plane (homref, het, homalt, missing) of the three sums
    wts = np.stack([np.stack([z, z, z, sel], 1),
                    np.stack([z, sel, z, z], 1),
                    np.stack([z, z, z, ehet * sel], 1)], axis=2)
    miss_ct, ohet, miss_ehet = weighted_sample_sums(
        ds.device_all_packed(), n, wts)
    obs = total_sel - miss_ct
    ehet_sum = total_ehet - miss_ehet

    inc = np.flatnonzero(ds.sample_mask)
    si = ds.si
    use_fid = si.has_fid and any(str(si.fid[i]) != "0" for i in inc)
    o_hom = obs - ohet
    e_hom = obs - ehet_sum
    denom = obs - e_hom
    with np.errstate(divide="ignore", invalid="ignore"):
        fval = np.where(denom != 0, (o_hom - e_hom) / denom, np.nan)
    cols = list(zip(np.rint(o_hom).astype(np.int64).tolist(), e_hom.tolist(),
                    np.rint(obs).astype(np.int64).tolist(), fval.tolist()))
    path = out_prefix + ".het"
    with open(path, "w") as f:
        f.write(("#FID\tIID" if use_fid else "#IID") + "\tO(HOM)\tE(HOM)\tOBS_CT\tF\n")
        for i in inc.tolist():
            oh, eh, ob, fv = cols[i]
            idp = f"{si.fid[i]}\t{si.iid[i]}" if use_fid else str(si.iid[i])
            f.write(f"{idp}\t{oh}\t{g6(eh)}\t{ob}\t{g6(fv)}\n")
    log.log(f"--het: Results written to {path} .")
