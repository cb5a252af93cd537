"""--variant-score: per-variant weighted dosage sums.

Behavior reference: Vscore (2.0/plink2_matrix_calc.cc:9274) /
VscoreThread (:8768): input file is sample IDs (#FID/#IID header or
headerless) plus one column per score (names from header or VSCORE1..);
per variant, score_k = sum_s wt_sk * altdosage_vs with missing genotypes
force-mean-imputed to 2*altfreq; --vscore-col-nums selects columns.
Output <out>.vscore: #CHROM POS ID REF ALT <names...>.

chrX/chrY (VscoreThread :8857-8868, :9158-9180): chrY and non-XY haploid
dosages are halved (slope 0.5); chrY nonmale values are zeroed and chrY
cannot be combined with unknown-sex samples; chrX follows --xchr-model
(2 = autosomal [default], 1 = male dosages halved, 0 = X excluded).

Port of plink_tpu/commands/vscore.py: the weight matrix W and its chrY
(male-only) and --xchr-model 1 (males halved) variants go to one K22
launch of up to 3K columns over the device-resident matrix; dosage-track
variants are scored on the host in f64, as plink_tpu does.
"""

from __future__ import annotations

import numpy as np

from ..dataset import Dataset
from ..ops.counts import weighted_variant_sums
from ..utils.chrom import MT_CODE, X_CODE, Y_CODE
from ..utils.fmt import g6
from ..utils.logging import RunLogger
from .basic_reports import alt_allele_freqs
from .score import _parse_col_nums


def run_vscore(ds: Dataset, cfg, log: RunLogger) -> None:
    args = cfg.variant_score
    path = args[0]
    single_prec = "single-prec" in args[1:]
    bin8 = "bin" in args[1:]
    bin4 = "bin4" in args[1:]
    binmode = bin8 or bin4
    if bin8 and (bin4 or single_prec):
        raise ValueError(
            "--variant-score 'bin' modifier cannot be used with 'bin4' or "
            "'single-prec'.")

    with open(path) as f:
        lines = [l.rstrip("\n") for l in f if l.strip()]
    si = ds.si
    first = lines[0]
    if first.startswith("#"):
        toks = first.lstrip("#").split()
        if toks[0] == "FID":
            id_cols = 2
        elif toks[0] == "IID":
            id_cols = 1
        else:
            raise ValueError(
                "--variant-score file header must start with #FID/#IID."
            )
        names = toks[id_cols:]
        body = lines[1:]
    else:
        id_cols = 1
        names = None
        body = lines
    sel = (
        _parse_col_nums(cfg.vscore_col_nums) if getattr(cfg, "vscore_col_nums", None)
        else None
    )

    if id_cols == 2:
        keys = {f"{si.fid[i]}\t{si.iid[i]}": i for i in range(si.sample_ct)}
    else:
        keys = {str(si.iid[i]): i for i in range(si.sample_ct)}
    K = None
    W = None
    miss_ct = 0
    for ln in body:
        t = ln.split()
        key = "\t".join(t[:id_cols])
        wt = t[id_cols:]
        if sel:
            wt = [t[c - 1] for c in sel]
        if K is None:
            K = len(wt)
            if K == 0:
                raise ValueError("No score columns in --variant-score file.")
            W = np.zeros((ds.raw_sample_ct, K))
        i = keys.get(key)
        if i is None:
            miss_ct += 1
            continue
        W[i] = [float(x) for x in wt]
    if names is None:
        names = [f"VSCORE{k + 1}" for k in range(K)]
    elif sel:
        names = [names[c - 1 - id_cols] for c in sel]

    # restrict to included samples
    W = W * ds.sample_mask[:, None]
    wtot = W.sum(axis=0)
    freqs = np.nan_to_num(alt_allele_freqs(ds, founders_only=not cfg.nonfounders,
                                           dosage=True))

    vi = ds.vi
    vmask = ds.variant_mask.copy()
    isx_all = vi.chrom == X_CODE
    isy_all = vi.chrom == Y_CODE
    ismt_all = vi.chrom == MT_CODE
    male = ds.male_mask() & ds.sample_mask
    if (vmask & isy_all).any() and ((ds.si.sex == 0) & ds.sample_mask).any():
        raise ValueError(
            "When chrY is present, --variant-score cannot be used with "
            "unknown-sex samples."
        )
    xchr_model = cfg.xchr_model
    if xchr_model == 0 and (vmask & isx_all).any():
        vmask = vmask & ~isx_all
        if not vmask.any():
            raise ValueError(
                "No --variant-score variants remaining after --xchr-model 0."
            )
    # weight-matrix variants: chrY uses male-only weights; chrX under
    # --xchr-model 1 uses half-male weights
    W_y = W * male[:, None] if (vmask & isy_all).any() else None
    W_x1 = (
        W - 0.5 * W * male[:, None]
        if (xchr_model == 1 and (vmask & isx_all).any())
        else None
    )
    wtot_y = W_y.sum(axis=0) if W_y is not None else None
    wtot_x1 = W_x1.sum(axis=0) if W_x1 is not None else None

    out = cfg.out + ".vscore"
    binfile = varsfile = None
    if binmode:
        # binary layout (ref Vscore :9534-9560, :10001-10022): score names
        # to .vscore.cols, variant IDs to .vscore.vars, the variant-major
        # value matrix to .vscore.bin (f64 for 'bin' unless single-prec;
        # f32 for 'bin4' or single-prec)
        with open(out + ".cols", "w") as cf:
            for nm in names:
                cf.write(nm + "\n")
        binfile = open(out + ".bin", "wb")
        varsfile = open(out + ".vars", "w")
        bin_dtype = "<f8" if (bin8 and not single_prec) else "<f4"
    else:
        f = open(out, "w")
        f.write("#CHROM\tPOS\tID\tREF\tALT\t" + "\t".join(names) + "\n")
    chrom_names = [vi.chr_info.name(c) for c in vi.chrom]
    dosage_vr = None
    if ds.has_dosage:
        dosage_vr = (ds.reader.header.vrtypes & 0x60) != 0
    # one launch: W, then W_y and W_x1 where they apply
    sets = [W] + [m for m in (W_y, W_x1) if m is not None]
    pw_all = weighted_variant_sums(ds.device_all_packed(), ds.raw_sample_ct,
                                   np.concatenate(sets, axis=1),
                                   f64=not single_prec)
    nk = W.shape[1]
    pw_main = pw_all[:, :nk]
    pw_y = pw_all[:, nk:2 * nk] if W_y is not None else None
    pw_x = pw_all[:, -nk:] if W_x1 is not None else None
    for v0 in range(0, ds.raw_variant_ct, ds.block_size):
        vct = min(ds.block_size, ds.raw_variant_ct - v0)
        sl = slice(v0, v0 + vct)
        pw = pw_main[sl]
        fblk = freqs[sl]
        wt_blk = np.broadcast_to(wtot, (vct, len(wtot)))
        if W_y is not None and isy_all[sl].any():
            ym = isy_all[sl]
            pw = np.where(ym[:, None, None], pw_y[sl], pw)
            wt_blk = np.where(ym[:, None], wtot_y, wt_blk)
        if W_x1 is not None and isx_all[sl].any():
            xm = isx_all[sl]
            pw = np.where(xm[:, None, None], pw_x[sl], pw)
            wt_blk = np.where(xm[:, None], wtot_x1, wt_blk)
        slope = np.where(isy_all[sl] | ismt_all[sl], 0.5, 1.0)
        score = slope[:, None] * (
            pw[:, :, 0] + 2.0 * pw[:, :, 1]
            + (wt_blk - pw[:, :, 2]) * (2.0 * fblk[:, None])
        )
        rows = []
        for j in range(vct):
            v = v0 + j
            if not vmask[v]:
                continue
            if dosage_vr is not None and dosage_vr[v]:
                d = ds.dosage_row(v)
                s = float(slope[j])
                fin = np.isfinite(d)
                dd = np.where(fin, d, 2.0 * freqs[v]) * s
                if isy_all[v]:
                    dd = dd * male
                    wv = W_y
                elif isx_all[v] and W_x1 is not None:
                    wv = W_x1
                else:
                    wv = W
                score[j] = dd @ wv
            if binmode:
                binfile.write(
                    np.asarray(score[j], dtype=bin_dtype).tobytes())
                varsfile.write(str(vi.vid[v]) + "\n")
                continue
            rows.append(
                f"{chrom_names[v]}\t{vi.pos[v]}\t{vi.vid[v]}\t{vi.ref[v]}\t"
                f"{vi.alt[v]}\t"
                + "\t".join(g6(score[j, k]) for k in range(len(names)))
                + "\n"
            )
        if not binmode:
            f.writelines(rows)
    if binmode:
        binfile.close()
        varsfile.close()
    else:
        f.close()
    if miss_ct:
        log.log(
            f"Warning: --variant-score: {miss_ct} line(s) skipped "
            "(unmatched sample ID)."
        )
    if binmode:
        log.log(
            f"--variant-score: Results written to {out}.bin + {out}.cols + "
            f"{out}.vars .")
    else:
        log.log(f"--variant-score: Results written to {out} .")
