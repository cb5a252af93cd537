"""--ld <var1> <var2>: two-variant LD detail report.

Port of plink_tpu/commands/ld_console.py (host only).  Behavior
reference: LdConsole (2.0/plink2_ld.cc); output layout verified
against a locally built plink2: allele major/minor lines, valid-sample and
statistically-phased counts, r^2 + |D'| per haplotype solution (multiple
cubic solutions listed with the best-likelihood tag and an HWE p-value
block), the 2x2 ML frequency table with linkage-equilibrium expectations,
and the in/out-of-phase summary line.
"""

from __future__ import annotations

import numpy as np

from ..dataset import Dataset
from ..utils.fmt import g6
from ..utils.logging import RunLogger
from .basic_reports import alt_allele_freqs


def run_ld_console(ds: Dataset, cfg, log: RunLogger) -> None:
    from ..ops.planes import _unpack_np
    from ..stats.hwe import hwe_exact_pvals
    from ..stats.phased_ld import phased_ld_detail

    vid1, vid2 = cfg.ld
    vid_to_idx = {str(v): i for i, v in enumerate(ds.vi.vid)}
    try:
        i, j = vid_to_idx[vid1], vid_to_idx[vid2]
    except KeyError as e:
        raise ValueError(f"--ld: variant ID {e} not found")
    inc = np.flatnonzero(ds.sample_mask & ds.founder_mask)
    gi = _unpack_np(ds.reader.read_packed(i, 1))[0][: ds.raw_sample_ct][inc]
    gj = _unpack_np(ds.reader.read_packed(j, 1))[0][: ds.raw_sample_ct][inc]
    both = (gi != 3) & (gj != 3)
    a = gi[both].astype(int)
    b = gj[both].astype(int)
    freqs = np.nan_to_num(alt_allele_freqs(ds, founders_only=True))
    alt1 = ds.vi.alt1()

    def allele_lines(v, name):
        maj_alt = freqs[v] > 0.5
        maj = str(alt1[v]) if maj_alt else str(ds.vi.ref[v])
        mnr = str(ds.vi.ref[v]) if maj_alt else str(alt1[v])
        lines = [f"{name} alleles:"]
        if not maj_alt:
            lines.append(f"  MAJOR = REF = {maj}")
            lines.append(f"  MINOR = {mnr}")
        else:
            lines.append(f"  MAJOR = {maj}")
            lines.append(f"  MINOR = {mnr}")
            lines.append(f"  (REF = {ds.vi.ref[v]})")
        return lines, maj_alt

    out = [f"--ld {vid1} {vid2}:", ""]
    l1, maj_alt_i = allele_lines(i, vid1)
    l2, maj_alt_j = allele_lines(j, vid2)
    out += l1 + [""] + l2 + [""]

    amin = 2 - a if maj_alt_i else a
    bmin = 2 - b if maj_alt_j else b
    dh = (a == 1) & (b == 1)
    known = float((np.minimum(amin, bmin) * (~dh)).sum())
    u = int(dh.sum())
    nm = int(both.sum())
    out.append(f"{nm} valid samples; {u} het pairs statistically phased.")
    sols, best_idx, exp = phased_ld_detail(
        float(amin.sum()), float(bmin.sum()), known, float(u), float(nm)
    )
    if not sols:
        out.append("Monomorphic variant; LD undefined.")
        log.log("\n".join(out))
        return
    multi = len(sols) > 1
    if multi:
        out.append(
            "Multiple phasing solutions; sample size, HWE, or random mating "
            "assumption may\nbe violated."
        )
        out.append("")
        out.append("HWE exact test p-values")
        out.append("-----------------------")
        for v, g in ((i, gi), (j, gj)):
            val = g[g != 3]
            p = hwe_exact_pvals(
                np.array([(val == 0).sum()]), np.array([(val == 1).sum()]),
                np.array([(val == 2).sum()]),
            )[0]
            out.append(f"  {ds.vi.vid[v]}: {g6(p)}")
    out.append("")
    for si_, sol in enumerate(sols):
        hdr = ""
        if multi:
            tag = " (best likelihood)" if si_ == best_idx else ""
            hdr = f"Solution #{si_ + 1}{tag}:\n"
        out.append(
            f"{hdr}  r^2 = {g6(sol['r2'])}    |D'| = {g6(abs(sol['dprime']))}"
        )
        out.append("")
        out.append(f"        Frequencies      :               {vid2}")
        out.append("  (expectations under LE)          MAJOR       MINOR")
        out.append("                                 ----------  ----------")
        out.append(
            f"                           MAJOR  {sol['freq_mm']:.6f}    "
            f"{sol['freq_mn']:.6f}"
        )
        out.append(
            f"                                 ({exp['mm']:.6f})  ({exp['mn']:.6f})"
        )
        out.append(f"                     {vid1}")
        out.append(
            f"                           MINOR  {sol['freq_nm']:.6f}    "
            f"{sol['freq_nn']:.6f}"
        )
        out.append(
            f"                                 ({exp['nm']:.6f})  ({exp['nn']:.6f})"
        )
        out.append("")
        if sol["d"] >= 0:
            out.append("  Major alleles are in phase with each other.")
        else:
            out.append("  Major alleles are out of phase with each other.")
        out.append("")
    log.log("\n".join(out).rstrip() + "\n")
