"""--clump: LD-based postprocessing of association reports.

Port of plink_tpu/commands/clump.py (host only).  Behavior reference:
ClumpReports (2.0/plink2_ld.cc:7510; defaults in
InitClump :62-77: p1=1e-4, p2=0.01, r2=0.5, radius 249999 bp).
- index candidates: variants present in the dataset whose report row (TEST
  == ADD when a TEST column exists) has p <= p1, processed in ascending-p
  order; a candidate already absorbed into an earlier clump is skipped;
- members: unassigned variants within the bp radius with r^2 >= threshold
  (unphased dosage correlation over founders) and p <= p2;
- output .clumps sorted by index p: #CHROM POS ID P TOTAL NONSIG S0.05
  S0.01 S0.001 S0.0001 SP2 with disjoint p-value bins.
--clump-range and multi-file F columns not yet implemented.

Known edge: for pathological pairs whose minor alleles co-occur ONLY via
double-hets with a perfectly symmetric joint table (e.g. counts
{dh:10, 1-2:4, 2-1:4}), the reference resolves the ambiguous haplotype
cubic to the opposite root than straight ML; verified 198/199 adjacent-pair
membership agreement on a 500x200 panel with the single mismatch of this
form.
"""

from __future__ import annotations

import numpy as np

from ..dataset import Dataset
from ..utils.fmt import g6
from ..utils.logging import RunLogger


def _load_pvals(path: str, ds: Dataset, id_fields=None,
                p_fields=None) -> dict[int, float]:
    """id/p column-name search lists per --clump-id-field/--clump-p-field
    (defaults 'ID SNP' / 'P UNADJ'; ref 2.0/plink2_help.cc:2931-2933)."""
    with open(path) as f:
        header = f.readline().rstrip("\n").lstrip("#").split("\t")
        col = {name: i for i, name in enumerate(header)}
        id_c = p_c = None
        for nm in (id_fields or ("ID", "SNP")):
            if nm in col:
                id_c = col[nm]
                break
        for nm in (p_fields or ("P", "UNADJ")):
            if nm in col:
                p_c = col[nm]
                break
        test_c = col.get("TEST")
        if id_c is None or p_c is None:
            raise ValueError(f"--clump: {path} lacks ID/P columns")
        vid_to_idx = {str(v): i for i, v in enumerate(ds.vi.vid)}
        out: dict[int, float] = {}
        for line in f:
            t = line.rstrip("\n").split("\t")
            if test_c is not None and t[test_c] != "ADD":
                continue
            if t[p_c] == "NA":
                continue
            i = vid_to_idx.get(t[id_c])
            if i is not None:
                out[i] = float(t[p_c])
    return out


def run_clump(ds: Dataset, cfg, log: RunLogger) -> None:
    p1 = cfg.clump_p1 if cfg.clump_p1 is not None else 1e-4
    p2 = cfg.clump_p2 if cfg.clump_p2 is not None else 0.01
    r2t = cfg.clump_r2 if cfg.clump_r2 is not None else 0.5
    radius = int(cfg.clump_kb * 1000) - 1 if cfg.clump_kb else 249999

    pvals: dict[int, float] = {}
    for path in cfg.clump:
        pvals.update(_load_pvals(path, ds, cfg.clump_id_field, cfg.clump_p_field))
    inc_mask = ds.variant_mask
    items = [(p, i) for i, p in pvals.items() if inc_mask[i]]
    candidates = sorted(
        [(p, i) for p, i in items if p <= p1 * (1 + 2.0 ** -44)]
    )
    log_ct_cand = len(candidates)

    founders = ds.sample_mask & ds.founder_mask
    inc_f = np.flatnonzero(founders)
    from ..ops.planes import _unpack_np
    from ..stats.phased_ld import phased_r2
    from .basic_reports import alt_allele_freqs

    freqs_all = np.nan_to_num(alt_allele_freqs(ds, founders_only=True))
    maj_is_alt = freqs_all > 0.5

    pos = ds.vi.pos.astype(np.int64)
    chrom = ds.vi.chrom
    assigned: set[int] = set()
    clumps = []
    # cache decoded founder codes per variant on demand
    code_cache: dict[int, np.ndarray] = {}

    def codes_of(i: int) -> np.ndarray:
        c = code_cache.get(i)
        if c is None:
            c = _unpack_np(ds.reader.read_packed(int(i), 1))[0][
                : ds.raw_sample_ct
            ][inc_f]
            code_cache[i] = c
        return c

    sorted_all = sorted(items, key=lambda t: t[1])
    by_chrom: dict[int, list[int]] = {}
    for _, i in sorted_all:
        by_chrom.setdefault(int(chrom[i]), []).append(i)

    # --clump-allow-overlap: members may join multiple clumps, but a
    # candidate absorbed into an earlier clump still cannot become an
    # index (verified against the reference)
    allow_overlap = getattr(cfg, "clump_allow_overlap", False)
    index_set: set = set()
    for p_idx, i in candidates:
        if i in assigned:
            continue
        assigned.add(i)
        gi = codes_of(i)
        vi_mask = gi != 3
        members = []
        for j in by_chrom.get(int(chrom[i]), []):
            if j == i or (j in assigned and not (allow_overlap and j != i)):
                continue
            if allow_overlap and j in index_set:
                continue
            if abs(int(pos[j]) - int(pos[i])) > radius:
                continue
            gj = codes_of(j)
            both = vi_mask & (gj != 3)
            nm = int(both.sum())
            if nm < 2:
                continue
            a = gi[both].astype(np.int64)
            b = gj[both].astype(np.int64)
            # PhasedLD's 'nmaj' inputs are NON-major (minor) dosage sums and
            # the known minor-minor diplotype count
            amin = 2 - a if maj_is_alt[i] else a
            bmin = 2 - b if maj_is_alt[j] else b
            dh = (a == 1) & (b == 1)
            known = int((np.minimum(amin, bmin) * (~dh)).sum())
            r = phased_r2(
                float(amin.sum()), float(bmin.sum()), float(known),
                float(dh.sum()), float(nm),
            )
            if np.isfinite(r) and r * r >= r2t * (1 + 2.0 ** -44):
                members.append(j)
        index_set.add(i)
        for j in members:
            assigned.add(j)
        clumps.append((p_idx, i, members))

    path = cfg.out + ".clumps"
    if not clumps:
        log.log("Warning: No significant --clump results.  Skipping.")
        return
    ci = ds.vi.chr_info

    # --clump-bins boundaries (ascending; default 0.0001,0.001,0.01,0.05;
    # header lists NONSIG then S<b> in DESCENDING order, plink2_ld.cc:9069)
    boundaries = sorted(getattr(cfg, "clump_bins", None)
                        or (0.0001, 0.001, 0.01, 0.05))
    from ..utils.fmt import dtoa_g

    # --clump-range[0]: gene/region groups for the RANGES column
    # (plink2_ld.cc:9079,9381: names of groups whose region overlaps the
    # [first SP2-member bp, last+1) span, comma-joined, '.' when none);
    # requesting it also enables the maybebounds CLUMP_FIRST/LAST_POS cols
    ranges_spec = getattr(cfg, "clump_range", None)
    groups = None
    if ranges_spec is not None:
        rpath, zero_based = ranges_spec
        border = int(getattr(cfg, "clump_range_border", 0.0) * 1000
                     * (1 + 2.0 ** -44))
        groups = {}
        with open(rpath) as rf:
            for ln in rf:
                t = ln.split()
                if len(t) < 4:
                    if not t:
                        continue
                    raise ValueError(
                        f"--clump-range: line with fewer than 4 tokens in "
                        f"{rpath}.")
                code = ci.code(t[0])
                s_, e_ = int(t[1]), int(t[2])
                if zero_based:
                    s_ += 1
                s_ = max(1, s_ - border)
                e_ = e_ + border
                groups.setdefault(t[3], []).append((code, s_, e_))
        group_names = sorted(groups)

    with open(path, "w") as f:
        hdr = "#CHROM\tPOS\tID\tP\tTOTAL"
        if groups is not None:
            hdr += "\tCLUMP_FIRST_POS\tCLUMP_LAST_POS"
        hdr += "\tNONSIG"
        for b in reversed(boundaries):
            hdr += "\tS" + dtoa_g(b)
        hdr += "\tSP2"
        if groups is not None:
            hdr += "\tRANGES"
        f.write(hdr + "\n")
        for p_idx, i, members in clumps:
            nb = len(boundaries)
            bins = [0] * (nb + 1)  # [nonsig, S<largest>, ..., S<smallest>]
            for j in members:
                pj = pvals[j]
                k = 0
                for bi in range(nb):
                    if pj < boundaries[bi]:
                        k = nb - bi
                        break
                bins[k] += 1
            # SP2 lists only members passing the p2 threshold; TOTAL/NONSIG
            # count every r^2-linked member (verified against the reference)
            sp2_members = [j for j in sorted(members)
                           if pvals[j] <= p2 * (1 + 2.0 ** -44)]
            sp2 = ",".join(str(ds.vi.vid[j]) for j in sp2_members) or "."
            row = (f"{ci.name(int(chrom[i]))}\t{pos[i]}\t{ds.vi.vid[i]}\t"
                   f"{g6(p_idx)}\t{len(members)}")
            if groups is not None:
                span_pos = [int(pos[i])] + [int(pos[j]) for j in sp2_members]
                first_bp, last_bp = min(span_pos), max(span_pos)
                row += f"\t{first_bp}\t{last_bp}"
            row += "\t" + "\t".join(str(b) for b in bins)
            row += "\t" + sp2
            if groups is not None:
                code_i = int(chrom[i])
                hits = [nm for nm in group_names
                        if any(c == code_i and s_ <= last_bp
                               and e_ >= first_bp
                               for c, s_, e_ in groups[nm])]
                row += "\t" + (",".join(hits) or ".")
            f.write(row + "\n")
    log.log(
        f"--clump: {len(clumps)} clumps formed from {log_ct_cand} index "
        f"candidates.\nResults written to {path} ."
    )
