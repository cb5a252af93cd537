""".pvar / .bim / .map variant-metadata parser and writer.

Format per pgen_spec.tex:787-832 (PVAR spec);
behavior per 2.0/plink2_pvar.cc:1159 (LoadPvar).  A .bim file (headerless,
6 columns CHROM ID CM POS ALT REF) and most sites-only VCFs parse as PVAR.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .psam import _open_text
from ..utils.chrom import ChrInfo


@dataclass
class VariantInfo:
    chrom: np.ndarray  # int16 chromosome codes (see utils.chrom)
    pos: np.ndarray  # int32 base-pair positions
    vid: np.ndarray  # object array of variant IDs
    ref: np.ndarray  # object array: REF allele
    alt: np.ndarray  # object array: comma-joined ALT allele(s)
    cm: np.ndarray | None = None  # float64 centimorgan positions
    qual: np.ndarray | None = None
    filt: np.ndarray | None = None
    info: np.ndarray | None = None
    header_lines: list[str] = field(default_factory=list)
    chr_info: ChrInfo = field(default_factory=ChrInfo)
    # importer-filled provisional-REF flags (VCF ##INFO PR Flag key,
    # ref info_pr_exists -> pgen nonref_flags, 2.0/plink2_import.cc:3097)
    nonref: np.ndarray | None = None

    @property
    def variant_ct(self) -> int:
        return len(self.vid)

    def allele_ct(self) -> np.ndarray:
        """Number of alleles (1 + ALT count) per variant."""
        return np.array([1 + (a.count(",") + 1 if a != "." else 0) for a in self.alt], dtype=np.int32)

    def alt1(self) -> np.ndarray:
        return np.array([a.split(",", 1)[0] for a in self.alt], dtype=object)


def read_pvar(path: str, chr_info: ChrInfo | None = None) -> VariantInfo:
    ci = chr_info or ChrInfo()
    header_lines: list[str] = []
    header_cols = None
    rows: list[list[str]] = []
    with _open_text(path) as f:
        for ln in f:
            ln = ln.rstrip("\r\n")
            if not ln:
                continue
            if ln.startswith("#"):
                if ln.startswith("#CHROM"):
                    header_cols = ln[1:].split()
                    if "FORMAT" in header_cols:
                        header_cols = header_cols[: header_cols.index("FORMAT")]
                else:
                    header_lines.append(ln)
                continue
            rows.append(ln.split())
    if header_cols is None:
        ncol = len(rows[0]) if rows else 6
        header_cols = (
            ["CHROM", "ID", "CM", "POS", "ALT", "REF"]
            if ncol >= 6
            else ["CHROM", "ID", "POS", "ALT", "REF"]
        )
    col = {c: j for j, c in enumerate(header_cols)}
    n = len(rows)

    def getcol(name):
        j = col.get(name)
        return None if j is None else [r[j] for r in rows]

    chrom = np.array([ci.code(c) for c in (getcol("CHROM") or [])], dtype=np.int16)
    pos_raw = getcol("POS")
    pos = np.array([int(p) for p in pos_raw], dtype=np.int32) if pos_raw else np.zeros(n, np.int32)
    vid = np.array(getcol("ID") or ["."] * n, dtype=object)
    ref = np.array(getcol("REF") or ["N"] * n, dtype=object)
    alt = np.array(getcol("ALT") or ["N"] * n, dtype=object)
    cm_raw = getcol("CM")
    cm = np.array([float(x) for x in cm_raw]) if cm_raw else None
    qual_raw = getcol("QUAL")
    filt_raw = getcol("FILTER")
    info_raw = getcol("INFO")
    return VariantInfo(
        chrom=chrom,
        pos=pos,
        vid=vid,
        ref=ref,
        alt=alt,
        cm=cm,
        qual=np.array(qual_raw, dtype=object) if qual_raw else None,
        filt=np.array(filt_raw, dtype=object) if filt_raw else None,
        info=np.array(info_raw, dtype=object) if info_raw else None,
        header_lines=header_lines,
        chr_info=ci,
    )


def read_bim(path: str, chr_info: ChrInfo | None = None) -> VariantInfo:
    """Read a headerless .bim: CHROM ID CM POS A1(=ALT) A2(=REF)."""
    ci = chr_info or ChrInfo()
    chrom, vid, cm, pos, alt, ref = [], [], [], [], [], []
    with _open_text(path) as f:
        for ln in f:
            t = ln.split()
            if not t:
                continue
            chrom.append(ci.code(t[0]))
            vid.append(t[1])
            cm.append(float(t[2]))
            pos.append(int(t[3]))
            alt.append(t[4])
            ref.append(t[5])
    return VariantInfo(
        chrom=np.array(chrom, dtype=np.int16),
        pos=np.array(pos, dtype=np.int32),
        vid=np.array(vid, dtype=object),
        ref=np.array(ref, dtype=object),
        alt=np.array(alt, dtype=object),
        cm=np.array(cm),
        chr_info=ci,
    )


def write_pvar(path: str, vi: VariantInfo, variant_mask: np.ndarray | None = None) -> None:
    idx = np.flatnonzero(variant_mask) if variant_mask is not None else np.arange(vi.variant_ct)
    ci = vi.chr_info

    def _col_present(col):
        # a column of all-None (every value '.') is dropped entirely,
        # matching the reference's .pvar writer behavior
        return col is not None and any(v is not None for v in col)

    has_info = _col_present(vi.info)
    has_filter = _col_present(vi.filt)
    has_qual = _col_present(vi.qual)
    has_cm = vi.cm is not None and np.any(vi.cm != 0)
    with open(path, "w") as f:
        for ln in vi.header_lines:
            f.write(ln + "\n")
        cols = ["#CHROM", "POS", "ID", "REF", "ALT"]
        if has_qual:
            cols.append("QUAL")
        if has_filter:
            cols.append("FILTER")
        if has_info:
            cols.append("INFO")
        if has_cm:
            cols.append("CM")
        f.write("\t".join(cols) + "\n")
        for i in idx:
            row = [ci.name(int(vi.chrom[i])), str(int(vi.pos[i])), str(vi.vid[i]), str(vi.ref[i]), str(vi.alt[i])]
            if has_qual:
                row.append("." if vi.qual[i] is None else str(vi.qual[i]))
            if has_filter:
                row.append("." if vi.filt[i] is None else str(vi.filt[i]))
            if has_info:
                row.append("." if vi.info[i] is None else str(vi.info[i]))
            if has_cm:
                row.append(f"{vi.cm[i]:g}")
            f.write("\t".join(row) + "\n")


def write_bim(path: str, vi: VariantInfo, variant_mask: np.ndarray | None = None) -> None:
    idx = np.flatnonzero(variant_mask) if variant_mask is not None else np.arange(vi.variant_ct)
    ci = vi.chr_info
    cm = vi.cm if vi.cm is not None else np.zeros(vi.variant_ct)
    with open(path, "w") as f:
        for i in idx:
            f.write(
                f"{ci.name(int(vi.chrom[i]))}\t{vi.vid[i]}\t{cm[i]:g}\t{int(vi.pos[i])}"
                f"\t{str(vi.alt[i]).split(',')[0]}\t{vi.ref[i]}\n"
            )
