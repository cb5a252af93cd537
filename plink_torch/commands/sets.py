"""1.9 set definitions: --set / --make-set with --set-names, --subset,
--make-set-border, --make-set-collapse-group, --set-collapse-all,
--make-set-complement-all, --complement-sets and the --gene / --gene-all
variant prefilter (plink_tpu/commands/sets.py `define_sets` and its
parsers).  --fast-epistasis set-by-set / set-by-all reads them; --write-set,
--set-table and the --assoc set test are not ported yet.

Behavior reference: define_sets / load_range_list (1.9/plink_set.c:274-560,
1003-1710).  The reference stores sets as range-lists / offset bitfields to
bound memory at biobank scale; here each set is a sorted int64 index array
over the filtered marker list."""

from __future__ import annotations

import re

import numpy as np

from ..utils.logging import RunLogger

_NAT_SPLIT = re.compile(r"(\d+)")


def _natural_key(s: str):
    """strcmp_natural ordering (1.9/plink_common.c): digit runs compare
    numerically, other runs case-insensitively."""
    parts = _NAT_SPLIT.split(s)
    key = []
    for i, p in enumerate(parts):
        if i & 1:
            key.append((1, int(p), ""))
        elif p:
            key.append((0, 0, p.upper()))
    key.append((2, 0, s))
    return key


class SetInfo:
    """Defined sets over the *current filtered marker list* (0..M-1)."""

    def __init__(self, names, setdefs):
        self.names = names            # list[str]
        self.setdefs = setdefs        # list[np.ndarray int64, sorted]
        self.ct = len(names)


def _read_subset_ids(cfg):
    ids = set()
    if cfg.subset_file:
        with open(cfg.subset_file) as f:
            for line in f:
                ids.update(line.split())
    ids.update(cfg.set_names_list)
    return ids


def _parse_make_set(ds, cfg, log):
    """--make-set range file -> (names, per-set (lo, hi) half-open
    filtered-index ranges); names natural-sorted + deduped
    (load_range_list, 1.9/plink_set.c:274)."""
    ci = ds.vi.chr_info
    border = cfg.make_set_border
    collapse_group = cfg.make_set_collapse_group
    subset = _read_subset_ids(cfg) if (
        cfg.subset_file or cfg.set_names_list) else None
    inc = np.flatnonzero(ds.variant_mask)
    chrom_f = ds.vi.chrom[inc]
    pos_f = ds.vi.pos[inc].astype(np.int64)
    chrom_slices = {}
    for c in np.unique(chrom_f):
        w = np.flatnonzero(chrom_f == c)
        chrom_slices[int(c)] = (int(w[0]), int(w[-1]) + 1)
    rows = []
    with open(cfg.make_set) as f:
        for ln, line in enumerate(f, 1):
            t = line.split()
            if not t:
                continue
            need = 5 if collapse_group else 4
            if len(t) < need:
                raise ValueError(
                    f"Line {ln} of --make-set file has fewer tokens than "
                    "expected.")
            name = t[4] if collapse_group else t[3]
            if subset is not None and t[3] not in subset:
                continue
            try:
                code = ci.code(t[0])
            except Exception:
                raise ValueError(
                    f"Invalid chromosome code on line {ln} of --make-set "
                    "file.")
            start, end = int(t[1]), int(t[2])
            if end < start:
                raise ValueError(
                    "Range end position smaller than range start on line "
                    f"{ln} of --make-set file.")
            rows.append((name, int(code), max(0, start - border),
                         end + border))
    names = sorted({r[0] for r in rows}, key=_natural_key)
    if not names:
        log.log("Warning: No valid ranges in --make-set file.")
        return [], []
    name_idx = {n: i for i, n in enumerate(names)}
    members = [set() for _ in names]
    for name, code, lo, hi in rows:
        cs = chrom_slices.get(code)
        if cs is None:
            continue
        s0, s1 = cs
        a = s0 + int(np.searchsorted(pos_f[s0:s1], lo, "left"))
        b = s0 + int(np.searchsorted(pos_f[s0:s1], hi, "right"))
        if b > a:
            members[name_idx[name]].update(range(a, b))
    return names, members


def _parse_set_file(ds, cfg, log):
    """--set file (NAME / variant IDs / END blocks) -> (names, member
    sets of filtered indices).  Unknown variant IDs are ignored."""
    subset = _read_subset_ids(cfg) if (
        cfg.subset_file or cfg.set_names_list) else None
    inc = np.flatnonzero(ds.variant_mask)
    id_to_idx = {str(v): i for i, v in enumerate(ds.vi.vid[inc])}
    names, members = [], []
    cur = None
    cur_name = None
    in_set = 0
    with open(cfg.set_file) as f:
        for line in f:
            for tok in line.split():
                if tok == "END":
                    if not in_set:
                        raise ValueError("Extra 'END' token in --set file.")
                    if in_set == 1:
                        names.append(cur_name)
                        members.append(cur)
                    in_set = 0
                elif not in_set:
                    if subset is not None and tok not in subset:
                        in_set = 2
                        continue
                    cur_name = tok
                    cur = set()
                    in_set = 1
                elif in_set == 1:
                    i = id_to_idx.get(tok)
                    if i is not None:
                        cur.add(i)
    if in_set:
        raise ValueError("Last token in --set file isn't 'END'.")
    return names, members


def define_sets(ds, cfg, log: RunLogger) -> SetInfo | None:
    """Load --set/--make-set and apply --gene/--gene-all prefiltering
    (which narrows ds.variant_mask before setdefs are finalized).
    Reference: define_sets (1.9/plink_set.c:1003)."""
    is_make = cfg.make_set is not None
    complement = cfg.complement_sets or (
        cfg.make_set_complement_all is not None)
    merged = cfg.set_collapse_all or cfg.make_set_complement_all
    gene_filter = cfg.gene_all or bool(cfg.gene_list)

    M0 = int(ds.variant_mask.sum())
    if is_make:
        names, members = _parse_make_set(ds, cfg, log)
    else:
        names, members = _parse_set_file(ds, cfg, log)
    if not names:
        return None

    # --gene / --gene-all variant prefilter (plink_set.c:1197-1345)
    if gene_filter:
        genekeep = set(cfg.gene_list) if cfg.gene_list else None
        if complement:
            # keep variants outside at least one kept set
            inter = np.ones(M0, bool)
            for n, mem in zip(names, members):
                if genekeep is not None and n not in genekeep:
                    continue
                row = np.zeros(M0, bool)
                row[list(mem)] = True
                inter &= row
            keep = ~inter
        else:
            keep = np.zeros(M0, bool)
            for n, mem in zip(names, members):
                if genekeep is not None and n not in genekeep:
                    continue
                keep[list(mem)] = True
        if not keep.any():
            raise ValueError("All variants excluded by --gene/--gene-all.")
        inc0 = np.flatnonzero(ds.variant_mask)
        newmask = np.zeros_like(ds.variant_mask)
        newmask[inc0[keep]] = True
        ds.variant_mask = newmask
        ds.invalidate_counts()
        old_to_new = np.full(M0, -1, np.int64)
        old_to_new[keep] = np.arange(int(keep.sum()))
        members = [
            {int(old_to_new[i]) for i in mem if keep[i]}
            for mem in members
        ]
        M0 = int(keep.sum())

    if merged:
        u = set()
        for mem in members:
            u |= mem
        names = [merged]
        members = [u]
    if complement:
        full = set(range(M0))
        members = [full - mem for mem in members]

    setdefs = [np.array(sorted(mem), np.int64) for mem in members]
    log.log(f"--{'make-' if is_make else ''}set: {len(names)} set"
            f"{'' if len(names) == 1 else 's'} defined.")
    return SetInfo(names, setdefs)
