"""--make-king / --make-king-table / --king-cutoff.

Behavior reference: CalcKing + table/matrix writers
(2.0/plink2_matrix_calc.cc:1662-2330) and KinshipPruneDestructive (:278).
Compute is kernel K7 (ops/pairwise.py `king_gram`, csrc/king_gram.cu): the
reference's per-pair popcount accumulators over one sample tile, with the
kinship, filter mask and pass count computed on the card.

Output formats (verified against a locally built plink2):
- .kin0  : header #[FID1\t]IID1\t[FID2\t]IID2\tNSNP\tHETHET\tIBS0\tKINSHIP;
           rows ordered idx1=1..N-1 outer (larger index first), idx2 inner;
           HETHET/IBS0 are proportions of NSNP (counts with 'counts').
- .king  : strictly-lower-triangle text matrix (N-1 rows, row i has i
           entries), plus .king.id sample-ID file.
- --king-cutoff: greedy max-independent-set prune writing
           .king.cutoff.in.id / .king.cutoff.out.id and updating the
           in-memory sample set.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dataset import Dataset
from ..ops.pairwise import (
    KING_COUNTER_KEYS,
    PackedDevice,
    iter_lower_tiles,
    king_gram,
    king_kinship,
)
from ..utils.fmt import g6
from ..utils.logging import RunLogger


def _king_variant_mask(ds: Dataset, log: RunLogger) -> np.ndarray:
    vmask = ds.variant_mask.copy()
    non_auto = vmask & ~ds.vi.chr_info.is_autosomal(ds.vi.chrom)
    excl = int(non_auto.sum())
    if excl:
        log.log(
            f"Excluding {excl} variant{'s' if excl != 1 else ''} on non-autosomes "
            "from KING-robust calculation."
        )
        vmask &= ~non_auto
    return vmask


def _pair_tables(ds: Dataset, vmask: np.ndarray, tile: int | None = None,
                 sample_mask=None):
    """Yield (rows, cols, counts) per lower tile; rows/cols are raw indices
    into the included-sample list."""
    pd = PackedDevice.for_pairs(ds, vmask, tile=tile, sample_mask=sample_mask)
    s = pd.tile
    for r0, c0 in iter_lower_tiles(pd.npad, s):
        cnt = king_gram(pd.packed, pd.vmask, r0, c0, s, s, counts=True)
        cnt = cnt.cpu().numpy().astype(np.int64)
        counts = dict(zip(KING_COUNTER_KEYS, cnt))
        yield r0, c0, s, counts, pd


def run_king(ds: Dataset, cfg, log: RunLogger) -> None:
    vmask = _king_variant_mask(ds, log)
    if getattr(cfg, "king_table_subset", None):
        _run_king_subset(ds, cfg, log, vmask)
        return
    if getattr(cfg, "king_cutoff_prefix", None):
        _king_cutoff_resume(ds, cfg, log)
        return
    inc = np.flatnonzero(ds.sample_mask)
    n = inc.size
    si = ds.si

    want_matrix = cfg.make_king or (cfg.king_cutoff is not None and not cfg.make_king_table)
    kin = None
    if want_matrix or cfg.king_cutoff is not None:
        kin = np.zeros((n, n), dtype=np.float64)

    # tile stream: counters + per-pair stats computed on the card (K7); the
    # host only fetches what each consumer needs (with --king-table-filter,
    # the pass count is checked first so clean tiles cost one scalar fetch)
    thresh = cfg.king_table_filter if cfg.king_table_filter is not None else -np.inf
    pd = PackedDevice.for_pairs(ds, vmask)
    s = pd.tile
    pair_i: list[np.ndarray] = []
    pair_j: list[np.ndarray] = []
    pair_stats: list[np.ndarray] = []  # columns: nsnp, hethet, ibs0, kin

    # dispatch-ahead pipeline: keep several tiles in flight so device
    # compute overlaps the result transfers
    from collections import deque

    q: deque = deque()
    state = {"total_pass": 0}

    def _drain_one():
        r0, c0, kin_t, nsnp_t, hh_t, ibs0_t, passing, cnt = q.popleft()
        rmax = min(r0 + s, n)
        cmax = min(c0 + s, n)
        if rmax <= r0 or cmax <= c0:
            return
        if kin is not None:
            kin[r0:rmax, c0:cmax] = kin_t[: rmax - r0, : cmax - c0].cpu().numpy()
        if cfg.make_king_table:
            c_pass = int(cnt)
            state["total_pass"] += c_pass
            if c_pass == 0:
                return
            ii, jj = torch.nonzero(passing, as_tuple=True)
            pair_i.append(ii.cpu().numpy() + r0)
            pair_j.append(jj.cpu().numpy() + c0)
            pair_stats.append(np.column_stack([
                t_[ii, jj].cpu().numpy() for t_ in (nsnp_t, hh_t, ibs0_t, kin_t)
            ]))

    for r0, c0 in iter_lower_tiles(pd.npad, s):
        q.append((r0, c0) + tuple(king_gram(pd.packed, pd.vmask, r0, c0, s, s,
                                            n=n, thresh=thresh)))
        if len(q) >= 8:
            _drain_one()
    while q:
        _drain_one()
    total_pass = state["total_pass"]

    if cfg.make_king_table:
        if cfg.king_table_filter is not None:
            grand_tot = n * (n - 1) // 2
            filtered = grand_tot - total_pass
            log.log(
                f"--king-table-filter: {total_pass} relationship"
                f"{'s' if total_pass != 1 else ''} reported ({filtered} "
                f"filtered out)."
            )
        _write_kin0_pairs(ds, cfg, log, pair_i, pair_j, pair_stats, n, inc)
    if cfg.make_king:
        _write_king_matrix(ds, cfg, log, kin, n, inc)
    if cfg.king_cutoff is not None:
        _king_cutoff_prune(ds, cfg, log, kin, n, inc)


def _ids_header_and_rows(si, inc):
    use_fid = si.has_fid and any(str(si.fid[i]) != "0" for i in inc)
    return use_fid


def _write_kin0_pairs(ds: Dataset, cfg, log: RunLogger, pair_i, pair_j,
                      pair_stats, n, inc) -> None:
    """Write .kin0 rows from the streamed (i, j, stats) pair set.

    Reference row order (CalcKing writer): outer index i ascending from 1,
    inner j < i ascending; --parallel restricts the i range via
    TriangleDivide bounds."""
    si = ds.si
    use_fid = _ids_header_and_rows(si, inc)
    par = getattr(cfg, "parallel", None)
    path = cfg.out + ".kin0" + (f".{par[0]}" if par else "")
    write_header = par is None or par[0] == 1
    ids = [str(si.iid[i]) for i in inc]
    fids = [str(si.fid[i]) for i in inc]
    if pair_i:
        I = np.concatenate(pair_i)
        J = np.concatenate(pair_j)
        S = np.concatenate(pair_stats)
    else:
        I = np.zeros(0, np.int64)
        J = np.zeros(0, np.int64)
        S = np.zeros((0, 4))
    lo, hi = 1, n
    if par:
        k, tot = par
        lo, hi = _parallel_bounds(n, 1, k - 1, tot)
        lo = max(lo, 1)
    m = (I >= lo) & (I < hi)
    I, J, S = I[m], J[m], S[m]
    order = np.lexsort((J, I))
    I, J, S = I[order], J[order], S[order]
    with open(path, "w") as f:
        hdr = "#"
        if use_fid:
            hdr += "FID1\tIID1\tFID2\tIID2"
        else:
            hdr += "IID1\tIID2"
        if write_header:
            f.write(hdr + "\tNSNP\tHETHET\tIBS0\tKINSHIP\n")
        lines: list[str] = []
        for i_, j_, st in zip(I, J, S):
            nsnp = int(st[0])
            recip = 1.0 / nsnp if nsnp else 0.0
            if use_fid:
                idpart = f"{fids[i_]}\t{ids[i_]}\t{fids[j_]}\t{ids[j_]}"
            else:
                idpart = f"{ids[i_]}\t{ids[j_]}"
            lines.append(
                f"{idpart}\t{nsnp}\t{g6(st[1] * recip)}\t{g6(st[2] * recip)}\t"
                f"{g6(st[3])}\n"
            )
        f.writelines(lines)
    log.log(f"--make-king-table: Results written to {path} .")


def _write_king_id(path: str, si, inc, use_fid: bool) -> None:
    with open(path, "w") as f:
        f.write("#FID\tIID\n" if use_fid else "#IID\n")
        for i in inc:
            f.write((f"{si.fid[i]}\t{si.iid[i]}" if use_fid else str(si.iid[i])) + "\n")


def _write_king_matrix(ds: Dataset, cfg, log: RunLogger, kin, n, inc) -> None:
    si = ds.si
    use_fid = _ids_header_and_rows(si, inc)
    mods = set(getattr(cfg, "make_king_mods", ()))
    shape = "triangle"
    for m in ("square", "square0", "triangle"):
        if m in mods:
            shape = m
    low = np.tril(kin, -1)
    full = low + low.T
    np.fill_diagonal(full, 0.5)
    par = getattr(cfg, "parallel", None)
    lo, hi = 1, n
    suffix = ""
    if par:
        k, tot = par
        lo, hi = _parallel_bounds(n, 1, k - 1, tot)
        lo = max(lo, 1)
        # square shapes emit every row, including row 0 (no triangle pairs):
        # shard 1 must start at row 0 or the concatenation drops it.
        if shape != "triangle" and k == 1:
            lo = 0
        suffix = f".{k}"
    if "bin" in mods or "bin4" in mods:
        dt = np.float32 if "bin4" in mods else np.float64
        path = cfg.out + ".king.bin" + suffix
        with open(path, "wb") as f:
            if shape == "triangle":
                for i in range(lo, hi):
                    f.write(full[i, :i].astype(dt).tobytes())
            else:
                for i in range(lo if par else 0, hi):
                    row = full[i] if shape == "square" else np.r_[
                        full[i, : i + 1], np.zeros(n - i - 1)
                    ]
                    f.write(row.astype(dt).tobytes())
    else:
        path = cfg.out + ".king" + suffix
        with open(path, "w") as f:
            if shape == "triangle":
                for i in range(lo, hi):
                    f.write("\t".join(g6(full[i, j]) for j in range(i)) + "\n")
            else:
                for i in range(lo if par else 0, hi):
                    row = full[i] if shape == "square" else np.r_[
                        full[i, : i + 1], np.zeros(n - i - 1)
                    ]
                    f.write("\t".join(g6(x) for x in row) + "\n")
    _write_king_id(cfg.out + ".king.id", si, inc, use_fid)
    log.log(
        f"--make-king: Results written to {path} and {cfg.out}.king.id ."
    )


def _parallel_bounds(ct: int, start: int, parallel_idx: int,
                     parallel_tot: int):
    """ParallelBounds/TriangleDivide port (2.0/plink2_common.cc:4936):
    row range whose triangle pair counts split evenly."""
    import math

    modif = 1 - start * 2

    def tdiv(cur_prod_x2: int) -> int:
        if cur_prod_x2 == 0:
            return -modif if modif < 0 else 0
        vv = int(math.sqrt(float(cur_prod_x2)))
        while (vv - 1) * (vv + modif - 1) >= cur_prod_x2:
            vv -= 1
        while vv * (vv + modif) < cur_prod_x2:
            vv += 1
        return vv

    ct_tot = ct * (ct + modif)
    return (
        tdiv((ct_tot * parallel_idx) // parallel_tot),
        tdiv((ct_tot * (parallel_idx + 1)) // parallel_tot),
    )


def _king_cutoff_prune(ds: Dataset, cfg, log: RunLogger, kin, n, inc) -> None:
    """Greedy relationship prune (ref: KinshipPruneDestructive,
    2.0/plink2_matrix_calc.cc:278-370): repeatedly (a) if a degree-1 vertex
    exists, remove its partner, else (b) remove the first maximal-degree
    vertex."""
    cutoff = cfg.king_cutoff
    adj = [set() for _ in range(n)]
    ii, jj = np.nonzero(np.tril(kin, -1) > cutoff)
    for i, j in zip(ii.tolist(), jj.tolist()):
        adj[i].add(j)
        adj[j].add(i)
    alive = np.ones(n, dtype=bool)
    degree = np.array([len(a) for a in adj], dtype=np.int64)

    def remove(v: int) -> None:
        alive[v] = False
        for w in adj[v]:
            if alive[w]:
                degree[w] -= 1
                adj[w].discard(v)
        degree[v] = 0
        adj[v].clear()

    while True:
        live_deg = degree * alive
        if not live_deg.any():
            break
        deg1 = np.flatnonzero(alive & (degree == 1))
        if deg1.size:
            v = int(deg1[0])
            partner = min(w for w in adj[v] if alive[w])
            remove(partner)
        else:
            remove(int(np.argmax(live_deg)))

    keep_local = np.flatnonzero(alive)
    removed_ct = n - keep_local.size
    si = ds.si
    use_fid = _ids_header_and_rows(si, inc)
    _write_king_id(cfg.out + ".king.cutoff.in.id", si, inc[keep_local], use_fid)
    _write_king_id(cfg.out + ".king.cutoff.out.id", si, inc[~alive], use_fid)
    new_mask = np.zeros(ds.raw_sample_ct, dtype=bool)
    new_mask[inc[keep_local]] = True
    ds.sample_mask = new_mask
    ds.invalidate_counts()
    log.log(
        f"--king-cutoff: Excluded {removed_ct} sample{'s' if removed_ct != 1 else ''}, "
        f"with IDs written to {cfg.out}.king.cutoff.out.id, and {keep_local.size} "
        f"remaining sample IDs written to {cfg.out}.king.cutoff.in.id ."
    )


def _run_king_subset(ds: Dataset, cfg, log: RunLogger, vmask) -> None:
    """--king-table-subset: recompute KING only for the pairs listed in a
    prior .kin0-style file (CalcKingTableSubset,
    2.0/plink2_matrix_calc.cc:2754): rows keep the input file's pair
    orientation and order; an optional second argument drops input rows
    whose KINSHIP column is below the threshold."""
    args = cfg.king_table_subset
    path = args[0]
    thresh = float(args[1]) if len(args) > 1 else None
    si = ds.si
    inc = np.flatnonzero(ds.sample_mask)
    by_iid = {str(si.iid[i]): p for p, i in enumerate(inc)}
    by_fid_iid = {f"{si.fid[i]}\t{si.iid[i]}": p for p, i in enumerate(inc)}
    with open(path) as f:
        lines = [l.rstrip("\n") for l in f if l.strip()]
    hdr = lines[0]
    if not hdr.startswith("#"):
        raise ValueError("--king-table-subset: header line required.")
    cols = hdr.lstrip("#").split()
    fid_mode = cols[0] == "FID1"
    kin_col = cols.index("KINSHIP") if thresh is not None else None
    pairs = []
    skip_ct = 0
    for ln in lines[1:]:
        t = ln.split()
        if fid_mode:
            k1, k2 = f"{t[0]}\t{t[1]}", f"{t[2]}\t{t[3]}"
            p1, p2 = by_fid_iid.get(k1), by_fid_iid.get(k2)
        else:
            p1, p2 = by_iid.get(t[0]), by_iid.get(t[1])
        if thresh is not None and float(t[kin_col]) < thresh:
            continue
        if p1 is None or p2 is None or p1 == p2:
            skip_ct += 1
            continue
        pairs.append((p1, p2))
    sel = sorted({p for pr in pairs for p in pr})
    rank = {p: r for r, p in enumerate(sel)}
    smask2 = np.zeros(ds.raw_sample_ct, bool)
    smask2[inc[sel]] = True
    use_fid = _ids_header_and_rows(si, inc)
    out = cfg.out + ".kin0"
    # counts over the compacted subset (single tile: subsets are small)
    tiles = {}
    for r0, c0, s, counts, pd in _pair_tables(
        ds, vmask, tile=1 << 30, sample_mask=smask2
    ):
        k = king_kinship(counts)
        tiles[(r0, c0)] = (k, counts)
    with open(out, "w") as f:
        hdr_out = "#FID1\tIID1\tFID2\tIID2" if use_fid else "#IID1\tIID2"
        f.write(hdr_out + "\tNSNP\tHETHET\tIBS0\tKINSHIP\n")
        for p1, p2 in pairs:
            a, b = rank[p1], rank[p2]
            hi_, lo_ = (a, b) if a > b else (b, a)
            k, counts = tiles[(0, 0)]
            nsnp = counts["nsnp"][hi_, lo_]
            hethet = counts["hethet"][hi_, lo_]
            ibs0 = counts["ibs0"][hi_, lo_]
            recip = 1.0 / nsnp if nsnp else 0.0
            i1, i2 = inc[sel[a]], inc[sel[b]]
            if use_fid:
                idpart = (f"{si.fid[i1]}\t{si.iid[i1]}\t"
                          f"{si.fid[i2]}\t{si.iid[i2]}")
            else:
                idpart = f"{si.iid[i1]}\t{si.iid[i2]}"
            f.write(
                f"{idpart}\t{nsnp}\t{g6(hethet * recip)}\t"
                f"{g6(ibs0 * recip)}\t{g6(k[hi_, lo_])}\n"
            )
    if skip_ct:
        log.log(
            f"Warning: --king-table-subset: {skip_ct} pair(s) skipped "
            "(sample ID not present)."
        )
    log.log(f"Results written to {out} .")


def _king_cutoff_resume(ds: Dataset, cfg, log: RunLogger) -> None:
    """--king-cutoff <prefix> <threshold>: resume pruning from a previously
    written triangular .king.bin + .king.id (KingCutoffBatchBinary,
    2.0/plink2_matrix_calc.h:224)."""
    prefix = cfg.king_cutoff_prefix
    with open(prefix + ".king.id") as f:
        lines = [l.split("\t") for l in f.read().splitlines()]
    hdr = lines[0]
    iid_col = hdr.index("IID") if "IID" in hdr else len(hdr) - 1
    ids = [t[iid_col] for t in lines[1:]]
    n = len(ids)
    raw = np.fromfile(prefix + ".king.bin")
    tri = n * (n - 1) // 2
    if raw.size == tri:
        vals = raw
    else:
        raw4 = np.fromfile(prefix + ".king.bin", dtype=np.float32)
        if raw4.size == tri:
            vals = raw4.astype(np.float64)
        else:
            raise ValueError(
                "--king-cutoff currently requires a *triangular* .bin file."
            )
    kin = np.zeros((n, n))
    pos = 0
    for i in range(1, n):
        kin[i, :i] = vals[pos : pos + i]
        pos += i
    si = ds.si
    by_iid = {str(si.iid[i]): i for i in range(si.sample_ct)}
    raw_idx = np.array([by_iid.get(x, -1) for x in ids])
    inc = raw_idx
    _king_cutoff_prune(ds, cfg, log, kin, n, inc)
