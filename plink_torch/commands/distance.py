"""--distance / --distance-matrix / --ibs-matrix: PLINK 1.9 IBS-based
distance matrices.

Behavior reference: calc_distance (1.9/plink_calc.c:7570-8210) and the
distance_d_write* emitters (:3279-3760):
- idist_ij = allele-difference count = 2*IBS0 + IBS1 over jointly
  nonmissing autosomal markers (non-autosomes are excluded up front with
  the same log message).
- Default missing handling rescales by *weighted* missingness
  (:7718-7768): per-marker weight w = p(1-p)(p^2-p+1) (p = set-allele
  freq), except monomorphic markers where w = set_allele_freq itself —
  i.e. exactly 1.0, since the set allele is the major allele.  Weights
  are normalized to sum to just under 2^32 and ROUNDED TO uint32; the
  pair distance is idist * W / (W - Wmiss_i - Wmiss_j + Wjoint_ij) with
  integer weight sums.  'flat-missing' (and the plink1 --distance-matrix/
  --ibs-matrix modes) use unweighted marker counts instead:
  idist * marker_ct / nsnp_ij.
- .dist values are the rescaled allele counts; .mibs = 1 - dist/(2*M);
  .mdist = dist/(2*M).  Shapes: triangle (default; .dist/.mdist omit the
  diagonal, .mibs includes it), square, square0; text is tab-delimited,
  'gz' gzips it, 'bin'/'bin4' write f64/f32 binary squares.  The plink1
  matrix modes are space-delimited squares with a trailing space.

The pair counts come from KING's kernel K7 in its counters mode
(ops/pairwise.py `king_gram`, csrc/king_gram.cu), one launch per lower
sample tile; the weighted joint-missing matrix from kernel K23
(`wmiss_gram`, csrc/wmiss_gram.cu), exact uint64 sums of the uint32
weights.  The f64 operations after them are plink_tpu's, in its order, so
the outputs are its bytes.

Documented deviation: plink 1.9's triangle-binary writer fails to reset
g_pct between the .mibs and .mdist emit loops (:3828-3837), so with
'ibs 1-ibs bin' the .mdist.bin gains 1% extra entries read past the end
of the dists allocation (uninitialized memory). We write the correct
n(n-1)/2 entries instead.
"""

from __future__ import annotations

import gzip

import numpy as np
import torch

from ..dataset import Dataset
from ..ops.pairwise import (
    PackedDevice,
    distance_weights,
    iter_lower_tiles,
    king_gram,
    wmiss_gram,
)
from ..utils.fmt import g6
from ..utils.logging import RunLogger
from .basic_reports import alt_allele_freqs


def _put(m: np.ndarray, blk: np.ndarray, r0: int, c0: int) -> None:
    """Write a lower tile's block and, off the diagonal, its mirror (the
    counts are symmetric, so a diagonal tile's upper part is its mirror)."""
    m[r0 : r0 + blk.shape[0], c0 : c0 + blk.shape[1]] = blk
    if r0 != c0:
        m[c0 : c0 + blk.shape[1], r0 : r0 + blk.shape[0]] = blk.T


def _pair_counts(ds: Dataset, vmask, need_weighted: bool, nonfounders: bool):
    """Returns (idist, nsnp, scale, marker_ct, included samples) where
    scale[i,j] is the missing-rescale factor (weighted or flat) and all
    arrays are full [n, n] symmetric.  Per lower tile: K7's counters
    (idist = 2 ibs0 + het x hom both ways, formed on the device) and, for
    the weighted rescale, K23's joint missing weights; the per-sample
    weighted missing count is the joint matrix's diagonal."""
    pd = PackedDevice.for_pairs(ds, vmask)
    n = pd.n
    s = pd.tile
    idist = np.zeros((n, n), np.int64)
    nsnp = np.zeros((n, n), np.int64)
    marker_ct = int(vmask.sum())

    wjoint = np.zeros((n, n), np.int64) if need_weighted else None
    if need_weighted:
        freqs = alt_allele_freqs(ds, founders_only=not nonfounders, dosage=True)
        wi, wsum = distance_weights(freqs[: ds.raw_variant_ct], vmask)
        wt = torch.zeros(pd.nblocks * pd.vb, dtype=torch.int64)
        wt[: wi.size] = torch.from_numpy(wi)
        wt = wt.to(pd.packed.device)
    else:
        wsum = 0

    for r0, c0 in iter_lower_tiles(pd.npad, s):
        rmax, cmax = min(r0 + s, n), min(c0 + s, n)
        cnt = king_gram(pd.packed, pd.vmask, r0, c0, s, s, counts=True)
        cut = np.s_[: rmax - r0, : cmax - c0]
        _put(idist, (2 * cnt[0] + cnt[2] + cnt[3]).cpu().numpy()[cut], r0, c0)
        _put(nsnp, cnt[5].cpu().numpy()[cut], r0, c0)
        del cnt
        if need_weighted:
            gw = wmiss_gram(pd.packed, pd.vmask, wt, r0, c0, s, s)
            _put(wjoint, gw.cpu().numpy()[cut], r0, c0)

    if need_weighted:
        # per-sample weighted missing: diagonal of the joint matrix
        wmiss_s = np.diag(wjoint).copy()
        denom = wsum - wmiss_s[:, None] - wmiss_s[None, :] + wjoint
        with np.errstate(divide="ignore", invalid="ignore"):
            scale = wsum / denom.astype(np.float64)
    else:
        with np.errstate(divide="ignore", invalid="ignore"):
            scale = marker_ct / nsnp.astype(np.float64)
    return idist, nsnp, scale, marker_ct, pd.include_idx


def _write_ids(path: str, ds: Dataset, inc) -> None:
    si = ds.si
    with open(path, "w") as f:
        for i in inc:
            f.write(f"{si.fid[i]}\t{si.iid[i]}\n")


def _emit_text(path, vals, shape, diag_val, include_diag_tri, gz=False):
    """vals: [n, n] f64; writes tab-delimited text in the 1.9 layout."""
    n = vals.shape[0]
    op = gzip.open if gz else open
    with op(path, "wt") as f:
        if shape == "triangle":
            r0 = 0 if include_diag_tri else 1
            for i in range(r0, n):
                end = i + 1 if include_diag_tri else i
                row = [_v(vals, i, j, diag_val) for j in range(end)]
                f.write("\t".join(row) + "\n")
        elif shape == "square":
            for i in range(n):
                f.write(
                    "\t".join(_v(vals, i, j, diag_val) for j in range(n))
                    + "\n"
                )
        else:  # square0
            for i in range(n):
                row = [_v(vals, i, j, diag_val) for j in range(i + 1)]
                row += ["0"] * (n - i - 1)
                f.write("\t".join(row) + "\n")


def _v(vals, i, j, diag_val):
    if i == j:
        return diag_val
    return g6(vals[i, j])


def _emit_bin(path, vals, shape, diag, f32=False, alct_quirk=False):
    """Binary emit matching 1.9/plink_calc.c:3786-4080 exactly:
    triangle omits the diagonal for all three matrix types; the bin4
    square .dist diagonal repeats the row's last lower-triangle value
    (fxx is never reset in the :3981 loop — replicated for byte parity)."""
    n = vals.shape[0]
    m = vals.copy()
    np.fill_diagonal(m, diag)
    if f32 and alct_quirk and shape == "square":
        for i in range(1, n):
            m[i, i] = np.float32(vals[i, i - 1])
    if shape == "square0":
        m[np.triu_indices(n, 1)] = 0.0
        out = m
    elif shape == "triangle":
        out = np.concatenate([m[i, :i] for i in range(n)])
    else:
        out = m
    out.astype(np.float32 if f32 else np.float64).tofile(path)


def run_distance(ds: Dataset, cfg, log: RunLogger) -> None:
    auto = ds.vi.chr_info.is_autosomal(ds.vi.chrom)
    vmask = ds.variant_mask & auto
    n_excl = int((ds.variant_mask & ~auto).sum())
    if n_excl:
        log.log(
            f"Excluding {n_excl} variant{'s' if n_excl != 1 else ''} on "
            "non-autosomes from distance matrix calc."
        )
    if not vmask.any():
        raise ValueError("--distance: no autosomal variants remaining.")

    mods = [m.lower() for m in (cfg.distance or ())]
    known = {"square", "square0", "triangle", "gz", "bin", "bin4", "ibs",
             "1-ibs", "allele-ct", "flat-missing"}
    for m in mods:
        if m not in known:
            raise ValueError(f"Invalid --distance parameter '{m}'.")
    shapes = [m for m in mods if m in ("square", "square0", "triangle")]
    if len(set(shapes)) > 1:
        raise ValueError(
            f"--distance '{shapes[0]}' and '{shapes[1]}' modifiers cannot "
            "coexist."
        )
    enc = [m for m in mods if m in ("gz", "bin", "bin4")]
    if len(set(enc)) > 1:
        raise ValueError("Conflicting --distance modifiers.")
    shape = shapes[0] if shapes else "triangle"
    want_ibs = "ibs" in mods
    want_1mibs = "1-ibs" in mods
    want_alct = "allele-ct" in mods or not (want_ibs or want_1mibs)
    flat = "flat-missing" in mods
    gz = "gz" in mods
    as_bin = "bin" in mods
    as_bin4 = "bin4" in mods
    if as_bin or as_bin4:
        if shape == "triangle" and "triangle" not in mods:
            shape = "square"  # bin defaults to square

    plink1_mdist = getattr(cfg, "distance_matrix", False)
    plink1_mibs = getattr(cfg, "ibs_matrix", False)
    run_dist = cfg.distance is not None
    if plink1_mibs and want_ibs and run_dist:
        raise ValueError(
            '--ibs-matrix cannot be used with "--distance ibs".'
        )
    if cfg.parallel is not None and run_dist:
        raise ValueError("--parallel is not yet supported with --distance.")

    need_weighted = run_dist and not flat
    idist, nsnp, scale, marker_ct, inc = _pair_counts(
        ds, vmask, need_weighted, cfg.nonfounders
    )
    flat_scale = None
    if plink1_mdist or plink1_mibs or flat:
        with np.errstate(divide="ignore", invalid="ignore"):
            flat_scale = marker_ct / nsnp.astype(np.float64)

    if run_dist:
        sc = flat_scale if flat else scale
        dist = idist * sc
        # one .id per emitted matrix type (ref distance_d_write_ids :3279)
        for want, ext in ((want_alct, ".dist.id"), (want_ibs, ".mibs.id"),
                          (want_1mibs, ".mdist.id")):
            if want:
                _write_ids(cfg.out + ext, ds, inc)
                log.log(f"IDs written to {cfg.out}{ext} .")
        half_m_recip = 0.5 / marker_ct
        if want_alct:
            path = cfg.out + ".dist" + (".gz" if gz else "")
            if as_bin or as_bin4:
                path = cfg.out + ".dist.bin"
                _emit_bin(path, dist, shape, 0.0, f32=as_bin4,
                          alct_quirk=True)
            else:
                _emit_text(path, dist, shape, "0", False, gz=gz)
            log.log(f"Distances (allele counts) written to {path} .")
        if want_ibs:
            mibs = 1.0 - dist * half_m_recip
            path = cfg.out + ".mibs" + (".gz" if gz else "")
            if as_bin or as_bin4:
                path = cfg.out + ".mibs.bin"
                _emit_bin(path, mibs, shape, 1.0, f32=as_bin4)
            else:
                _emit_text(path, mibs, shape, "1", True, gz=gz)
            log.log(f"IBS matrix written to {path} .")
        if want_1mibs:
            mdist = dist * half_m_recip
            path = cfg.out + ".mdist" + (".gz" if gz else "")
            if as_bin or as_bin4:
                path = cfg.out + ".mdist.bin"
                _emit_bin(path, mdist, shape, 0.0, f32=as_bin4)
            else:
                _emit_text(path, mdist, shape, "0", False, gz=gz)
            log.log(f"Distances (proportions) written to {path} .")

    if plink1_mdist or plink1_mibs:
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = idist / (2.0 * nsnp)
        if plink1_mdist:
            path = cfg.out + ".mdist"
            _write_ids(path + ".id", ds, inc)
            _emit_p1_square(path, frac, "0")
            log.log(
                f"Distances (proportions) written to {path} , and IDs to "
                f"{path}.id ."
            )
        if plink1_mibs:
            path = cfg.out + ".mibs"
            _write_ids(path + ".id", ds, inc)
            _emit_p1_square(path, 1.0 - frac, "1")
            log.log(
                f"IBS matrix written to {path} , and IDs to {path}.id ."
            )


def _emit_p1_square(path, vals, diag_val):
    n = vals.shape[0]
    with open(path, "w") as f:
        for i in range(n):
            f.write(
                "".join(
                    (_v(vals, i, j, diag_val) + " ") for j in range(n)
                )
                + "\n"
            )
