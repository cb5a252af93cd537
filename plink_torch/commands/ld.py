"""--indep-pairwise / --indep-pairphase: windowed r^2 greedy LD pruning.

Behavior reference: LdPrune / IndepPairwiseThread (2.0/plink2_ld.cc:2530,
:801-1116) with the default (non plink1-order) scan: when a window fills,
'second' scans new window positions in reverse, 'first' scans earlier live
positions in reverse; on r^2 > threshold the variant whose major-allele
frequency is greater (by a (1+2^-44) factor) is removed — second removed =>
break to next second.  Monomorphic/all-het variants are removed at load
(:906-910).  Window geometry per LdPruneNextSubcontig/LdPruneNextWindow
(:{subcontig,window} advance), subcontigs split per chromosome and, in
bp mode, at gaps wider than the window (LdPruneSubcontigSplitAll :2165).

The pair decisions come from kernel K11 (ops/ld.py `LdBitsBand`) over the
subcontig's rows of the device-resident packed matrix, founders only; the
serial greedy walk runs on the host over those bits (the native
`ld_prune_walk`; `_walk_py` is the same walk in Python, the tests'
reference).  --indep-pairphase (IndepPairphaseThread, 2.0/plink2_ld.cc:1549)
runs the same walk with K11 on the founders' 2n haplotype columns, built on
the host from the phase tracks.

Outputs <out>.prune.in / <out>.prune.out (variant IDs in variant order).

Not yet implemented vs the reference (as in plink_tpu): chrX male/nonmale
double-weighting (:935-947; chrX variants are treated autosomally),
--indep-preferred, --indep-order 1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dataset import Dataset
from ..io.pack import pack2, unpack2
from ..ops.ld import LdBitsBand
from ..ops.pairwise import compact_samples
from ..utils.logging import RunLogger
from .basic_reports import alt_allele_freqs

_EPS = 1.0 + 2.0 ** -44  # kSmallEpsilon factor in the removal tie-break
HAP_BLOCK = 2048  # variants a block of --indep-pairphase's haplotype expansion


def _parse_spec(args: tuple) -> tuple[int, bool, int, float]:
    """--indep-pairwise <ws>[kb] [step] <r2> -> (ws, is_kb, step, r2)."""
    args = list(args)
    if len(args) < 2:
        raise ValueError("--indep-pairwise requires window size and r^2 threshold")
    w0 = args[0]
    is_kb = False
    if w0.lower().endswith("kb"):
        is_kb = True
        ws = int(float(w0[:-2]) * 1000 * _EPS)
    elif len(args) >= 2 and args[1].lower() == "kb":
        is_kb = True
        ws = int(float(w0) * 1000 * _EPS)
        args.pop(1)
    else:
        ws = int(float(w0))
    r2 = float(args[-1])
    if not 0.0 <= r2 < 1.0:
        raise ValueError(f"--indep-pairwise: invalid r^2 threshold {r2}")
    step = 1
    if len(args) == 3:
        step = int(args[1])
        if is_kb and step != 1:
            raise ValueError(
                "--indep-pairwise window-increment must be 1 with kb window"
            )
        if not is_kb and step > ws:
            raise ValueError("--indep-pairwise increment cannot exceed window size")
    return ws, is_kb, step, r2


def _subcontigs(sub_bps: np.ndarray, ws: int, is_kb: bool):
    """Split one chromosome's included variants into subcontigs: in bp mode,
    break where the gap exceeds the window (no pairs can span it)."""
    n = len(sub_bps)
    if not is_kb:
        return [(0, n)]
    out = []
    start = 0
    for i in range(1, n):
        if int(sub_bps[i]) - ws > int(sub_bps[i - 1]):
            if i - start > 1:
                out.append((start, i))
            start = i
    if n - start > 1:
        out.append((start, n))
    return out


def indep_pairwise(ds: Dataset, cfg, log: RunLogger, phased: bool = False) -> None:
    """phased=True is --indep-pairphase: the same walk, the pair r^2 that
    of the haplotype columns."""
    spec = cfg.indep_pairphase if phased else cfg.indep_pairwise
    if phased and not ds.has_phase:
        # the reference requires true phase tracks for --indep-pairphase
        # (it does not statistically phase like --r2-phased)
        raise ValueError(
            "--indep-pairphase: 0-based variant #0 is not fully phased."
        )
    ws, is_kb, step, r2t = _parse_spec(spec)
    vmask = ds.variant_mask.copy()
    flagname = "indep-pairphase" if phased else "indep-pairwise"
    chr0 = vmask & (ds.vi.chrom == 0)
    if chr0.any():
        ct = int(chr0.sum())
        log.log(
            f"--{flagname}: Ignoring {ct} chromosome 0 "
            f"variant{'s' if ct != 1 else ''}."
        )
        vmask &= ~chr0
    founders = ds.sample_mask & ds.founder_mask
    freqs = alt_allele_freqs(ds, founders_only=True)
    with np.errstate(invalid="ignore"):
        majf = np.where(freqs > 0.5, freqs, 1.0 - freqs)

    inc_f = np.flatnonzero(founders)
    npad = -(-len(inc_f) // 4) * 4
    smask = np.zeros(npad, np.int8)
    smask[: len(inc_f)] = 1

    removed_global = np.zeros(ds.raw_variant_ct, dtype=bool)
    considered = np.zeros(ds.raw_variant_ct, dtype=bool)

    for chrom in np.unique(ds.vi.chrom[vmask]):
        cidx = np.flatnonzero(vmask & (ds.vi.chrom == chrom))
        if cidx.size < 2:
            continue
        bps = ds.vi.pos[cidx]
        for s0, s1 in _subcontigs(bps, ws, is_kb):
            sub = cidx[s0:s1]
            considered[sub] = True
            _prune_subcontig(ds, sub, ds.vi.pos[sub], majf[sub], inc_f, smask,
                             npad, ws, is_kb, step, r2t, removed_global, phased)

    pruned = removed_global & considered
    kept = considered & ~removed_global
    with open(cfg.out + ".prune.in", "w") as f:
        ki = np.flatnonzero(kept)
        if ki.size:
            f.write("\n".join(map(str, ds.vi.vid[ki])) + "\n")
    with open(cfg.out + ".prune.out", "w") as f:
        pi = np.flatnonzero(pruned)
        if pi.size:
            f.write("\n".join(map(str, ds.vi.vid[pi])) + "\n")
    ct, tot = int(pruned.sum()), int(considered.sum())
    log.log(
        f"--{flagname} ({'kb' if is_kb else 'ct'} window): {ct}/{tot} "
        f"variants removed; IDs written to {cfg.out}.prune.in + "
        f"{cfg.out}.prune.out ."
    )


def _max_bp_window_span(bps: np.ndarray, ws: int) -> int:
    """Max count of included variants inside any ws-bp window (band width)."""
    n = len(bps)
    j = 0
    best = 1
    for i in range(n):
        while j < n and int(bps[j]) <= int(bps[i]) + ws:
            j += 1
        best = max(best, j - i)
    return best - 1


def _subcontig_rows(ds: Dataset, sub: np.ndarray, inc_f: np.ndarray,
                    npad: int) -> torch.Tensor:
    """The subcontig's packed rows [n, npad / 4] on the run's device, from
    the resident copy: founder columns compacted on the device when not
    every sample is one, else the byte axis padded (padding samples decode
    to hom-REF and the sample mask zeroes them)."""
    flat = ds.device_all_packed()
    rows = flat[torch.from_numpy(sub).to(flat.device)]
    if inc_f.size != ds.raw_sample_ct:
        return compact_samples(rows, torch.from_numpy(inc_f).to(flat.device), npad)
    if rows.shape[1] < npad // 4:
        rows = torch.nn.functional.pad(rows, (0, npad // 4 - rows.shape[1]))
    return rows.contiguous()


def _haplotype_rows(ds: Dataset, sub: np.ndarray, inc_f: np.ndarray):
    """--indep-pairphase's input (plink_tpu/commands/ld.py:191-221): the
    founders' two haplotypes of each variant as columns 2s and 2s + 1, coded
    0 (REF), 2 (ALT) or 3 (missing), packed and put on the run's device, and
    their sample mask.  The r^2 of 0/1 haplotype indicators is the phased
    r^2, so K11 runs on them unchanged.  Raises on a het call without
    phase.  The subcontig is read in one piece and expanded in blocks of
    HAP_BLOCK variants; only the phase tracks are parsed per variant."""
    n, N = len(sub), ds.raw_sample_ct
    lo, hi = int(sub[0]), int(sub[-1]) + 1
    packed = ds.reader.read_packed(lo, hi - lo)[sub - lo]
    nh = 2 * len(inc_f)
    npad = -(-nh // 4) * 4
    out = np.empty((n, npad // 4), np.uint8)
    for b0 in range(0, n, HAP_BLOCK):
        full = unpack2(packed[b0 : b0 + HAP_BLOCK], N)
        pp, pi = np.empty((2, *full.shape), bool)
        for k, c in enumerate(full):
            pp[k], pi[k] = ds.phase_row(int(sub[b0 + k]), c)
        if len(inc_f) != N:
            full, pp, pi = full[:, inc_f], pp[:, inc_f], pi[:, inc_f]
        het = full == 1
        bad = np.flatnonzero((het & ~pp).any(axis=1))
        if bad.size:
            raise ValueError(
                f"--indep-pairphase: 0-based variant #{int(sub[b0 + bad[0]])} "
                "is not fully phased."
            )
        # unswapped "0|1": hap1 REF(0), hap2 ALT(2); missing stays 3
        alt, miss = full == 2, full == 3
        hap = np.empty((len(full), len(inc_f), 2), np.uint8)
        for h, alt_h in enumerate((alt | (het & pi), alt | (het & ~pi))):
            code = alt_h.view(np.uint8) << 1
            code[miss] = 3
            hap[:, :, h] = code
        out[b0 : b0 + len(full)] = pack2(hap.reshape(len(full), nh))
    smask = np.zeros(npad, np.int8)
    smask[:nh] = 1
    return torch.from_numpy(out).to(ds.device), smask


def _prune_subcontig(ds, sub, bps, majf_sub, inc_f, smask, npad, ws, is_kb,
                     step, r2t, removed_global, phased=False):
    n = len(sub)
    width = (min(ws, n - 1)) if not is_kb else _max_bp_window_span(bps, ws)
    if phased:
        rows, smask = _haplotype_rows(ds, sub, inc_f)
    else:
        rows = _subcontig_rows(ds, sub, inc_f, npad)
    band = LdBitsBand(rows, smask, width, r2t)
    # per-variant monomorphic check (ref :906-910): no homs, or all nonmissing
    # hom-ref, or all hom-alt
    plusone, minusone, nm = band.homref1, band.homalt1, band.nm1
    mono = ((plusone == 0) & (minusone == 0)) | (plusone == nm) | (minusone == nm)
    removed = _walk(band, mono, majf_sub, bps, ws, is_kb, step)
    removed_global[sub[removed]] = True


def _walk(band, mono, majf, bps, ws, is_kb, step) -> np.ndarray:
    """The serial greedy window walk over the band's decision bits: the
    native `ld_prune_walk` (`_walk_py` where the native library cannot be
    built).  Returns the removed mask [n]."""
    from ..native import get_lib

    lib = get_lib()
    if lib is None:
        return _walk_py(band, mono, majf, bps, ws, is_kb, step)
    n = band.n
    exceeds8 = np.ascontiguousarray(band.exceeds, dtype=np.uint8)
    mono8 = np.ascontiguousarray(mono, dtype=np.uint8)
    majf64 = np.ascontiguousarray(majf, dtype=np.float64)
    bps64 = np.ascontiguousarray(bps, dtype=np.int64)
    removed = np.zeros(n, np.uint8)
    lib.ld_prune_walk(
        exceeds8.ctypes.data, mono8.ctypes.data, majf64.ctypes.data,
        bps64.ctypes.data, n, band.width, ws, int(is_kb), step, _EPS,
        removed.ctypes.data,
    )
    return removed.astype(bool)


def _walk_py(band, mono, majf_sub, bps, ws, is_kb, step) -> np.ndarray:
    """The walk in Python (plink_tpu/commands/ld.py:268-351), the reference
    the native walk is tested against."""
    n = band.n
    removed = np.zeros(n, dtype=bool)
    window: list[int] = []  # subcontig-local indices at each winpos
    cur_removed: list[bool] = []
    winpos_split = 0
    start = 0
    if is_kb:
        end_bp_thresh = int(bps[0]) + ws
        first_len = 1
        while first_len < n and int(bps[first_len]) <= end_bp_thresh:
            first_len += 1
        # next_end doubles as the index of the first variant OUTSIDE the
        # window (the reference's variant_uidx_winend), so bps[next_end] > ws
        # is guaranteed whenever we advance -- no underflow in min_bp
        next_end = first_len
    else:
        next_end = min(n, ws)

    cur = 0
    while cur < n:
        i = cur
        cur_removed.append(bool(mono[i]))
        if mono[i]:
            removed[i] = True
        window.append(i)
        cur += 1
        if cur != next_end:
            continue
        # ---- process window pairs (default reverse-scan order) ----
        stop = winpos_split if winpos_split else 1
        wlen = len(window)
        for second in range(wlen - 1, stop - 1, -1):
            # the reference deliberately does NOT skip a removed 'second'
            # here (plink2_ld.cc:1043-1049 has no cur_window_removed check
            # on second_winpos): an already-removed variant still prunes
            # earlier partners
            s_loc = window[second]
            live_firsts = [
                fp for fp in range(second - 1, -1, -1) if not cur_removed[fp]
            ]
            if not live_firsts:
                continue
            f_locs = np.array([window[fp] for fp in live_firsts])
            exceeds = band.r2_exceeds_vec(f_locs, s_loc)
            for k, fp in enumerate(live_firsts):
                if not exceeds[k] or cur_removed[fp]:
                    continue
                f_loc = window[fp]
                if majf_sub[f_loc] <= majf_sub[s_loc] * _EPS:
                    cur_removed[second] = True
                    removed[s_loc] = True
                    break
                cur_removed[fp] = True
                removed[f_loc] = True
        # ---- advance window (ref LdPruneNextWindow) ----
        if next_end == n:
            break
        if is_kb:
            # ref LdPruneNextWindow bp branch: advance start until the old
            # first-outside variant fits, then extend the end to the new
            # first-outside variant
            new_start = start
            min_bp = int(bps[next_end]) - ws
            while True:
                new_start += 1
                if int(bps[new_start]) >= min_bp:
                    break
            end_thresh = int(bps[new_start]) + ws
            ne = next_end
            while ne < n and int(bps[ne]) <= end_thresh:
                ne += 1
            next_end = ne
        else:
            new_start = start + step
            next_end = min(new_start + ws, n)
        new_window, new_removed = [], []
        for wp, i_loc in enumerate(window):
            if cur_removed[wp] or i_loc < new_start:
                continue
            new_window.append(i_loc)
            new_removed.append(False)
        window, cur_removed = new_window, new_removed
        winpos_split = len(window)
        start = new_start
    return removed

