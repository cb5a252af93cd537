"""--make-grm-bin / --make-grm-list / --make-rel / --pca.

Behavior reference: CalcGrm (2.0/plink2_matrix_calc.cc:4555) with
ExpandCenteredVarmaj normalization (:3839) and per-pair observed-variant
denominators (:4769-4781); CalcPca (:5594) for eigen decomposition.
Compute is kernel K8 (ops/pairwise.py `grm_gram`, csrc/grm_gram.cu): the
full-f32 Z^T Z product with f64 run sums and the joint-missing pair counts,
instead of dsyrk rank-k blocks; per-sample missing counts are kernel K5.

Output formats (verified against a locally built plink2):
- .grm.id : FID\tIID lines, no header.
- .grm    : "i\tj\tnsnp\tvalue" 1-based lower triangle incl. diagonal.
- .grm.bin / .grm.N.bin : float32 LE lower triangle incl. diagonal.
- .rel / .rel.id : text relationship matrix (triangle incl. diagonal by
  default; 'square'/'square0' modifiers), GCTA-compatible.
- .eigenvec / .eigenval : unit-norm GRM eigenvectors (sample-major) and
  eigenvalues; exact mode = full eigendecomposition of the GRM; approx
  mode streams the genotypes (commands/pca.py) without the matrix.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..dataset import Dataset
from ..ops.pairwise import (
    PackedDevice,
    grm_coefs,
    grm_gram,
    iter_lower_tiles,
    sample_miss_counts,
)
from ..utils.fmt import g6
from ..utils.logging import RunLogger
from .basic_reports import alt_allele_freqs
from .glm import _phase_timer


def _grm_setup(ds: Dataset, cfg):
    """Shared PackedDevice, per-code normed-dosage coefficients (f32
    [nb, vb, 3] on the card) and per-sample missing counts (K5)."""
    freqs = alt_allele_freqs(ds, founders_only=not cfg.nonfounders)
    vmask = ds.variant_mask.copy()
    pd = PackedDevice.for_pairs(ds, vmask)
    coefs = grm_coefs(
        freqs, np.zeros(len(freqs), dtype=bool), vmask
    )  # genome-wide is_haploid only (ref :4694); humans => diploid everywhere
    npadv = pd.nblocks * pd.vb
    cpad = np.zeros((npadv, 3), dtype=np.float32)
    cpad[: coefs.shape[0]] = coefs
    coef_dev = torch.from_numpy(cpad.reshape(pd.nblocks, pd.vb, 3)).to(
        pd.packed.device)
    miss_dev = sample_miss_counts(pd.packed, pd.vmask)
    return pd, coef_dev, miss_dev


def _stream_grm_bin(ds: Dataset, cfg, log: RunLogger) -> None:
    """--make-grm-bin without materializing the N x N matrix anywhere.

    The card streams [tile, chunk] output chunks (K8: the f32 GRM ratio and
    the f32 valid-pair count per pair, the division done on the card); a
    writer thread packs and appends the row-major lower triangle of both
    while the next chunks are still in flight.
    """
    import queue
    import threading
    from collections import deque

    mark = _phase_timer(log)
    pd, coef_dev, miss_dev = _grm_setup(ds, cfg)
    n, s = pd.n, pd.tile
    # --parallel k n: compute/write only the ParallelBounds(start=0) row
    # piece, suffixing outputs .<k> (ref CalcGrm TriangleFill2 outer
    # bounds + output naming, 2.0/plink2_matrix_calc.cc:4597,4952-4981;
    # pieces concatenate to the full triangle)
    row_lo, row_hi = 0, n
    suffix = ""
    par = getattr(cfg, "parallel", None)
    if par is not None:
        from .king import _parallel_bounds

        k_, tot_ = par
        row_lo, row_hi = _parallel_bounds(n, 0, k_ - 1, tot_)
        suffix = f".{k_}"
    c = min(4 * s, pd.npad) if pd.npad > s else s
    mv = pd.variant_ct
    mark("setup (packed copy, coefficients, K5 missing counts)")

    err: list[BaseException] = []
    writeq: queue.Queue = queue.Queue(maxsize=2)
    writer_busy = [0.0]

    def _writer():
        try:
            with open(cfg.out + ".grm.bin" + suffix, "wb") as fb, \
                    open(cfg.out + ".grm.N.bin" + suffix, "wb") as fn:
                while True:
                    item = writeq.get()
                    if item is None:
                        return
                    t0 = time.perf_counter()
                    r0, parts = item
                    rmax = min(r0 + s, row_hi)
                    rows, cols = rmax - r0, rmax  # row i needs cols 0..i
                    g = np.empty((rows, cols), np.float32)
                    nm = np.empty((rows, cols), np.float32)
                    for a0, ga, na in parts:  # overlaps rewrite same values
                        hi = min(a0 + c, cols)
                        g[:, a0:hi] = ga[:rows, : hi - a0]
                        nm[:, a0:hi] = na[:rows, : hi - a0]
                    i0 = max(0, row_lo - r0)  # first strip of a piece
                    total = (r0 + i0 + 1 + rmax) * (rows - i0) // 2
                    gflat = np.empty(total, np.float32)
                    nflat = np.empty(total, np.float32)
                    off = 0
                    for i in range(i0, rows):
                        ln = r0 + i + 1
                        gflat[off : off + ln] = g[i, :ln]
                        nflat[off : off + ln] = nm[i, :ln]
                        off += ln
                    fb.write(gflat)
                    fn.write(nflat)
                    writer_busy[0] += time.perf_counter() - t0
        except BaseException as e:  # surface in the main thread
            err.append(e)

    wt = threading.Thread(target=_writer, daemon=True)
    wt.start()

    # chunk grid: anchors every c columns, the last anchor pulled back so a
    # fixed-width window stays in bounds (multiple-of-4 for packed bytes)
    chunks = []
    last_anchor = {}
    # strips stay on the s-aligned grid (plink_tpu's dynamic_slice clamps
    # out-of-range starts); the writer trims rows below row_lo inside the
    # first strip
    for r0 in range((row_lo // s) * s, pd.npad, s):
        if r0 >= row_hi:
            break
        rmax = min(r0 + s, row_hi)
        anchors = sorted({min(a, pd.npad - c) for a in range(0, rmax, c)})
        for a0 in anchors:
            chunks.append((r0, a0))
        last_anchor[r0] = anchors[-1]

    pending: deque = deque()
    strip: dict[int, list] = {}

    def _drain_one():
        r0, a0, g, nm = pending.popleft()
        strip.setdefault(r0, []).append((a0, g.cpu().numpy(), nm.cpu().numpy()))
        if a0 == last_anchor[r0]:
            if err:
                raise err[0]
            writeq.put((r0, strip.pop(r0)))

    for r0, a0 in chunks:
        pending.append((r0, a0) + grm_gram(pd.packed, coef_dev, pd.vmask,
                                           miss_dev, mv, r0, a0, s, c))
        if len(pending) >= 6:
            _drain_one()
    while pending:
        _drain_one()
    mark(f"K8 chunks computed and fetched ({len(chunks)} of {s} x {c})")
    writeq.put(None)
    wt.join()
    mark(f"writer drained (busy {writer_busy[0]:.3f}s in all)")
    if err:
        raise err[0]
    if par is None or par[0] == 1:
        _write_id_file(cfg.out + ".grm.id",
                       ds.si, np.flatnonzero(ds.sample_mask))
    log.log(f"{ds.variant_ct} variants used in GRM computation.")
    if par is None:
        log.log(
            f"--make-grm-bin: GRM written to {cfg.out}.grm.bin + "
            f"{cfg.out}.grm.N.bin + {cfg.out}.grm.id ."
        )
    else:
        log.log(
            f"--make-grm-bin: GRM piece {par[0]}/{par[1]} (rows "
            f"{row_lo}-{row_hi - 1}) written to "
            f"{cfg.out}.grm.bin{suffix} + {cfg.out}.grm.N.bin{suffix} ."
        )


def _grm_matrix(ds: Dataset, cfg, log: RunLogger):
    """Compute the full GRM [n, n] float64 (lower triangle valid) and the
    per-pair observed counts [n, n] int64."""
    pd, coef_dev, miss_dev = _grm_setup(ds, cfg)
    n = pd.n
    s = pd.tile
    mv = pd.variant_ct
    grm = np.zeros((n, n), dtype=np.float64)
    nm = np.zeros((n, n), dtype=np.int64)
    # dispatch-ahead pipeline: the card computes tile k+1..k+W while tile
    # k's result is fetched
    from collections import deque

    window = 8
    q: deque = deque()

    def _drain_one():
        r0, c0, acc, cnt = q.popleft()
        rmax, cmax = min(r0 + s, n), min(c0 + s, n)
        if rmax <= r0 or cmax <= c0:
            return
        grm[r0:rmax, c0:cmax] = acc[: rmax - r0, : cmax - c0].cpu().numpy()
        nm[r0:rmax, c0:cmax] = cnt[: rmax - r0, : cmax - c0].cpu().numpy()

    # small panels keep f64 numerators (byte parity with plink_tpu's)
    fetch32 = n > 8192 and int(mv) < 65536
    for r0, c0 in iter_lower_tiles(pd.npad, s):
        q.append((r0, c0) + grm_gram(pd.packed, coef_dev, pd.vmask, miss_dev,
                                     mv, r0, c0, s, s, tile=True,
                                     fetch32=fetch32))
        if len(q) >= window:
            _drain_one()
    while q:
        _drain_one()
    with np.errstate(divide="ignore", invalid="ignore"):
        grm = grm / nm
    return grm, nm


def _write_id_file(path: str, si, inc) -> None:
    with open(path, "w") as f:
        for i in inc:
            f.write(f"{si.fid[i]}\t{si.iid[i]}\n")


def run_grm_pca(ds: Dataset, cfg, log: RunLogger) -> None:
    from .pca import run_pca

    inc = np.flatnonzero(ds.sample_mask)
    n = inc.size
    # --pca approx streams the genotypes and never builds the N x N matrix
    want_exact_pca = cfg.pca is not None and not cfg.pca_approx
    needs_matrix = cfg.make_grm_list or cfg.make_rel or want_exact_pca
    if getattr(cfg, "parallel", None) is not None and cfg.make_grm_bin \
            and needs_matrix:
        raise ValueError(
            "--parallel --make-grm-bin cannot be combined with commands "
            "that consume the full relationship matrix.")
    if cfg.make_grm_bin and not needs_matrix:
        # streaming path: nothing else needs the resident N x N matrix
        _stream_grm_bin(ds, cfg, log)
        if cfg.pca is not None:
            run_pca(ds, cfg, log, grm=None)
        return
    grm = None
    if cfg.make_grm_bin or needs_matrix:
        grm, nm = _grm_matrix(ds, cfg, log)
        log.log(f"{ds.variant_ct} variants used in GRM computation.")

    si = ds.si
    if cfg.make_grm_list:
        path = cfg.out + ".grm"
        with open(path, "w") as f:
            for i in range(n):
                for j in range(i + 1):
                    f.write(f"{i + 1}\t{j + 1}\t{nm[i, j]}\t{g6(grm[i, j])}\n")
        _write_id_file(cfg.out + ".grm.id", si, inc)
        log.log(f"--make-grm-list: GRM written to {path} + {cfg.out}.grm.id .")
    if cfg.make_grm_bin:
        # stream the lower triangle in row blocks (no 2x in-memory copy of
        # the multi-GB triangle at biobank n)
        with open(cfg.out + ".grm.bin", "wb") as fb, \
                open(cfg.out + ".grm.N.bin", "wb") as fn:
            bs = 1024
            for i0 in range(0, n, bs):
                i1 = min(i0 + bs, n)
                fb.write(np.concatenate(
                    [grm[i, : i + 1] for i in range(i0, i1)]
                ).astype("<f4").tobytes())
                fn.write(np.concatenate(
                    [nm[i, : i + 1] for i in range(i0, i1)]
                ).astype("<f4").tobytes())
        _write_id_file(cfg.out + ".grm.id", si, inc)
        log.log(
            f"--make-grm-bin: GRM written to {cfg.out}.grm.bin + "
            f"{cfg.out}.grm.N.bin + {cfg.out}.grm.id ."
        )
    if cfg.make_rel:
        shape = cfg.make_rel
        path = cfg.out + ".rel"
        with open(path, "w") as f:
            if shape == "square":
                full = np.tril(grm) + np.tril(grm, -1).T
                for i in range(n):
                    f.write("\t".join(g6(v) for v in full[i]) + "\n")
            elif shape == "square0":
                for i in range(n):
                    row = [g6(grm[i, j]) for j in range(i + 1)] + ["0"] * (n - i - 1)
                    f.write("\t".join(row) + "\n")
            else:  # triangle (default)
                for i in range(n):
                    f.write("\t".join(g6(grm[i, j]) for j in range(i + 1)) + "\n")
        _write_id_file(cfg.out + ".rel.id", si, inc)
        log.log(f"--make-rel: Matrix written to {path} + {cfg.out}.rel.id .")

    if cfg.pca is not None:
        run_pca(ds, cfg, log, grm=grm)
