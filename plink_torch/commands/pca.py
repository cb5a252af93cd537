"""--pca [k] [approx] [allele-wts]: principal component analysis.

Behavior reference: CalcPca (2.0/plink2_matrix_calc.cc:5594).
- exact (default): full eigendecomposition of the missing-corrected GRM
  (host float64 eigh, mirroring the reference's LAPACK dsyevr path :5995);
  the GRM comes from kernel K8 (commands/grm.py `_grm_matrix`).
- approx: Halko-style randomized range finder (:5697-5930): pc_ct+1
  power-iteration blocks of width 2*pc_ct concatenated into the projection
  QQ, X-projection SVD, eigenvalues = s^2 / variant_ct.  The power
  iterations and the projection stream the packed genotypes on the card
  (ops/pca.py: K9 X q, K10 X^T b); QR, SVD and the eigenvector algebra are
  host f64 numpy, as in plink_tpu.
- allele-wts: per-allele loadings of the exact or approx eigenvectors
  (K9 on the eigenvectors).

Outputs: .eigenvec (header #[FID\t]IID\tPC1.., unit-norm sample
eigenvectors, dtoa_g), .eigenval (one eigenvalue per line) and, with
allele-wts, .eigenvec.allele.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dataset import Dataset
from ..ops.pairwise import DEFAULT_VB, PackedDevice, _env_size, grm_coefs
from ..ops.pca import x_apply, xtx_apply
from ..utils.fmt import g6
from ..utils.logging import RunLogger
from .basic_reports import _provref_strs, alt_allele_freqs
from .glm import _phase_timer


class _Operands:
    """The streamed standardised genotype matrix: packed blocks on the card
    (plink_tpu's single-sample-tile layout), per-code coefficients f32
    [nb, vb, 3] and the sample mask f32 [npad]."""

    def __init__(self, ds: Dataset, cfg):
        self.freqs = alt_allele_freqs(ds, founders_only=not cfg.nonfounders)
        self.vmask = ds.variant_mask.copy()
        pd = PackedDevice(ds, self.vmask, _env_size("PLINK_TORCH_VB", DEFAULT_VB, 8))
        coefs = grm_coefs(self.freqs, np.zeros(len(self.freqs), dtype=bool),
                          self.vmask)
        self.npadv = pd.nblocks * pd.vb
        cpad = np.zeros((self.npadv, 3), dtype=np.float32)
        cpad[: coefs.shape[0]] = coefs
        dev = pd.packed.device
        self.pd = pd
        self.coef = torch.from_numpy(cpad.reshape(pd.nblocks, pd.vb, 3)).to(dev)
        smask = np.zeros(pd.npad, np.float32)
        smask[: pd.n] = 1.0
        self.smask = torch.from_numpy(smask).to(dev)

    def x(self, q: np.ndarray) -> np.ndarray:
        """X q [npadv, L] on the host for host q [npad, L]."""
        qd = torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(self.smask.device)
        out = x_apply(self.pd.packed, self.coef, self.smask, qd)
        return out.cpu().numpy().reshape(self.npadv, q.shape[1])


def run_pca(ds: Dataset, cfg, log: RunLogger, grm: np.ndarray | None = None) -> None:
    pc_ct = cfg.pca
    inc = np.flatnonzero(ds.sample_mask)
    n = inc.size
    if pc_ct >= n:
        raise ValueError(f"--pca {pc_ct}: requires more samples than PCs")
    mark = _phase_timer(log)
    ops = None
    if cfg.pca_approx:
        ops = _Operands(ds, cfg)
        mark("setup (allele frequencies, packed copy, coefficients)")
        eigvals, eigvecs = _pca_approx(ops, cfg, pc_ct, log, mark)
    else:
        if grm is None:
            from .grm import _grm_matrix

            grm, _ = _grm_matrix(ds, cfg, log)
        full = np.tril(grm) + np.tril(grm, -1).T
        w, v = np.linalg.eigh(full)
        eigvals = w[::-1][:pc_ct]
        eigvecs = v[:, ::-1][:, :pc_ct]
        mark("GRM and host eigh")
    _write_eig(ds, cfg, log, inc, eigvals, eigvecs, pc_ct)
    mark("write .eigenvec / .eigenval")
    if cfg.pca_allele_wts:
        _write_allele_wts(ds, cfg, log, ops or _Operands(ds, cfg), eigvals,
                          eigvecs, pc_ct)
        mark("allele-wts (K9 and the .eigenvec.allele writer)")


def _pca_approx(ops: _Operands, cfg, pc_ct: int, log: RunLogger, mark):
    pd = ops.pd
    n, npad = pd.n, pd.npad
    variant_ct = int(ops.vmask.sum())
    L = 2 * pc_ct
    # the start matrix from host numpy, the stream plink_tpu draws from
    rng = np.random.default_rng(cfg.seed if cfg.seed is not None else 0)
    g0 = rng.standard_normal((npad, L)).astype(np.float32)
    g0[n:] = 0.0
    blocks = [g0]
    cur = torch.from_numpy(g0).to(ops.smask.device)
    inv_m = 1.0 / variant_ct
    for _ in range(pc_ct):
        cur = xtx_apply(pd.packed, ops.coef, ops.smask, cur) * inv_m
        blocks.append(cur.cpu().numpy())
    mark(f"power iterations (K9 + K10, {pc_ct} x {pd.nblocks} blocks)")
    qq = np.concatenate(blocks, axis=1).astype(np.float64)  # [npad, (pc_ct+1)*L]
    qq[n:] = 0.0
    qq, _ = np.linalg.qr(qq)
    mark(f"host QR of [{npad}, {qq.shape[1]}]")
    b = ops.x(qq.astype(np.float32))[: len(ops.freqs)]
    mark("projection (K9)")
    # SVD of the projected matrix ("Recovering top PCs from range
    # approximation", ref :5867)
    _, s, vt = np.linalg.svd(b.astype(np.float64), full_matrices=False)
    eigvals = (s[:pc_ct] ** 2) / variant_ct
    eigvecs = (qq @ vt.T[:, :pc_ct])[:n]
    # re-normalize (qq columns orthonormal => already unit, up to fp error)
    eigvecs /= np.linalg.norm(eigvecs, axis=0, keepdims=True)
    mark("host SVD and eigenvectors")
    log.log(f"--pca approx: {variant_ct} variants, {pc_ct} PCs extracted.")
    return eigvals, eigvecs


def _write_eig(ds, cfg, log, inc, eigvals, eigvecs, pc_ct) -> None:
    si = ds.si
    use_fid = si.has_fid and any(str(si.fid[i]) != "0" for i in inc)
    with open(cfg.out + ".eigenval", "w") as f:
        for w in eigvals:
            f.write(g6(w) + "\n")
    with open(cfg.out + ".eigenvec", "w") as f:
        hdr = ("#FID\tIID" if use_fid else "#IID") + "".join(
            f"\tPC{k + 1}" for k in range(pc_ct)
        )
        f.write(hdr + "\n")
        for r, i in enumerate(inc):
            idp = f"{si.fid[i]}\t{si.iid[i]}" if use_fid else str(si.iid[i])
            f.write(idp + "".join("\t" + g6(v) for v in eigvecs[r]) + "\n")
    log.log(
        f"--pca: Eigenvector{'s' if pc_ct != 1 else ''} written to "
        f"{cfg.out}.eigenvec, and eigenvalue{'s' if pc_ct != 1 else ''} to "
        f"{cfg.out}.eigenval ."
    )


def _write_allele_wts(ds, cfg, log, ops: _Operands, eigvals, eigvecs,
                      pc_ct) -> None:
    """--pca allele-wts: per-allele PC loadings (FlushAlleleWts,
    2.0/plink2_matrix_calc.cc:5452): weight for PC k = (Z_v . u_k) /
    sqrt(eigval_k) with Z the (2p,sqrt(2pq))-normalized dosage used for the
    GRM; biallelic rows carry +/- 0.5 * w / sqrt(lambda) (ref :5554-5562),
    REF = +, ALT the negation.  Row v of the file carries variant v's
    weights, as the reference writes them (plink_tpu/commands/pca.py:143
    writes the r-th included variant's row from X's raw row r, which differs
    once a filter removes a variant)."""
    n, npad = ops.pd.n, ops.pd.npad
    upad = np.zeros((npad, pc_ct), np.float32)
    upad[:n] = eigvecs
    w = ops.x(upad)
    inv_sqrt = 1.0 / np.sqrt(np.maximum(eigvals, 1e-300))
    vi = ds.vi
    prov_hdr, prov_fn = _provref_strs(ds)
    alt1 = vi.alt1()
    path = cfg.out + ".eigenvec.allele"
    with open(path, "w") as f:
        f.write("#CHROM\tID\tREF\tALT" + prov_hdr + "\tA1"
                + "".join(f"\tPC{k + 1}" for k in range(pc_ct)) + "\n")
        for v in np.flatnonzero(ops.vmask):
            meta = (f"{vi.chr_info.name(vi.chrom[v])}\t{vi.vid[v]}\t"
                    f"{vi.ref[v]}\t{vi.alt[v]}{prov_fn(int(v))}")
            wrow = 0.5 * w[v] * inv_sqrt
            f.write(meta + f"\t{vi.ref[v]}"
                    + "".join("\t" + g6(x) for x in wrow) + "\n")
            f.write(meta + f"\t{alt1[v]}"
                    + "".join("\t" + g6(-x) for x in wrow) + "\n")
    log.log(f"--pca allele-wts: Weights written to {path} .")
