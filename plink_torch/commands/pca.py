"""--pca [k]: principal component analysis, exact mode.

Behavior reference: CalcPca (2.0/plink2_matrix_calc.cc:5594).
- exact (default): full eigendecomposition of the missing-corrected GRM
  (host float64 eigh, mirroring the reference's LAPACK dsyevr path :5995);
  the GRM comes from kernel K8 (commands/grm.py `_grm_matrix`).
- `approx` and `allele-wts` are not yet ported (they stream the packed
  genotypes through plink_tpu/ops/pca.py's kernels); the pipeline refuses
  them.

Outputs: .eigenvec (header #[FID\t]IID\tPC1.., unit-norm sample
eigenvectors, dtoa_g) and .eigenval (one eigenvalue per line).
"""

from __future__ import annotations

import numpy as np

from ..dataset import Dataset
from ..utils.fmt import g6
from ..utils.logging import RunLogger


def run_pca(ds: Dataset, cfg, log: RunLogger, grm: np.ndarray) -> None:
    """Exact PCA of `grm` (lower triangle valid), as commands/grm.py's
    run_grm_pca computes it."""
    pc_ct = cfg.pca
    inc = np.flatnonzero(ds.sample_mask)
    n = inc.size
    if pc_ct >= n:
        raise ValueError(f"--pca {pc_ct}: requires more samples than PCs")
    full = np.tril(grm) + np.tril(grm, -1).T
    w, v = np.linalg.eigh(full)
    eigvals = w[::-1][:pc_ct]
    eigvecs = v[:, ::-1][:, :pc_ct]
    _write_eig(ds, cfg, log, inc, eigvals, eigvecs, pc_ct)


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
