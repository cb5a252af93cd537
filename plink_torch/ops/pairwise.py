"""Device-resident packed genotype blocks (plink_tpu/ops/pairwise.py
`PackedDevice`, without the mesh branches)."""

from __future__ import annotations

import numpy as np
import torch

from .planes import unpack_codes


def compact_samples(packed: torch.Tensor, idx: torch.Tensor, npad: int,
                    step: int = 2048) -> torch.Tensor:
    """packed uint8 [V, NB] -> [V, npad/4] holding only the samples `idx`
    (in order), repacked on packed's device; padding samples decode to
    hom-REF.  Row chunks bound the [rows, 4*NB] code temporaries."""
    V = packed.shape[0]
    n = idx.shape[0]
    out = torch.empty((V, npad // 4), dtype=torch.uint8, device=packed.device)
    for r0 in range(0, V, step):
        codes = unpack_codes(packed[r0 : r0 + step])[:, idx]
        codes = torch.nn.functional.pad(codes, (0, npad - n))
        c = codes.reshape(codes.shape[0], npad // 4, 4)
        out[r0 : r0 + codes.shape[0]] = (c[..., 0] | (c[..., 1] << 2)
                                         | (c[..., 2] << 4) | (c[..., 3] << 6))
    return out


class PackedDevice:
    """Whole-cohort packed genotypes as a uint8 [nb, vb, NB] tensor on
    `device`.

    Sample columns are compacted to the included set (`compact_samples`, on
    the device, from the dataset's resident copy) so the kernels never
    gather; the variant axis is zero-padded to whole blocks (padded rows
    decode to hom-REF and are masked by the caller).  When every sample is
    included, the resident copy is padded and reshaped as it is.
    """

    def __init__(self, ds, vmask: np.ndarray, vb: int,
                 sample_mask: np.ndarray | None = None):
        smask = ds.sample_mask if sample_mask is None else sample_mask
        self.include_idx = np.flatnonzero(smask)
        self.n = int(self.include_idx.size)
        self.npad = -(-self.n // 4) * 4
        self.vb = vb
        M = ds.raw_variant_ct
        self.nblocks = max(1, -(-M // vb))
        flat = ds.device_all_packed()
        if self.include_idx.size != ds.raw_sample_ct:
            idx = torch.from_numpy(self.include_idx).to(flat.device)
            flat = compact_samples(flat, idx, self.npad)
        pad_v = self.nblocks * vb - M
        if pad_v:
            flat = torch.nn.functional.pad(flat, (0, 0, 0, pad_v))
        self.packed = flat.reshape(self.nblocks, vb, self.npad // 4)
        self.variant_ct = int(np.asarray(vmask, dtype=bool).sum())
