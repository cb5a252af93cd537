"""Device-resident packed genotype blocks (plink_tpu/ops/pairwise.py
`PackedDevice`, without the mesh branches)."""

from __future__ import annotations

import numpy as np
import torch

from .planes import _pack_np, _unpack_np


class PackedDevice:
    """Whole-cohort packed genotypes as a uint8 [nb, vb, NB] tensor on
    `device`.

    Sample columns are compacted to the included set on the host (one numpy
    repack) so the kernels never gather; the variant axis is zero-padded to
    whole blocks (padded rows decode to hom-REF and are masked by the
    caller).  When every sample is included, the dataset's resident copy is
    padded and reshaped on the device instead of uploading again.
    """

    def __init__(self, ds, vmask: np.ndarray, vb: int,
                 sample_mask: np.ndarray | None = None):
        device = ds.device
        smask = ds.sample_mask if sample_mask is None else sample_mask
        self.include_idx = np.flatnonzero(smask)
        self.n = int(self.include_idx.size)
        self.npad = -(-self.n // 4) * 4
        self.vb = vb
        M = ds.raw_variant_ct
        self.nblocks = max(1, -(-M // vb))
        nb_bytes = self.npad // 4
        compact = self.include_idx.size != ds.raw_sample_ct
        pad_v = self.nblocks * vb - M
        if not compact:
            flat = ds.device_all_packed()
            if pad_v:
                flat = torch.nn.functional.pad(flat, (0, 0, 0, pad_v))
            self.packed = flat.reshape(self.nblocks, vb, nb_bytes)
        else:
            host = torch.zeros((self.nblocks, vb, nb_bytes), dtype=torch.uint8,
                               pin_memory=device.type == "cuda")
            blocks = host.numpy()
            for bi, (_v0, packed) in enumerate(
                    ds.iter_packed_blocks(block_size=vb)):
                codes = _unpack_np(packed)[:, self.include_idx]
                blocks[bi, : packed.shape[0]] = _pack_np(codes, self.npad)
            self.packed = host.to(device, non_blocking=True)
        self.variant_ct = int(np.asarray(vmask, dtype=bool).sum())
