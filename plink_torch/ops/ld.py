"""Pairwise LD decisions for `--indep-pairwise`: kernel K11 `ld_band_bits`
(`csrc/ld_band.cu`) with its plain PyTorch version, and `LdBitsBand`.

Genotypes are scored x in {+1 hom-REF, 0 het, -1 hom-ALT} with
pairwise-complete missing handling (ref ComputeIndepPairwiseR2Components,
2.0/plink2_ld.cc:194-414).  For the pair (i, j = i + d) of a subcontig, over
the masked founder samples, the six statistics are entries of the 3 x 3 Gram
of the hom-REF (R), hom-ALT (A) and valid (V) planes:
    dot = RR - RA - AR + AA     nm  = VV
    s_i = RV - AV               q_i = RV + AV
    s_j = VR - VA               q_j = VR + VA
and the pair exceeds the r^2 threshold iff cov^2 > r2t * var1 * var2 in f64
(cov = dot nm - s_i s_j, var1 = q_i nm - s_i^2, var2 = q_j nm - s_j^2;
strict >, plink_tpu/ops/ld.py:159-165).  Only the decision bits [n, w + 1]
and the d = 0 counts (nm1, homref1, homalt1) leave the function.

plink_tpu forms each chunk's plane Gram with itself and with the next chunk
and gathers the band; K11 counts the band directly (AND + popcount over
32-sample bit words), the plain version follows plink_tpu's chunked Gram.
The wrapper runs the plain version for CPU tensors and launches the kernel
for CUDA tensors (or raises).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .planes import unpack_codes

PLAIN_CHUNK = 512  # rows of the plain version's plane Gram (plink_tpu's c)


def ld_inputs_from_numpy(packed: np.ndarray, smask: np.ndarray,
                         device="cpu") -> tuple:
    """plink_tpu's numpy operands (packed uint8 [n, NB] subcontig rows, int8
    sample mask [npad = 4 NB]) as this port's tensors on `device`."""
    return (torch.from_numpy(np.ascontiguousarray(packed, np.uint8)).to(device),
            torch.from_numpy(np.ascontiguousarray(smask, np.int8)).to(device))


def _planes_rav(packed: torch.Tensor, smask: torch.Tensor) -> torch.Tensor:
    """packed [C, NB] -> [3C, npad] int8 planes (R rows | A rows | V rows),
    sample-masked (plink_tpu/ops/ld.py `_planes_rav`)."""
    codes = unpack_codes(packed).to(torch.int8)
    b0 = codes & 1
    b1 = (codes >> 1) & 1
    miss = b0 & b1
    r = (1 - b0) & (1 - b1)
    a = b1 - miss
    v = 1 - miss
    m = smask.to(torch.int8)[None, :]
    return torch.cat([r * m, a * m, v * m], dim=0)


def ld_band_bits_plain(packed, smask, width: int, r2t: float):
    """Plain version of K11: the RAV plane Gram of each PLAIN_CHUNK-row chunk
    against the rows from its start to its end + width (int32 matmul on the
    CPU; f32 on the card, exact below 2^24), the band gathered, then
    plink_tpu's f64 decision in its order."""
    n = packed.shape[0]
    dev = packed.device
    mm_dtype = torch.int32 if dev.type == "cpu" else torch.float32
    ex = torch.zeros((n, width + 1), dtype=torch.uint8, device=dev)
    counts = torch.zeros((3, n), dtype=torch.int32, device=dev)
    dd = torch.arange(width + 1, device=dev)[None, :]
    for r0 in range(0, n, PLAIN_CHUNK):
        r1 = min(r0 + PLAIN_CHUNK, n)
        c1 = min(r1 + width, n)
        ca, cb = r1 - r0, c1 - r0
        p3 = _planes_rav(packed[r0:r1], smask).to(mm_dtype)
        q3 = _planes_rav(packed[r0:c1], smask).to(mm_dtype)
        g = (p3 @ q3.t()).to(torch.int32)
        jj = torch.arange(ca, device=dev)[:, None] + dd
        valid = jj < cb
        jc = jj.clamp(max=cb - 1)

        def band(a, b):
            m = g[a * ca : (a + 1) * ca, b * cb : (b + 1) * cb]
            return torch.take_along_dim(m, jc, dim=1).double()

        rr, ra, rv = band(0, 0), band(0, 1), band(0, 2)
        ar, aa, av = band(1, 0), band(1, 1), band(1, 2)
        vr, va, vv = band(2, 0), band(2, 1), band(2, 2)
        dot = rr - ra - ar + aa
        s_i, q_i = rv - av, rv + av
        s_j, q_j = vr - va, vr + va
        cov = dot * vv - s_i * s_j
        var1 = q_i * vv - s_i * s_i
        var2 = q_j * vv - s_j * s_j
        exceeds = (cov * cov > r2t * var1 * var2) & valid
        exceeds[:, 0] = False
        ex[r0:r1] = exceeds.to(torch.uint8)
        counts[:, r0:r1] = torch.stack([vv[:, 0], rv[:, 0], av[:, 0]]).to(torch.int32)
    return ex, counts[0], counts[1], counts[2]


def ld_band_bits(packed, smask, width: int, r2t: float):
    """K11: the r^2 > r2t decisions of one subcontig.  packed uint8 [n, NB]
    (rows in subcontig order, samples compacted to the founders and padded
    to npad = 4 NB), smask int8 [npad] -> (exceeds uint8 [n, width + 1],
    entry [i, d] for the pair (i, i + d), 0 for d = 0 and i + d >= n; nm1,
    homref1, homalt1 int32 [n], the valid, hom-REF and hom-ALT counts of each
    variant).  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if packed.dtype != torch.uint8 or packed.dim() != 2 or not packed.is_contiguous():
        raise ValueError("ld_band_bits: packed must be contiguous uint8 [n, NB]")
    if smask.dtype != torch.int8 or smask.dim() != 1 \
            or smask.shape[0] != 4 * packed.shape[1] or not smask.is_contiguous():
        raise ValueError("ld_band_bits: smask must be contiguous int8 [4 * NB]")
    if smask.device != packed.device:
        raise ValueError("ld_band_bits: inputs on different devices")
    if width < 0:
        raise ValueError("ld_band_bits: width must be >= 0")
    if packed.device.type == "cpu":
        return ld_band_bits_plain(packed, smask, width, r2t)
    if packed.device.type != "cuda":
        raise ValueError(f"ld_band_bits: unsupported device {packed.device}")
    dev = packed.device
    n, nb_bytes = packed.shape
    nwords = -(-smask.shape[0] // 32)
    mbits = torch.empty(nwords, dtype=torch.int32, device=dev)
    planes = torch.empty(3 * nwords * max(n, 1), dtype=torch.int32, device=dev)
    ex = torch.empty((n, width + 1), dtype=torch.uint8, device=dev)
    counts = torch.empty((3, n), dtype=torch.int32, device=dev)
    _cuda.launch("ld_band_bits", packed.data_ptr(), nb_bytes, n, smask.data_ptr(),
                 smask.shape[0], width, float(r2t), mbits.data_ptr(),
                 planes.data_ptr(), ex.data_ptr(), counts[0].data_ptr(),
                 counts[1].data_ptr(), counts[2].data_ptr())
    return ex, counts[0], counts[1], counts[2]


class LdBitsBand:
    """Banded r^2-exceeds-threshold decisions for one subcontig: entry
    [i, d] is 1 iff cov^2 > r2t * var1 * var2 for the pair (i, i + d)
    (plink_tpu/ops/ld.py `LdBitsBand`), made on the device by K11; also the
    per-variant (nm, homref, homalt) counts.  `packed_rows`: uint8 tensor
    [n, NB] on the run's device; `smask`: int8 [npad] sample mask."""

    def __init__(self, packed_rows: torch.Tensor, smask: np.ndarray, width: int,
                 r2t: float):
        n = packed_rows.shape[0]
        self.n = n
        self.width = min(width, max(n - 1, 0))
        sm = torch.from_numpy(np.ascontiguousarray(smask, np.int8)).to(
            packed_rows.device)
        ex, nm1, homref1, homalt1 = ld_band_bits(packed_rows, sm, self.width, r2t)
        self.exceeds = ex.cpu().numpy()
        self.nm1 = nm1.cpu().numpy().astype(np.int64)
        self.homref1 = homref1.cpu().numpy().astype(np.int64)
        self.homalt1 = homalt1.cpu().numpy().astype(np.int64)

    def r2_exceeds_vec(self, firsts: np.ndarray, second: int):
        """Decision bits of the pairs (f, second) for f in firsts."""
        return self.exceeds[firsts, second - firsts].astype(bool)
