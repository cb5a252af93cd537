"""Pairwise sample x sample work: KING-robust kinship (kernel K7,
`csrc/king_gram.cu`) and the GRM (kernel K8, `csrc/grm_gram.cu`), with
their plain PyTorch versions, the host helpers of plink_tpu/ops/pairwise.py
and the device-resident packed genotype blocks (`PackedDevice`).

Both kernels take a [nb, vb, NB] uint8 packed tensor, an int8 [nb, vb]
variant mask, and one sample tile [row0, row0 + s) x [col0, col0 + t)
inside the packed rows, and sum over every variant in one launch.  The
wrappers run the plain version for CPU tensors and launch the kernel for
CUDA tensors (or raise).  Per-sample missing counts over a variant mask
(plink_tpu's `sample_miss_counts`) are kernel K5, `ops/counts.py`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import _cuda
from .counts import sample_counts
from .planes import unpack_codes

# tile/block geometry of plink_tpu (sample tiles are multiples of 4 so packed
# byte columns stay aligned); PLINK_TORCH_TILE / PLINK_TORCH_VB override
DEFAULT_TILE = 2048
DEFAULT_VB = 2048


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


def _env_size(name: str, default: int, multiple: int) -> int:
    env = os.environ.get(name)
    if not env:
        return default
    return max(multiple, (int(env) // multiple) * multiple)


class PackedDevice:
    """Whole-cohort packed genotypes as a uint8 [nb, vb, NB] tensor on
    `device`, with the int8 [nb, vb] variant mask beside it (`vmask`).

    Sample columns are compacted to the included set (`compact_samples`, on
    the device, from the dataset's resident copy) so the kernels never
    gather; the variant axis is zero-padded to whole blocks (padded rows
    decode to hom-REF and are masked).  Without `tile` the sample axis is
    padded to a multiple of 4 (the GLM).  With `tile` (the pairwise
    commands) it is padded as plink_tpu pads it: to a multiple of 4 while
    n <= tile (one tile, `self.tile = npad`), else to a multiple of the tile,
    so that every tile of the grid lies inside the packed rows; padded
    samples decode as valid hom-REF and the callers drop their pairs.
    """

    def __init__(self, ds, vmask: np.ndarray, vb: int,
                 sample_mask: np.ndarray | None = None,
                 tile: int | None = None):
        smask = ds.sample_mask if sample_mask is None else sample_mask
        self.include_idx = np.flatnonzero(smask)
        self.n = int(self.include_idx.size)
        self.npad = -(-self.n // 4) * 4
        self.tile = self.npad
        if tile is not None and self.n > tile:
            self.tile = tile
            self.npad = -(-self.n // tile) * tile
        self.vb = vb
        M = ds.raw_variant_ct
        self.nblocks = max(1, -(-M // vb))
        flat = ds.device_all_packed()
        if self.include_idx.size != ds.raw_sample_ct:
            idx = torch.from_numpy(self.include_idx).to(flat.device)
            flat = compact_samples(flat, idx, self.npad)
        elif flat.shape[1] != self.npad // 4:
            flat = torch.nn.functional.pad(flat, (0, self.npad // 4 - flat.shape[1]))
        pad_v = self.nblocks * vb - M
        if pad_v:
            flat = torch.nn.functional.pad(flat, (0, 0, 0, pad_v))
        self.packed = flat.reshape(self.nblocks, vb, self.npad // 4)
        fullmask = np.asarray(vmask, dtype=bool)
        vm = np.zeros(self.nblocks * vb, np.int8)
        vm[:M] = fullmask
        self.vmask = torch.from_numpy(vm.reshape(self.nblocks, vb)).to(flat.device)
        self.variant_ct = int(fullmask.sum())

    @classmethod
    def for_pairs(cls, ds, vmask: np.ndarray, tile: int | None = None,
                  sample_mask: np.ndarray | None = None) -> "PackedDevice":
        """The pairwise commands' layout: plink_tpu's default block and
        tile (PLINK_TORCH_VB / PLINK_TORCH_TILE override the defaults; the
        tests force several tiles on small panels with the latter)."""
        if tile is None:
            tile = _env_size("PLINK_TORCH_TILE", DEFAULT_TILE, 4)
        return cls(ds, vmask, _env_size("PLINK_TORCH_VB", DEFAULT_VB, 8),
                   sample_mask, tile)


def pairwise_inputs_from_numpy(packed: np.ndarray, vmask: np.ndarray,
                               coef: np.ndarray | None = None,
                               device="cpu") -> tuple:
    """The numpy arrays plink_tpu's king_gram_tile / grm_tile / grm_chunk
    take (packed uint8 [nb, vb, NB], vmask int8 [nb, vb], coef f32
    [nb, vb, 3]) as this port's tensors on `device`: (packed, vmask) or
    (packed, vmask, coef)."""
    out = (torch.from_numpy(np.ascontiguousarray(packed, np.uint8)).to(device),
           torch.from_numpy(np.ascontiguousarray(vmask, np.int8)).to(device))
    if coef is not None:
        out += (torch.from_numpy(np.ascontiguousarray(coef, np.float32)).to(device),)
    return out


def _check_pairs(name: str, packed, vmask, row0: int, col0: int, s: int,
                 t: int, coef=None) -> None:
    if packed.dtype != torch.uint8 or packed.dim() != 3 or not packed.is_contiguous():
        raise ValueError(f"{name}: packed must be contiguous uint8 [nb, vb, NB]")
    if vmask.dtype != torch.int8 or tuple(vmask.shape) != tuple(packed.shape[:2]) \
            or not vmask.is_contiguous():
        raise ValueError(f"{name}: vmask must be contiguous int8 [nb, vb]")
    if coef is not None and (coef.dtype != torch.float32 or not coef.is_contiguous()
                             or tuple(coef.shape) != (*packed.shape[:2], 3)):
        raise ValueError(f"{name}: coef must be contiguous float32 [nb, vb, 3]")
    if any(x.device != packed.device for x in (vmask, coef) if x is not None):
        raise ValueError(f"{name}: inputs on different devices")
    npad = packed.shape[2] * 4
    if min(row0, col0) < 0 or s <= 0 or t <= 0 or row0 % 4 or col0 % 4 \
            or s % 4 or t % 4 or row0 + s > npad or col0 + t > npad:
        raise ValueError(f"{name}: tile rows [{row0}, {row0 + s}) x cols "
                         f"[{col0}, {col0 + t}) must be multiples of 4 inside "
                         f"the {npad} packed samples")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {packed.device}")


# ---------------------------------------------------------------------------
# host helpers (plink_tpu/ops/pairwise.py, numpy)
# ---------------------------------------------------------------------------


def king_counts_from_gram(g: np.ndarray, s: int, t: int) -> dict[str, np.ndarray]:
    """Split a [3s, 3t] H/A/V plane Gram into the reference's five per-pair
    accumulators plus nsnp (all [s, t] int64). Keys follow kKingOffset*
    naming with het_r_hom_c = (row-sample het) x (col-sample hom)."""
    g = np.asarray(g, dtype=np.int64)
    H, A, V = 0, 1, 2
    blk = lambda a, b: g[a * s : (a + 1) * s, b * t : (b + 1) * t]  # noqa: E731
    hethet = blk(H, H)
    ibs0 = blk(V, A) + blk(A, V) - blk(H, A) - blk(A, H) - 2 * blk(A, A)
    het_r_hom_c = blk(H, V) - hethet
    het_c_hom_r = blk(V, H) - hethet
    nsnp = blk(V, V)
    homhom = nsnp - ibs0 - hethet - het_r_hom_c - het_c_hom_r
    return {
        "ibs0": ibs0,
        "hethet": hethet,
        "het_r_hom_c": het_r_hom_c,
        "het_c_hom_r": het_c_hom_r,
        "homhom": homhom,
        "nsnp": nsnp,
    }


KING_COUNTER_KEYS = ("ibs0", "hethet", "het_r_hom_c", "het_c_hom_r", "homhom",
                     "nsnp")


def king_kinship(counts: dict[str, np.ndarray]) -> np.ndarray:
    """KING-robust kinship (ref: ComputeKinship, plink2_matrix_calc.cc:1555):
    0.5 - (4*ibs0 + het1hom2 + het2hom1) / (4*(hethet + min(het1hom2, het2hom1))).
    -inf when the denominator is zero, matching the reference edge case."""
    ibs0 = counts["ibs0"].astype(np.float64)
    h12 = counts["het_r_hom_c"].astype(np.float64)
    h21 = counts["het_c_hom_r"].astype(np.float64)
    smaller = counts["hethet"].astype(np.float64) + np.minimum(h12, h21)
    with np.errstate(divide="ignore", invalid="ignore"):
        return 0.5 - (4.0 * ibs0 + h12 + h21) / (4.0 * smaller)


def grm_coefs(
    alt_freq: np.ndarray, is_haploid: np.ndarray, vmask: np.ndarray,
    variance_standardize: bool = True,
) -> np.ndarray:
    """Per-variant normed-dosage values for codes {homref, het, homalt}.

    ref: ExpandCenteredVarmaj (2.0/plink2_matrix_calc.cc:3839-3885):
    value = (x - 2*alt_freq) / sqrt(2*ref*alt), haploid gets an extra 1/sqrt2;
    near-zero-variance variants zero-fill (but stay in the denominator).
    Excluded variants (vmask 0) zero-fill AND must be masked from the
    denominator by the caller via the int8 vmask.
    """
    p = np.asarray(alt_freq, dtype=np.float64)
    var = 2.0 * p * (1.0 - p)
    eps = 2 ** -44  # kSmallEpsilon (2.0/include/plink2_base.h)
    if variance_standardize:
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_sd = np.where(var > eps, 1.0 / np.sqrt(var), 0.0)
    else:
        inv_sd = np.where(np.isfinite(p), 1.0, 0.0)
    inv_sd = np.where(is_haploid, inv_sd / np.sqrt(2.0), inv_sd)
    inv_sd = np.where(vmask, inv_sd, 0.0)
    x = np.stack([np.zeros_like(p), np.ones_like(p), np.full_like(p, 2.0)], axis=1)
    coefs = (x - 2.0 * p[:, None]) * inv_sd[:, None]
    return np.nan_to_num(coefs).astype(np.float32)


def iter_lower_tiles(n: int, tile: int):
    """Yield (row0, col0) lower-triangle tile origins covering all pairs i>j."""
    starts = list(range(0, n, tile))
    for r0 in starts:
        for c0 in starts:
            if c0 <= r0:
                yield r0, c0


# ---------------------------------------------------------------------------
# K5 reused: per-sample missing counts over a variant mask
# ---------------------------------------------------------------------------


def sample_miss_counts(packed: torch.Tensor, vmask: torch.Tensor) -> torch.Tensor:
    """Per-sample missing-genotype counts int32 [npad] over the variants of
    vmask (plink_tpu/ops/pairwise.py `sample_miss_counts`): one K5 launch
    over the [nb * vb, NB] rows on the card, its plain version on the CPU."""
    flat = packed.reshape(-1, packed.shape[2])
    return sample_counts(flat, vmask.reshape(-1, 1).to(torch.float32))[0]


# ---------------------------------------------------------------------------
# K7: KING counters and kinship of one tile
# ---------------------------------------------------------------------------


def king_gram_plain(packed, vmask, row0: int, col0: int, s: int, t: int,
                    n: int | None = None, thresh: float = -np.inf,
                    counts: bool = False):
    """Plain version of K7: the H/A/V plane Gram [3s, 3t] of each variant
    block (an int32 matmul on the CPU; f32 on the card, exact below 2^24),
    summed in int32, then the counters and king_tile_stats."""
    mm_dtype = torch.int32 if packed.device.type == "cpu" else torch.float32
    g = torch.zeros((3 * s, 3 * t), dtype=torch.int32, device=packed.device)

    def planes3(pk, vm, a0, w):
        codes = unpack_codes(pk[:, a0 // 4 : (a0 + w) // 4])
        vmc = (vm != 0)[:, None]
        return torch.cat([(codes == 1) & vmc, (codes == 2) & vmc,
                          (codes != 3) & vmc], dim=1).to(mm_dtype)

    for b in range(packed.shape[0]):
        p = planes3(packed[b], vmask[b], row0, s)
        q = planes3(packed[b], vmask[b], col0, t)
        g += (p.t() @ q).to(torch.int32)
    blk = lambda a, c: g[a * s : (a + 1) * s, c * t : (c + 1) * t]  # noqa: E731
    H, A, V = 0, 1, 2
    hethet = blk(H, H)
    ibs0 = blk(V, A) + blk(A, V) - blk(H, A) - blk(A, H) - 2 * blk(A, A)
    hrhc = blk(H, V) - hethet
    hchr = blk(V, H) - hethet
    nsnp = blk(V, V)
    if counts:
        return torch.stack([ibs0, hethet, hrhc, hchr,
                            nsnp - ibs0 - hethet - hrhc - hchr, nsnp])
    # king_tile_stats, in the same order of f64 operations
    n = packed.shape[2] * 4 if n is None else n
    smaller = hethet.double() + torch.minimum(hrhc, hchr).double()
    num = 4.0 * ibs0.double() + hrhc.double() + hchr.double()
    kin = 0.5 - num / (4.0 * smaller)  # -inf (or NaN) where smaller == 0
    rows = row0 + torch.arange(s, device=g.device)
    cols = col0 + torch.arange(t, device=g.device)
    valid = (rows[:, None] > cols[None, :]) & (rows[:, None] < n) & (cols[None, :] < n)
    passing = valid & (kin >= thresh)
    return (kin, nsnp, hethet, ibs0, passing,
            passing.sum(dtype=torch.int32).reshape(1))


def king_gram(packed, vmask, row0: int, col0: int, s: int, t: int,
              n: int | None = None, thresh: float = -np.inf,
              counts: bool = False):
    """K7: KING over every variant of packed [nb, vb, NB] (vmask int8
    [nb, vb]) for the sample tile [row0, row0 + s) x [col0, col0 + t).

    Default: plink_tpu's king_tile_stats outputs (kin f64 [s, t], nsnp,
    hethet, ibs0 int32 [s, t], pass bool [s, t] = strict lower triangle,
    both samples < n, kin >= thresh; pass count int32 [1]).  With `counts`:
    int32 [6, s, t] in KING_COUNTER_KEYS order.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    _check_pairs("king_gram", packed, vmask, row0, col0, s, t)
    if packed.device.type == "cpu":
        return king_gram_plain(packed, vmask, row0, col0, s, t, n, thresh, counts)
    dev = packed.device
    nvar = packed.shape[0] * packed.shape[1]
    s64, t64 = -(-s // 64) * 64, -(-t // 64) * 64
    planes = torch.empty(3 * (-(-nvar // 32)) * (s64 + t64), dtype=torch.int32,
                         device=dev)
    n = packed.shape[2] * 4 if n is None else n
    if counts:
        cnt = torch.empty((6, s, t), dtype=torch.int32, device=dev)
        outs = (None,) * 6
    else:
        cnt = None
        outs = (torch.empty((s, t), dtype=torch.float64, device=dev),
                *(torch.empty((s, t), dtype=torch.int32, device=dev) for _ in range(3)),
                torch.empty((s, t), dtype=torch.bool, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev))
    _cuda.launch("king_gram", packed.data_ptr(), packed.shape[2], nvar,
                 vmask.data_ptr(), row0, s, col0, t, n, float(thresh),
                 int(counts), planes.data_ptr(), *(_cuda.ptr(o) for o in outs),
                 _cuda.ptr(cnt))
    return cnt if counts else outs


# ---------------------------------------------------------------------------
# K8: GRM tile / chunk
# ---------------------------------------------------------------------------


def _grm_finish(acc, jm, miss, mv: int, row0: int, col0: int, s: int, c: int,
                tile: bool, fetch32: bool):
    m_r = miss[row0 : row0 + s]
    m_c = miss[col0 : col0 + c]
    if tile:
        nm = (mv - m_r[:, None] - m_c[None, :] + jm).to(torch.int32)
        return (acc.float() if fetch32 else acc), nm
    # _grm_chunk_finish: (Mv - m_i - m_j) + jm in f64, the division in f64
    nm = (float(mv) - m_r.double()[:, None] - m_c.double()[None, :]) + jm.double()
    return (acc / nm).float(), nm.float()


def grm_gram_plain(packed, coef, vmask, miss, mv: int, row0: int, col0: int,
                   s: int, c: int, tile: bool = False, fetch32: bool = False):
    """Plain version of K8: per variant block, the f32 product Z_r^T Z_c
    carried in f64 and the joint-missing Gram (int32 on the CPU; f32 on the
    card, exact below 2^24), then the chunk or tile epilogue."""
    mm_dtype = torch.int32 if packed.device.type == "cpu" else torch.float32
    acc = torch.zeros((s, c), dtype=torch.float64, device=packed.device)
    jm = torch.zeros((s, c), dtype=torch.int32, device=packed.device)

    def side(pk, cf, vm, a0, w):
        codes = unpack_codes(pk[:, a0 // 4 : (a0 + w) // 4]).long()
        z = torch.gather(cf, 1, codes.clamp(max=2))
        z = torch.where(codes == 3, torch.zeros((), dtype=z.dtype), z)
        miss_pl = ((codes == 3) & (vm != 0)[:, None]).to(mm_dtype)
        return z, miss_pl

    for b in range(packed.shape[0]):
        zr, mr = side(packed[b], coef[b], vmask[b], row0, s)
        zc, mc = side(packed[b], coef[b], vmask[b], col0, c)
        acc += (zr.t() @ zc).double()
        jm += (mr.t() @ mc).to(torch.int32)
    return _grm_finish(acc, jm, miss, mv, row0, col0, s, c, tile, fetch32)


def grm_gram(packed, coef, vmask, miss, mv: int, row0: int, col0: int, s: int,
             c: int, tile: bool = False, fetch32: bool = False):
    """K8: the GRM block of samples [row0, row0 + s) x [col0, col0 + c) over
    every variant of packed [nb, vb, NB] (coef f32 [nb, vb, 3] normed values
    of codes 0/1/2, vmask int8 [nb, vb], miss int32 [npad] per-sample
    missing counts over vmask, mv = variants in vmask).

    Chunk mode (plink_tpu's grm_chunk): (g f32 [s, c] = acc / nm, nm f32
    [s, c], the valid-pair counts as .grm.N.bin stores them; plink_tpu
    returns the joint-missing part of nm, narrowed for its host link).  Tile
    mode (`tile`, plink_tpu's grm_tile): (acc f64 [s, c] (f32 with
    `fetch32`), nm int32 [s, c]).  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    _check_pairs("grm_gram", packed, vmask, row0, col0, s, c, coef)
    if miss.dtype != torch.int32 or miss.dim() != 1 \
            or miss.shape[0] != packed.shape[2] * 4 or miss.device != packed.device:
        raise ValueError("grm_gram: miss must be int32 [npad] on packed's device")
    if packed.device.type == "cpu":
        return grm_gram_plain(packed, coef, vmask, miss, mv, row0, col0, s, c,
                              tile, fetch32)
    dev = packed.device
    if tile:
        mode = 2 if fetch32 else 1
        val = torch.empty((s, c), dtype=torch.float32 if fetch32 else torch.float64,
                          device=dev)
        cnt = torch.empty((s, c), dtype=torch.int32, device=dev)
    else:
        mode = 0
        val = torch.empty((s, c), dtype=torch.float32, device=dev)
        cnt = torch.empty((s, c), dtype=torch.float32, device=dev)
    _cuda.launch("grm_gram", packed.data_ptr(), packed.shape[2],
                 packed.shape[0] * packed.shape[1], vmask.data_ptr(),
                 coef.data_ptr(), miss.data_ptr(), int(mv), row0, s, col0, c,
                 mode, val.data_ptr(), cnt.data_ptr())
    return val, cnt
