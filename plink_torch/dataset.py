"""Dataset: the shared in-memory state commands operate on.

Mirrors the role of Plink2Core's shared state (2.0/plink2.cc:836):
sample_include / variant_include bitmasks, founder info, sex, cached
genotype counts.  Genotypes are read from the .pgen as packed 2-bit rows,
which are also the host->device transfer format; `device_all_packed` keeps
one copy on the run's device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from .io import PgenReader, read_bim, read_psam, read_pvar
from .io.psam import SampleInfo
from .io.pvar import VariantInfo
from .ops.counts import HOST_SMALL_GENOTYPES, masked_geno_counts
from .utils.chrom import MT_CODE, Y_CODE

DEFAULT_BLOCK = 8192  # variants per streamed block (vblock analogue)


@dataclass
class Dataset:
    reader: PgenReader
    vi: VariantInfo
    si: SampleInfo
    sample_mask: np.ndarray  # bool [N]
    variant_mask: np.ndarray  # bool [M]
    founder_mask: np.ndarray  # bool [N]
    device: torch.device
    block_size: int = DEFAULT_BLOCK
    _counts_cache: dict = field(default_factory=dict)

    @property
    def sample_ct(self) -> int:
        return int(self.sample_mask.sum())

    @property
    def variant_ct(self) -> int:
        return int(self.variant_mask.sum())

    @property
    def raw_sample_ct(self) -> int:
        return self.reader.sample_ct

    @property
    def raw_variant_ct(self) -> int:
        return self.reader.variant_ct

    _packed_cache: np.ndarray | None = None
    PACKED_CACHE_MAX_BYTES = 4 << 30

    def all_packed(self) -> np.ndarray | None:
        """Whole-file packed matrix [M, NB], cached; None if too large."""
        if self._packed_cache is None:
            M = self.raw_variant_ct
            nb = (self.raw_sample_ct + 3) // 4
            if M * nb > self.PACKED_CACHE_MAX_BYTES:
                return None
            self._packed_cache = self.reader.read_packed(0, M)
        return self._packed_cache

    _device_packed = None

    def device_all_packed(self) -> torch.Tensor:
        """Whole-file packed matrix [M, NB] as a uint8 tensor on the run's
        device, cached.  The upload goes through pinned host memory, one
        variant block at a time, when the file is too large to cache on the
        host."""
        if self._device_packed is None:
            M = self.raw_variant_ct
            nb = (self.raw_sample_ct + 3) // 4
            pin = self.device.type == "cuda"
            host = self.all_packed()
            if host is not None:
                t = torch.from_numpy(host)
                self._device_packed = (t.pin_memory() if pin else t).to(
                    self.device, non_blocking=True)
            else:
                dev = torch.empty((M, nb), dtype=torch.uint8, device=self.device)
                for v0, pk in self.iter_packed_blocks():
                    t = torch.from_numpy(pk)
                    dev[v0 : v0 + pk.shape[0]].copy_(
                        t.pin_memory() if pin else t, non_blocking=True)
                self._device_packed = dev
        return self._device_packed

    def iter_packed_blocks(self, block_size: int | None = None):
        """Yield (vstart, packed[uint8, B x NB]) over ALL raw variants in order."""
        bs = block_size or self.block_size
        M = self.raw_variant_ct
        cache = self.all_packed()
        for vstart in range(0, M, bs):
            vct = min(bs, M - vstart)
            if cache is not None:
                yield vstart, cache[vstart : vstart + vct]
            else:
                yield vstart, self.reader.read_packed(vstart, vct)

    def count_matrix(self):
        """The packed matrix the counting functions take: host numpy on
        panels of at most HOST_SMALL_GENOTYPES genotypes (counted in numpy,
        as plink_tpu does), else the device-resident copy."""
        if self.raw_variant_ct * self.raw_sample_ct <= HOST_SMALL_GENOTYPES:
            return self.all_packed()
        return self.device_all_packed()

    # -- cached whole-file counting ------------------------------------
    def counts(self, masks: list[np.ndarray]) -> list[np.ndarray]:
        """Per-variant (hom-REF, het, hom-ALT, missing) int64 [M, 4] over
        each of up to three raw-sample masks, in one pass.  Cached per mask
        set, the way the reference computes LoadAlleleAndGenoCounts once and
        reuses it (plink2.cc:2280); sample filters call invalidate_counts."""
        key = tuple(np.packbits(np.asarray(m, bool)).tobytes() for m in masks)
        hit = self._counts_cache.get(key)
        if hit is None:
            hit = masked_geno_counts(self.count_matrix(), masks)
            self._counts_cache[key] = hit
        return hit

    def geno_counts(self, mask: np.ndarray | None = None) -> np.ndarray:
        """Per-variant genotype counts [M, 4] over the current sample set
        (within `mask` when given)."""
        smask = self.sample_mask if mask is None else self.sample_mask & mask
        return self.counts([smask])[0]

    def invalidate_counts(self) -> None:
        self._counts_cache.clear()

    _allele_cts = None

    def allele_cts(self) -> np.ndarray:
        """Alleles per variant (2 = biallelic) from the .pvar ALT column."""
        if self._allele_cts is None:
            self._allele_cts = np.array(
                [str(a).count(",") + 2 for a in self.vi.alt], dtype=np.int32)
        return self._allele_cts

    def multiallelic_mask(self) -> np.ndarray:
        return self.allele_cts() > 2

    def ma_patch(self, v: int):
        """Aux-track-1 patches for variant v: (ids01, allele01, ids10,
        lo10, hi10); empty arrays for biallelic records."""
        return self.reader.read_multiallelic(int(v), int(self.allele_cts()[v]))

    @property
    def has_dosage(self) -> bool:
        """Any variant carries a dosage track (vrtype bits 5-6)."""
        h = self.reader.header
        return h.mode == 0x10 and bool((h.vrtypes & 0x60).any())

    @property
    def has_phase(self) -> bool:
        """Any variant carries a hardcall-phase track (vrtype bit 4)."""
        h = self.reader.header
        return h.mode == 0x10 and bool((h.vrtypes & 0x10).any())

    def variant_allele_ct(self, v: int) -> int:
        a = str(self.vi.alt[int(v)])
        return 1 + (a.count(",") + 1 if a != "." else 0)

    def phase_row(self, v: int, codes: np.ndarray):
        """(phasepresent [N] bool, swapped [N] bool) for one variant's het
        calls (False everywhere when no phase track), given its hardcalls
        codes [N].  For multiallelic variants the het universe includes
        aux1b het patches (aux.het_ids)."""
        aux = self.reader.read_dosage(int(v), self.variant_allele_ct(v), codes)
        pp = np.zeros(self.raw_sample_ct, bool)
        pi = np.zeros(self.raw_sample_ct, bool)
        if aux.phasepresent is not None:
            if aux.het_ids is not None:
                het_idx = aux.het_ids
            else:
                het_idx = np.flatnonzero(codes == 1)
            pp[het_idx] = aux.phasepresent
            phased_idx = het_idx[aux.phasepresent]
            pi[phased_idx] = aux.phaseinfo
        return pp, pi

    def is_haploid_all(self) -> np.ndarray:
        return (self.vi.chrom == Y_CODE) | (self.vi.chrom == MT_CODE)

    def male_mask(self) -> np.ndarray:
        return self.si.sex == 1

    def female_mask(self) -> np.ndarray:
        return self.si.sex == 2


def _founders_from_pedigree(si: SampleInfo) -> np.ndarray:
    if si.pat is None or si.mat is None:
        return np.ones(si.sample_ct, dtype=bool)
    return np.array([(p == "0" and m == "0") for p, m in zip(si.pat, si.mat)], dtype=bool)


def load_dataset(prefix: str, device: torch.device,
                 block_size: int = DEFAULT_BLOCK,
                 missing_pheno: float = -9) -> Dataset:
    """Load a .pgen/.pvar/.psam or .bed/.bim/.fam fileset by prefix."""
    if os.path.exists(prefix + ".pgen"):
        si = read_psam(
            prefix + (".psam" if os.path.exists(prefix + ".psam") else ".fam"),
            missing_pheno=missing_pheno,
        )
        vi = (
            read_pvar(prefix + ".pvar")
            if os.path.exists(prefix + ".pvar")
            else read_bim(prefix + ".bim")
        )
        reader = PgenReader(prefix + ".pgen", sample_ct=si.sample_ct)
    elif os.path.exists(prefix + ".bed"):
        si = read_psam(prefix + ".fam", missing_pheno=missing_pheno)
        vi = read_bim(prefix + ".bim")
        bed_path = prefix + ".bed"
        with open(bed_path, "rb") as bf:
            head = bf.read(3)
        if head[:2] == b"\x6c\x1b" and head[2] == 0x00:
            # PLINK1 sample-major layout: auto-transpose like the reference
            # (Plink1SampleMajorToPgen, 2.0/plink2_import_legacy.h:32)
            from .io.pgen_read import transpose_sample_major_bed

            bed_path = transpose_sample_major_bed(
                bed_path, si.sample_ct, vi.variant_ct)
        reader = PgenReader(bed_path, sample_ct=si.sample_ct)
    else:
        raise FileNotFoundError(f"no .pgen or .bed found for prefix {prefix}")
    if reader.variant_ct != vi.variant_ct:
        raise ValueError(
            f"variant count mismatch: genotype file has {reader.variant_ct}, metadata {vi.variant_ct}"
        )
    N, M = si.sample_ct, vi.variant_ct
    return Dataset(
        reader=reader,
        vi=vi,
        si=si,
        sample_mask=np.ones(N, dtype=bool),
        variant_mask=np.ones(M, dtype=bool),
        founder_mask=_founders_from_pedigree(si),
        device=device,
        block_size=max(64, min(block_size, (1 << 27) // max(N, 1))),
    )
