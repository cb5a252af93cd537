""".pgen reader.

Implements the PGEN specification (pgen_spec.tex):
storage modes 0x01 (PLINK1 .bed), 0x02 (fixed-width 2-bit), 0x10/0x11
(standard variable-width records).  Hardcall main-track decoding covers all
record types 0-7 (dense, 1-bit, LD-compressed, LD-inverted, difflist).
Auxiliary tracks (multiallelic patches, hardcall phase, dosage) are parsed
for biallelic dosage; remaining tracks are skipped via the record lengths.

Reference implementation this mirrors behaviorally (not structurally):
2.0/include/pgenlib_read.{h,cc} (PgfiInitPhase1/2, PgrGet family).
The reference decodes per-variant with scalar C++; here whole variant blocks
are decoded with vectorized numpy into [V, ceil(N/4)] packed 2-bit rows,
which are the host->HBM transfer format for the CUDA kernels.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from . import pack
from .varint import decode_difflist, decode_varint

MAGIC = b"\x6c\x1b"

# Record-type bit meanings (pgen_spec.tex:345-349).
VRTYPE_MAIN_MASK = 0x07
VRTYPE_MULTIALLELIC = 0x08
VRTYPE_HPHASE = 0x10
VRTYPE_DOSAGE_BITS = 0x60
VRTYPE_DPHASE = 0x80


@dataclass
class PgenHeader:
    mode: int
    variant_ct: int
    sample_ct: int
    vrtypes: np.ndarray  # uint8 [M]
    record_offsets: np.ndarray  # uint64 [M+1], absolute file offsets
    allele_cts: np.ndarray | None = None  # uint32 [M] or None (all biallelic)
    provisional_ref: np.ndarray | None = None  # bool [M] or None
    all_provisional: bool = False


def _read_header(f, sample_ct_hint: int | None) -> PgenHeader:
    head = f.read(3)
    if head[:2] != MAGIC:
        raise ValueError("not a .pgen file (bad magic)")
    mode = head[2]
    if mode == 0x00:
        raise ValueError(
            "sample-major .bed reached the reader untransposed; "
            "load_dataset should have converted it"
        )
    if mode == 0x01:
        if sample_ct_hint is None:
            raise ValueError("mode 0x01 (.bed) requires external sample count")
        f.seek(0, os.SEEK_END)
        fsize = f.tell()
        nb = pack.bytes_per_variant(sample_ct_hint)
        variant_ct = (fsize - 3) // nb
        offsets = 3 + np.arange(variant_ct + 1, dtype=np.uint64) * np.uint64(nb)
        vrtypes = np.full(variant_ct, 0xFF, dtype=np.uint8)  # sentinel: PLINK1 type
        return PgenHeader(mode, variant_ct, sample_ct_hint, vrtypes, offsets)
    if mode not in (0x02, 0x03, 0x04, 0x10, 0x11):
        raise ValueError(f"unsupported pgen storage mode 0x{mode:02x}")
    dims = np.frombuffer(f.read(8), dtype="<u4")
    variant_ct, sample_ct = int(dims[0]), int(dims[1])
    fmt = f.read(1)[0]
    if mode in (0x02, 0x03, 0x04):
        vrtype_val = {0x02: 0, 0x03: 0x40, 0x04: 0xC0}[mode]
        rec_len = {
            0x02: pack.bytes_per_variant(sample_ct),
            0x03: pack.bytes_per_variant(sample_ct) + 2 * sample_ct,
            0x04: pack.bytes_per_variant(sample_ct) + 4 * sample_ct,
        }[mode]
        provisional = None
        all_prov = False
        prv_code = (fmt >> 6) & 3
        hdr_end = f.tell()
        if prv_code == 2:
            all_prov = True
        elif prv_code == 3:
            prov_bytes = np.frombuffer(f.read((variant_ct + 7) // 8), dtype=np.uint8)
            provisional = np.unpackbits(prov_bytes, bitorder="little")[:variant_ct].astype(bool)
            hdr_end = f.tell()
        offsets = hdr_end + np.arange(variant_ct + 1, dtype=np.uint64) * np.uint64(rec_len)
        vrtypes = np.full(variant_ct, vrtype_val, dtype=np.uint8)
        return PgenHeader(mode, variant_ct, sample_ct, vrtypes, offsets, None, provisional, all_prov)

    # Modes 0x10/0x11: variable-width records.
    vrtype_len_code = fmt & 0x0F
    if vrtype_len_code > 7:
        raise ValueError("reserved vrtype/length format code")
    vrtype_8bit = vrtype_len_code >= 4
    len_bytes = (vrtype_len_code & 3) + 1
    ac_bytes = (fmt >> 4) & 3
    prv_code = (fmt >> 6) & 3

    n_blocks = (variant_ct + (1 << 16) - 1) >> 16
    block_offsets = np.frombuffer(f.read(8 * n_blocks), dtype="<u8")

    vrtypes = np.empty(variant_ct, dtype=np.uint8)
    rec_lens = np.empty(variant_ct, dtype=np.uint64)
    allele_cts = np.empty(variant_ct, dtype=np.uint32) if ac_bytes else None
    provisional = np.empty(variant_ct, dtype=bool) if prv_code == 3 else None
    for b in range(n_blocks):
        vstart = b << 16
        vct = min(1 << 16, variant_ct - vstart)
        if vrtype_8bit:
            vrtypes[vstart : vstart + vct] = np.frombuffer(f.read(vct), dtype=np.uint8)
        else:
            raw = np.frombuffer(f.read((vct + 1) // 2), dtype=np.uint8)
            expanded = np.empty(raw.size * 2, dtype=np.uint8)
            expanded[0::2] = raw & 0x0F
            expanded[1::2] = raw >> 4
            vrtypes[vstart : vstart + vct] = expanded[:vct]
        lraw = np.frombuffer(f.read(len_bytes * vct), dtype=np.uint8).reshape(vct, len_bytes)
        lv = np.zeros(vct, dtype=np.uint64)
        for k in range(len_bytes):
            lv |= lraw[:, k].astype(np.uint64) << np.uint64(8 * k)
        rec_lens[vstart : vstart + vct] = lv
        if ac_bytes:
            araw = np.frombuffer(f.read(ac_bytes * vct), dtype=np.uint8).reshape(vct, ac_bytes)
            av = np.zeros(vct, dtype=np.uint32)
            for k in range(ac_bytes):
                av |= araw[:, k].astype(np.uint32) << np.uint32(8 * k)
            allele_cts[vstart : vstart + vct] = av
        if prv_code == 3:
            praw = np.frombuffer(f.read((vct + 7) // 8), dtype=np.uint8)
            provisional[vstart : vstart + vct] = np.unpackbits(praw, bitorder="little")[:vct].astype(bool)

    # Absolute record offsets: cumsum of lengths anchored at each block offset.
    offsets = np.empty(variant_ct + 1, dtype=np.uint64)
    for b in range(n_blocks):
        vstart = b << 16
        vct = min(1 << 16, variant_ct - vstart)
        csum = np.cumsum(rec_lens[vstart : vstart + vct])
        offsets[vstart] = block_offsets[b]
        offsets[vstart + 1 : vstart + vct + 1] = block_offsets[b] + csum
    return PgenHeader(
        mode, variant_ct, sample_ct, vrtypes, offsets, allele_cts, provisional, prv_code == 2
    )


@dataclass
class VariantAux:
    """Decoded auxiliary tracks for one variant (biallelic subset)."""

    dosage_ids: np.ndarray | None = None  # sample indices with explicit dosage
    dosage_vals: np.ndarray | None = None  # uint16, 0..32768 (65535 = missing)
    phasepresent: np.ndarray | None = None  # bool over het calls (in sample order)
    phaseinfo: np.ndarray | None = None  # bool over phased het calls (1 = swapped)
    dphase_ids: np.ndarray | None = None  # sample indices with explicit dphase
    dphase_delta: np.ndarray | None = None  # int16, 16384*(left - right hap dosage)
    het_ids: np.ndarray | None = None  # multiallelic: the phase-bit het
    # universe (main code-1 samples + het aux1b patches, sample-ID order);
    # None for biallelic variants, where the universe is just codes == 1


class PgenReader:
    """Random-access .pgen reader producing packed 2-bit genotype blocks.

    read_packed(vstart, vct) -> uint8 [vct, ceil(N/4)] in pgen encoding.
    """

    def __init__(self, path: str, sample_ct: int | None = None):
        self.path = path
        self._f = open(path, "rb")
        self.header = _read_header(self._f, sample_ct)
        self.variant_ct = self.header.variant_ct
        self.sample_ct = self.header.sample_ct
        self._nb = pack.bytes_per_variant(self.sample_ct)
        # LD cache: last non-LD dense-decoded packed row and its variant index.
        self._ld_base: np.ndarray | None = None
        self._ld_base_vidx = -1

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- raw record access -------------------------------------------------
    def _read_records_raw(self, vstart: int, vct: int) -> tuple[np.ndarray, np.ndarray]:
        offs = self.header.record_offsets
        begin = int(offs[vstart])
        end = int(offs[vstart + vct])
        self._f.seek(begin)
        buf = np.frombuffer(self._f.read(end - begin), dtype=np.uint8)
        rel = (offs[vstart : vstart + vct + 1] - np.uint64(begin)).astype(np.int64)
        return buf, rel

    def _ensure_ld_base(self, vidx: int) -> None:
        """Decode the most recent non-LD record at or before vidx into the cache."""
        vrtypes = self.header.vrtypes
        base = vidx
        while (vrtypes[base] & VRTYPE_MAIN_MASK) in (2, 3):
            base -= 1
            if base < (vidx >> 16) << 16:
                raise ValueError("LD-compressed record with no base in its block")
        if self._ld_base_vidx != base:
            self.read_packed(base, 1)  # populates the cache

    # -- main decode -------------------------------------------------------
    def read_packed(self, vstart: int, vct: int) -> np.ndarray:
        """Decode hardcalls for variants [vstart, vstart+vct) to packed rows."""
        hdr = self.header
        N, nb = self.sample_ct, self._nb
        out = np.empty((vct, nb), dtype=np.uint8)
        if hdr.mode == 0x01:
            buf, rel = self._read_records_raw(vstart, vct)
            raw = buf.reshape(vct, nb)
            out[:] = pack.BED2PGEN_BYTE[raw]
            return out
        if hdr.mode in (0x02, 0x03, 0x04):
            buf, rel = self._read_records_raw(vstart, vct)
            rec_len = int(rel[1] - rel[0])
            out[:] = buf.reshape(vct, rec_len)[:, :nb]
            return out

        # Variable-width: make sure any LD chain is resolvable.
        if (hdr.vrtypes[vstart] & VRTYPE_MAIN_MASK) in (2, 3):
            self._ensure_ld_base(vstart)
        buf, rel = self._read_records_raw(vstart, vct)
        vrtypes = hdr.vrtypes[vstart : vstart + vct]
        main = vrtypes & VRTYPE_MAIN_MASK

        # native fast path (C++; see native/pgen_decode.cc)
        from ..native import get_lib

        lib = get_lib()
        if lib is not None:
            import ctypes

            ld_base = (
                self._ld_base.copy()
                if self._ld_base is not None
                else np.zeros(nb, dtype=np.uint8)
            )
            ld_valid = np.array(
                [1 if self._ld_base is not None else 0], dtype=np.int64
            )
            buf_c = np.ascontiguousarray(buf)
            rel_c = np.ascontiguousarray(rel)
            vr_c = np.ascontiguousarray(vrtypes)
            nthreads = min(os.cpu_count() or 1, 8) if vct >= 256 else 1
            rc = lib.pgen_decode_block_mt(
                buf_c.ctypes.data_as(ctypes.c_void_p),
                rel_c.ctypes.data_as(ctypes.c_void_p),
                vr_c.ctypes.data_as(ctypes.c_void_p),
                vct, N,
                ld_base.ctypes.data_as(ctypes.c_void_p),
                ld_valid.ctypes.data_as(ctypes.c_void_p),
                out.ctypes.data_as(ctypes.c_void_p),
                nthreads,
            )
            if rc == 0:
                # track LD cache across calls: last non-LD row of this batch
                nonld = np.flatnonzero(~np.isin(main, (2, 3)))
                if nonld.size:
                    self._ld_base = out[nonld[-1]].copy()
                    self._ld_base_vidx = vstart + int(nonld[-1])
                return out
            # fall through to the numpy reference implementation on error

        # Fast path: bulk-copy all dense (type 0) records.
        dense_idx = np.flatnonzero(main == 0)
        for i in dense_idx:
            o = int(rel[i])
            out[i] = buf[o : o + nb]
        for i in range(vct):
            m = int(main[i])
            if m == 0:
                pass  # already copied
            else:
                out[i] = self._decode_one(buf, int(rel[i]), m, out, i, vstart)
            if m not in (2, 3):
                self._ld_base = out[i].copy()
                self._ld_base_vidx = vstart + i
        return out

    def _decode_one(
        self, buf: np.ndarray, o: int, main: int, out: np.ndarray, i: int, vstart: int
    ) -> np.ndarray:
        N, nb = self.sample_ct, self._nb
        if main == 1:
            # 1-bit representation (pgen_spec.tex:440-447).
            pair_code = int(buf[o])
            o += 1
            low, high = {1: (0, 1), 2: (0, 2), 3: (0, 3), 5: (1, 2), 6: (1, 3), 9: (2, 3)}[pair_code]
            nbits_bytes = (N + 7) // 8
            bits = buf[o : o + nbits_bytes]
            o += nbits_bytes
            onebit = np.unpackbits(bits, bitorder="little")[:N]
            codes = np.where(onebit, np.uint8(high), np.uint8(low))
            sids, gvals, o = decode_difflist(buf, o, N, True)
            codes[sids] = gvals
            return pack.pack2(codes)
        if main in (2, 3):
            if self._ld_base_vidx == -1 or self._ld_base is None:
                self._ensure_ld_base(vstart + i)
            row = self._ld_base.copy()
            sids, gvals, o = decode_difflist(buf, o, N, True)
            pack.patch_packed_inplace(row, sids, gvals)
            if main == 3:
                row = pack.invert_packed(row)
            return row
        if main in (4, 6, 7):
            base_cat = {4: 0, 6: 2, 7: 3}[main]
            fill = {0: 0x00, 2: 0xAA, 3: 0xFF}[base_cat]
            row = np.full(nb, fill, dtype=np.uint8)
            if N & 3:
                # zero the padding bits in the last byte
                keep = (1 << (2 * (N & 3))) - 1
                row[-1] &= keep
            sids, gvals, o = decode_difflist(buf, o, N, True)
            pack.patch_packed_inplace(row, sids, gvals)
            return row
        raise ValueError(f"unsupported main track type {main}")

    def read_codes(self, vstart: int, vct: int) -> np.ndarray:
        """Decode to unpacked uint8 codes [vct, N]."""
        return pack.unpack2(self.read_packed(vstart, vct), self.sample_ct)

    # -- dosage ------------------------------------------------------------
    def read_dosage(self, vidx: int, allele_ct: int = 2,
                    codes: np.ndarray | None = None) -> VariantAux:
        """Decode dosage/phase tracks for one variant (if present).
        allele_ct is needed to parse past auxiliary track #1 on
        multiallelic variants; codes, the variant's hardcalls [N] where the
        caller has them, saves decoding its main track again."""
        hdr = self.header
        vrtype = int(hdr.vrtypes[vidx])
        aux = VariantAux()
        if hdr.mode == 0x01 or (
            (vrtype & VRTYPE_DOSAGE_BITS) == 0
            and (vrtype & VRTYPE_HPHASE) == 0
        ):
            return aux
        N = self.sample_ct
        buf, rel = self._read_records_raw(vidx, 1)
        o = int(rel[0])
        # Skip main track.
        main = vrtype & VRTYPE_MAIN_MASK
        if main == 0:
            o += self._nb
        elif main == 1:
            o += 1 + (N + 7) // 8
            _, _, o = decode_difflist(buf, o, N, True)
        elif main in (2, 3, 4, 6, 7):
            _, _, o = decode_difflist(buf, o, N, True)
        het_ids = None
        if codes is None and vrtype & (VRTYPE_MULTIALLELIC | VRTYPE_HPHASE):
            codes = pack.unpack2(self.read_packed(vidx, 1)[0], N)
        if vrtype & VRTYPE_MULTIALLELIC:
            if vrtype & VRTYPE_DOSAGE_BITS:
                # True multiallelic dosage (aux tracks #5-6) is unfinalized
                # in the spec (pgen_spec.tex:621-630) and unimplemented by
                # the reference as well (pgenlib_read.cc:9150 "true
                # multiallelic dosages not yet supported by PgrGetMD()";
                # pgenlib_write.cc:317 "todo: multiallelic dosage").
                # Matching that surface exactly.
                raise NotImplementedError(
                    "multiallelic dosage decode not supported (the pgen "
                    "spec leaves aux tracks #5-6 unfinalized; plink2's own "
                    "PgrGetMD() has the same limitation)")
            # multiallelic + hardcall phase: parse past track #1; the phase
            # het universe then includes aux1b het patches
            # (GetAux1bHetIncr, 2.0/include/pgenlib_read.cc:7728)
            (_, _, ids10, lo10, hi10), o = self._parse_ma_track(
                buf, o, codes, allele_ct)
            het = codes == 1
            if ids10.size:
                het = het.copy()
                het[ids10[lo10 != hi10]] = True
            het_ids = np.flatnonzero(het)
            aux.het_ids = het_ids
        if vrtype & VRTYPE_HPHASE:
            # Skip phase track: need het count.
            if het_ids is not None:
                het_ct = int(het_ids.size)
            else:
                het_ct = int((codes == 1).sum())
            first = int(buf[o])
            if first & 1:
                total_bits = 1 + het_ct
                nbytes = (total_bits + 7) // 8
                allbits = np.unpackbits(buf[o : o + nbytes], bitorder="little")
                phasepresent = allbits[1 : 1 + het_ct].astype(bool)
                o += nbytes
                p = int(phasepresent.sum())
                pbytes = (p + 7) // 8
                aux.phaseinfo = np.unpackbits(buf[o : o + pbytes], bitorder="little")[:p].astype(bool)
                aux.phasepresent = phasepresent
                o += pbytes
            else:
                total_bits = 1 + het_ct
                nbytes = (total_bits + 7) // 8
                allbits = np.unpackbits(buf[o : o + nbytes], bitorder="little")
                aux.phasepresent = np.ones(het_ct, dtype=bool)
                aux.phaseinfo = allbits[1 : 1 + het_ct].astype(bool)
                o += nbytes
        dbits = vrtype & VRTYPE_DOSAGE_BITS
        if dbits == 0x20:  # difflist of dosage sample IDs
            sids, _, o = decode_difflist(buf, o, N, False)
            vals = buf[o : o + 2 * sids.size].view("<u2")
            o += 2 * sids.size
            aux.dosage_ids, aux.dosage_vals = sids, vals.copy()
        elif dbits == 0x40:  # dense: every sample
            vals = buf[o : o + 2 * N].view("<u2")
            o += 2 * N
            aux.dosage_ids = np.arange(N, dtype=np.uint32)
            aux.dosage_vals = vals.copy()
        elif dbits == 0x60:  # bitarray + values
            nbytes = (N + 7) // 8
            present = np.unpackbits(buf[o : o + nbytes], bitorder="little")[:N].astype(bool)
            o += nbytes
            ids = np.flatnonzero(present).astype(np.uint32)
            vals = buf[o : o + 2 * ids.size].view("<u2")
            o += 2 * ids.size
            aux.dosage_ids, aux.dosage_vals = ids, vals.copy()
        if vrtype & VRTYPE_DPHASE:
            # Explicit dosage-phase, aux tracks #7-8 (pgen_spec.tex:650-671):
            # int16 = 16384 * (left-hap ALT dosage - right-hap ALT dosage).
            if dbits == 0x40:
                # dense: one int16 per sample, -32768 = no dphase; no track #7
                dvals = buf[o : o + 2 * N].view("<i2")
                ids = np.flatnonzero(dvals != -32768).astype(np.uint32)
                aux.dphase_ids = ids
                aux.dphase_delta = dvals[ids].copy()
            else:
                # track #7: bitarray over the D entries of track #4
                D = 0 if aux.dosage_ids is None else int(aux.dosage_ids.size)
                nbytes = (D + 7) // 8
                sel = np.unpackbits(
                    buf[o : o + nbytes], bitorder="little")[:D].astype(bool)
                o += nbytes
                k = int(sel.sum())
                aux.dphase_ids = aux.dosage_ids[sel].astype(np.uint32)
                aux.dphase_delta = buf[o : o + 2 * k].view("<i2").copy()
        return aux

    # -- multiallelic hardcalls --------------------------------------------
    def read_multiallelic(self, vidx: int, allele_ct: int):
        """Decode auxiliary track #1 (multiallelic hard-calls,
        pgen_spec.tex:469-541) for one variant.

        Returns (ids01, allele01, ids10, lo10, hi10):
          ids01    sample indices whose het call is REF-ALTx with x >= 2,
          allele01 the 1-based ALT index x for each,
          ids10    sample indices whose category-2 call isn't hom-ALT1,
          lo10/hi10 the unordered 1-based ALT allele pair.
        Empty arrays when the variant has no aux track.
        """
        empt = np.zeros(0, np.int64)
        vrtype = int(self.header.vrtypes[vidx])
        if self.header.mode == 0x01 or not (vrtype & VRTYPE_MULTIALLELIC):
            return empt, empt, empt, empt, empt
        N = self.sample_ct
        buf, rel = self._read_records_raw(vidx, 1)
        o = int(rel[0])
        main = vrtype & VRTYPE_MAIN_MASK
        if main == 0:
            o += self._nb
        elif main == 1:
            o += 1 + (N + 7) // 8
            _, _, o = decode_difflist(buf, o, N, True)
        elif main in (2, 3, 4, 6, 7):
            _, _, o = decode_difflist(buf, o, N, True)
        codes = pack.unpack2(self.read_packed(vidx, 1)[0], N)
        res, _ = self._parse_ma_track(buf, o, codes, allele_ct)
        return res

    def _parse_ma_track(self, buf, o, codes, allele_ct):
        """Parse auxiliary track #1 starting at offset o; returns
        ((ids01, allele01, ids10, lo10, hi10), end_offset)."""
        N = self.sample_ct
        empt = np.zeros(0, np.int64)
        cat1 = np.flatnonzero(codes == 1)
        cat2 = np.flatnonzero(codes == 2)
        n_alt = allele_ct - 1
        fmt = int(buf[o])
        o += 1
        f01, f10 = fmt & 0x0F, fmt >> 4

        def _read_bitarray(o, J):
            nb_ = (J + 7) // 8
            bits = np.unpackbits(buf[o : o + nb_], bitorder="little")[:J]
            return bits.astype(bool), o + nb_

        def _val_width(n_alt):
            # category-1 value width in bits (pgen_spec.tex:488-499)
            if n_alt == 2:
                return 0
            if n_alt == 3:
                return 1
            if n_alt <= 5:
                return 2
            if n_alt <= 17:
                return 4
            if n_alt <= 257:
                return 8
            return 16

        def _read_packed_vals(o, K, width):
            if K == 0 or width == 0:
                return np.zeros(K, np.int64), o + 0
            total_bits = K * width
            nb_ = (total_bits + 7) // 8
            bits = np.unpackbits(buf[o : o + nb_], bitorder="little")
            vals = np.zeros(K, np.int64)
            for b in range(width):
                vals |= bits[b::width][:K].astype(np.int64) << b
            return vals, o + nb_

        # --- category 1 patch set ---
        if f01 == 15:
            ids01 = empt
            allele01 = empt
        else:
            if f01 == 0:
                sel, o = _read_bitarray(o, cat1.size)
                ids01 = cat1[sel]
            elif f01 == 1:
                sids, _, o = decode_difflist(buf, o, N, False)
                ids01 = sids.astype(np.int64)
            else:
                raise ValueError(f"reserved cat1 patch format {f01}")
            w = _val_width(n_alt)
            vals, o = _read_packed_vals(o, ids01.size, w)
            allele01 = vals + 2

        # --- category 2 patch set ---
        if f10 == 15:
            ids10, lo10, hi10 = empt, empt, empt
        else:
            if f10 == 0:
                sel, o = _read_bitarray(o, cat2.size)
                ids10 = cat2[sel]
            elif f10 == 1:
                sids, _, o = decode_difflist(buf, o, N, False)
                ids10 = sids.astype(np.int64)
            else:
                raise ValueError(f"reserved cat2 patch format {f10}")
            K = ids10.size
            if n_alt == 2:
                bits, o = _read_bitarray(o, K)
                lo10 = np.where(bits, 2, 1).astype(np.int64)
                hi10 = np.full(K, 2, np.int64)
            else:
                if n_alt <= 4:
                    w = 2
                elif n_alt <= 16:
                    w = 4
                elif n_alt <= 256:
                    w = 8
                else:
                    w = 16
                pairs, o = _read_packed_vals(o, 2 * K, w)
                lo10 = pairs[0::2] + 1
                hi10 = pairs[1::2] + 1
        return ((np.asarray(ids01, np.int64), np.asarray(allele01, np.int64),
                 np.asarray(ids10, np.int64), np.asarray(lo10, np.int64),
                 np.asarray(hi10, np.int64)), o)

    def read_allele_codes(self, vidx: int, allele_ct: int) -> np.ndarray:
        """Per-sample unordered allele pair [N, 2] int16 (REF=0, ALT1=1, ...;
        -1/-1 = missing), assembling the biallelic base + aux track 1."""
        N = self.sample_ct
        codes = pack.unpack2(self.read_packed(vidx, 1)[0], N)
        out = np.zeros((N, 2), np.int16)
        out[codes == 1] = (0, 1)
        out[codes == 2] = (1, 1)
        out[codes == 3] = (-1, -1)
        ids01, a01, ids10, lo10, hi10 = self.read_multiallelic(vidx, allele_ct)
        if ids01.size:
            out[ids01, 1] = a01.astype(np.int16)
        if ids10.size:
            out[ids10, 0] = lo10.astype(np.int16)
            out[ids10, 1] = hi10.astype(np.int16)
        return out


def transpose_sample_major_bed(path: str, sample_ct: int,
                               variant_ct: int) -> str:
    """Convert a PLINK1 sample-major .bed (mode byte 0x00) into a
    variant-major temporary .bed next to it and return the new path.

    Role of Plink1SampleMajorToPgen (2.0/plink2_import_legacy.h:32, worker
    :1408): old PLINK versions stored one SAMPLE per row; everything
    downstream wants variant rows.  Chunked over variant ranges so peak
    memory stays ~sample_ct x 4096 bytes."""
    out_path = path[:-4] + ".vmaj-temporary.bed"
    nbs = pack.bytes_per_variant(variant_ct)  # bytes per SAMPLE row
    data = np.fromfile(path, np.uint8, offset=3)
    if data.size < sample_ct * nbs:
        raise ValueError(
            f"{path}: sample-major .bed is truncated "
            f"({data.size} body bytes < {sample_ct} x {nbs})"
        )
    data = data[: sample_ct * nbs].reshape(sample_ct, nbs)
    chunk = 4096  # variants per pass
    with open(out_path, "wb") as f:
        f.write(MAGIC + b"\x01")
        for v0 in range(0, variant_ct, chunk):
            v1 = min(v0 + chunk, variant_ct)
            b0, b1 = v0 // 4, (v1 + 3) // 4
            codes = pack.unpack2(data[:, b0:b1], (b1 - b0) * 4)
            codes = codes[:, v0 - b0 * 4 : v1 - b0 * 4]  # [N, vchunk]
            f.write(pack.pack2(np.ascontiguousarray(codes.T)).tobytes())
    return out_path
