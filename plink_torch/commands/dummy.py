"""--dummy: synthetic panel generator.

Port of plink_tpu/commands/dummy.py: the same numpy generator calls in the
same order, written with the port's writers, so a seeded run writes the
same .pgen / .pvar / .psam bytes as plink_tpu's.  Host-only.

Behavior reference: GenerateDummy (2.0/plink2_import.cc:16326) and the flag
grammar in 2.0/plink2_help.cc:253-275:
  --dummy <sample ct> <SNP ct> [missing geno freq(s)] [missing pheno freq]
          [{acgt | 1234 | 12}] ['pheno-ct='<count>] ['scalar-pheno']

Genotypes are drawn per-variant from Hardy-Weinberg proportions with a
uniform(0,1) ALT frequency, matching the reference's generation model.  The
RNG stream differs from SFMT19937, so generated panels are *statistically*
but not byte-wise equivalent; differential tests therefore generate panels
with one engine and feed the identical files to both.
"""

from __future__ import annotations

import numpy as np

from ..dataset import Dataset, load_dataset
from ..io.pgen_write import PgenWriter
from ..io.psam import PhenoCol, SampleInfo, write_psam
from ..io.pvar import VariantInfo, write_pvar
from ..utils.logging import RunLogger


def _gen_block(sample_ct: int) -> int:
    """Variants generated per chunk, bounded so each [block, N] f64 draw
    stays ~1 GB at biobank sample counts."""
    return max(64, min(8192, (1 << 27) // max(sample_ct, 1)))


def _parse_dummy_args(args: tuple) -> dict:
    if len(args) < 2:
        raise ValueError("--dummy requires at least <sample ct> <variant ct>")
    spec = {
        "sample_ct": int(args[0]),
        "variant_ct": int(args[1]),
        "miss_geno_freqs": [0.0],
        "miss_pheno_freq": 0.0,
        "alleles": "AB",
        "pheno_ct": 1,
        "scalar_pheno": False,
        "phase_freq": 0.0,
        "dosage_freq": 0.0,
    }
    numeric_seen = 0
    for a in args[2:]:
        if a == "acgt":
            spec["alleles"] = "ACGT"
        elif a == "1234":
            spec["alleles"] = "1234"
        elif a == "12":
            spec["alleles"] = "12"
        elif a == "scalar-pheno":
            spec["scalar_pheno"] = True
        elif a.startswith("pheno-ct="):
            spec["pheno_ct"] = int(a.split("=", 1)[1])
        elif a.startswith("phase-freq="):
            spec["phase_freq"] = float(a.split("=", 1)[1])
        elif a.startswith("dosage-freq="):
            spec["dosage_freq"] = float(a.split("=", 1)[1])
        else:
            if numeric_seen == 0:
                spec["miss_geno_freqs"] = [float(t) for t in a.split(",")]
            elif numeric_seen == 1:
                spec["miss_pheno_freq"] = float(a)
            else:
                raise ValueError(f"--dummy: unexpected argument '{a}'")
            numeric_seen += 1
    return spec


def generate_dummy(cfg, log: RunLogger, device) -> Dataset:
    spec = _parse_dummy_args(cfg.dummy)
    N, M = spec["sample_ct"], spec["variant_ct"]
    rng = np.random.default_rng(cfg.seed if cfg.seed is not None else 0)

    # variant metadata: all on chr1, 1-based positions, IDs snp0..snp(M-1)
    if spec["alleles"] == "AB":
        ref = np.full(M, "B", dtype=object)
        alt = np.full(M, "A", dtype=object)
    elif spec["alleles"] == "12":
        ref = np.full(M, "2", dtype=object)
        alt = np.full(M, "1", dtype=object)
    else:
        pool = np.array(list(spec["alleles"]), dtype=object)
        ia = rng.integers(0, len(pool), size=M)
        ib = (ia + 1 + rng.integers(0, len(pool) - 1, size=M)) % len(pool)
        ref, alt = pool[ia], pool[ib]
    vi = VariantInfo(
        chrom=np.ones(M, dtype=np.int16),
        pos=np.arange(1, M + 1, dtype=np.int32),
        vid=np.array([f"snp{i}" for i in range(M)], dtype=object),
        ref=ref,
        alt=alt,
    )

    # sample metadata: per0..per(N-1), random sex, pheno(s)
    iid = np.array([f"per{i}" for i in range(N)], dtype=object)
    sex = rng.integers(1, 3, size=N).astype(np.int8)
    phenos: dict[str, PhenoCol] = {}
    for p in range(spec["pheno_ct"]):
        name = "PHENO1" if spec["pheno_ct"] == 1 else f"PHENO{p + 1}"
        nonmiss = rng.random(N) >= spec["miss_pheno_freq"]
        if spec["scalar_pheno"]:
            phenos[name] = PhenoCol(name, "qt", rng.standard_normal(N), nonmiss)
        else:
            phenos[name] = PhenoCol(
                name, "cc", rng.integers(0, 2, size=N).astype(np.float64), nonmiss
            )
    si = SampleInfo(
        fid=np.zeros(N, dtype=object),
        iid=iid,
        sid=None,
        pat=None,
        mat=None,
        sex=sex,
        phenos=phenos,
        has_fid=False,
    )
    for i in range(N):
        si.fid[i] = "0"

    miss_freqs = np.asarray(spec["miss_geno_freqs"], dtype=np.float64)
    per_variant_miss = miss_freqs[rng.integers(0, len(miss_freqs), size=M)]

    gen_block = _gen_block(N)
    dos_f = spec["dosage_freq"]
    ph_f = spec["phase_freq"]
    # hard-call/erase thresholds applied to generated dosages exactly as
    # GenerateDummyThread does (2.0/plink2_import.cc:16560-16625); dosage
    # VALUES are ~uniform on 0..32768 via ((rand16+1)/2).  The RNG stream
    # differs (see module docstring), so equivalence is statistical.
    hc_halfdist = 8192 - (cfg.hard_call_thresh
                          if getattr(cfg, "hard_call_thresh", None)
                          is not None else 16384 // 10)
    erase_halfdist = 8192 - getattr(cfg, "dosage_erase_thresh", 0)
    with PgenWriter(cfg.out + ".pgen", N, M,
                    with_dosage=dos_f > 0.0,
                    with_phase=ph_f > 0.0) as w:
        for v0 in range(0, M, gen_block):
            vct = min(gen_block, M - v0)
            freq = rng.uniform(0.0, 1.0, size=(vct, 1))
            codes = (
                (rng.random((vct, N)) < freq).astype(np.uint8)
                + (rng.random((vct, N)) < freq).astype(np.uint8)
            )
            mrate = per_variant_miss[v0 : v0 + vct, None]
            codes[rng.random((vct, N)) < mrate] = 3
            if dos_f <= 0.0 and ph_f <= 0.0:
                w.append_codes(codes)
                continue
            for r in range(vct):
                row = codes[r].copy()
                dids = np.zeros(0, np.uint32)
                dvals = np.zeros(0, "<u2")
                dpids = np.zeros(0, np.uint32)
                dpdeltas = np.zeros(0, "<i2")
                pp_possible = (rng.random(N) < ph_f) if ph_f > 0.0 \
                    else np.zeros(N, bool)
                pi = rng.random(N) < 0.5
                if dos_f > 0.0:
                    cand = (rng.random(N) < dos_f) & (row != 3)
                    didx = np.flatnonzero(cand)
                    dint = ((rng.integers(0, 65536, didx.size) + 1)
                            // 2).astype(np.int64)
                    halfdist = np.abs((dint & 16383) - 8192)
                    store = halfdist < erase_halfdist
                    newg = np.where(halfdist < hc_halfdist, 3,
                                    (dint + 8192) >> 14).astype(np.uint8)
                    row[didx] = newg
                    dids = didx[store].astype(np.uint32)
                    dvals = dint[store].astype("<u2")
                    if ph_f > 0.0:
                        dph = store & pp_possible[didx] \
                            & (row[didx] != 3)
                        delta = np.minimum(dint, 32768 - dint)
                        delta = delta - (1 - (delta & 1))  # force odd
                        delta = np.where(pi[didx], delta, -delta)
                        dpids = didx[dph].astype(np.uint32)
                        dpdeltas = delta[dph].astype("<i2")
                pp = pp_possible & (row == 1)
                if ph_f > 0.0:
                    w.append_codes_with_phase(
                        row.reshape(1, -1), pp, pi & pp, dids, dvals,
                        dpids, dpdeltas)
                elif dids.size:
                    w.append_codes_with_dosage(row.reshape(1, -1), dids,
                                               dvals)
                else:
                    w.append_codes_with_dosage(
                        row.reshape(1, -1), np.zeros(0, np.uint32),
                        np.zeros(0, "<u2"))
    write_pvar(cfg.out + ".pvar", vi)
    write_psam(cfg.out + ".psam", si)
    log.log(
        f"Dummy data ({M} variants, {N} samples) written to {cfg.out}.pgen + "
        f"{cfg.out}.pvar + {cfg.out}.psam ."
    )
    return load_dataset(cfg.out, device)
