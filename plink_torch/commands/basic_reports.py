"""--freq / --missing / --hardy / --geno-counts report commands, and the
allele counts --glm reads.

Port of plink_tpu/commands/basic_reports.py.  Behaviour references:
WriteAlleleFreqs / WriteMissingnessReports / HardyReport / WriteGenoCounts
in 2.0/plink2_misc.cc, with the counts from kernels K1 (per-variant, up to
three sample masks per launch) and K5 (per-sample) instead of
LoadAlleleAndGenoCountsThread (2.0/plink2_data.cc:2304).

Sex-chromosome conventions (matching the reference):
- chrX: females contribute 2 alleles, males 1 (het male X = "hethap",
  treated as missing); chrY: only males, haploid; MT: haploid for all.

Dosage tracks enter only the --glm A1 choice and the sample reports'
frequencies (`alt_allele_freqs(..., dosage=True)`).  Not yet ported (each
raises NotPortedError): dosage tracks in the reports and filters, and the
--freq machr2/minimac3r2 columns.
"""

from __future__ import annotations

import numpy as np

from .. import NotPortedError
from ..dataset import Dataset
from ..io.compress import open_out
from ..ops.counts import sample_missing_counts
from ..stats.hwe import hwe_exact_lnpvals, hwe_exact_pvals
from ..stats.hwe_x import hwe_x_exact_lnpval, hwe_x_exact_pvals
from ..utils.chrom import MT_CODE, X_CODE, Y_CODE
from ..utils.fmt import g6, logp_to_str
from ..utils.logging import RunLogger


def _group_counts(ds: Dataset, founders_only: bool) -> dict[str, np.ndarray]:
    """Counts [M,4] for 'all', 'male', 'female' subsets of included samples
    (one K1 launch for the three masks, cached on the dataset)."""
    base = ds.sample_mask & (ds.founder_mask if founders_only else True)
    a, m, f = ds.counts([base, base & ds.male_mask(), base & ds.female_mask()])
    return {"all": a, "male": m, "female": f}


def allele_counts_and_obs(ds: Dataset, founders_only: bool = False):
    """Per-variant (alt_allele_ct, obs_allele_ct) honoring X/Y/MT ploidy.

    Rules verified against LoadAlleleAndGenoCountsThread
    (2.0/plink2_data.cc:2540-2660):
    - chrX: nonmales (incl. unknown sex) diploid; males haploid with EVERY
      nonmissing male counted and a het male contributing half an ALT;
    - chrY: nonfemales only, haploid, het = half an ALT;
    - chrMT: all samples haploid, het = half an ALT.
    Returns (alt_ct, obs_ct) float64 [M] (half-allele granularity).
    """
    cts = _group_counts(ds, founders_only)
    chrom = ds.vi.chrom
    is_x = chrom == X_CODE
    is_y = chrom == Y_CODE
    is_mt = chrom == MT_CODE
    a = cts["all"].astype(np.float64)
    m = cts["male"].astype(np.float64)
    f = cts["female"].astype(np.float64)
    nm = a - m  # nonmales (females + unknown sex)
    nf = a - f  # nonfemales (males + unknown sex)
    # Diploid default.
    alt = a[:, 1] + 2 * a[:, 2]
    obs = 2 * (a[:, 0] + a[:, 1] + a[:, 2])
    # chrX: nonmales diploid + males haploid with het = 0.5.
    x_alt = (nm[:, 1] + 2 * nm[:, 2]) + (m[:, 2] + 0.5 * m[:, 1])
    x_obs = 2 * (nm[:, 0] + nm[:, 1] + nm[:, 2]) + (m[:, 0] + m[:, 1] + m[:, 2])
    alt = np.where(is_x, x_alt, alt)
    obs = np.where(is_x, x_obs, obs)
    # chrY: nonfemales haploid, het = 0.5.
    alt = np.where(is_y, nf[:, 2] + 0.5 * nf[:, 1], alt)
    obs = np.where(is_y, nf[:, 0] + nf[:, 1] + nf[:, 2], obs)
    # MT: all samples haploid, het = 0.5.
    alt = np.where(is_mt, a[:, 2] + 0.5 * a[:, 1], alt)
    obs = np.where(is_mt, a[:, 0] + a[:, 1] + a[:, 2], obs)
    return alt, obs


def _refuse_dosage(ds: Dataset) -> None:
    if ds.has_dosage:
        raise NotPortedError("dosage tracks are not yet ported to plink_torch")


def alt_allele_freqs(ds: Dataset, founders_only: bool = True,
                     dosage: bool = False) -> np.ndarray:
    """ALT allele frequencies (founders by default, the reference's
    MAF-filter convention).  With `dosage` (the --glm A1 choice and the
    sample reports: --het, --check-sex, --score, --variant-score), variants
    carrying a dosage track take their frequency from the dosages, as
    plink_tpu's alt_allele_freqs does; the other callers (filters, KING,
    GRM, PCA, LD) refuse a dosage fileset until their slice is ported.
    --read-freq's frequencies (`ds.freq_override`) replace the computed
    ones wherever they are finite."""
    if not dosage:
        _refuse_dosage(ds)
    alt, obs = allele_counts_and_obs(ds, founders_only)
    if ds.has_dosage:
        for v, (a_, o_) in dosage_counts_and_obs(ds, founders_only).items():
            alt[v], obs[v] = a_, o_
    with np.errstate(invalid="ignore", divide="ignore"):
        out = np.where(obs > 0, alt / obs, np.nan)
    fo = ds.freq_override
    if fo is not None:
        out = np.where(np.isfinite(fo), fo, out)
    return out


def dosage_counts_and_obs(ds: Dataset, founders_only: bool):
    """Dosage-aware (alt_dosage_sum, obs_allele_ct) for variants carrying a
    dosage track (plink_tpu dosage_counts_and_obs; LoadAlleleAndGenoCounts
    dosage branch: a sample counts as observed when it has a dosage entry or
    a nonmissing hardcall).  Autosomal accounting only; returns {v: (alt,
    obs)}."""
    smask = ds.sample_mask & (ds.founder_mask if founders_only else True)
    vr = ds.reader.header.vrtypes
    out = {}
    for v in np.flatnonzero(ds.variant_mask & ((vr & 0x60) != 0)):
        u = ds.dosage_u16_row(int(v))[smask]
        miss = int(np.count_nonzero(u == 65535))
        # an integer sum of the 1/16384 units: the f64 sum of the dosages,
        # exactly (every partial sum of these dyadics is exact)
        alt = (int(u.sum(dtype=np.int64)) - 65535 * miss) / 16384.0
        out[int(v)] = (alt, 2.0 * (u.size - miss))
    return out


def _provref_strs(ds: Dataset):
    hdr = ds.reader.header
    if hdr.all_provisional:
        return "\tPROVISIONAL_REF?", lambda i: "\tY"
    if hdr.provisional_ref is not None:
        pr = hdr.provisional_ref
        # maybeprovref semantics: the column appears only when at least one
        # INCLUDED variant has a provisional REF (ref ProvrefCol,
        # 2.0/plink2_common.h:1549-1561)
        if bool(pr[ds.variant_mask].any()):
            return "\tPROVISIONAL_REF?", lambda i: "\tY" if pr[i] else "\tN"
        return "", lambda i: ""
    if ds.reader.header.mode == 0x01:
        return "\tPROVISIONAL_REF?", lambda i: "\tY"
    return "", lambda i: ""


def ma_alt_counts(ds: Dataset, v: int, alt_total: float,
                  smask: np.ndarray) -> np.ndarray:
    """Per-ALT allele counts for a multiallelic variant from the sparse aux
    patches (host-side corrections on top of the dense ALT1-collapsed base
    counting; diploid chromosomes).  alt_total = total ALT dosage over the
    included samples."""
    n_alt = int(ds.allele_cts()[v]) - 1
    cts = np.zeros(n_alt, np.float64)
    cts[0] = alt_total
    ids01, a01, ids10, lo10, hi10 = ds.ma_patch(v)
    if ids01.size:
        keep = smask[ids01]
        for a in a01[keep]:
            cts[0] -= 1.0
            cts[a - 1] += 1.0
    if ids10.size:
        keep = smask[ids10]
        for lo, hi in zip(lo10[keep], hi10[keep]):
            cts[0] -= 2.0
            cts[lo - 1] += 1.0
            cts[hi - 1] += 1.0
    return cts


def _cts_str(x: float) -> str:
    """Dosage-count rendering on the 1/32768 grid: shortest decimal that
    round-trips to the same grid point, else 5 decimals with banker
    rounding (ddosagetoa_full + PrintDdosageDecimal,
    2.0/plink2_common.cc:234-273)."""
    total = int(round(x * 32768.0))
    ip, rem = divmod(total, 32768)
    if rem == 0:
        return str(ip)
    range_top = rem * 1250 + 625  # (rem*2 in 65536ths) scaled to 40960k
    if (range_top % 4096) < 1250:
        fd = range_top // 4096
        s = f"{fd:04d}".rstrip("0")
        return f"{ip}.{s}"
    five = (3125 * rem + 512) // 1024 - (1 if (rem % 2048) == 512 else 0)
    first, last4 = divmod(five, 10000)
    s = str(first)
    if last4:
        s += f"{last4:04d}".rstrip("0")
    return f"{ip}.{s}"


_FREQ_COL_ORDER = [
    "chrom", "pos", "ref", "alt1", "alt", "maybeprovref", "provref",
    "reffreq", "alt1freq", "altfreq", "freq", "eq", "eqz", "alteq",
    "alteqz", "numeq", "altnumeq", "machr2", "minimac3r2", "nobs",
]
_FREQ_DEFAULT = {"chrom", "ref", "alt", "maybeprovref", "altfreq", "nobs"}
_FREQ_EXCLUSIVE = {"altfreq", "freq", "eq", "eqz", "alteq", "alteqz",
                   "numeq", "altnumeq"}


def _parse_colset(spec: str | None, order: list, default: set,
                  flagname: str) -> list:
    """plink2 column-set descriptor: 'cols=+a,-b' modifies the default,
    'cols=a,b,c' replaces it; output order is canonical."""
    cols = set(default)
    if spec:
        toks = spec.split(",")
        if toks and toks[0][:1] in "+-":
            for t in toks:
                if t.startswith("+"):
                    cols.add(t[1:])
                elif t.startswith("-"):
                    cols.discard(t[1:])
                else:
                    raise ValueError(
                        f"{flagname}: mixed modify/replace cols= spec")
        else:
            cols = set(toks)
        unknown = cols - set(order)
        if unknown:
            raise ValueError(
                f"{flagname}: unrecognized column id(s) "
                f"{sorted(unknown)}")
    return [c for c in order if c in cols]


def write_freq(ds: Dataset, out_prefix: str, log: RunLogger,
               founders_only: bool = True, zs: bool = False,
               counts: bool = False, cols: str | None = None) -> str:
    """--freq ['counts'] ['cols='...] -> <out>.afreq/.acount[.zst]."""
    _refuse_dosage(ds)
    alt, obs = allele_counts_and_obs(ds, founders_only)
    sel = _parse_colset(cols, _FREQ_COL_ORDER, _FREQ_DEFAULT, "--freq")
    if len([c for c in sel if c in _FREQ_EXCLUSIVE]) > 1:
        raise ValueError(
            "--freq: altfreq/freq/eq/eqz/alteq/alteqz/numeq/altnumeq "
            "column sets are mutually exclusive.")
    if "machr2" in sel or "minimac3r2" in sel:
        raise NotPortedError("--freq machr2/minimac3r2 columns are not yet "
                             "ported to plink_torch.")
    path = out_prefix + (".acount" if counts else ".afreq")
    ci = ds.vi.chr_info
    prov_hdr, prov_fn = _provref_strs(ds)
    hdr_of = {
        "chrom": "#CHROM", "pos": "POS", "ref": "REF", "alt1": "ALT1",
        "alt": "ALT", "maybeprovref": "PROVISIONAL_REF?",
        "provref": "PROVISIONAL_REF?",
        "reffreq": "REF_CT" if counts else "REF_FREQ",
        "alt1freq": "ALT1_CT" if counts else "ALT1_FREQ",
        "altfreq": "ALT_CTS" if counts else "ALT_FREQS",
        "freq": "CTS" if counts else "FREQS",
        "eq": "CTS" if counts else "FREQS",
        "eqz": "CTS" if counts else "FREQS",
        "alteq": "ALT_CTS" if counts else "ALT_FREQS",
        "alteqz": "ALT_CTS" if counts else "ALT_FREQS",
        "numeq": "NUM_CTS" if counts else "NUM_FREQS",
        "altnumeq": "NUM_CTS" if counts else "NUM_FREQS",
        "nobs": "OBS_CT",
    }
    fh, path = open_out(path, zs)
    fmt = _cts_str if counts else g6
    with fh:
        hdr_cols = []
        first = True
        for c in sel:
            if c == "maybeprovref" and not prov_hdr:
                continue
            h = hdr_of[c]
            if first and c != "chrom":
                hdr_cols.append("#" + h if not h.startswith("#") else h)
            else:
                hdr_cols.append(h)
            first = False
        # ID always present, after chrom/pos
        id_pos = sum(1 for c in sel if c in ("chrom", "pos"))
        hdr_cols.insert(id_pos, "ID")
        if not sel or sel[0] not in ("chrom", "pos"):
            hdr_cols[0] = "#" + hdr_cols[0].lstrip("#")
        fh.write("\t".join(hdr_cols) + "\n")
        ma = ds.multiallelic_mask()
        smask_f = ds.sample_mask & (
            ds.founder_mask if founders_only else True
        )
        vi = ds.vi
        for i in np.flatnonzero(ds.variant_mask):
            alt_cts = None
            if ma[i]:
                alt_cts = ma_alt_counts(ds, int(i), alt[i], smask_f)
            o = float(obs[i])
            a = float(alt[i])
            r = o - a
            vals = []
            for c in sel:
                if c == "chrom":
                    vals.append(ci.name(int(vi.chrom[i])))
                elif c == "pos":
                    vals.append(str(int(vi.pos[i])))
                elif c == "ref":
                    vals.append(str(vi.ref[i]))
                elif c == "alt1":
                    vals.append(str(vi.alt1()[i]) if ma[i]
                                else str(vi.alt[i]))
                elif c == "alt":
                    vals.append(str(vi.alt[i]))
                elif c in ("maybeprovref", "provref"):
                    if c == "maybeprovref" and not prov_hdr:
                        continue
                    vals.append(prov_fn(i).lstrip("\t") or "N")
                elif c == "nobs":
                    vals.append(str(int(o)))
                else:
                    vals.append(_freq_val_str(
                        c, a, r, o, alt_cts, vi, int(i), counts, fmt))
            vals.insert(id_pos, str(vi.vid[i]))
            fh.write("\t".join(vals) + "\n")
    log.log(f"--freq: Allele frequencies "
            f"({'founders' if founders_only else 'all samples'}) "
            f"written to {path} .")
    return path


def _freq_val_str(c, a, r, o, alt_cts, vi, i, counts, fmt):
    """One frequency/count cell for column id c."""

    def val(x):
        if counts:
            return fmt(x)
        return g6(x / o) if o > 0 else "NA"

    if alt_cts is not None:
        alts = [float(x) for x in alt_cts]
    else:
        alts = [a]
    alt_names = str(vi.alt[i]).split(",")
    if c == "reffreq":
        return val(r)
    if c == "alt1freq":
        return val(alts[0])
    if c == "altfreq":
        return ",".join(val(x) for x in alts)
    if c == "freq":
        return ",".join(val(x) for x in [r] + alts)
    if c in ("eq", "eqz", "alteq", "alteqz"):
        pairs = []
        if c in ("eq", "eqz"):
            pairs.append((str(vi.ref[i]), r))
        for nm_, x in zip(alt_names, alts):
            pairs.append((nm_, x))
        if c in ("eq", "alteq"):
            pairs = [(nm_, x) for nm_, x in pairs if x != 0]
        if not pairs:
            return "."
        return ",".join(f"{nm_}={val(x)}" for nm_, x in pairs)
    if c in ("numeq", "altnumeq"):
        pairs = [(0, r)] if c == "numeq" else []
        pairs += [(k + 1, x) for k, x in enumerate(alts)]
        pairs = [(k, x) for k, x in pairs if x != 0]
        if not pairs:
            return "."
        return ",".join(f"{k}={val(x)}" for k, x in pairs)
    raise ValueError(c)


def write_missing(
    ds: Dataset, out_prefix: str, log: RunLogger, sample: bool = True,
    variant: bool = True, zs: bool = False
) -> list[str]:
    """--missing -> <out>.vmiss / <out>.smiss."""
    out_paths = []
    ci = ds.vi.chr_info
    base = ds.sample_mask
    male = base & ds.male_mask()
    n_all = int(base.sum())
    n_male = int(male.sum())
    is_y = ds.vi.chrom == Y_CODE
    has_y = bool(is_y.any())
    if variant:
        cts = ds.geno_counts()
        # chrY OBS_CT counts males only; missing among males.
        gc_male = ds.geno_counts(mask=male) if has_y else None
        fh, path = open_out(out_prefix + ".vmiss", zs)
        with fh:
            fh.write("#CHROM\tID\tMISSING_CT\tOBS_CT\tF_MISS\n")
            for i in np.flatnonzero(ds.variant_mask):
                if gc_male is not None and ds.vi.chrom[i] == Y_CODE:
                    miss, obs = int(gc_male[i, 3]), n_male
                else:
                    miss, obs = int(cts[i, 3]), n_all
                fm = miss / obs if obs else np.nan
                fh.write(f"{ci.name(int(ds.vi.chrom[i]))}\t{ds.vi.vid[i]}\t{miss}\t{obs}\t{g6(fm)}\n")
        out_paths.append(path)
    if sample:
        vmask = ds.variant_mask.astype(np.float32)
        vmask_nony = vmask * ~is_y
        # per-sample missing counts in one pass: non-Y for everyone, and
        # Y-only for males
        vmasks = [vmask_nony] + ([vmask * is_y] if has_y else [])
        miss_g = sample_missing_counts(ds.count_matrix(), ds.raw_sample_ct,
                                       vmasks)
        miss_nony = miss_g[0]
        miss_y = miss_g[1] if has_y else None
        vct_nony = int(vmask_nony.sum())
        vct_all = int(vmask.sum())
        pheno_names = list(ds.si.phenos)
        fh, path = open_out(out_prefix + ".smiss", zs)
        with fh:
            pheno_hdr = "".join(f"\t{n}" for n in pheno_names)
            fh.write(f"{ds.si.id_header()}{pheno_hdr}\tMISSING_CT\tOBS_CT\tF_MISS\n")
            for s in np.flatnonzero(ds.sample_mask):
                if ds.si.sex[s] == 1 and has_y:
                    miss, obs = int(miss_nony[s] + miss_y[s]), vct_all
                else:
                    miss, obs = int(miss_nony[s]), vct_nony
                fm = miss / obs if obs else np.nan
                # Per-phenotype missingness indicator: Y = missing, N = present.
                pcols = "".join(
                    "\tN" if ds.si.phenos[n].nonmiss[s] else "\tY" for n in pheno_names
                )
                fh.write(f"{ds.si.id_str(s)}{pcols}\t{miss}\t{obs}\t{g6(fm)}\n")
        out_paths.append(path)
    log.log(f"--missing: Sample/variant missing data report(s) written to "
            f"{' + '.join(out_paths)} .")
    return out_paths


def write_hardy(
    ds: Dataset, out_prefix: str, log: RunLogger, midp: bool = False,
    founders_only: bool = True, zs: bool = False
) -> str:
    """--hardy -> <out>.hardy (autosomal) and, when chrX variants are
    present, <out>.hardy.x with the Graffelman-Weir female+male exact test
    (ref: HardyReport chrX path + ComputeHweXLnPvals, 2.0/plink2_misc.cc)."""
    is_x = ds.vi.chrom == X_CODE
    # all / male / female in one K1 launch (the mask set --freq counts)
    grp = _group_counts(ds, founders_only)
    cts, cts_m, cts_f = grp["all"], grp["male"], grp["female"]
    use = np.where(is_x[:, None], cts_f, cts)
    hom_ref, het, hom_alt = use[:, 0], use[:, 1], use[:, 2]
    pvals = hwe_exact_pvals(hom_ref, het, hom_alt, midp=midp)
    # extreme-regime escalation: tails that underflow f64 re-compute in
    # ln space with extended-precision factorials and print via the
    # lntoa_g mantissa-x-10^-exp form, distinguishing 1e-325 from
    # 1e-1000000 (ref HweLnP + plink2_highprec dd tail sums,
    # 2.0/include/plink2_highprec.h:36-60, 2.0/README.md:96-100)
    ext_lnp: dict[int, float] = {}
    ext_idx = np.flatnonzero(np.isfinite(pvals) & (pvals < 1e-290))
    if ext_idx.size:
        lnv = hwe_exact_lnpvals(
            hom_ref[ext_idx], het[ext_idx], hom_alt[ext_idx], midp=midp)
        ext_lnp = {int(i): float(v) for i, v in zip(ext_idx, lnv)}
    ci = ds.vi.chr_info
    fh, path = open_out(out_prefix + ".hardy", zs)
    with fh:
        fh.write("#CHROM\tID\tA1\tAX\tHOM_A1_CT\tHET_A1_CT\tTWO_AX_CT\t"
                 "O(HET_A1)\tE(HET_A1)\t"
                 + ("MIDP" if midp else "P") + "\n")
        for i in np.flatnonzero(ds.variant_mask):
            if ds.vi.chrom[i] in (X_CODE, Y_CODE, MT_CODE):
                # Main report is autosomal; chrX uses the separate .hardy.x
                # female+male test (HardyReport, plink2_misc.cc:5696+).
                continue
            n = int(hom_ref[i] + het[i] + hom_alt[i])
            # Reproduce the reference's fp expression order for bit-identical
            # output (plink2_misc.cc:5648-5660): recip multiply, then
            # E = maj2 * (1 - maj2*0.5).
            recip = 1.0 / n if n else np.nan
            ohet = float(het[i]) * recip if n else np.nan
            if n and hom_ref[i] == n:
                ehet_str = "0"
            elif n:
                maj2 = float(hom_ref[i] * 2 + het[i]) * recip
                ehet_str = g6(maj2 * (1.0 - maj2 * 0.5))
            else:
                ehet_str = "NA"
            if int(i) in ext_lnp:
                p_str = logp_to_str(ext_lnp[int(i)])
            else:
                p_str = g6(pvals[i])
            fh.write(
                f"{ci.name(int(ds.vi.chrom[i]))}\t{ds.vi.vid[i]}\t{ds.vi.ref[i]}\t{ds.vi.alt[i]}"
                f"\t{int(hom_ref[i])}\t{int(het[i])}\t{int(hom_alt[i])}"
                f"\t{g6(ohet)}\t{ehet_str}\t{p_str}\n"
            )
    log.log(
        f"--hardy{' midp' if midp else ''}: Autosomal Hardy-Weinberg report "
        f"({'all samples' if not founders_only else 'founders only'}) written to {path} ."
    )
    x_idx = np.flatnonzero(ds.variant_mask & is_x)
    if x_idx.size:
        fa = cts_f[x_idx, 0]
        fh = cts_f[x_idx, 1]
        fb = cts_f[x_idx, 2]
        ma = cts_m[x_idx, 0]
        mb = cts_m[x_idx, 2]
        px = hwe_x_exact_pvals(fa, fh, fb, ma, mb, midp=midp)
        # extreme-regime escalation, as on the autosomal path
        ext_x: dict[int, float] = {}
        for k in np.flatnonzero(np.isfinite(px) & (px < 1e-290)):
            ext_x[int(k)] = hwe_x_exact_lnpval(
                int(fa[k]), int(fh[k]), int(fb[k]), int(ma[k]), int(mb[k]),
                midp=midp)
        xpath = out_prefix + ".hardy.x"
        with open(xpath, "w") as fhx:
            fhx.write(
                "#CHROM\tID\tA1\tAX\tFEMALE_HOM_A1_CT\tFEMALE_HET_A1_CT\t"
                "FEMALE_TWO_AX_CT\tMALE_A1_CT\tMALE_AX_CT\tO(FEMALE_HET_A1)\t"
                "E(FEMALE_HET_A1)\tFEMALE_A1_FREQ\tMALE_A1_FREQ\t"
                + ("MIDP" if midp else "P") + "\n"
            )
            for k, i in enumerate(x_idx):
                n_f = int(fa[k] + fh[k] + fb[k])
                n_m = int(ma[k] + mb[k])
                recip = 1.0 / n_f if n_f else np.nan
                ohet = float(fh[k]) * recip if n_f else np.nan
                if n_f and fa[k] == n_f:
                    ehet_str = "0"
                elif n_f:
                    a1x2 = float(fa[k] * 2 + fh[k]) * recip
                    ehet_str = g6(a1x2 * (1.0 - a1x2 * 0.5))
                else:
                    ehet_str = "NA"
                ffreq = (
                    float(2 * fa[k] + fh[k]) / (2 * n_f) if n_f else np.nan
                )
                mfreq = float(ma[k]) / n_m if n_m else np.nan
                fhx.write(
                    f"{ci.name(int(ds.vi.chrom[i]))}\t{ds.vi.vid[i]}\t"
                    f"{ds.vi.ref[i]}\t{ds.vi.alt[i]}\t{int(fa[k])}\t{int(fh[k])}\t"
                    f"{int(fb[k])}\t{int(ma[k])}\t{int(mb[k])}\t{g6(ohet)}\t"
                    f"{ehet_str}\t{g6(ffreq)}\t{g6(mfreq)}\t"
                    + (logp_to_str(ext_x[k]) if k in ext_x else g6(px[k]))
                    + "\n"
                )
        log.log(
            f"--hardy{' midp' if midp else ''}: chrX Hardy-Weinberg report "
            f"({'all samples' if not founders_only else 'founders only'}) "
            f"written to {xpath} ."
        )
    return path


def write_geno_counts(ds: Dataset, out_prefix: str, log: RunLogger,
                      zs: bool = False) -> str:
    """--geno-counts -> <out>.gcount.

    Hethap handling verified against the reference (mixed-chromosome panel):
    chrX male hets and chrY/MT hets count as MISSING; chrY rows cover
    nonfemales only.
    """
    cts = _group_counts(ds, founders_only=False)
    a, m, f = cts["all"], cts["male"], cts["female"]
    nf = a - f
    ma = ds.multiallelic_mask()
    ci = ds.vi.chr_info
    prov_hdr, prov_fn = _provref_strs(ds)
    fh, path = open_out(out_prefix + ".gcount", zs)
    with fh:
        fh.write(
            f"#CHROM\tID\tREF\tALT{prov_hdr}\tHOM_REF_CT\tHET_REF_ALT_CTS\tTWO_ALT_GENO_CTS"
            "\tHAP_REF_CT\tHAP_ALT_CTS\tMISSING_CT\n"
        )
        for i in np.flatnonzero(ds.variant_mask):
            chrom = int(ds.vi.chrom[i])
            hom_ref, het, hom_alt, miss = (int(x) for x in a[i])
            hap_ref = hap_alt = 0
            if chrom == MT_CODE:
                hap_ref, hap_alt = hom_ref, hom_alt
                miss += het
                hom_ref = hom_alt = het = 0
            elif chrom == Y_CODE:
                hap_ref, hap_alt = int(nf[i, 0]), int(nf[i, 2])
                miss = int(nf[i, 3]) + int(nf[i, 1])  # hets -> missing
                hom_ref = hom_alt = het = 0
            elif chrom == X_CODE:
                hap_ref, hap_alt = int(m[i, 0]), int(m[i, 2])
                hom_ref -= hap_ref
                hom_alt -= hap_alt
                het -= int(m[i, 1])  # male hets -> missing
                miss += int(m[i, 1])
            if ma[i]:
                # multiallelic expansion: per-ALT het counts, colex-ordered
                # ALTxALTy pair counts, per-ALT hap counts (WriteGenoCounts
                # multiallelic branch, 2.0/plink2_misc.cc)
                n_alt = int(ds.allele_cts()[i]) - 1
                smask_i = ds.sample_mask
                ids01, a01, ids10, lo10, hi10 = ds.ma_patch(int(i))
                het_cts = np.zeros(n_alt, np.int64)
                het_cts[0] = het
                pair_cts = np.zeros((n_alt + 1, n_alt + 1), np.int64)
                pair_cts[1, 1] = hom_alt
                if ids01.size:
                    for x in a01[smask_i[ids01]]:
                        het_cts[0] -= 1
                        het_cts[x - 1] += 1
                if ids10.size:
                    keep = smask_i[ids10]
                    for lo, hi in zip(lo10[keep], hi10[keep]):
                        pair_cts[1, 1] -= 1
                        pair_cts[lo, hi] += 1
                het_str = ",".join(str(x) for x in het_cts)
                # colex order: (1,1),(1,2),(2,2),(1,3),(2,3),(3,3)...
                pairs = []
                for hi_ in range(1, n_alt + 1):
                    for lo_ in range(1, hi_ + 1):
                        pairs.append(int(pair_cts[lo_, hi_]))
                two_str = ",".join(str(x) for x in pairs)
                hap_str = ",".join(
                    str(hap_alt if k == 0 else 0) for k in range(n_alt)
                )
                fh.write(
                    f"{ci.name(chrom)}\t{ds.vi.vid[i]}\t{ds.vi.ref[i]}\t"
                    f"{ds.vi.alt[i]}{prov_fn(i)}\t{hom_ref}\t{het_str}\t"
                    f"{two_str}\t{hap_ref}\t{hap_str}\t{miss}\n"
                )
                continue
            fh.write(
                f"{ci.name(chrom)}\t{ds.vi.vid[i]}\t{ds.vi.ref[i]}\t{ds.vi.alt[i]}{prov_fn(i)}"
                f"\t{hom_ref}\t{het}\t{hom_alt}\t{hap_ref}\t{hap_alt}\t{miss}\n"
            )
    log.log(f"--geno-counts: Genotype counts written to {path} .")
    return path
