"""Command pipeline (ref: Plink2Core, 2.0/plink2.cc:836), as far as this port
runs it, in plink_tpu's order (plink_tpu/pipeline.py): load a .pgen/.bed
fileset, apply --pheno, the sample filters (keep/remove, founders, --mind),
the variant filters (extract/exclude, chr), the counts-based reports and
their filters (freq, geno-counts, missing, --geno, hardy, --hwe,
--maf/--mac), the relationship commands (KING, then GRM / PCA),
--indep-pairwise, --indep-pairphase, the --r2/--r tables and matrices,
--ld, then --glm, and --clump last.

Every other flag raises NotPortedError before anything runs; the run never
falls back to plink_tpu.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import NotPortedError
from .cli import Config
from .dataset import load_dataset
from .utils.logging import RunLogger, set_logger

# Config fields this port runs; a field set away from its default names a
# flag that is not yet ported
_PORTED_FIELDS = {
    "pfile", "bfile", "out", "glm", "glm_modifiers", "pheno", "pheno_name",
    "covar", "covar_name", "nonfounders", "input_missing_phenotype",
    "output_chr", "seed", "silent", "threads", "memory", "argv",
    # sample and variant filters
    "keep", "remove", "keep_founders", "keep_nonfounders", "mind",
    "extract", "exclude", "chr", "not_chr", "autosome", "autosome_par",
    # counts-based reports and their filters
    "freq", "freq_counts", "freq_cols", "freq_zs", "geno_counts",
    "geno_counts_zs", "missing", "missing_zs", "hardy", "hardy_midp",
    "hardy_zs", "geno", "hwe", "hwe_midp", "maf", "max_maf", "mac", "max_mac",
    # relationship commands
    "make_king", "make_king_mods", "make_king_table", "king_cutoff",
    "king_cutoff_prefix", "king_table_subset", "king_table_filter",
    "make_grm_bin", "make_grm_list", "make_rel", "pca", "pca_approx",
    "pca_allele_wts", "parallel",
    # LD pruning and reports
    "indep_pairwise", "indep_pairphase", "bad_ld", "vcor", "vcor_args",
    "ld_window_kb", "ld_window_r2", "ld", "clump", "clump_p1", "clump_p2",
    "clump_r2", "clump_kb", "clump_id_field", "clump_p_field", "clump_range",
    "clump_range_border", "clump_bins", "clump_allow_overlap",
}


def _unported_flags(cfg: Config) -> list[str]:
    out = []
    for f in dataclasses.fields(Config):
        if f.name in _PORTED_FIELDS:
            continue
        default = f.default if f.default is not dataclasses.MISSING \
            else f.default_factory()
        if getattr(cfg, f.name) != default:
            out.append("--" + f.name.replace("_", "-"))
    return out


def _load(cfg: Config, device):
    """The input fileset (--pfile / --bfile; every other input flag is
    refused by _unported_flags before this runs)."""
    if not (cfg.pfile or cfg.bfile):
        raise ValueError("no input fileset specified (--pfile/--bfile)")
    return load_dataset(cfg.pfile or cfg.bfile, device,
                        missing_pheno=cfg.input_missing_phenotype)


def _degenerate_data_checks(cfg: Config, ds) -> None:
    """The LD guard of plink_tpu's degenerate-data checks (ref
    2.0/plink2.cc:2065-2105): LD-estimating commands with < 50 founders
    error unless --bad-ld."""
    ld_needed = bool(cfg.indep_pairwise or cfg.indep_pairphase or cfg.ld)
    if not ld_needed or cfg.bad_ld or int(ds.founder_mask.sum()) >= 50:
        return
    if ds.raw_sample_ct < 50:
        raise ValueError(
            "This run estimates linkage disequilibrium between "
            "variants, but there are less than 50 samples to estimate "
            "from.  You should perform this operation on a larger "
            "dataset.\n(Strictly speaking, you can also override this "
            "error with --bad-ld, but this is almost always a bad "
            "idea.)")
    raise ValueError(
        "This run estimates linkage disequilibrium between variants, "
        "but there are less than 50 founders to estimate from.  "
        "--make-founders may help.\n(Strictly speaking, you can also "
        "override this error with --bad-ld, but this is almost always "
        "a bad idea.)")


def _filter_and_report(ds, cfg: Config, log) -> None:
    """Sample filters, variant filters, then the counts-based reports and
    enforcement in the reference's exact order (plink2.cc:1325-1899,
    2310-2479): freq -> geno-counts -> missing -> --geno -> hardy -> --hwe
    -> --maf/--mac."""
    from .commands import basic_reports as R
    from .commands import filters as F

    if cfg.keep:
        F.keep_remove_samples(ds, cfg.keep, keep=True, log=log)
    if cfg.remove:
        F.keep_remove_samples(ds, cfg.remove, keep=False, log=log)
    if cfg.keep_founders:
        F.keep_founders_filter(ds, True, log)
    if cfg.keep_nonfounders:
        F.keep_founders_filter(ds, False, log)
    if cfg.mind is not None:
        with log.phase("--mind"):
            F.mind_filter(ds, cfg.mind, log)
    if ds.sample_ct == 0:
        raise ValueError("No samples remaining after main filters.")

    if cfg.extract:
        F.extract_exclude_variants(ds, cfg.extract, extract=True, log=log)
    if cfg.exclude:
        F.extract_exclude_variants(ds, cfg.exclude, extract=False, log=log)
    if cfg.chr:
        F.filter_chr(ds, cfg.chr, log, keep=True)
    if cfg.not_chr:
        F.filter_chr(ds, cfg.not_chr, log, keep=False)
    if cfg.autosome:
        F.filter_autosomes(ds, log)
    if cfg.autosome_par:
        F.filter_autosomes(ds, log, include_par=True)

    if cfg.freq:
        with log.phase("--freq"):
            R.write_freq(ds, cfg.out, log, founders_only=not cfg.nonfounders,
                         zs=cfg.freq_zs, counts=cfg.freq_counts,
                         cols=cfg.freq_cols)
    if cfg.geno_counts:
        with log.phase("--geno-counts"):
            R.write_geno_counts(ds, cfg.out, log, zs=cfg.geno_counts_zs)
    if cfg.missing:
        with log.phase("--missing"):
            R.write_missing(ds, cfg.out, log, zs=cfg.missing_zs)
    if cfg.geno is not None:
        with log.phase("--geno"):
            F.geno_filter(ds, cfg.geno, log)
    if cfg.hardy:
        with log.phase("--hardy"):
            R.write_hardy(ds, cfg.out, log, midp=cfg.hardy_midp,
                          founders_only=not cfg.nonfounders, zs=cfg.hardy_zs)
    if cfg.hwe is not None:
        with log.phase("--hwe"):
            F.hwe_filter(ds, cfg.hwe, cfg.hwe_midp, log)
    if any(v is not None for v in (cfg.maf, cfg.max_maf, cfg.mac, cfg.max_mac)):
        with log.phase("--maf"):
            F.maf_filter(ds, log, cfg.maf, cfg.max_maf, cfg.mac, cfg.max_mac,
                         nonfounders=cfg.nonfounders)


def run_pipeline(cfg: Config, device) -> int:
    bad = _unported_flags(cfg)
    if bad:
        raise NotPortedError(
            f"{', '.join(bad)}: not yet ported to plink_torch.")
    log = RunLogger(cfg.out, silent=cfg.silent)
    set_logger(log)
    log.banner(["plink2t"] + cfg.argv)
    if cfg.seed is not None:
        np.random.seed(cfg.seed)
    try:
        ds = _load(cfg, device)
        log.log(
            f"{ds.raw_variant_ct} variants and {ds.raw_sample_ct} samples loaded."
        )
        if cfg.output_chr != "MT":
            ds.vi.chr_info.set_output_chr(cfg.output_chr)
        _degenerate_data_checks(cfg, ds)
        if cfg.pheno:
            # 2.0 psam input: --pheno APPENDS to the psam phenotype columns;
            # they are only dropped when --pheno-name is also given (ref
            # ignore_psam_phenos, 2.0/plink2.cc:955).  plink1 filesets
            # (.fam col-6 phenotype): --pheno REPLACES the fam phenotype.
            from .commands.glm import _match_rows, _read_table
            from .io.psam import _build_pheno

            id_mode, ids, colnames, vals = _read_table(cfg.pheno)
            rows = _match_rows(ds, id_mode, ids)
            n_raw = ds.raw_sample_ct
            phenos = {} if (cfg.pheno_name or cfg.pfile is None) \
                else dict(ds.si.phenos)
            for c_, nm_ in enumerate(colnames):
                col = ["NA"] * n_raw
                for r_, idx in enumerate(rows):
                    if idx >= 0:
                        col[idx] = vals[r_][c_]
                phenos[nm_] = _build_pheno(nm_, col)
            ds.si.phenos = phenos
        _filter_and_report(ds, cfg, log)
        if cfg.make_king or cfg.make_king_table or cfg.king_cutoff is not None:
            from .commands.king import run_king

            with log.phase("--make-king"):
                run_king(ds, cfg, log)
        if cfg.make_grm_bin or cfg.make_grm_list or cfg.make_rel \
                or cfg.pca is not None:
            from .commands.grm import run_grm_pca

            with log.phase("--make-grm/--pca"):
                run_grm_pca(ds, cfg, log)
        if cfg.indep_pairwise:
            from .commands.ld import indep_pairwise

            with log.phase("--indep-pairwise"):
                indep_pairwise(ds, cfg, log)
        if cfg.indep_pairphase:
            from .commands.ld import indep_pairwise

            with log.phase("--indep-pairphase"):
                indep_pairwise(ds, cfg, log, phased=True)
        if cfg.vcor:
            from .commands.vcor import run_vcor

            with log.phase("--r2/--r"):
                run_vcor(ds, cfg, log)
        if cfg.ld:
            from .commands.ld_console import run_ld_console

            with log.phase("--ld"):
                run_ld_console(ds, cfg, log)
        if cfg.glm:
            from .commands.glm import run_glm

            with log.phase("--glm"):
                run_glm(ds, cfg, log)
        if cfg.clump:
            from .commands.clump import run_clump

            with log.phase("--clump"):
                run_clump(ds, cfg, log)
        log.log(f"End of run; total wall-clock {log.elapsed():.2f}s.")
        return 0
    except Exception as e:
        log.log(f"Error: {e}")
        raise
    finally:
        log.close()
