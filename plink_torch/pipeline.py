"""Command pipeline (ref: Plink2Core, 2.0/plink2.cc:836), as far as this port
runs it, in plink_tpu's order (plink_tpu/pipeline.py): load a .pgen/.bed
fileset (or write and load a --dummy one), apply --pheno, the sample
filters (keep/remove, founders, --mind), the variant filters
(extract/exclude, chr), the counts-based reports and
their filters (freq, geno-counts, missing, --geno, hardy, --hwe,
--maf/--mac), the relationship commands (KING, then GRM / PCA), the sample
reports (--het, --sample-counts, --fst, then --check-sex / --impute-sex),
--indep-pairwise, --indep-pairphase, the --r2/--r tables and matrices,
--ld, --variant-score, --score, then --glm, --assoc / --model, the
pair-count commands (--genome, --distance, --cluster / --neighbour /
--mds-plot, --ibs-test, --groupdist, --regress-distance), --fast-epistasis,
and --clump last.  1.9's --set / --make-set definitions are read after the
QC filters.

Every other flag raises NotPortedError before anything runs; the run never
falls back to plink_tpu.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import NotPortedError
from .cli import Config, FlagError
from .dataset import load_dataset
from .utils.logging import RunLogger, set_logger

# Config fields this port runs; a field set away from its default names a
# flag that is not yet ported
_PORTED_FIELDS = {
    "pfile", "bfile", "out", "glm", "glm_modifiers", "pheno", "pheno_name",
    "covar", "covar_name", "nonfounders", "input_missing_phenotype",
    # --glm's chrX coding and its covariate / phenotype transforms
    "xchr_model", "xchr_model_set", "covar_variance_standardize",
    "variance_standardize", "quantile_normalize", "pheno_quantile_normalize",
    "covar_quantile_normalize", "condition", "condition_list",
    # --glm's permutation tests (--aperm) and --adjust
    "aperm", "adjust",
    "output_chr", "seed", "silent", "threads", "memory", "argv",
    # --dummy and its hard-call / erase thresholds
    "dummy", "hard_call_thresh", "dosage_erase_thresh",
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
    # sample reports and scoring, and the frequencies they read
    "het", "het_small_sample", "sample_counts", "check_sex", "impute_sex",
    "score", "score_list", "score_col_nums", "q_score_range", "variant_score",
    "vscore_col_nums", "read_freq", "bad_freqs",
    # the pair-count commands: IBS distance, IBD, clustering / MDS and the
    # IBS permutation / jackknife tests
    "genome", "genome_mods", "distance", "distance_matrix", "ibs_matrix",
    "cluster", "cluster_k", "cluster_mc", "cluster_mcc", "cluster_ppc",
    "cluster_ibm", "ppc_gap", "neighbour", "mds_plot", "ibs_test",
    "groupdist", "regress_distance",
    # plink 1.9's case/control association (--assoc / --model and their
    # permutation tests), --fst, and --fast-epistasis with its set inputs
    "assoc", "assoc_mods", "model", "model_mods", "allow_no_sex", "cell", "ci",
    "fst", "fast_epistasis", "epi1", "epi2", "epi_gap", "je_cellmin",
    "set_file", "make_set", "set_names_list", "subset_file", "make_set_border",
    "make_set_collapse_group", "complement_sets", "set_collapse_all",
    "make_set_complement_all", "gene_all", "gene_list",
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


def _load(cfg: Config, device, log):
    """The input fileset (--pfile / --bfile, or the panel --dummy writes;
    every other input flag is refused by _unported_flags before this
    runs)."""
    if cfg.pfile or cfg.bfile:
        return load_dataset(cfg.pfile or cfg.bfile, device,
                            missing_pheno=cfg.input_missing_phenotype)
    if cfg.dummy:
        from .commands.dummy import generate_dummy

        return generate_dummy(cfg, log, device)
    raise ValueError("no input fileset specified (--pfile/--bfile/--dummy)")


def _degenerate_data_checks(cfg: Config, ds) -> None:
    """plink_tpu's degenerate-data checks as far as the port runs them (ref
    2.0/plink2.cc:2065-2105): LD-estimating commands with < 50 founders
    error unless --bad-ld; commands that need decent allele frequencies
    (--score, --check-sex, --impute-sex, --het) with < 50 founders (or
    samples) error unless --read-freq or --bad-freqs."""
    founder_ct = int(ds.founder_mask.sum())
    sample_ct = ds.raw_sample_ct
    ld_needed = bool(cfg.indep_pairwise or cfg.indep_pairphase or cfg.ld)
    if ld_needed and founder_ct < 50 and not cfg.bad_ld:
        if sample_ct < 50:
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
    decent_needed = bool(cfg.score or cfg.score_list or cfg.check_sex
                         or cfg.impute_sex or cfg.het)
    if decent_needed and not cfg.read_freq and not cfg.bad_freqs and (
            sample_ct < 50
            or (not cfg.nonfounders and founder_ct < 50)):
        if not cfg.nonfounders and sample_ct >= 50:
            raise ValueError(
                "This run requires decent allele frequencies, but they "
                "aren't being loaded with --read-freq, and less than 50 "
                "founders are available to impute them from.  Possible "
                "solutions:\n* You can use --nonfounders to include "
                "nonfounders when imputing allele\n  frequencies.\n* You "
                "can generate (with --freq) or obtain an allele frequency "
                "file based on a\n  larger similar-population reference "
                "dataset, and load it with --read-freq.\n* (Not "
                "recommended) You can override this error with "
                "--bad-freqs.")
        raise ValueError(
            "This run requires decent allele frequencies, but they aren't "
            "being loaded with --read-freq, and less than 50 samples are "
            "available to impute them from.\nYou should generate (with "
            "--freq) or obtain an allele frequency file based on a larger "
            "similar-population reference dataset, and load it with "
            "--read-freq.")


def _read_freq(cfg: Config, ds, log) -> None:
    """--read-freq: the ALT_FREQS column of a .afreq-style file, by variant
    ID, replaces the computed frequencies wherever they are read
    (ds.freq_override; plink_tpu/pipeline.py:838-857)."""
    ov = {}
    with open(cfg.read_freq) as f:
        hdr = f.readline().lstrip("#").split()
        idc = hdr.index("ID")
        fc = hdr.index("ALT_FREQS")
        for ln in f:
            t = ln.split()
            try:
                ov[t[idc]] = float(t[fc])
            except ValueError:
                pass
    fo = np.full(ds.raw_variant_ct, np.nan)
    for i, vid_ in enumerate(ds.vi.vid):
        if str(vid_) in ov:
            fo[i] = ov[str(vid_)]
    ds.freq_override = fo
    log.log(f"--read-freq: {int(np.isfinite(fo).sum())} frequencies loaded.")


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
        ds = _load(cfg, device, log)
        log.log(
            f"{ds.raw_variant_ct} variants and {ds.raw_sample_ct} samples loaded."
        )
        if cfg.output_chr != "MT":
            ds.vi.chr_info.set_output_chr(cfg.output_chr)
        _degenerate_data_checks(cfg, ds)
        if cfg.read_freq:
            _read_freq(cfg, ds, log)
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
        if cfg.set_file or cfg.make_set:
            # 1.9's set definitions after the QC filters (--gene / --gene-all
            # may narrow the variants); --fast-epistasis set-by-set /
            # set-by-all defines them again, as plink_tpu does
            from .commands.sets import define_sets

            define_sets(ds, cfg, log)
        if cfg.make_king or cfg.make_king_table or cfg.king_cutoff is not None:
            from .commands.king import run_king

            with log.phase("--make-king"):
                run_king(ds, cfg, log)
        if cfg.make_grm_bin or cfg.make_grm_list or cfg.make_rel \
                or cfg.pca is not None:
            from .commands.grm import run_grm_pca

            with log.phase("--make-grm/--pca"):
                run_grm_pca(ds, cfg, log)
        if cfg.het:
            from .commands.het import write_het

            with log.phase("--het"):
                write_het(ds, cfg.out, log, small_sample=cfg.het_small_sample)
        if cfg.sample_counts:
            from .commands.sample_counts import write_sample_counts

            with log.phase("--sample-counts"):
                write_sample_counts(ds, cfg.out, log)
        if cfg.fst:
            from .commands.fst import run_fst

            with log.phase("--fst"):
                run_fst(ds, cfg, log)
        if cfg.check_sex is not None or cfg.impute_sex is not None:
            from .commands.check_sex import run_check_sex

            with log.phase("--check-sex/--impute-sex"):
                run_check_sex(ds, cfg, log, impute=cfg.impute_sex is not None)
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
        if cfg.variant_score:
            from .commands.vscore import run_vscore

            with log.phase("--variant-score"):
                run_vscore(ds, cfg, log)
        if cfg.score or cfg.score_list:
            from .commands.score import score_report

            with log.phase("--score"):
                score_report(ds, cfg, log)
        if cfg.glm:
            from .commands.glm import run_glm

            with log.phase("--glm"):
                run_glm(ds, cfg, log)
        if cfg.assoc or cfg.model:
            from .commands import assoc19

            with log.phase("--assoc/--model"):
                if cfg.assoc:
                    pc = next(iter(ds.si.phenos.values()), None)
                    if pc is not None and pc.kind == "qt":
                        raise NotPortedError(
                            "--assoc on a quantitative phenotype is not yet "
                            "ported to plink_torch.")
                    assoc19.run_assoc(ds, cfg, log)
                if cfg.model:
                    assoc19.run_model(ds, cfg, log)
        if cfg.genome:
            from .commands.genome import run_genome

            with log.phase("--genome"):
                run_genome(ds, cfg, log)
        if cfg.distance is not None or cfg.distance_matrix or cfg.ibs_matrix:
            from .commands.distance import run_distance

            with log.phase("--distance"):
                run_distance(ds, cfg, log)
        if cfg.cluster is not None or cfg.neighbour is not None:
            from .commands.cluster import run_cluster

            with log.phase("--cluster"):
                run_cluster(ds, cfg, log)
        elif cfg.mds_plot is not None:
            raise FlagError("--mds-plot must be used with --cluster.")
        if cfg.ibs_test is not None:
            from .commands.ibs_test import run_ibs_test

            with log.phase("--ibs-test"):
                run_ibs_test(ds, cfg, log)
        if cfg.groupdist is not None:
            from .commands.groupdist import run_groupdist

            with log.phase("--groupdist"):
                run_groupdist(ds, cfg, log)
        if cfg.regress_distance is not None:
            from .commands.groupdist import run_regress_distance

            with log.phase("--regress-distance"):
                run_regress_distance(ds, cfg, log)
        if cfg.fast_epistasis is not None:
            from .commands.epistasis import run_fast_epistasis

            with log.phase("--fast-epistasis"):
                run_fast_epistasis(ds, cfg, log)
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
