"""Command-line interface: plink2-compatible flag parsing into a typed config.

`Config` and `parse_args` are plink_tpu's, so every flag parses as there;
the pipeline then refuses what this port does not run yet.

Mirrors the role of CmdlineParsePhase1/2/3 + the alphabetical flag chain
(2.0/plink2_cmdline.h:1747-1763, 2.0/plink2.cc:3700+), implemented as a
declarative flag table instead of a hand-rolled case chain.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field


@dataclass
class Config:
    # input
    pfile: str | None = None
    bfile: str | None = None
    pedmap: str | None = None  # --file / --pedmap prefix
    vcf: tuple | None = None
    gen: tuple | None = None  # (path, modifiers...)
    bgen: tuple | None = None
    fa: tuple | None = None
    ref_from_fa: tuple | None = None
    normalize: bool = False
    tped: str | None = None
    eigfile: str | None = None
    bcf: tuple | None = None
    read_freq: str | None = None
    het_small_sample: bool = False
    allelexxxx: tuple | None = None
    bad_freqs: bool = False
    bad_ld: bool = False
    ac_founders: bool = False
    tfam: str | None = None
    sample: str | None = None
    data: tuple | None = None
    # import thresholds (16384-scale ints; 2.0/plink2.cc:5470,7088,7368)
    hard_call_thresh: int | None = None
    dosage_erase_thresh: int = 0
    import_dosage_certainty: float = 0.0
    vcf_min_gq: int | None = None
    vcf_min_dp: int | None = None
    vcf_max_dp: int | None = None
    vcf_half_call: int | None = None  # 0=ref 1=haploid 2=missing 3=error
    out: str = "plink2"
    # sample filters
    keep: str | None = None
    remove: str | None = None
    keep_if: list[str] = field(default_factory=list)
    keep_cats: str | None = None
    keep_cat_names: list[str] = field(default_factory=list)
    keep_cat_pheno: str | None = None
    remove_cats: str | None = None
    remove_cat_names: list[str] = field(default_factory=list)
    remove_cat_pheno: str | None = None
    remove_if: list[str] = field(default_factory=list)
    mind: float | None = None
    keep_females: bool = False
    keep_males: bool = False
    # variant filters
    extract: tuple | None = None
    extract_if_info: str | None = None
    exclude_if_info: str | None = None
    require_info: tuple = ()
    require_no_info: tuple = ()
    loop_cats: str | None = None
    allow_extra_chr: bool = False
    bp_space: int | None = None
    vcf_id_mode: tuple | None = None
    unrelated_heritability: tuple | None = None
    grm_bin: str | None = None
    grm_gz: str | None = None
    drop_pheno_names: tuple = ()  # internal: --loop-cats consumed column
    exclude: tuple | None = None
    extract_intersect: tuple | None = None
    snp: str | None = None
    snps: list[str] = field(default_factory=list)
    exclude_snp: str | None = None
    exclude_snps: list[str] = field(default_factory=list)
    window: float | None = None
    from_id: str | None = None
    to_id: str | None = None
    chr: list[str] = field(default_factory=list)
    not_chr: list[str] = field(default_factory=list)
    autosome: bool = False
    autosome_par: bool = False
    from_bp: int | None = None
    to_bp: int | None = None
    snps_only: bool = False
    min_alleles: int | None = None
    max_alleles: int | None = None
    var_min_qual: float | None = None
    var_filter: list[str] | None = None  # [] = PASS-only
    output_chr: str = "MT"  # chrM naming scheme (plink2 --output-chr default)
    input_missing_phenotype: float = -9
    require_pheno: list[str] | None = None
    require_covar: list[str] | None = None
    prune: bool = False
    new_id_max_allele_len: tuple = (23, "error")
    geno: float | None = None
    maf: float | None = None
    max_maf: float | None = None
    mac: float | None = None
    max_mac: float | None = None
    hwe: float | None = None
    hwe_midp: bool = False
    nonfounders: bool = False
    xchr_model: int = 2
    # commands
    freq: bool = False
    freq_counts: bool = False
    freq_cols: str | None = None
    freq_zs: bool = False
    missing: bool = False
    missing_zs: bool = False
    hardy: bool = False
    hardy_midp: bool = False
    hardy_zs: bool = False
    geno_counts: bool = False
    geno_counts_zs: bool = False
    write_snplist_zs: bool = False
    zst_decompress: tuple | None = None
    het: bool = False
    sample_counts: bool = False
    make_pgen: bool = False
    make_bed: bool = False
    export_fmts: list[str] = field(default_factory=list)
    write_snplist: bool = False
    validate: bool = False
    pgen_info: bool = False
    genotyping_rate: tuple | None = None
    maj_ref: bool = False
    indiv_sort: tuple | None = None
    recover_var_ids: tuple | None = None
    # relationship / matrix
    make_king: bool = False
    make_king_mods: tuple = ()
    make_king_table: bool = False
    king_cutoff: float | None = None
    king_cutoff_prefix: str | None = None
    king_table_subset: tuple | None = None
    king_table_filter: float | None = None
    make_grm_bin: bool = False
    make_grm_list: bool = False
    make_rel: str | None = None
    pca: int | None = None
    pca_approx: bool = False
    pca_allele_wts: bool = False
    pheno_svd: tuple | None = None
    # LD
    indep_pairwise: tuple | None = None  # (window, step, r2) window may be "Nkb"
    indep_pairphase: tuple | None = None
    vcor: tuple | None = None  # (phased: bool, squared: bool)
    vcor_args: tuple = ()
    ld_window_kb: float | None = None
    ld_window_r2: float | None = None
    # GLM
    glm: bool = False
    glm_modifiers: list[str] = field(default_factory=list)
    pheno: str | None = None
    pheno_name: list[str] = field(default_factory=list)
    covar: str | None = None
    covar_name: list[str] = field(default_factory=list)
    covar_variance_standardize: bool = False
    variance_standardize: tuple | None = None
    quantile_normalize: tuple | None = None
    pheno_quantile_normalize: tuple | None = None
    covar_quantile_normalize: tuple | None = None
    condition: tuple | None = None
    condition_list: tuple | None = None
    quantile_normalize: bool = False
    # segmental CNV module (1.9/plink_cnv.c)
    cfile: str | None = None
    cnv_list: str | None = None
    cnv_make_map: tuple | None = None
    cnv_kb: float | None = None
    cnv_max_kb: float | None = None
    cnv_score: float | None = None
    cnv_max_score: float | None = None
    cnv_sites: int | None = None
    cnv_max_sites: int | None = None
    cnv_del: bool = False
    cnv_dup: bool = False
    cnv_intersect: str | None = None
    cnv_exclude: str | None = None
    cnv_subset: str | None = None
    cnv_overlap: float | None = None
    cnv_region_overlap: float | None = None
    cnv_union_overlap: float | None = None
    cnv_disrupt: bool = False
    cnv_write: tuple | None = None
    cnv_check_no_overlap: bool = False
    adjust: bool = False
    aperm: tuple | None = None
    adjust_file: tuple | None = None
    gwas_ssf: tuple | None = None
    # scoring
    score: tuple | None = None  # (path, modifiers...)
    score_list: tuple | None = None
    variant_score: tuple | None = None
    vscore_col_nums: str | None = None
    score_col_nums: str | None = None
    q_score_range: tuple | None = None
    fst: tuple | None = None
    mendel: bool = False
    assoc: bool = False
    assoc_mods: tuple = ()
    recode19: str | None = None
    linear19: tuple | None = None
    no_snp: bool = False
    write_dosage: bool = False
    interaction19: bool = False
    logistic19: tuple | None = None
    xchr_model_set: bool = False
    model: bool = False
    model_mods: tuple = ()
    allow_no_sex: bool = False
    cell: int | None = None
    genome: bool = False
    genome_mods: tuple = ()
    distance: tuple | None = None
    distance_matrix: bool = False
    ibs_matrix: bool = False
    cluster: tuple | None = None
    cluster_k: int | None = None
    cluster_mc: int | None = None
    cluster_mcc: tuple[int, int] | None = None
    cluster_ppc: float | None = None
    cluster_ibm: float | None = None
    ppc_gap: int | None = None
    neighbour: tuple[int, int] | None = None
    mds_plot: tuple | None = None
    homozyg: tuple | None = None
    homozyg_snp: int | None = None
    homozyg_kb: float | None = None
    homozyg_density: float | None = None
    homozyg_gap: float | None = None
    homozyg_het: int | None = None
    homozyg_window_snp: int | None = None
    homozyg_window_het: int | None = None
    homozyg_window_missing: int | None = None
    homozyg_window_threshold: float | None = None
    homozyg_match: float | None = None
    pool_size: int | None = None
    fast_epistasis: tuple | None = None
    epistasis: tuple | None = None
    vif: float | None = None
    test_missing: tuple | None = None
    twolocus: tuple | None = None
    flip_scan: tuple | None = None
    flip_scan_window: int | None = None
    flip_scan_window_kb: float | None = None
    flip_scan_threshold: float | None = None
    show_tags: str | None = None
    list_all: bool = False
    tag_kb: float | None = None
    tag_r2: float | None = None
    tag_mode2: bool = False
    test_mishap: bool = False
    gxe: int | None = None
    lasso: tuple | None = None
    lasso_select_covars: tuple | None = None
    tucc: tuple | None = None
    make_perm_pheno: int | None = None
    ibs_test: int | None = None
    groupdist: tuple | None = None
    regress_distance: tuple | None = None
    qfam: tuple | None = None
    dfam: tuple | None = None
    gene_report: tuple | None = None
    gene_subset: str | None = None
    gene_list_border: int = 0
    gene_report_snp_field: str | None = None
    annotate: tuple | None = None
    annotate_snp_field: str | None = None
    border: int = 0
    pfilter: float | None = None
    aperm: tuple = (6, 1000000, 0.0, 0.0001, 1.0, 0.001)
    perm_batch_size: int | None = None
    mh: bool = False
    mh2: bool = False
    bd: bool = False
    mh_mods: tuple = ()
    homog: bool = False
    within: str | None = None
    mwithin: int | None = None
    family: bool = False
    # 1.9 set subsystem (--set/--make-set + set test)
    set_file: str | None = None
    make_set: str | None = None
    set_names_list: tuple = ()
    subset_file: str | None = None
    make_set_border: int = 0
    make_set_collapse_group: bool = False
    complement_sets: bool = False
    set_collapse_all: str | None = None
    make_set_complement_all: str | None = None
    gene_all: bool = False
    gene_list: tuple = ()
    write_set: bool = False
    set_table: bool = False
    set_r2: float = 0.5
    set_r2_write: bool = False
    set_p: float = 0.05
    set_max: int = 5
    set_test_lambda: float = 0.0
    # 1.9 --dosage
    dosage: tuple | None = None
    fam: str | None = None
    psam: str | None = None
    import_dosage: tuple | None = None
    map: str | None = None
    epi1: float | None = None
    epi2: float | None = None
    epi_gap: float | None = None
    je_cellmin: int | None = None
    tdt: tuple | None = None
    ci: float | None = None
    meta_analysis: list[str] | None = None
    meta_analysis_mods: tuple = ()
    meta_chr_field: tuple | None = None
    meta_snp_field: tuple | None = None
    meta_bp_field: tuple | None = None
    meta_a1_field: tuple | None = None
    meta_a2_field: tuple | None = None
    meta_p_field: tuple | None = None
    meta_se_field: tuple | None = None
    meta_ess_field: tuple | None = None
    blocks: tuple | None = None
    blocks_max_kb: float | None = None
    blocks_min_maf: float | None = None
    blocks_strong_lowci: float | None = None
    blocks_strong_highci: float | None = None
    blocks_recomb_highci: float | None = None
    blocks_inform_frac: float | None = None
    sdiff: tuple | None = None
    pgen_diff: tuple | None = None
    check_sex: tuple | None = None
    impute_sex: tuple | None = None
    clump: list[str] = field(default_factory=list)
    ld: tuple | None = None
    clump_p1: float | None = None
    clump_p2: float | None = None
    clump_r2: float | None = None
    clump_kb: float | None = None
    clump_id_field: tuple | None = None
    clump_p_field: tuple | None = None
    clump_range: tuple | None = None  # (path, zero_based)
    clump_range_border: float = 0.0
    clump_bins: tuple | None = None
    clump_allow_overlap: bool = False
    export_allele: str | None = None
    af_pseudocount: float = 0.0
    mach_r2_filter: tuple | None = None
    minimac3_r2_filter: tuple | None = None
    set_all_var_ids: str | None = None
    set_missing_var_ids: str | None = None
    sort_vars: bool = False
    ref_allele: tuple | None = None
    alt_allele: tuple | None = None
    rm_dup: str | None = None
    thin: float | None = None
    thin_count: int | None = None
    thin_indiv: float | None = None
    thin_indiv_count: int | None = None
    keep_founders: bool = False
    keep_nonfounders: bool = False
    update_sex: str | None = None
    update_name: tuple | None = None
    update_map: tuple | None = None
    update_alleles: str | None = None
    update_ids: str | None = None
    update_parents: str | None = None
    make_just_psam: bool = False
    make_just_pvar: bool = False
    write_samples: bool = False
    snps_only_acgt: bool = False
    # misc
    threads: int | None = None
    memory: int | None = None
    seed: int | None = None
    silent: bool = False
    parallel: tuple[int, int] | None = None
    dummy: tuple | None = None  # --dummy sample_ct variant_ct [opts]
    pmerge: tuple | None = None
    pmerge_list: tuple | None = None
    # raw argv for the log
    argv: list[str] = field(default_factory=list)


class FlagError(ValueError):
    pass


def _tok_groups(argv: list[str]) -> list[tuple[str, list[str]]]:
    groups = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("--"):
            raise FlagError(f"unexpected argument '{a}' (flags start with --)")
        name = a[2:].replace("-", "_")
        args = []
        i += 1
        while i < len(argv) and not argv[i].startswith("--"):
            args.append(argv[i])
            i += 1
        groups.append((name, args))
    return groups


def parse_args(argv: list[str]) -> Config:
    cfg = Config(argv=list(argv))
    for name, args in _tok_groups(argv):
        if name in ("pfile", "bfile", "file", "pedmap"):
            key = {"file": "pedmap", "pedmap": "pedmap"}.get(name, name)
            setattr(cfg, key, args[0])
        elif name == "vcf":
            cfg.vcf = tuple(args)
        elif name == "gen":
            cfg.gen = tuple(args)
        elif name == "bgen":
            cfg.bgen = tuple(args)
        elif name == "fa":
            cfg.fa = tuple(args)
        elif name == "ref_from_fa":
            cfg.ref_from_fa = tuple(args)
        elif name == "normalize":
            cfg.normalize = True
        elif name in ("tped", "tfam"):
            setattr(cfg, name, args[0])
        elif name == "eigfile":
            cfg.eigfile = args[0]
        elif name == "bcf":
            cfg.bcf = tuple(args)
        elif name == "read_freq":
            cfg.read_freq = args[0]
        elif name in ("bad_freqs", "bad_ld", "ac_founders"):
            setattr(cfg, name, True)
        elif name == "hard_call_threshold":
            f = float(args[0])
            if not 0.0 <= f < 0.5 - 2.0 ** -44:
                raise FlagError("--hard-call-threshold must be in [0, 0.5).")
            cfg.hard_call_thresh = int(f * (1 + 2.0 ** -44) * 16384)
        elif name == "dosage_erase_threshold":
            f = float(args[0])
            if not 0.0 <= f < 0.5 - 2.0 ** -44:
                raise FlagError(
                    "--dosage-erase-threshold must be in [0, 0.5).")
            cfg.dosage_erase_thresh = int(f * (1 + 2.0 ** -44) * 16384)
        elif name == "import_dosage_certainty":
            f = float(args[0])
            if not 0.0 <= f <= 1.0:
                raise FlagError(
                    "--import-dosage-certainty must be in [0, 1].")
            cfg.import_dosage_certainty = f
        elif name in ("vcf_min_gq", "vcf_min_dp", "vcf_max_dp"):
            setattr(cfg, name, int(args[0]))
        elif name == "vcf_half_call":
            modes = {"reference": 0, "r": 0, "haploid": 1, "h": 1,
                     "missing": 2, "m": 2, "error": 3, "e": 3}
            if args[0] not in modes:
                raise FlagError(
                    f"'{args[0]}' is not a valid mode for --vcf-half-call.")
            cfg.vcf_half_call = modes[args[0]]
        elif name == "sample":
            cfg.sample = args[0]
        elif name == "data":
            cfg.data = tuple(args)
        elif name == "out":
            cfg.out = args[0]
        elif name in ("keep", "remove", "pheno", "covar"):
            setattr(cfg, name, args[0])
        elif name in ("extract", "exclude", "extract_intersect"):
            setattr(cfg, name, tuple(args))
        elif name in ("extract_if_info", "extract_if",
                      "exclude_if_info", "exclude_if"):
            key = ("extract_if_info" if name.startswith("extract")
                   else "exclude_if_info")
            setattr(cfg, key, " ".join(args))
        elif name in ("require_info", "require_no_info"):
            setattr(cfg, name, tuple(args))
        elif name == "loop_cats":
            cfg.loop_cats = args[0]
        elif name == "unrelated_heritability":
            cfg.unrelated_heritability = tuple(args)
        elif name in ("grm_bin", "grm_gz"):
            setattr(cfg, name, args[0])
        elif name in ("allow_extra_chr", "aec"):
            # nonstandard contig names are always accepted by our chrom
            # registry (ref errors without this flag; we are permissive)
            cfg.allow_extra_chr = True
        elif name == "bp_space":
            cfg.bp_space = int(args[0])
        elif name == "double_id":
            cfg.vcf_id_mode = ("double", None)
        elif name == "const_fid":
            cfg.vcf_id_mode = ("const", args[0] if args else "0")
        elif name == "id_delim":
            cfg.vcf_id_mode = ("delim", args[0] if args else "_")
        elif name == "snp":
            cfg.snp = args[0]
        elif name == "snps":
            cfg.snps = args
        elif name == "exclude_snp":
            cfg.exclude_snp = args[0]
        elif name == "exclude_snps":
            cfg.exclude_snps = args
        elif name == "window":
            cfg.window = float(args[0])
        elif name == "from":
            cfg.from_id = args[0]
        elif name == "to":
            cfg.to_id = args[0]
        elif name in ("pheno_name", "covar_name"):
            setattr(cfg, name, [t for a in args for t in a.split(",")])
        elif name in ("mind", "geno"):
            setattr(cfg, name, float(args[0]) if args else 0.1)
        elif name in ("maf", "max_maf", "mac", "max_mac"):
            setattr(cfg, name, float(args[0]) if args else (0.01 if name == "maf" else None))
        elif name == "hwe":
            cfg.hwe = float(args[0])
            cfg.hwe_midp = "midp" in args[1:]
        elif name in ("chr", "not_chr"):
            setattr(cfg, name, [t for a in args for t in a.split(",")])
        elif name == "autosome":
            cfg.autosome = True
        elif name == "autosome_par":
            cfg.autosome_par = True
        elif name == "snps_only":
            cfg.snps_only = True
            cfg.snps_only_acgt = "just-acgt" in args
        elif name == "set_all_var_ids":
            cfg.set_all_var_ids = args[0]
        elif name == "set_missing_var_ids":
            cfg.set_missing_var_ids = args[0]
        elif name == "sort_vars":
            cfg.sort_vars = True
        elif name in ("ref_allele", "alt_allele"):
            setattr(cfg, name, tuple(args))
        elif name == "rm_dup":
            cfg.rm_dup = args[0] if args else "error"
        elif name == "thin":
            cfg.thin = float(args[0])
        elif name == "thin_count":
            cfg.thin_count = int(args[0])
        elif name == "thin_indiv":
            cfg.thin_indiv = float(args[0])
        elif name == "thin_indiv_count":
            cfg.thin_indiv_count = int(args[0])
        elif name == "keep_founders":
            cfg.keep_founders = True
        elif name == "keep_nonfounders":
            cfg.keep_nonfounders = True
        elif name == "update_sex":
            cfg.update_sex = args[0]
        elif name in ("update_name", "update_map"):
            setattr(cfg, name, tuple(args))
        elif name in ("update_alleles", "update_ids", "update_parents"):
            setattr(cfg, name, args[0])
        elif name in ("make_just_psam", "make_just_pvar"):
            setattr(cfg, name, True)
        elif name == "write_samples":
            cfg.write_samples = True
        elif name == "from_bp":
            cfg.from_bp = int(args[0])
        elif name == "to_bp":
            cfg.to_bp = int(args[0])
        elif name == "nonfounders":
            cfg.nonfounders = True
        elif name == "freq":
            cfg.freq = True
            cfg.freq_counts = "counts" in args
            cfg.freq_zs = "zs" in args
            for a in args:
                if a.startswith("cols="):
                    cfg.freq_cols = a[5:]
        elif name == "missing":
            cfg.missing = True
            cfg.missing_zs = "zs" in args
        elif name == "hardy":
            cfg.hardy = True
            cfg.hardy_midp = "midp" in args
            cfg.hardy_zs = "zs" in args
        elif name == "geno_counts":
            cfg.geno_counts = True
            cfg.geno_counts_zs = "zs" in args
        elif name == "het":
            cfg.het = True
            cfg.het_small_sample = "small-sample" in args
        elif name in ("allele1234", "alleleACGT"):
            dash = "--" + name
            if args and args[0] != "multichar":
                raise FlagError(f"Invalid {dash} parameter '{args[0]}'.")
            if cfg.allelexxxx is not None:
                raise FlagError(
                    "--allele1234 and --alleleACGT cannot be used together.")
            cfg.allelexxxx = ("acgt" if name == "alleleACGT" else "1234",
                              bool(args))
        elif name == "sample_counts":
            cfg.sample_counts = True
        elif name == "make_pgen":
            cfg.make_pgen = True
        elif name == "make_bed":
            cfg.make_bed = True
        elif name == "export":
            cfg.export_fmts = args
        elif name == "write_snplist":
            cfg.write_snplist = True
            cfg.write_snplist_zs = "zs" in args
        elif name == "zst_decompress":
            cfg.zst_decompress = tuple(args)
        elif name == "validate":
            cfg.validate = True
        elif name == "genotyping_rate":
            cfg.genotyping_rate = tuple(args)
        elif name == "maj_ref":
            cfg.maj_ref = True
        elif name == "indiv_sort":
            cfg.indiv_sort = tuple(args)
        elif name == "recover_var_ids":
            cfg.recover_var_ids = tuple(args)
        elif name == "pgen_info":
            cfg.pgen_info = True
        elif name == "make_king":
            cfg.make_king = True
            cfg.make_king_mods = tuple(args)
        elif name == "make_king_table":
            cfg.make_king_table = True
        elif name == "king_table_filter":
            cfg.king_table_filter = float(args[0])
        elif name == "assoc":
            cfg.assoc = True
            cfg.assoc_mods = tuple(args)
        elif name == "recode":
            fmts19 = {"structure", "bimbam", "bimbam-1chr", "lgen",
                      "lgen-ref", "23", "fastphase", "fastphase-1chr"}
            sel = [a for a in args if a in fmts19]
            if len(sel) != 1 or len(args) != 1:
                raise FlagError(
                    "--recode supports exactly one of: structure, bimbam, "
                    "bimbam-1chr, lgen, lgen-ref, 23, fastphase, "
                    "fastphase-1chr (use --export for the other formats)."
                )
            cfg.recode19 = sel[0]
        elif name in ("linear", "logistic"):
            allowed = {
                "perm", "perm-count", "genotypic", "hethom", "dominant",
                "recessive", "no-x-sex", "hide-covar", "sex", "interaction",
                "beta", "standard-beta", "intercept", "no-snp", "set-test",
            }
            for a in args:
                if not (a in allowed or a.startswith("mperm=")):
                    raise FlagError(f"Invalid --{name} parameter '{a}'.")
            if name == "linear":
                if "beta" in args:
                    raise FlagError(
                        "--linear 'beta' modifier is --logistic-only.")
                cfg.linear19 = tuple(args)
            else:
                if "standard-beta" in args:
                    raise FlagError(
                        "--logistic 'standard-beta' modifier is --linear-only.")
                cfg.logistic19 = tuple(args)
        elif name == "model":
            cfg.model = True
            cfg.model_mods = tuple(args)
        elif name == "allow_no_sex":
            cfg.allow_no_sex = True
        elif name == "cell":
            cfg.cell = int(args[0])
        elif name == "genome":
            cfg.genome = True
            cfg.genome_mods = tuple(args)
        elif name == "distance":
            cfg.distance = tuple(args)
        elif name == "distance_matrix":
            cfg.distance_matrix = True
        elif name == "ibs_matrix":
            cfg.ibs_matrix = True
        elif name == "cluster":
            cfg.cluster = tuple(args)
        elif name == "K":
            cfg.cluster_k = int(args[0])
        elif name == "mc":
            cfg.cluster_mc = int(args[0])
        elif name == "mcc":
            cfg.cluster_mcc = (int(args[0]), int(args[1]))
        elif name == "ppc":
            cfg.cluster_ppc = float(args[0])
        elif name == "ibm":
            cfg.cluster_ibm = float(args[0])
        elif name == "ppc_gap":
            cfg.ppc_gap = int(float(args[0]) * 1000)
        elif name in ("neighbour", "neighbor"):
            cfg.neighbour = (int(args[0]), int(args[1]))
        elif name == "homozyg":
            cfg.homozyg = tuple(args)
        elif name == "homozyg_snp":
            cfg.homozyg_snp = int(args[0])
        elif name == "homozyg_kb":
            cfg.homozyg_kb = float(args[0])
        elif name == "homozyg_density":
            cfg.homozyg_density = float(args[0])
        elif name == "homozyg_gap":
            cfg.homozyg_gap = float(args[0])
        elif name == "homozyg_het":
            cfg.homozyg_het = int(args[0])
        elif name == "homozyg_window_snp":
            cfg.homozyg_window_snp = int(args[0])
        elif name == "homozyg_window_het":
            cfg.homozyg_window_het = int(args[0])
        elif name == "homozyg_window_missing":
            cfg.homozyg_window_missing = int(args[0])
        elif name == "homozyg_window_threshold":
            cfg.homozyg_window_threshold = float(args[0])
        elif name == "homozyg_match":
            cfg.homozyg_match = float(args[0])
        elif name == "pool_size":
            cfg.pool_size = int(args[0])
        elif name == "fast_epistasis":
            cfg.fast_epistasis = tuple(args)
        elif name == "epistasis":
            cfg.epistasis = tuple(args)
        elif name == "vif":
            cfg.vif = float(args[0])
        elif name == "test_missing":
            cfg.test_missing = tuple(args)
        elif name == "twolocus":
            if len(args) != 2:
                raise FlagError("--twolocus requires 2 variant IDs.")
            cfg.twolocus = (args[0], args[1])
        elif name == "flip_scan":
            cfg.flip_scan = tuple(args)
        elif name == "flip_scan_window":
            cfg.flip_scan_window = int(args[0])
        elif name == "flip_scan_window_kb":
            cfg.flip_scan_window_kb = float(args[0])
        elif name == "flip_scan_threshold":
            cfg.flip_scan_threshold = float(args[0])
        elif name == "show_tags":
            cfg.show_tags = args[0]
        elif name == "list_all":
            cfg.list_all = True
        elif name == "tag_kb":
            cfg.tag_kb = float(args[0])
        elif name == "tag_r2":
            cfg.tag_r2 = float(args[0])
        elif name == "tag_mode2":
            cfg.tag_mode2 = True
        elif name == "test_mishap":
            cfg.test_mishap = True
        elif name == "gxe":
            cfg.gxe = int(args[0]) if args else 1
        elif name == "lasso":
            if not args:
                raise FlagError("--lasso requires a heritability estimate.")
            cfg.lasso = tuple(args)
        elif name == "lasso_select_covars":
            cfg.lasso_select_covars = tuple(args)
        elif name in ("mh", "cmh"):
            cfg.mh = True
            cfg.mh_mods = tuple(args)
        elif name == "mh2":
            cfg.mh2 = True
        elif name == "tucc":
            for a in args:
                if a != "write-bed":
                    raise FlagError(
                        f"Invalid --tucc parameter '{a}'.")
            cfg.tucc = tuple(args)
        elif name == "make_perm_pheno":
            cfg.make_perm_pheno = int(args[0])
        elif name == "ibs_test":
            cfg.ibs_test = int(args[0]) if args else 100000
            if cfg.ibs_test < 1024:
                raise FlagError(
                    f"--ibs-test permutation count '{args[0]}' too "
                    "small (min 1024).")
        elif name == "groupdist":
            it = int(args[0]) if args else 100000
            if args and it < 2:
                raise FlagError(
                    f"Invalid --groupdist jackknife iteration count "
                    f"'{args[0]}'.")
            cfg.groupdist = (it, int(args[1]) if len(args) > 1 else 0)
        elif name == "regress_distance":
            it = int(args[0]) if args else 100000
            if args and it < 2:
                raise FlagError(
                    f"Invalid --regress-distance jackknife iteration "
                    f"count '{args[0]}'.")
            cfg.regress_distance = (
                it, int(args[1]) if len(args) > 1 else 0)
        elif name == "dfam":
            cfg.dfam = tuple(args)
        elif name == "gene_report":
            cfg.gene_report = (args[0], args[1])
        elif name == "gene_subset":
            cfg.gene_subset = args[0]
        elif name == "gene_list_border":
            # kb -> bp (1.9/plink.c --gene-list-border)
            cfg.gene_list_border = int(args[0]) * 1000
        elif name == "gene_report_snp_field":
            cfg.gene_report_snp_field = args[0]
        elif name == "annotate":
            # 1.9/plink.c:4522-4598
            if not args:
                raise FlagError("--annotate requires a report file.")
            files = {}
            mods = set()
            for p in args[1:]:
                eq = p.split("=", 1)
                if len(eq) == 2 and eq[0] in (
                        "attrib", "ranges", "filter", "subset",
                        "snps") and eq[1]:
                    files[eq[0]] = eq[1]
                elif p in ("NA", "prune"):
                    other = "prune" if p == "NA" else "NA"
                    if other in mods:
                        raise FlagError(
                            "--annotate 'NA' and 'prune' cannot be "
                            "used together.")
                    mods.add(p)
                elif p in ("block", "minimal", "distance"):
                    mods.add(p)
                else:
                    raise FlagError(
                        f"Invalid --annotate parameter '{p}'.")
            if "block" in mods and ({"NA", "minimal"} & mods):
                raise FlagError(
                    "--annotate 'block' cannot be used with 'NA' or "
                    "'minimal'.")
            if "attrib" not in files and "ranges" not in files:
                raise FlagError(
                    "--annotate must be used with 'attrib' and/or "
                    "'ranges'.")
            if "ranges" not in files:
                if "subset" in files:
                    raise FlagError(
                        "--annotate 'subset' modifier must be used "
                        "with 'ranges'.")
                for m in ("minimal", "distance"):
                    if m in mods:
                        raise FlagError(
                            f"--annotate '{m}' modifier must be used "
                            "with 'ranges'.")
            cfg.annotate = (args[0], files, frozenset(mods))
        elif name == "annotate_snp_field":
            if cfg.annotate is None or "attrib" not in cfg.annotate[1]:
                raise FlagError(
                    "--annotate-snp-field must be used with "
                    "--annotate + 'attrib'.")
            cfg.annotate_snp_field = args[0]
        elif name == "border":
            if cfg.annotate is None or "ranges" not in cfg.annotate[1]:
                raise FlagError(
                    "--border now must be used with --annotate + "
                    "'ranges'.")
            dxx = float(args[0])
            if dxx < 0:
                raise FlagError(
                    f"Invalid --border parameter '{args[0]}'.")
            # kb -> bp with 1.9's epsilon nudge (plink.c:4990)
            if dxx > 2147483.646:
                cfg.border = 0x7ffffffe
            else:
                cfg.border = int(dxx * 1000 * (1 + 2.0 ** -44))
        elif name == "pfilter":
            cfg.pfilter = float(args[0])
        elif name == "qfam":
            cfg.qfam = ("within", tuple(args))
        elif name == "qfam_parents":
            cfg.qfam = ("parents", tuple(args))
        elif name == "qfam_between":
            cfg.qfam = ("between", tuple(args))
        elif name == "qfam_total":
            cfg.qfam = ("total", tuple(args))
        elif name == "aperm":
            d = list(cfg.aperm)
            for k, a in enumerate(args[:6]):
                d[k] = int(a) if k < 2 else float(a)
            # reference quirk: the parsed min is incremented
            # (1.9/plink.c:4454 aperm.min++); the default 6 already
            # uses that convention
            d[0] += 1
            if d[0] >= d[1]:
                raise FlagError(
                    "--aperm min permutation count must be smaller "
                    "than max.")
            cfg.aperm = tuple(d)
        elif name == "perm_batch_size":
            cfg.perm_batch_size = int(args[0])
        elif name == "bd":
            cfg.mh = True
            cfg.bd = True
            cfg.mh_mods = tuple(args)
        elif name == "homog":
            cfg.homog = True
        elif name == "dosage":
            cfg.dosage = tuple(args)
        elif name == "fam":
            cfg.fam = args[0]
        elif name == "psam":
            cfg.psam = args[0]
        elif name == "import_dosage":
            cfg.import_dosage = tuple(args)
        elif name == "map":
            cfg.map = args[0]
        elif name == "set":
            cfg.set_file = args[0]
        elif name == "make_set":
            cfg.make_set = args[0]
        elif name == "set_names":
            cfg.set_names_list = tuple(args)
        elif name == "subset":
            cfg.subset_file = args[0]
        elif name == "make_set_border" or name == "border":
            # kb -> bp with the reference's epsilon guard
            # (1.9/plink.c:9289-9293)
            v = float(args[0])
            cfg.make_set_border = (
                2147483646 if v > 2147483.646
                else int(v * 1000 * (1 + 2.0 ** -44)))
        elif name == "make_set_collapse_group":
            cfg.make_set_collapse_group = True
        elif name == "complement_sets":
            cfg.complement_sets = True
        elif name == "set_collapse_all":
            cfg.set_collapse_all = args[0]
        elif name == "make_set_complement_all":
            cfg.make_set_complement_all = args[0]
        elif name == "make_set_complement_group":
            cfg.make_set_collapse_group = True
            cfg.complement_sets = True
        elif name == "gene_all":
            cfg.gene_all = True
        elif name == "gene":
            cfg.gene_list = tuple(args)
        elif name == "write_set":
            cfg.write_set = True
        elif name == "set_table":
            cfg.set_table = True
        elif name == "set_r2":
            rest = list(args)
            if rest and rest[0] == "write":
                cfg.set_r2_write = True
                rest = rest[1:]
            if rest:
                if rest[-1] == "write":
                    cfg.set_r2_write = True
                    rest = rest[:-1]
            if rest:
                v = float(rest[0])
                if v < 0.0:
                    raise FlagError(
                        f"Invalid --set-r2 parameter '{rest[0]}'.")
                if v > 0.0:
                    cfg.set_r2 = v
                else:
                    cfg.set_max = 1
        elif name == "set_p":
            v = float(args[0])
            if not 0.0 < v <= 1.0:
                raise FlagError(f"Invalid --set-p parameter '{args[0]}'.")
            cfg.set_p = v
        elif name == "set_max":
            cfg.set_max = int(args[0])
        elif name == "set_test_lambda":
            v = float(args[0])
            if v < 1:
                cfg.set_test_lambda = 1.0
            else:
                cfg.set_test_lambda = v
        elif name == "within":
            cfg.within = args[0]
            if len(args) > 1:
                cfg.mwithin = int(args[1])
        elif name == "mwithin":
            cfg.mwithin = int(args[0])
        elif name == "family":
            cfg.family = True
        elif name == "epi1":
            cfg.epi1 = float(args[0])
        elif name == "epi2":
            cfg.epi2 = float(args[0])
        elif name == "gap":
            cfg.epi_gap = float(args[0])
        elif name == "je_cellmin":
            cfg.je_cellmin = int(args[0])
        elif name == "blocks":
            for a in args:
                if a not in ("no-pheno-req", "no-small-max-span"):
                    raise FlagError(f"Invalid --blocks parameter '{a}'.")
            cfg.blocks = tuple(args)
        elif name in ("blocks_max_kb", "blocks_min_maf",
                      "blocks_strong_lowci", "blocks_strong_highci",
                      "blocks_recomb_highci", "blocks_inform_frac"):
            setattr(cfg, name, float(args[0]))
        elif name == "tdt":
            cfg.tdt = tuple(args)
        elif name == "meta_analysis":
            if len(args) < 2:
                raise FlagError(
                    "--meta-analysis requires at least two PLINK "
                    "report files.")
            if "+" in args:
                cut = args.index("+")
                if cut < 2:
                    raise FlagError(
                        "--meta-analysis requires at least two PLINK "
                        "report files.")
                cfg.meta_analysis = list(args[:cut])
                valid = ("study", "no-map", "no-allele", "report-all",
                         "logscale", "qt", "weighted-z", "report-dups")
                for m in args[cut + 1:]:
                    if m not in valid:
                        raise FlagError(
                            f"Invalid --meta-analysis parameter '{m}'.")
                cfg.meta_analysis_mods = tuple(args[cut + 1:])
            else:
                cfg.meta_analysis = list(args)
        elif name in ("meta_analysis_chr_field",
                      "meta_analysis_snp_field",
                      "meta_analysis_bp_field",
                      "meta_analysis_a1_field",
                      "meta_analysis_a2_field",
                      "meta_analysis_p_field",
                      "meta_analysis_se_field",
                      "meta_analysis_ess_field"):
            key = name.replace("meta_analysis", "meta")
            setattr(cfg, key, tuple(args))
        elif name == "ci":
            f = float(args[0])
            if not 0.01 <= f < 1.0:
                raise FlagError("--ci parameter must be in [0.01, 1).")
            cfg.ci = f
        elif name == "mds_plot":
            dims = 2
            by_cluster = eigendecomp = eigvals = False
            for a in args:
                if a == "by-cluster":
                    by_cluster = True
                elif a == "eigendecomp":
                    eigendecomp = True
                elif a == "eigvals":
                    eigvals = True
                else:
                    dims = int(a)
            cfg.mds_plot = (dims, by_cluster, eigendecomp, eigvals)
        elif name == "min_alleles":
            cfg.min_alleles = int(args[0])
        elif name == "max_alleles":
            cfg.max_alleles = int(args[0])
        elif name == "var_min_qual":
            cfg.var_min_qual = float(args[0])
        elif name == "var_filter":
            cfg.var_filter = list(args)
        elif name == "output_chr":
            valid = ("chr26", "26", "chrM", "chrMT", "M", "MT", "0M", "0MT")
            if args[0] not in valid:
                raise FlagError(f"invalid --output-chr value '{args[0]}'")
            cfg.output_chr = args[0]
        elif name == "input_missing_phenotype":
            cfg.input_missing_phenotype = float(args[0])
        elif name == "require_pheno":
            cfg.require_pheno = list(args)
        elif name == "require_covar":
            cfg.require_covar = list(args)
        elif name == "prune":
            cfg.prune = True
        elif name == "new_id_max_allele_len":
            ml = int(args[0])
            mode = args[1] if len(args) > 1 else "error"
            if mode not in ("error", "missing", "truncate"):
                raise FlagError(f"invalid --new-id-max-allele-len mode '{mode}'")
            cfg.new_id_max_allele_len = (ml, mode)
        elif name == "xchr_model":
            cfg.xchr_model = int(args[0])
            cfg.xchr_model_set = True
        elif name == "aperm":
            # --aperm min [max [alpha [beta [init_interval [slope]]]]]
            dflt = [6, 1000000, 0.0, 0.0001, 1.0, 0.001 * (1 + 2 ** -44)]
            vals = [float(a) for a in args]
            cfg.aperm = tuple(
                (vals[i] if i < len(vals) else dflt[i]) for i in range(6)
            )
        elif name == "king_table_subset":
            cfg.king_table_subset = tuple(args)
        elif name == "king_cutoff":
            if len(args) >= 2:
                cfg.king_cutoff_prefix = args[0]
                cfg.king_cutoff = float(args[1])
            else:
                cfg.king_cutoff = float(args[0]) if args else 0.177
        elif name == "make_grm_bin":
            cfg.make_grm_bin = True
        elif name == "make_grm_list":
            cfg.make_grm_list = True
        elif name == "make_rel":
            shape = "triangle"
            for a in args:
                if a in ("square", "square0", "triangle"):
                    shape = a
            cfg.make_rel = shape
        elif name == "pheno_svd":
            cfg.pheno_svd = tuple(args)
        elif name == "pca":
            cfg.pca = 10
            for a in args:
                if a == "approx":
                    cfg.pca_approx = True
                elif a == "allele-wts":
                    cfg.pca_allele_wts = True
                elif a.isdigit():
                    cfg.pca = int(a)
        elif name == "indep_pairwise":
            cfg.indep_pairwise = tuple(args)
        elif name == "indep_pairphase":
            cfg.indep_pairphase = tuple(args)
        elif name in ("r2_unphased", "r_unphased", "r2_phased", "r_phased"):
            cfg.vcor = ("unphased" not in name, name.startswith("r2"))
            cfg.vcor_args = tuple(args)
        elif name == "ld_window_kb":
            cfg.ld_window_kb = float(args[0])
        elif name == "ld_window_r2":
            cfg.ld_window_r2 = float(args[0])
        elif name == "glm":
            cfg.glm = True
            cfg.glm_modifiers = args
        elif name in ("condition", "condition_list"):
            setattr(cfg, name, tuple(args))
        elif name == "covar_variance_standardize":
            cfg.covar_variance_standardize = True
        elif name == "variance_standardize":
            cfg.variance_standardize = tuple(args) if args else ("*",)
        elif name == "quantile_normalize":
            cfg.quantile_normalize = tuple(args) if args else ("*",)
        elif name == "pheno_quantile_normalize":
            cfg.pheno_quantile_normalize = tuple(args) if args else ("*",)
        elif name == "covar_quantile_normalize":
            cfg.covar_quantile_normalize = tuple(args) if args else ("*",)
        elif name == "quantile_normalize":
            cfg.quantile_normalize = True
        elif name == "adjust":
            cfg.adjust = True
        elif name == "adjust_file":
            cfg.adjust_file = tuple(args)
        elif name == "gwas_ssf":
            cfg.gwas_ssf = tuple(args)
        elif name == "fst":
            cfg.fst = tuple(args)
        elif name in ("mendel", "me_report"):
            cfg.mendel = True
        elif name in ("sample_diff", "sdiff"):
            cfg.sdiff = tuple(args)
        elif name == "pgen_diff":
            cfg.pgen_diff = tuple(args)
        elif name == "check_sex":
            cfg.check_sex = tuple(args)
        elif name == "impute_sex":
            cfg.impute_sex = tuple(args)
        elif name == "clump":
            cfg.clump = [t for a in args for t in a.split(",")]
        elif name == "ld":
            cfg.ld = (args[0], args[1])
        elif name == "minimac3_r2_filter":
            cfg.minimac3_r2_filter = (
                float(args[0]),
                float(args[1]) if len(args) > 1 else float("inf"),
            )
        elif name == "mach_r2_filter":
            cfg.mach_r2_filter = (
                float(args[0]) if args else 0.1,
                float(args[1]) if len(args) > 1 else 2.0,
            )
        elif name == "af_pseudocount":
            cfg.af_pseudocount = float(args[0])
        elif name in ("export_allele", "recode_allele"):
            cfg.export_allele = args[0]
        elif name in ("clump_id_field", "clump_snp_field"):
            cfg.clump_id_field = tuple(args)
        elif name in ("clump_p_field", "clump_field"):
            cfg.clump_p_field = tuple(args)
        elif name == "clump_range":
            cfg.clump_range = (args[0], False)
        elif name == "clump_range0":
            cfg.clump_range = (args[0], True)
        elif name == "clump_range_border":
            cfg.clump_range_border = float(args[0])
        elif name == "clump_bins":
            cfg.clump_bins = tuple(
                float(t) for a in args for t in a.split(",") if t)
        elif name == "clump_allow_overlap":
            cfg.clump_allow_overlap = True
        elif name in ("clump_p1", "clump_p2", "clump_r2", "clump_kb"):
            setattr(cfg, name, float(args[0]))
        elif name == "score":
            cfg.score = tuple(args)
        elif name == "score_list":
            cfg.score_list = tuple(args)
        elif name == "variant_score":
            cfg.variant_score = tuple(args)
        elif name == "vscore_col_nums":
            cfg.vscore_col_nums = args[0]
        elif name == "q_score_range":
            cfg.q_score_range = tuple(args)
        elif name == "score_col_nums":
            cfg.score_col_nums = args[0]
        elif name == "threads":
            cfg.threads = int(args[0])
        elif name == "memory":
            cfg.memory = int(args[0])
        elif name == "seed":
            cfg.seed = int(args[0])
        elif name == "silent":
            cfg.silent = True
        elif name == "parallel":
            cfg.parallel = (int(args[0]), int(args[1]))
        elif name == "dummy":
            cfg.dummy = tuple(args)
        elif name == "cfile":
            cfg.cfile = args[0]
        elif name == "cnv_list":
            cfg.cnv_list = args[0]
        elif name == "cnv_make_map":
            cfg.cnv_make_map = tuple(args)
        elif name in ("cnv_kb", "cnv_max_kb", "cnv_score", "cnv_max_score",
                      "cnv_overlap", "cnv_region_overlap",
                      "cnv_union_overlap"):
            setattr(cfg, name, float(args[0]))
        elif name in ("cnv_sites", "cnv_max_sites"):
            setattr(cfg, name, int(args[0]))
        elif name in ("cnv_del", "cnv_dup", "cnv_disrupt",
                      "cnv_check_no_overlap"):
            setattr(cfg, name, True)
        elif name in ("cnv_intersect", "cnv_exclude", "cnv_subset"):
            setattr(cfg, name, args[0])
        elif name == "cnv_write":
            cfg.cnv_write = tuple(args)
        elif name in ("pmerge", "pmerge_list"):
            setattr(cfg, name, tuple(args))
        elif name == "no_snp":
            cfg.no_snp = True
        elif name == "write_dosage":
            cfg.write_dosage = True
        elif name == "interaction":
            cfg.interaction19 = True
        elif name in ("keep_if", "remove_if"):
            setattr(cfg, name, args)
        elif name in ("keep_cats", "keep_cat_pheno", "remove_cats",
                      "remove_cat_pheno"):
            setattr(cfg, name, args[0])
        elif name in ("keep_cat_names", "remove_cat_names"):
            setattr(cfg, name, args)
        elif name in ("keep_females", "keep_males"):
            setattr(cfg, name, True)
        else:
            dash = name.replace("_", "-")
            from .help_data import PLINK2_FLAGS

            if dash in PLINK2_FLAGS:
                raise FlagError(
                    f"--{dash} is a plink2 flag that is not implemented in "
                    "plink-tpu yet."
                )
            raise FlagError(f"unrecognized flag '--{dash}'")
    if cfg.interaction19:
        # deprecated alias (1.9/plink.c:7710): same as the 'interaction'
        # modifier on --linear/--logistic
        if cfg.linear19 is not None and "interaction" not in cfg.linear19:
            cfg.linear19 = tuple(cfg.linear19) + ("interaction",)
        elif cfg.logistic19 is not None \
                and "interaction" not in cfg.logistic19:
            cfg.logistic19 = tuple(cfg.logistic19) + ("interaction",)
    if cfg.no_snp:
        if cfg.linear19 is not None:
            if "no-snp" not in cfg.linear19:
                cfg.linear19 = tuple(cfg.linear19) + ("no-snp",)
        elif cfg.logistic19 is not None:
            if "no-snp" not in cfg.logistic19:
                cfg.logistic19 = tuple(cfg.logistic19) + ("no-snp",)
        else:
            raise FlagError(
                "--no-snp must be used with --linear or --logistic.")
    return cfg


def main(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if argv and argv[0] in ("--help", "-h", "help"):
        print("Error: --help is not yet ported to plink_torch.", file=sys.stderr)
        return 2
    try:
        cfg = parse_args(argv)
    except FlagError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    from . import DeviceError, NotPortedError, resolve_device
    from .pipeline import run_pipeline

    try:
        device = resolve_device()
    except DeviceError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    try:
        return run_pipeline(cfg, device)
    except NotPortedError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
