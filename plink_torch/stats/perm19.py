"""PLINK 1.9 permutation-vector generators, bit-exact RNG consumption:
the run's master SFMT stream, the case/control permutation of
--ibs-test, and the permutation matrix of --assoc / --model with its
cluster-restricted variant (plink_tpu/stats/perm19.py; the QT generators
are not needed yet).

Behavior reference: 1.9/plink_perm.c:60-470 (generate_cc_perm_vec /
generate_cc_perm1 / cluster variants) and 1.9/plink_cluster.c
cluster_include_and_reindex / adjust_cc_perm_preimage.

The reference's magic-number division ((magic * ((urand >> pre) + incr))
>> post) is an exact uint32 floor division by tot_quotient for every
dividend (plink_common.c:3383 magic_num), so plain // is used here.
"""

from __future__ import annotations

import numpy as np

from .sfmt import Sfmt, sfmt_thread_array


def master_sfmt(cfg):
    """Per-run master generator (g_sfmt): all RNG consumers in a run
    share one stream, in pipeline order, exactly like the reference."""
    m = getattr(cfg, "_sfmt_master", None)
    if m is None:
        if cfg.seed is not None:
            m = Sfmt(cfg.seed & 0xFFFFFFFF)
        else:
            import os

            m = Sfmt(int.from_bytes(os.urandom(4), "little"))
        object.__setattr__(cfg, "_sfmt_master", m)
    return m


def _draw(sfmt, tot_quotient, upper_bound):
    while True:
        urand = sfmt.genrand_uint32()
        if urand <= upper_bound:
            return urand // tot_quotient


def generate_cc_perm(tot_ct, set_ct, sfmt):
    """generate_cc_perm_vec / generate_cc_perm1 (identical RNG stream
    and case-set; only the bit packing differed).  Returns a bool
    array: True = case."""
    tot_quotient = (1 << 32) // tot_ct
    upper_bound = tot_ct * tot_quotient - 1
    out = np.zeros(tot_ct, bool)
    if set_ct * 2 < tot_ct:
        n = set_ct
        want = False     # draw until we hit a clear slot, then set
    else:
        out[:] = True
        n = tot_ct - set_ct
        want = True      # draw until we hit a set slot, then clear
    for _ in range(n):
        while True:
            uii = _draw(sfmt, tot_quotient, upper_bound)
            if out[uii] == want:
                break
        out[uii] = not want
    return out


def generate_cc_cluster_perm(tot_ct, preimage, clusters, case_cts,
                             sfmt):
    """generate_cc_cluster_perm_vec/perm1.  clusters: list of collapsed
    member index arrays (each size >= 2), case_cts aligned; preimage is
    the majority-adjusted bool array (True = case)."""
    out = preimage.copy()
    for members, target_ct in zip(clusters, case_cts):
        size = len(members)
        if not target_ct or target_ct == size:
            continue
        tot_quotient = (1 << 32) // size
        upper_bound = size * tot_quotient - 1
        if target_ct * 2 < size:
            n, want = target_ct, False
        else:
            n, want = size - target_ct, True
        for _ in range(n):
            while True:
                uii = int(members[_draw(sfmt, tot_quotient,
                                        upper_bound)])
                if out[uii] == want:
                    break
            out[uii] = not want
    return out


def cc_perm_matrix(pheno_case, perm_ct, thread_ct, master,
                   clusters=None, sfmts=None):
    """All --make-perm-pheno style case/control permutations:
    [perm_ct, n] bool.  pheno_case: bool array over pheno-nonmissing
    samples in filtered order.  clusters: optional
    (member_arrays, case_cts, preimage) from reindex_clusters_19.
    Pass a persistent ``sfmts`` list (sized to the max thread count) to
    continue thread RNG streams across generation batches (--linear/
    --logistic multi-pass permutation)."""
    n = pheno_case.size
    case_ct = int(pheno_case.sum())
    thread_ct = min(thread_ct, perm_ct)
    if sfmts is None:
        sfmts = sfmt_thread_array(master, thread_ct)
    out = np.zeros((perm_ct, n), bool)
    for tidx in range(thread_ct):
        pidx = (tidx * perm_ct) // thread_ct
        pmax = ((tidx + 1) * perm_ct) // thread_ct
        for p in range(pidx, pmax):
            if clusters is None:
                out[p] = generate_cc_perm(n, case_ct, sfmts[tidx])
            else:
                members, case_cts, preimage = clusters
                out[p] = generate_cc_cluster_perm(
                    n, preimage, members, case_cts, sfmts[tidx])
    return out


def reindex_clusters_19(assign_nm, case_nm=None):
    """cluster_include_and_reindex with remove_size1=1
    (1.9/plink_cluster.c): assign_nm = cluster index (or -1) per
    pheno-nonmissing sample in filtered order, cluster indices already
    natural-name-sorted.  Returns (member_arrays, case_cts, preimage,
    sample_to_cluster); case_cts/preimage are None without case_nm."""
    n = assign_nm.size
    kept_members = []
    case_cts = [] if case_nm is not None else None
    sample_to_cluster = np.full(n, -1, np.int64)
    kmax = int(assign_nm.max()) + 1 if n else 0
    for k in range(kmax):
        mem = np.flatnonzero(assign_nm == k)
        if mem.size <= 1:
            continue
        sample_to_cluster[mem] = len(kept_members)
        kept_members.append(mem)
        if case_nm is not None:
            case_cts.append(int(case_nm[mem].sum()))
    preimage = None
    if case_nm is not None:
        preimage = case_nm.copy()
        for mem, cct in zip(kept_members, case_cts):
            preimage[mem] = not (cct * 2 < mem.size)
    return kept_members, case_cts, preimage, sample_to_cluster
