"""Permutation-test report writing and empirical-p bookkeeping.

Copy of plink_tpu/commands/perm_report.py (host only; the port imports
nothing of plink_tpu).

Behavior reference: plink2_perm.{h,cc} —
- adaptive (aperm) pruning schedule and CI test
  (GlmLinearPerm, 2.0/plink2_glm_linear.cc:5639-5698): first check at
  permutation index aperm_min-1, next at +int(interval + perm_ct*slope);
  prune when aperm_alpha falls outside the normal CI of the running EMP1
  with z_t = Phi^-1(1 - beta/(2*test_ct)).
- EMP1 = (ctx2 + 2) / (2*denom) with tie-as-half counting ("x2" counters,
  2.0/plink2_glm_linear.cc:5685), denom = perms+1 (or prune-time perm_ct+1).
- max(T) EMP2 from the sorted per-permutation best statistics with ties
  split (WritePermReportBody, 2.0/plink2_perm.cc:440-470).
- report columns / file naming: InitPermReportWriter
  (2.0/plink2_perm.cc:262-328): .<a|m>perm suffix, default columns
  #CHROM ID REF ALT PROVISIONAL_REF? A1 OMITTED then EMP1/PERM_CT or
  EMP1/EMP2 ('perm-count' switches to raw counts with .5 ties).

Permutation streams use numpy's PCG64 seeded by --seed (documented
deviation from the reference's SFMT19937; empirical p-values are
RNG-agnostic up to Monte-Carlo noise).
"""

from __future__ import annotations

import numpy as np

from ..utils.fmt import g6


class AdaptiveState:
    """Reference-faithful adaptive pruning over permutation batches.

    Maintains per-test ctx2 counters and evaluates the CI check at the
    exact per-permutation indices the reference uses, replayed from the
    batched [T, B] tie/exceed counts after each batch.
    """

    def __init__(self, n_tests: int, aperm: tuple, perms_total: int):
        (self.amin, self.amax, self.alpha, beta,
         self.intercept, self.slope) = aperm
        from ..stats.distributions import norm_ppf

        self.zt = float(norm_ppf(1.0 - beta / (2.0 * max(n_tests, 1))))
        self.ctx2 = np.zeros(n_tests, np.int64)
        self.denom = np.zeros(n_tests, np.int64)  # 0 = still active
        self.next_check = np.full(n_tests, self.amin - 1, np.int64)
        self.perms_done = 0
        self.perms_total = perms_total

    def active(self) -> np.ndarray:
        return self.denom == 0

    def update(self, cnt_batch: np.ndarray) -> None:
        """cnt_batch: int8 [T, B] per-permutation x2 increments (0/1/2) for
        this batch, in permutation order."""
        T, B = cnt_batch.shape
        act = np.flatnonzero(self.denom == 0)
        if act.size == 0:
            self.perms_done += B
            return
        csum = np.cumsum(cnt_batch[act], axis=1, dtype=np.int64)
        base = self.ctx2[act]
        for t_i, t in enumerate(act):
            nc = self.next_check[t]
            pruned = False
            while nc < self.perms_done + B:
                pidx_local = nc - self.perms_done
                perm_ct = nc + 1
                c = base[t_i] + (csum[t_i, pidx_local] if pidx_local >= 0
                                 else 0)
                emp1 = (c + 2) / (2.0 * (perm_ct + 1))
                ci = self.zt * np.sqrt(emp1 * (1 - emp1) / perm_ct)
                if (emp1 - ci > self.alpha) or (emp1 + ci < self.alpha):
                    self.denom[t] = perm_ct + 1
                    self.ctx2[t] = c
                    pruned = True
                    break
                nc += int(self.intercept + perm_ct * self.slope)
            if not pruned:
                self.next_check[t] = nc
                self.ctx2[t] = base[t_i] + csum[t_i, B - 1]
        self.perms_done += B

    def finish(self) -> None:
        self.denom[self.denom == 0] = self.perms_done + 1

    def remaining(self) -> int:
        return int((self.denom == 0).sum())


def emp2_from_best(orig_stats: np.ndarray, best_stats: np.ndarray,
                   lower_is_extreme: bool) -> np.ndarray:
    """EMP2 x2 counts per test from the per-permutation best statistics
    (ties split; WritePermReportBody, 2.0/plink2_perm.cc:445-452)."""
    perms_total = len(best_stats)
    s = np.sort(best_stats)
    lo = np.searchsorted(s, orig_stats, side="left")
    hi = np.searchsorted(s, orig_stats, side="right")
    ctx2 = lo + hi
    if not lower_is_extreme:
        ctx2 = 2 * perms_total - ctx2
    return ctx2


def write_perm_report(path, ds, vmask, a1, omitted, provref, valid,
                      test_idx_of_variant, adaptive, ctx2, denom,
                      perms_total, emp2_ctx2=None, perm_count=False,
                      log=None):
    """Write the .aperm/.mperm file.

    valid: bool [M] raw variants with a valid original test; ctx2/denom
    indexed by test index (cumsum of valid over vmask order)."""
    vi = ds.vi
    with open(path, "w") as f:
        f.write("#CHROM\tID\tREF\tALT\tPROVISIONAL_REF?\tA1\tOMITTED\t")
        if adaptive:
            f.write("EMP1_CT\tPERM_CT\n" if perm_count else "EMP1\tPERM_CT\n")
        else:
            f.write("EMP1_CT\tEMP2_CT\n" if perm_count else "EMP1\tEMP2\n")
        emp2_recip = 1.0 / (2.0 * (perms_total + 1))
        for v in np.flatnonzero(vmask):
            meta = (
                f"{vi.chr_info.name(vi.chrom[v])}\t{vi.vid[v]}\t{vi.ref[v]}\t"
                f"{vi.alt[v]}\t{provref[v]}\t{a1[v]}\t"
                f"{omitted[v]}\t"
            )
            t = test_idx_of_variant[v]
            if t < 0 or not valid[v]:
                f.write(meta + "NA\tNA\n")
                continue
            c2 = int(ctx2[t])
            dn = int(denom[t])
            if adaptive:
                if perm_count:
                    half = ".5" if c2 % 2 else ""
                    f.write(meta + f"{c2 // 2}{half}\t{dn - 1}\n")
                else:
                    emp1 = (c2 + 2) / (2.0 * dn)
                    f.write(meta + f"{g6(emp1)}\t{dn - 1}\n")
            else:
                e2 = int(emp2_ctx2[t])
                if perm_count:
                    h1 = ".5" if c2 % 2 else ""
                    h2 = ".5" if e2 % 2 else ""
                    f.write(meta + f"{c2 // 2}{h1}\t{e2 // 2}{h2}\n")
                else:
                    emp1 = (c2 + 2) * emp2_recip
                    emp2 = (e2 + 2) * emp2_recip
                    f.write(meta + f"{g6(emp1)}\t{g6(emp2)}\n")
    if log is not None:
        log.log(f"Permutation test results written to {path} .")
