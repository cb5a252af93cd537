"""PLINK 1.9 permutation-vector generators, bit-exact RNG consumption:
the run's master SFMT stream and the case/control permutation of
--ibs-test (plink_tpu/stats/perm19.py; the cluster and QT generators are
not needed yet).

Behavior reference: 1.9/plink_perm.c:60-470 (generate_cc_perm_vec /
generate_cc_perm1).

The reference's magic-number division ((magic * ((urand >> pre) + incr))
>> post) is an exact uint32 floor division by tot_quotient for every
dividend (plink_common.c:3383 magic_num), so plain // is used here.
"""

from __future__ import annotations

import numpy as np

from .sfmt import Sfmt


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
