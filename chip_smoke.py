#!/usr/bin/env python3
"""On-card smoke test of plink_torch, the PyTorch + CUDA port.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. card report: name and power limit, torch / CUDA versions, TF32 off;
  2. build: every kernel under plink_torch/csrc with nvcc (in parallel);
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes (500,000 samples, d = 13), with its time, the
     plain version's time, one library call's time and the card's bound;
  4. main path: `--pfile P --glm hide-covar --covar P.cov` through
     plink_torch.cli.main on a 500,000-sample x 4,096-variant panel
     (`--variants 16384`: the headline); every kernel must have launched,
     and the report must equal plink2's; then once more under
     torch.profiler for the card's busy share;
  5. parity: a 2,000 x 1,200 panel through the port on the card and on the
     CPU (plain versions), hybrid and firth, compared column by column; two
     card runs must give identical bytes.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device or
without the plink_torch package beside this script.
"""

from __future__ import annotations

import argparse
import gzip
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_SAMPLES = 500_000  # the headline configuration's sample width
N_VARIANTS = 4_096  # two 2,048-variant blocks; --variants up to 16,384
SMALL = (2_000, 1_200, 1)  # samples, variants, seed of the parity panel
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores
# kernel vs plain tolerances for f32 sums over 500,000 samples taken in
# another order; each entry is normalised by a Cauchy-Schwarz bound on its
# size (sqrt of the two diagonal entries; sqrt(sum x_j^2 * obs) for vectors)
TOL_VS_PLAIN = 2e-4  # the plain version's cuBLAS products run each 500,000-
# term sum in about one f32 sequence: ~sqrt(n) * eps = 4e-5, with headroom
TOL_VS_F64 = 2e-5  # the kernel sums <= 2,048-sample runs in f32 (drift ~5e-6)
# and adds the runs in f64; held against the plain version run in f64
TOL_LOGLIK = 1e-6  # relative; f32 per-sample terms summed in f64 on both sides
TOL_CHOL = 1e-3  # relative to the row's largest entry; cond(H) * f32 eps
GLM_FLOAT_RTOL = 1e-3  # report columns OR / SE / Z / P (bench.py's rule)
# plink2's own report on the headline 500,000 x 16,384 panel (the panel
# generator is counter-based, so its first rows are a smaller panel's rows),
# kept as gzip because the card's machine has no zstandard: `--write-golden`
GOLDEN = os.path.join(HERE, "chip_smoke_golden.tsv.gz")
GOLDEN_SRC = os.path.join(HERE, "bench_golden",
                          "o_glm.PHENO1.glm.logistic.hybrid.zst")


def log(msg=""):
    print(msg, flush=True)


def card_report(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    from plink_torch import resolve_device

    dev = resolve_device()
    assert dev.type == "cuda", dev
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    return dev, smi.splitlines()[0]


def build():
    """Build every kernel library; print per kernel entry (template
    arguments from the mangled name) its registers and spill bytes, for the
    covariate width of the main path (dc = 12) and wherever ptxas spilled."""
    from plink_torch.ops import _cuda

    t0 = time.perf_counter()
    secs = _cuda.build_all()
    log(f"build: {time.perf_counter() - t0:.1f}s wall "
        + " ".join(f"{k}={v:.1f}s" for k, v in secs.items()))
    for name in secs:
        entry, spill = None, 0
        for line in _cuda.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                args = re.findall(r"Li(\d+)E", entry)
                short = re.search(r"\d+([a-z_]+_kernel)", entry)
                short = short.group(1) if short else entry
                if spill or (args and args[0] in ("12", "13", "15")):
                    log(f"  {short}<{','.join(args)}>: {m.group(1)} registers, "
                        f"{spill} bytes spilled")
                entry, spill = None, 0


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def chunked(torch, fn, n_rows, step, dim=0):
    """Run a row-independent plain version `fn(row_slice)` over row chunks
    (bounded [rows, n] temporaries) and concatenate each output along the
    variant axis `dim`."""
    outs = [fn(slice(r0, min(n_rows, r0 + step)))
            for r0 in range(0, n_rows, step)]
    if isinstance(outs[0], tuple):
        return tuple(None if o[0] is None else torch.cat(o, dim)
                     for o in zip(*outs))
    return torch.cat(outs, dim)


def norm_err(torch, k, p, scale):
    return float(((k - p).abs() / scale).max())


def mat_scale(torch, m):
    """sqrt(|m_jj m_kk|): a bound on |m_jk| for a sum of weighted x x^T."""
    dg = torch.diagonal(m, dim1=1, dim2=2).abs().clamp(min=1e-30)
    return torch.sqrt(dg[:, :, None] * dg[:, None, :])


def make_panel(prefix, n, m, seed):
    from plink_torch.bench_gen import gen_panel, make_cov

    gen_panel(prefix, n, m, miss_rate=0.02, seed=seed)
    make_cov(prefix, seed + 1)


def main_path_inputs(torch, prefix, dev):
    """The panel's packed genotypes on the card, its per-sample table and its
    (all, male, female) masks, as the main path builds them:
    c = [1 | SEX | PC1..PC10] (dc = 12), y = PHENO1, every sample in."""
    import numpy as np

    from plink_torch.dataset import load_dataset

    ds = load_dataset(prefix, dev)
    packed = ds.device_all_packed()
    n = ds.raw_sample_ct
    cov = np.loadtxt(prefix + ".cov", skiprows=1, usecols=range(1, 12),
                     dtype=np.float64)
    y = ds.si.phenos["PHENO1"].data
    feat = np.zeros((packed.shape[1] * 4, 14), np.float32)
    feat[:n, 0] = 1.0
    feat[:n, 1:12] = cov
    feat[:n, 12] = y
    feat[:n, 13] = 1.0
    sex = ds.si.sex
    masks = np.zeros((packed.shape[1] * 4, 3), np.float32)
    masks[:n, 0] = 1.0
    masks[:n, 1] = sex == 1
    masks[:n, 2] = sex == 2
    return (packed, torch.from_numpy(feat).to(dev),
            torch.from_numpy(masks).to(dev))


def check_kernels(torch, dev, prefix):
    from plink_torch.ops import counts as C
    from plink_torch.ops import glm as G

    packed_all, feat, masks = main_path_inputs(torch, prefix, dev)
    vb = 2048
    pk = packed_all[:vb]
    dc = feat.shape[1] - 2
    d = dc + 1
    rows = []

    # K1 over the whole panel, as _group_counts calls it
    k1 = C.geno_counts(packed_all, masks)
    V = packed_all.shape[0]
    plain1 = lambda sl: C.geno_counts_plain(packed_all[sl], masks)  # noqa: E731
    p1 = chunked(torch, plain1, V, 512, dim=1)
    err1 = int((k1 - p1).abs().max())
    assert err1 == 0, f"geno_counts differs from its plain version by {err1}"
    ms1 = time_ms(torch, lambda: C.geno_counts(packed_all, masks), 20)
    pms1 = time_ms(torch, lambda: chunked(torch, plain1, V, 512, dim=1), 1)
    bytes1 = packed_all.numel() + masks.numel() * 4 + k1.numel() * 4
    rows.append(dict(name="geno_counts", source="plink_torch/csrc/geno_counts.cu",
                     replaces="plink_tpu/ops/counts.py:98",
                     max_abs_err=float(err1), tol=0.0, ms=ms1, plain_ms=pms1,
                     bound_ms=1e3 * bytes1 / HBM_BYTES_PER_S, bound_by="bytes",
                     library_ms=None))
    log(f"K1 geno_counts [{packed_all.shape[0]}x{packed_all.shape[1]}B, G=3]: "
        f"exact; {ms1:.3f} ms, plain {pms1:.1f} ms")

    # K2 on block 0, against the plain version in f32 and in f64
    gw = torch.zeros((vb, 3), dtype=torch.float32, device=dev)
    gw[:, 0], gw[:, 1] = 1.0, 2.0  # ADD with A1 = ALT
    gwm = torch.stack([gw, gw], dim=1).contiguous()
    feat64 = feat.double()
    k2 = G.glm_moments(pk, gwm, feat)
    plain2 = lambda sl: G.glm_moments_plain(pk[sl], gwm[sl], feat)  # noqa: E731
    p2 = chunked(torch, plain2, vb, 256)
    r2 = chunked(torch, lambda sl: G.glm_moments_plain(
        pk[sl], gwm[sl].double(), feat64), vb, 128)
    sc2 = mat_scale(torch, r2)
    e2, e2r, e2pr = (norm_err(torch, a, b, sc2)
                     for a, b in ((k2, p2), (k2, r2), (p2, r2)))
    ints = [0, dc, dc + 1, dc + 2]  # intercept, y, G, ADD: integer sums
    exact2 = bool(torch.equal(k2[:, ints][:, :, ints], p2[:, ints][:, :, ints]))
    assert e2 <= TOL_VS_PLAIN and e2r <= TOL_VS_F64 and exact2, (e2, e2r, exact2)
    ms2 = time_ms(torch, lambda: G.glm_moments(pk, gwm, feat), 5)
    pms2 = time_ms(torch, lambda: chunked(torch, plain2, vb, 256), 1)
    n_valid = float(k2[:, 0, 0].sum())
    D = dc + 3
    valid_f = (pk.unsqueeze(-1) >> torch.arange(0, 8, 2, dtype=torch.uint8,
                                                device=dev) & 3).reshape(vb, -1)
    valid_f = (valid_f != 3).to(torch.float32)
    cy = feat[:, : dc + 1]
    ccfl2 = (cy[:, :, None] * cy[:, None, :]).reshape(-1, (dc + 1) ** 2)
    lib2 = time_ms(torch, lambda: torch.matmul(valid_f, ccfl2), 5)
    ops2 = n_valid * 2 * D * (D + 1) / 2
    bytes2 = pk.numel() + feat.numel() * 4 + gwm.numel() * 4 + k2.numel() * 4
    rows.append(dict(name="glm_moments", source="plink_torch/csrc/glm_moments.cu",
                     replaces="plink_tpu/ops/glm.py:242",
                     max_abs_err=float((k2 - p2).abs().max()), max_norm_err=e2,
                     tol=TOL_VS_PLAIN, max_norm_err_f64=e2r, tol_f64=TOL_VS_F64,
                     ms=ms2, plain_ms=pms2, **_bound(ops2, bytes2),
                     library_ms=lib2))
    log(f"K2 glm_moments [{vb}x{feat.shape[0]}, D={D}]: norm err vs plain "
        f"{e2:.2e} (tol {TOL_VS_PLAIN:g}), vs f64 {e2r:.2e} (tol "
        f"{TOL_VS_F64:g}; plain vs f64 {e2pr:.2e}), integer entries exact; "
        f"{ms2:.3f} ms, plain {pms2:.1f} ms, matmul {lib2:.3f} ms")

    # K4 then K3 from the main path's own start: OLS init solve, one
    # logistic pass at it, and the Firth pass at beta = 0
    idx = list(range(dc)) + [dc + 1]
    h0 = k2[:, idx][:, :, idx].contiguous()
    rhs0 = (G._Z_INIT * (k2[:, idx, dc] - 0.5 * k2[:, idx, 0])).contiguous()
    beta0, _, _ = G.chol_small(h0, rhs=rhs0)
    active = torch.ones(vb, dtype=torch.bool, device=dev)
    vsc = torch.sqrt(torch.diagonal(h0, dim1=1, dim2=2).clamp(min=1e-30)
                     * k2[:, :1, 0])  # |sum r x_j| <= sqrt(sum x_j^2 * obs)

    def k3_check(label, beta, hinv):
        km, kv, kl = G.glm_irls_pass(pk, gw, feat, beta, active, hinv)
        pm, pv, pl = chunked(torch, lambda sl: G.glm_irls_pass_plain(
            pk[sl], gw[sl], feat, beta[sl], active[sl],
            None if hinv is None else hinv[sl]), vb, 256)
        rm, rv, rl = chunked(torch, lambda sl: G.glm_irls_pass_plain(
            pk[sl], gw[sl].double(), feat64, beta[sl].double(), active[sl],
            None if hinv is None else hinv[sl].double()), vb, 128)
        scm = mat_scale(torch, rm)
        em, emr, empr = (norm_err(torch, a, b, scm)
                         for a, b in ((km, pm), (km, rm), (pm, rm)))
        ev, evr = norm_err(torch, kv, pv, vsc), norm_err(torch, kv, rv, vsc)
        el = 0.0 if kl is None else float(((kl - pl).abs() / pl.abs()).max())
        if not (max(em, ev) <= TOL_VS_PLAIN and max(emr, evr) <= TOL_VS_F64
                and el <= TOL_LOGLIK):
            row = int(((km - rm).abs() / scm).amax((1, 2)).argmax())
            raise AssertionError(
                f"K3 {label}: vs plain H {em} vec {ev}, vs f64 H {emr} vec {evr}"
                f", loglik {el}; worst row {row}: obs {float(k2[row, 0, 0])} "
                f"ADD sum {float(k2[row, 0, dc + 2])} beta {beta[row].tolist()}")
        mae = max(float((km - pm).abs().max()), float((kv - pv).abs().max()))
        log(f"K3 glm_irls_pass {label} [{vb}x{feat.shape[0]}, d={d}]: norm err "
            f"vs plain H {em:.2e} vec {ev:.2e}, vs f64 H {emr:.2e} vec "
            f"{evr:.2e} (plain vs f64 H {empr:.2e}), loglik rel {el:.2e}")
        return km, kv, mae, max(em, ev), max(emr, evr)

    H, grad, mae3, err3, err3r = k3_check("logistic", beta0, None)
    zero = torch.zeros((vb, d), dtype=torch.float32, device=dev)
    Hz, _, _ = G.glm_irls_pass(pk, gw, feat, zero, active)
    _, hz_inv, _ = G.chol_small(Hz, inverse=True)
    _, _, mae3f, err3f, err3fr = k3_check("firth2", zero, hz_inv)
    ms3 = time_ms(torch, lambda: G.glm_irls_pass(pk, gw, feat, beta0, active), 5)
    ms3f = time_ms(torch, lambda: G.glm_irls_pass(pk, gw, feat, zero, active,
                                                  hz_inv), 3)
    pms3 = time_ms(torch, lambda: chunked(torch, lambda sl: G.glm_irls_pass_plain(
        pk[sl], gw[sl], feat, beta0[sl], active[sl]), vb, 256), 1)
    c = feat[:, :dc]
    ccfl3 = (c[:, :, None] * c[:, None, :]).reshape(-1, dc * dc)
    lib3 = time_ms(torch, lambda: torch.matmul(valid_f, ccfl3), 5)
    del valid_f
    ntri = d * (d + 1) // 2
    ops3 = n_valid * (2 * ntri + 4 * d + 12)  # H, gradient, eta, p / loglik
    ops3f = n_valid * (4 * ntri + 4 * d + 12)  # + the hat diagonal
    bytes3 = pk.numel() + feat.numel() * 4 + (vb * (d * d + 2 * d + 5)) * 4
    rows.append(dict(name="glm_irls_pass", source="plink_torch/csrc/glm_irls.cu",
                     replaces="plink_tpu/ops/glm.py:328",
                     max_abs_err=max(mae3, mae3f), max_norm_err=max(err3, err3f),
                     tol=TOL_VS_PLAIN, max_norm_err_f64=max(err3r, err3fr),
                     tol_f64=TOL_VS_F64, ms=ms3, plain_ms=pms3,
                     **_bound(ops3, bytes3), library_ms=lib3, firth2_ms=ms3f,
                     firth2_bound_ms=_bound(ops3f, bytes3 + vb * d * d * 4)["bound_ms"]))
    log(f"K3 glm_irls_pass: logistic {ms3:.3f} ms, firth2 {ms3f:.3f} ms, plain "
        f"{pms3:.1f} ms, matmul {lib3:.3f} ms")

    # K4 at [2048, 13, 13] on the logistic Hessian and gradient
    kx, ki, kd = G.chol_small(H, rhs=grad, inverse=True, logdet=True)
    px, pi, pdet = G.chol_small_plain(H, grad, True, True)
    ex = float(((kx - px).abs().amax(1) / px.abs().amax(1)).max())
    ei = float(((ki - pi).abs().amax((1, 2)) / pi.abs().amax((1, 2))).max())
    ed = float(((kd - pdet).abs() / pdet.abs().clamp(min=1.0)).max())
    assert max(ex, ei, ed) <= TOL_CHOL, (ex, ei, ed)
    ms4 = time_ms(torch, lambda: G.chol_small(H, rhs=grad, inverse=True,
                                              logdet=True), 50)
    pms4 = time_ms(torch, lambda: G.chol_small_plain(H, grad, True, True), 3)
    lib4 = time_ms(torch, lambda: torch.linalg.inv(H), 50)
    ops4 = vb * (d ** 3 / 3 + 2 * d * d + d ** 3)  # factor, solve, inverse
    bytes4 = vb * (2 * d * d + 2 * d + 1) * 4
    rows.append(dict(name="chol_small", source="plink_torch/csrc/chol_small.cu",
                     replaces="plink_tpu/ops/glm.py:125",
                     max_abs_err=float(max((kx - px).abs().max(), (ki - pi).abs().max())),
                     max_norm_err=max(ex, ei, ed), tol=TOL_CHOL, ms=ms4,
                     plain_ms=pms4, **_bound(ops4, bytes4), library_ms=lib4))
    log(f"K4 chol_small [{vb},{d},{d}]: rel err solve {ex:.2e} inverse {ei:.2e} "
        f"logdet {ed:.2e} (tol {TOL_CHOL:g}); {ms4:.4f} ms, plain {pms4:.2f} ms, "
        f"linalg.inv {lib4:.4f} ms")
    return rows


def _bound(ops, nbytes):
    t_ops = 1e3 * ops / FP32_FLOP_PER_S
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def read_report(path, limit=None):
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        hdr = f.readline().rstrip("\n").split("\t")
        rows = [ln.rstrip("\n").split("\t") for ln, _ in zip(f, range(
            limit if limit is not None else 1 << 62))]
    return hdr, rows


def write_golden():
    import zstandard

    with open(GOLDEN_SRC, "rb") as f:
        text = zstandard.ZstdDecompressor().stream_reader(f).read().decode()
    with open(GOLDEN, "wb") as raw, \
            gzip.GzipFile(fileobj=raw, mode="wb", mtime=0) as g:
        g.write(text.encode())


def float_allowed(col, y):
    """bench.py's GLM parity rule for P; OR and SE relative; Z relative to
    max(|Z|, 1), as a Z near 0 comes from a beta near 0 whose f32 noise is
    large relative to itself."""
    if col == "P":
        return GLM_FLOAT_RTOL * max(1e-8, abs(y)) + 1e-9
    return GLM_FLOAT_RTOL * (max(abs(y), 1.0) if col == "Z_STAT" else abs(y))


def compare_reports(a, b):
    """Every column of report `a` against the same rows of `b`: exact, except
    OR / SE / Z / P within float_allowed.  Returns the largest float
    difference as a fraction of what is allowed (<= 1)."""
    ha, ra = read_report(a)
    hb, rb = read_report(b, limit=len(ra))
    assert ha == hb and len(ra) == len(rb), (a, b, ha, hb, len(ra), len(rb))
    floats = {"OR", "LOG(OR)_SE", "Z_STAT", "P"}
    worst, bad = 0.0, []
    for x, y in zip(ra, rb):
        for col, u, v in zip(ha, x, y):
            if col in floats and u != "NA" and v != "NA":
                frac = abs(float(u) - float(v)) / float_allowed(col, float(v))
                worst = max(worst, frac)
                ok = frac <= 1.0
            else:
                ok = u == v
            if not ok:
                bad.append((col, x, y))
    assert not bad, f"{len(bad)} cells differ; first: {bad[:3]}"
    return worst


def run_main_path(torch, prefix, out, card, n_variants):
    from plink_torch import cli
    from plink_torch.ops import _cuda

    argv = ["--pfile", prefix, "--glm", "hide-covar", "--covar",
            prefix + ".cov", "--out", out, "--silent"]
    os.environ["PLINK_TORCH_TIMING"] = "1"
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        os.environ.pop("PLINK_TORCH_TIMING")
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    assert rc == 0, rc
    with open(out + ".log") as f:
        for ln in f:
            if ln.startswith(("[timing]", "[phase]")):
                log("  " + ln.rstrip())
    hdr, rows = read_report(out + ".PHENO1.glm.logistic.hybrid")
    assert len(rows) == n_variants, len(rows)
    ie, ifi = hdr.index("ERRCODE"), hdr.index("FIRTH?")
    errs = {}
    for r in rows:
        assert r[ifi] in ("Y", "N"), r
        errs[r[ie]] = errs.get(r[ie], 0) + 1
    ip = hdr.index("P")
    finite = sum(1 for r in rows if r[ip] != "NA" and math.isfinite(float(r[ip])))
    assert finite > 0.9 * n_variants, finite
    assert all(v > 0 for v in launches.values()), launches
    log(f"main path: {N_SAMPLES} samples x {n_variants} variants, d=13: "
        f"{wall:.2f}s wall, {n_variants / wall:.0f} variants/s on {card}; "
        f"ERRCODE {errs}; launches {launches}")
    worst = compare_reports(out + ".PHENO1.glm.logistic.hybrid", GOLDEN)
    log(f"main path = plink2 ({os.path.basename(GOLDEN_SRC)}, first "
        f"{n_variants} rows): exact columns equal, floats within "
        f"{worst:.2f} of their tolerance")
    return launches


def trace_main_path(torch, prefix, out):
    """The main path once more under torch.profiler: the card's busy time
    (kernels and copies, one stream) against the wall, and the kernels that
    take it."""
    from torch.profiler import ProfilerActivity, profile

    from plink_torch import cli

    argv = ["--pfile", prefix, "--glm", "hide-covar", "--covar",
            prefix + ".cov", "--out", out, "--silent"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        assert cli.main(argv) == 0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, by_name = 0.0, {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = evt.time_range.elapsed_us()
            busy += us
            name = re.sub(r"^void |\(anonymous namespace\)::|[<(].*$", "",
                          evt.name)
            by_name[name] = by_name.get(name, 0.0) + us
    assert busy > 0, "the trace saw no device work"
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"trace: wall {wall:.3f}s (under the profiler), device busy "
        f"{busy / 1e6:.3f}s, idle {100 * (1 - busy / 1e6 / wall):.1f}%; "
        + ", ".join(f"{k} {v / 1e3:.1f} ms" for k, v in top))


def run_parity(tmp):
    from plink_torch import cli

    n, m, seed = SMALL
    prefix = os.path.join(tmp, "small")
    make_panel(prefix, n, m, seed)
    os.environ["PLINK_TORCH_VB"] = "256"
    try:
        for mod, ext in ((None, "glm.logistic.hybrid"), ("firth", "glm.firth")):
            mods = ["hide-covar"] + ([mod] if mod else [])
            outs = {}
            for tag, devname in (("cuda1", "cuda"), ("cpu", "cpu"),
                                 ("cuda2", "cuda")):
                os.environ["PLINK_TORCH_DEVICE"] = devname
                out = os.path.join(tmp, f"{tag}_{mod}")
                rc = cli.main(["--pfile", prefix, "--glm", *mods, "--covar",
                               prefix + ".cov", "--out", out, "--silent"])
                assert rc == 0, (tag, rc)
                outs[tag] = f"{out}.PHENO1.{ext}"
            worst = compare_reports(outs["cuda1"], outs["cpu"])
            with open(outs["cuda1"], "rb") as f1, open(outs["cuda2"], "rb") as f2:
                assert f1.read() == f2.read(), "two CUDA runs differ"
            hdr, rows = read_report(outs["cuda1"])
            firth_y = 0
            if "FIRTH?" in hdr:
                firth_y = sum(r[hdr.index("FIRTH?")] == "Y" for r in rows)
                assert firth_y > 0, "no Firth fallback row on the parity panel"
            log(f"parity {ext} [{n}x{m}]: CUDA = CPU (exact columns, floats "
                f"within {worst:.2f} of their tolerance), two CUDA runs "
                f"byte-identical, FIRTH?=Y rows {firth_y}")
    finally:
        os.environ.pop("PLINK_TORCH_VB", None)
        os.environ.pop("PLINK_TORCH_DEVICE", None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", type=int, default=N_VARIANTS,
                    help="variants of the main path's panel (<= 16,384)")
    ap.add_argument("--write-golden", action="store_true",
                    help=f"rewrite {os.path.basename(GOLDEN)} from "
                         "bench_golden (needs zstandard; no card) and exit")
    args = ap.parse_args(argv)
    if args.write_golden:
        write_golden()
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    if not os.path.isdir(os.path.join(HERE, "plink_torch")):
        print("chip_smoke: the plink_torch package is not beside this script",
              file=sys.stderr)
        return 1
    dev, card = card_report(torch)
    build()
    tmp = tempfile.mkdtemp(prefix="plink_torch_smoke_")
    try:
        prefix = os.path.join(tmp, "panel")
        t0 = time.perf_counter()
        make_panel(prefix, N_SAMPLES, args.variants, 42)
        log(f"panel {N_SAMPLES}x{args.variants}: {time.perf_counter() - t0:.1f}s")
        rows = check_kernels(torch, dev, prefix)
        torch.cuda.empty_cache()
        launches = run_main_path(torch, prefix, os.path.join(tmp, "main"),
                                 card, args.variants)
        trace_main_path(torch, prefix, os.path.join(tmp, "traced"))
        run_parity(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lib_names = {"glm_irls_pass": "glm_irls"}
    for r in rows:
        r["route"] = "cuda"
        r["launches"] = launches.get(lib_names.get(r["name"], r["name"]), 0)
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
