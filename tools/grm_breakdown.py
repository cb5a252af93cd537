"""Where K8's and K20's time goes on the card: K8 grm_gram
(plink_torch/csrc/grm_gram.cu) and K20 linear_perm_stat
(csrc/linear_perm.cu).

K8, at chip_smoke's phase-6 shape (one 2,048 x 8,192 chunk of the GRM over
32,768 variants: rows the last 2,048 of 10,240 samples, columns the last
8,192, so the chunk holds the diagonal; random codes at allele frequencies
U(0.01, 0.5) and 2% missing, plink2's coefficients, 3% of the variants out
of vmask):

- builds the kernel as it is, with parts of its stage loop taken out (the
  source's K8_CUT_* macros: the decode of the B planes and the A
  fragments, the wgmmas, the jm product, the f64 flushes), and patched
  copies of the source with another scheme (PATCHES: f32 runs of 256 to
  2,048 variants, all nine bf16 part products, stages of 64 and 32
  variants), each with nvcc into a temporary directory, and times every
  build through its C entry point, outputs allocated once, by CUDA events
  and on the device alone (torch.profiler);
- holds the kernel and each scheme against the plain version in f64: each
  entry's error as a share of sqrt(sum Z_i^2 sum Z_j^2) (chip_smoke's K8
  measure, TOL_K8 = 2e-6), the diagonal's mean signed error beside it;
- the margin of chip_smoke's .grm.bin parity case (CUDA against the CPU's
  plain version, GRM_BIN_ATOL = 2e-6 absolute on g = acc / nm): on
  2,000-sample panels of that case's generator at 800 and 1,200 variants
  and seeds 1 to 3, the largest |g| difference of the kernel (runs of
  128), of the 256-variant patch and of the parent's kernel (with
  --parent) from the CPU's g and from f64;
- with --parent DIR (a copy of an earlier tree), builds DIR's grm_gram.cu
  and linear_perm.cu too and times them in the same call.

K20, at chip_smoke's phase-3e shapes (2,048 variants, B = 134
permutations; d = 13, the additive model; d = 14, q = 2, genotypic; d =
24, `interaction`): its device time (torch.profiler) through its C entry
point and through the wrapper (`linear_perm_stat`, its CUDA-event time and
its host enqueue time a call), beside `torch.bmm(inv, xty)`'s.

Needs the card and nvcc; run from the repository root (~2 minutes with its
builds; `--only k8` or `--only k20` times one kernel, `--only margin`
measures only the parity margin):

    python3 tools/grm_breakdown.py [--parent DIR] [--only k8|k20|margin]
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from plink_torch.ops import _cuda  # noqa: E402
from plink_torch.ops import glm as G  # noqa: E402
from plink_torch.ops import pairwise as P  # noqa: E402

# name: the parts of K8's stage loop left out (its K8_CUT_* hooks)
BUILDS = {
    "kernel": [],
    "no decode": ["K8_CUT_DECODE"],
    "no wgmma": ["K8_CUT_WGMMA"],
    "no jm product": ["K8_CUT_JM"],
    "no f64 flushes": ["K8_CUT_FLUSH"],
    "wgmma only": ["K8_CUT_DECODE", "K8_CUT_FLUSH"],
    "loop only": ["K8_CUT_DECODE", "K8_CUT_WGMMA", "K8_CUT_FLUSH"],
}
# name: (text of grm_gram.cu, its replacement) -- other schemes, built from
# patched copies of the source
_RUN = "constexpr int kRun = 128;"
_LAST = "  hop::wgmma_m64n64k16_bf16_rs(small, a[2], d[0]);\n"
_NINE = _LAST + "".join(f"  hop::wgmma_m64n64k16_bf16_rs(small, a[{i}], d[{j}]);\n"
                        for i, j in ((1, 2), (2, 1), (2, 2)))
PATCHES = {
    **{f"runs of {r}": [(_RUN, f"constexpr int kRun = {r};")]
       for r in (256, 512, 1024, 2048)},
    "nine products": [(_LAST, _NINE)],
    "nine products, runs of 256": [(_LAST, _NINE), (_RUN, "constexpr int kRun = 256;")],
    "64-variant stages": [("constexpr int kKT = 128;", "constexpr int kKT = 64;")],
    "32-variant stages": [("constexpr int kKT = 128;", "constexpr int kKT = 32;")],
}


def _entry(so, name):
    fn = getattr(ctypes.CDLL(so), _cuda._ENTRY[name][0])
    fn.argtypes = _cuda._ENTRY[name][1]
    fn.restype = ctypes.c_int
    return fn


def patched(tmp, name, edits):
    """A copy of grm_gram.cu with `edits` applied, beside the headers it
    includes."""
    src = open(os.path.join(_cuda._CSRC, "grm_gram.cu")).read()
    for old, new in edits:
        assert src.count(old) == 1, (name, old)
        src = src.replace(old, new)
    path = os.path.join(tmp, "k8_" + "".join(c if c.isalnum() else "_" for c in name)
                        + ".cu")
    with open(path, "w") as f:
        f.write(src)
    return path


def build(tmp, parent, keep=None):
    """One nvcc per build (those named in `keep`, else all), all at once;
    -> {name: C entry point}."""
    jobs = {f"K8 {name}": ("grm_gram", os.path.join(_cuda._CSRC, "grm_gram.cu"),
                           [f"-D{m}" for m in cuts])
            for name, cuts in BUILDS.items()}
    jobs.update({f"K8 {name}": ("grm_gram", patched(tmp, name, edits), [])
                 for name, edits in PATCHES.items()})
    if parent:
        csrc = os.path.join(parent, "plink_torch", "csrc")
        jobs["K8 parent"] = ("grm_gram", os.path.join(csrc, "grm_gram.cu"), [])
        jobs["K20 parent"] = ("linear_perm_stat", os.path.join(csrc, "linear_perm.cu"), [])
    if keep is not None:
        jobs = {k: v for k, v in jobs.items() if k in keep}
    procs = {}
    for i, (key, (_, src, macros)) in enumerate(jobs.items()):
        so = os.path.join(tmp, f"b{i}.so")
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-I{_cuda._CSRC}", *macros, "-o",
               so, src]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT), so)
    entries = {}
    for key, (proc, so) in procs.items():
        out = proc.communicate()[0].decode()
        if proc.returncode:  # a build with a part cut out may not compile
            if key == "K8 kernel" or "parent" in key or keep is not None:
                raise RuntimeError(f"nvcc failed for {key}:\n{out}")
            print(f"{key}: nvcc failed ({out.strip().splitlines()[-1]})", flush=True)
            continue
        if key == "K8 kernel":
            for line in out.splitlines():
                if "grm_gram_kernel" in line or "registers" in line or "spill" in line \
                        or "C75" in line:
                    print("  ptxas:", line.strip(), flush=True)
        entries[key] = _entry(so, jobs[key][0])
    return entries


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def device_us(fn, reps):
    """Mean device time of the kernels `fn` launches (the profiler's CUDA
    time a call), and the host's time to enqueue one call, in us."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = sum(e.self_device_time_total for e in prof.key_averages()) / reps
    return dev, host


def grm_panel(dev, npad=10_240, V=32_768, vb=2048, seed=5):
    """Packed codes [V // vb, vb, npad // 4], vmask, coef and K5's missing
    counts of a random panel."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.rand(V, 1, device=dev, generator=g) * 0.49 + 0.01
    codes = ((torch.rand(V, npad, device=dev, generator=g) < p).to(torch.uint8)
             + (torch.rand(V, npad, device=dev, generator=g) < p).to(torch.uint8))
    codes[torch.rand(V, npad, device=dev, generator=g) < 0.02] = 3
    codes = codes.reshape(V, npad // 4, 4)
    packed = (codes[..., 0] | codes[..., 1] << 2 | codes[..., 2] << 4
              | codes[..., 3] << 6).reshape(V // vb, vb, npad // 4).contiguous()
    del codes
    vm = (torch.rand(V, device=dev, generator=g) >= 0.03)
    freq = p[:, 0].double().cpu().numpy()
    coef = torch.from_numpy(P.grm_coefs(freq, freq < 0, vm.cpu().numpy())).to(dev)
    vmask = vm.to(torch.int8).reshape(V // vb, vb).contiguous()
    coef = coef.reshape(V // vb, vb, 3).contiguous()
    miss = P.sample_miss_counts(packed, vmask)
    return packed, vmask, coef, miss, int(vm.sum())


def k8(args_parent):
    dev = torch.device("cuda")
    packed, vmask, coef, miss, mv = grm_panel(dev)
    npad, V = packed.shape[2] * 4, packed.shape[0] * packed.shape[1]
    s, c = 2048, 8192
    r0, c0 = npad - s, npad - c
    acc = torch.empty((s, c), dtype=torch.float64, device=dev)
    cnt = torch.empty((s, c), dtype=torch.int32, device=dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def launch(fn, mode=1):
        rc = fn(packed.data_ptr(), npad // 4, V, vmask.data_ptr(), coef.data_ptr(),
                miss.data_ptr(), mv, r0, s, c0, c, mode, acc.data_ptr(), cnt.data_ptr(),
                stream())
        assert rc == 0, rc

    ref, rnm = P.grm_gram_plain(packed, coef.double(), vmask, miss, mv, r0, c0, s, c,
                                tile=True)
    flat = packed.reshape(V, -1)
    d = torch.zeros(npad, dtype=torch.float64, device=dev)
    c2 = coef.reshape(-1, 3).double() ** 2
    for v0 in range(0, V, 1024):
        cd = P.unpack_codes(flat[v0 : v0 + 1024]).long()
        d += torch.where(cd == 3, 0.0, torch.gather(c2[v0 : v0 + 1024], 1,
                                                    cd.clamp(max=2))).sum(0)
    scale = torch.sqrt(d[r0 : r0 + s, None] * d[None, c0 : c0 + c]).clamp(min=1e-30)
    diag = torch.arange(s, device=dev)
    dcol = diag + (r0 - c0)

    def errs(a):
        e = float(((a - ref).abs() / scale).max())
        dg = float(((a - ref)[diag, dcol] / scale[diag, dcol]).mean())
        return e, dg

    pacc, _ = P.grm_gram_plain(packed, coef, vmask, miss, mv, r0, c0, s, c, tile=True)
    e, dg = errs(pacc)
    print(f"K8 plain version (f32 products a 2,048-variant block, f64 across): "
          f"max norm err vs f64 {e:.3e}, diagonal mean {dg:.3e}", flush=True)
    del pacc
    with tempfile.TemporaryDirectory() as tmp:
        entries = build(tmp, args_parent)
        launch(entries["K8 kernel"])
        first = acc.clone()
        launch(entries["K8 kernel"])
        assert torch.equal(first, acc), "K8: two runs differ"
        del first
        for key, fn in entries.items():
            if not key.startswith("K8"):
                continue
            launch(fn)
            torch.cuda.synchronize()
            scheme = key == "K8 kernel" or key[3:] in PATCHES
            if scheme:  # a cut build's sums are wrong by design
                e, dg = errs(acc)
                assert torch.equal(cnt, rnm), f"{key}: pair counts differ from plain"
            ms = time_ms(lambda fn=fn: launch(fn), 3)
            dev_us, _ = device_us(lambda fn=fn: launch(fn), 3)
            print(f"{key}: {ms:.3f} ms (device {dev_us / 1e3:.3f} ms) [{s}x{c} chunk, "
                  f"V={V}]" + (f"; max norm err vs f64 {e:.3e}, diagonal mean "
                               f"{dg:.3e}" if scheme else ""), flush=True)
        del ref, rnm, scale
        zr = torch.empty((V, s), dtype=torch.float32, device=dev)
        zc = torch.empty((V, c), dtype=torch.float32, device=dev)
        cf = coef.reshape(-1, 3)
        for v0 in range(0, V, 1024):
            for a0, w, out in ((r0, s, zr), (c0, c, zc)):
                cd = P.unpack_codes(flat[v0 : v0 + 1024, a0 // 4 : (a0 + w) // 4]).long()
                z = torch.gather(cf[v0 : v0 + 1024], 1, cd.clamp(max=2))
                out[v0 : v0 + 1024] = torch.where(cd == 3, 0.0, z)
        lib = time_ms(lambda: torch.matmul(zr.t(), zc), 3)
        print(f"K8 yardstick, f32 torch.matmul of the decoded planes (TF32 off): "
              f"{lib:.3f} ms", flush=True)
        del zr, zc, acc, cnt
        torch.cuda.empty_cache()
        grm_parity_margin(entries)
        return entries


MARGIN_BUILDS = ("K8 runs of 256", "K8 parent")


def grm_parity_margin(entries, n=2000, tile=512):
    """chip_smoke's .grm.bin parity case, entry by entry: g = acc / nm of
    the kernel (f32 runs of 128), of its 256-variant patch and of the
    parent's kernel where built (MARGIN_BUILDS in `entries`) against the
    CPU's plain version (f32 products a block, what the case's CPU run
    writes) and against f64, over the lower triangle of n samples of the
    case's panel generator."""
    from types import SimpleNamespace

    from plink_torch.bench_gen import gen_panel
    from plink_torch.commands.grm import _grm_setup
    from plink_torch.dataset import load_dataset

    os.environ["PLINK_TORCH_TILE"] = str(tile)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        for m in (800, 1200):
            for seed in (1, 2, 3):
                prefix = os.path.join(tmp, f"p{m}_{seed}")
                gen_panel(prefix, n, m, miss_rate=0.02, seed=seed)
                ds = load_dataset(prefix, torch.device("cpu"))
                pd, coef, miss = _grm_setup(ds, SimpleNamespace(nonfounders=False))
                mv, npad = int(pd.variant_ct), pd.npad
                gcpu, nm = P.grm_gram(pd.packed, coef, pd.vmask, miss, mv, 0, 0, npad,
                                      npad)
                a64, n64 = P.grm_gram_plain(pd.packed, coef.double(), pd.vmask, miss,
                                            mv, 0, 0, npad, npad, tile=True)
                g64 = a64 / n64
                args = [t.to(dev) for t in (pd.packed, coef, pd.vmask, miss)]
                g128, nm128 = P.grm_gram(args[0], args[1], args[2], args[3], mv, 0, 0,
                                         npad, npad)
                gs = {"runs of 128": g128}
                for key in MARGIN_BUILDS:
                    if key not in entries:
                        continue
                    g, cnt = torch.empty_like(g128), torch.empty_like(nm128)
                    rc = entries[key](args[0].data_ptr(), npad // 4,
                                      args[0].shape[0] * args[0].shape[1],
                                      args[2].data_ptr(), args[1].data_ptr(),
                                      args[3].data_ptr(), mv, 0, npad, 0, npad, 0,
                                      g.data_ptr(), cnt.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
                    assert rc == 0, rc
                    assert torch.equal(cnt.cpu(), nm), key
                    gs[key[3:]] = g
                low = torch.tril(torch.ones(n, n, dtype=torch.bool))
                assert torch.equal(nm128.cpu(), nm)

                def worst(g, want):
                    dlt = (g.cpu().double()[:n, :n] - want.double()[:n, :n]).abs()
                    return float(dlt[low].max()), float(dlt.diagonal().max())

                out = []
                for tag, g in gs.items():
                    (ec, dc), (ef, _) = worst(g, gcpu), worst(g, g64)
                    out.append(f"{tag}: {ec:.3e} from the CPU (diagonal {dc:.3e}), "
                               f"{ef:.3e} from f64")
                print(f"GRM parity margin [{n}x{m}, seed {seed}; GRM_BIN_ATOL 2e-6; CPU "
                      f"from f64 {worst(gcpu, g64)[0]:.3e}]: " + "; ".join(out),
                      flush=True)
    os.environ.pop("PLINK_TORCH_TILE")


def k20(entries):
    dev = torch.device("cuda")
    vb, B, dc = 2048, 134, 12
    g = torch.Generator(device="cuda").manual_seed(9)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for name, P_, q in (("additive", 1, 0), ("genotypic", 2, 2), ("interaction", dc, 0)):
        d = dc + P_
        a = torch.randn(vb, d, d, device=dev, generator=g)
        inv = (a @ a.transpose(1, 2) / d + torch.eye(d, device=dev)).contiguous()
        inv0 = None
        if q:
            keep = G._kept(d, dc, q)
            inv0 = inv[:, keep][:, :, keep].contiguous()
        xty = torch.randn(vb, d, B, device=dev, generator=g)
        bx = (torch.bmm(inv, xty) * xty).sum(1)  # rss = yy - bx >= 5
        yy = bx + 5.0 + 45.0 * torch.rand(vb, B, device=dev, generator=g)
        nm = torch.full((vb,), 500_000.0, device=dev)
        out = torch.empty((vb, B), dtype=torch.float32, device=dev)
        ref = G.linear_perm_stat_plain(inv.double(), xty.double(), yy.double(),
                                       nm.double(), dc, q,
                                       None if inv0 is None else inv0.double())
        for key in ["kernel"] + [k[4:] for k in entries if k.startswith("K20 ")]:
            fn = (_cuda._lib("linear_perm_stat").pt_linear_perm_stat if key == "kernel"
                  else entries["K20 " + key])

            def call(fn=fn):
                rc = fn(inv.data_ptr(), xty.data_ptr(), yy.data_ptr(), nm.data_ptr(),
                        _cuda.ptr(inv0), vb, d, dc, q, B, out.data_ptr(), stream())
                assert rc == 0, rc
            call()
            torch.cuda.synchronize()
            err = float(((out - ref).abs() / ref.abs().clamp(min=1.0)).max())
            dev_us, host_us = device_us(call, 50)
            print(f"K20 {key} [{name}, d={d}, q={q}, B={B}]: device {dev_us:.2f} us, "
                  f"entry point enqueue {host_us:.2f} us, err vs f64 {err:.2e}",
                  flush=True)
        wrap = lambda: G.linear_perm_stat(inv, xty, yy, nm, dc, q, inv0)  # noqa: E731
        wdev, whost = device_us(wrap, 50)
        wms = time_ms(wrap, 10)
        lib = lambda: torch.bmm(inv, xty)  # noqa: E731
        ldev, lhost = device_us(lib, 50)
        lms = time_ms(lib, 10)
        print(f"K20 wrapper [{name}]: events {wms * 1e3:.2f} us a call (10 calls), "
              f"device {wdev:.2f} us, enqueue {whost:.2f} us; torch.bmm(inv, xty): "
              f"events {lms * 1e3:.2f} us, device {ldev:.2f} us, enqueue "
              f"{lhost:.2f} us", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an earlier tree whose K8 and K20 to time too")
    ap.add_argument("--only", choices=("k8", "k20", "margin"),
                    help="time one kernel only, or only the .grm.bin parity margin")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.only == "margin":
        with tempfile.TemporaryDirectory() as tmp:
            grm_parity_margin(build(tmp, args.parent, MARGIN_BUILDS))
        return
    if args.only != "k20":
        entries = k8(args.parent)
        if args.only != "k8":
            k20(entries)
        return
    with tempfile.TemporaryDirectory() as tmp:
        entries = {}
        if args.parent:
            so = os.path.join(tmp, "k20.so")
            subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", so,
                            os.path.join(args.parent, "plink_torch", "csrc",
                                         "linear_perm.cu")], check=True,
                           capture_output=True)
            entries["K20 parent"] = _entry(so, "linear_perm_stat")
        k20(entries)


if __name__ == "__main__":
    main()
