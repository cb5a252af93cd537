"""Where the int8 plane Grams' time goes on the card: K7 king_gram
(plink_torch/csrc/king_gram.cu) and K13 ld_gram_pair (csrc/ld_gram.cu).

Builds each kernel as it is and with parts of its stage loop taken out (the
sources' K7_CUT_* / K13_CUT_* macros: the copies of later stages, the plane
decode, the wgmmas, K13's output stores, K7's whole second kernel), and K13
with its sample split capped at 4 or 8 instead of 6 (K13_MAX_SPLITS), each
with nvcc into a temporary directory, and times every build through its C
entry point with the outputs allocated once:

- K7 on one 2,048 x 2,048 tile of a 50,000-sample panel over 32,768
  variants (bench.py's king_50k shape, chip_smoke's phase 6), stats mode;
- K13 on 512 x 512 (the `--r` matrix) and 256 x 256 (the `--r2-phased`
  table) chunk pairs of 10,000 samples (indep_10k: 2,500 code bytes a row,
  so windows of aligned 16-byte pieces), and 512 x 512 at 10,240 samples
  (rows 16-byte aligned); the builds that leave nothing out (the kernel,
  the other caps) are also held to the plain version, and timed on the
  device alone (torch.profiler) beside the host's time to enqueue a launch.

Random codes; a build with a part taken out computes wrong counts, only its
time is read.  Then the wrappers as the port calls them (`king_gram`,
`ld_gram_pair`: Python, scratch and outputs allocated per call), beside the
library calls chip_smoke times.

Needs the card and nvcc; run from the repository root (~1.5 minutes with
its builds):

    python3 tools/gram_breakdown.py
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from plink_torch.ops import _cuda  # noqa: E402
from plink_torch.ops import ld as LD  # noqa: E402
from plink_torch.ops import pairwise as P  # noqa: E402

# (kernel, build name): macros
BUILDS = {
    ("king_gram", "kernel"): [],
    ("king_gram", "no copies after the first stages"): ["K7_CUT_COPIES"],
    ("king_gram", "no decode"): ["K7_CUT_DECODE"],
    ("king_gram", "no wgmma"): ["K7_CUT_WGMMA"],
    ("king_gram", "wgmma only"): ["K7_CUT_COPIES", "K7_CUT_DECODE"],
    ("king_gram", "loop only"): ["K7_CUT_COPIES", "K7_CUT_DECODE", "K7_CUT_WGMMA"],
    ("king_gram", "transpose pass only"): ["K7_CUT_GRAM"],
    ("ld_gram_pair", "kernel"): [],
    ("ld_gram_pair", "no copies after the first stages"): ["K13_CUT_COPIES"],
    ("ld_gram_pair", "no decode"): ["K13_CUT_DECODE"],
    ("ld_gram_pair", "no wgmma"): ["K13_CUT_WGMMA"],
    ("ld_gram_pair", "no output stores"): ["K13_CUT_STORE"],
    ("ld_gram_pair", "wgmma only"): ["K13_CUT_COPIES", "K13_CUT_DECODE",
                                     "K13_CUT_STORE"],
    ("ld_gram_pair", "loop only"): ["K13_CUT_COPIES", "K13_CUT_DECODE",
                                    "K13_CUT_WGMMA", "K13_CUT_STORE"],
    ("ld_gram_pair", "at most 4 splits"): ["K13_MAX_SPLITS=4"],
    ("ld_gram_pair", "at most 8 splits"): ["K13_MAX_SPLITS=8"],
}
# builds whose counts are right: held to the plain version on every case,
# and timed on the device alone (the profiler's kernel time) beside the
# host's time to enqueue a launch
EXACT = ("kernel", "at most 4 splits", "at most 8 splits")


def build(tmp):
    """One nvcc per build, all at once; -> {(kernel, name): C entry point}."""
    procs = {}
    for i, ((kern, name), macros) in enumerate(BUILDS.items()):
        so = os.path.join(tmp, f"{kern}_{i}.so")
        src = os.path.join(_cuda._CSRC, _cuda._SOURCE.get(kern, kern) + ".cu")
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *[f"-D{m}" for m in macros],
               "-o", so, src]
        procs[kern, name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT), so)
    entries = {}
    for key, (proc, so) in procs.items():
        out = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        fn = getattr(ctypes.CDLL(so), _cuda._ENTRY[key[0]][0])
        fn.argtypes = _cuda._ENTRY[key[0]][1]
        fn.restype = ctypes.c_int
        entries[key] = fn
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


def device_us(fn, reps=50):
    """Mean device time of the kernels `fn` launches (the profiler's CUDA
    time a call), and the host's time to enqueue one call, in us."""
    import time

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


def rand_codes(rows, nb, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 256, (rows, nb), dtype=torch.uint8, device="cuda", generator=g)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    # K7: one tile of king_50k
    n, V, s = 50_000, 32_768, 2048
    pk = rand_codes(V, n // 4, 1).reshape(16, 2048, -1)
    vm = torch.ones((16, 2048), dtype=torch.int8, device=dev)
    codes = torch.empty(2 * s * V // 4, dtype=torch.uint8, device=dev)
    outs = [torch.empty((s, s), dtype=dt, device=dev)
            for dt in (torch.float64, torch.int32, torch.int32, torch.int32, torch.uint8)]
    pct = torch.zeros(1, dtype=torch.int32, device=dev)

    def k7(fn):
        rc = fn(pk.data_ptr(), n // 4, V, vm.data_ptr(), 0, s, 0, s, n, 0.0442, 0,
                codes.data_ptr(), *(o.data_ptr() for o in outs), pct.data_ptr(), None,
                stream())
        assert rc == 0, rc

    # K13: chunk pairs
    k13_cases = []
    for c, nn in ((512, 10_000), (256, 10_000), (512, 10_240)):
        rows = rand_codes(2 * c, nn // 4, c + nn)
        sm = torch.ones(nn, dtype=torch.int8, device=dev)
        g = torch.empty((3 * c, 3 * c), dtype=torch.int32, device=dev)
        k13_cases.append((c, nn, rows[:c], rows[c:], sm, g))

    def k13(fn, case):
        c, nn, pa, pb, sm, g = case
        rc = fn(pa.data_ptr(), c, pb.data_ptr(), c, nn // 4, sm.data_ptr(), nn,
                g.data_ptr(), stream())
        assert rc == 0, rc

    with tempfile.TemporaryDirectory() as tmp:
        entries = build(tmp)
        for (kern, name), fn in entries.items():
            if kern == "king_gram":
                ms = time_ms(lambda: k7(fn), 10)
                same = ""
                if name in EXACT:
                    ref = P.king_gram_plain(pk, vm, 0, 0, s, s, n=n, thresh=0.0442)
                    ok = (outs[0].cpu().numpy().tobytes() == ref[0].cpu().numpy().tobytes()
                          and all(torch.equal(a, b.to(a.dtype))
                                  for a, b in zip(outs[1:], ref[1:5])))
                    same = ", = plain" if ok else ", DIFFERS from plain"
                print(f"K7 {name}: {ms:.4f} ms [{s}x{s} tile, V={V}, n={n}]{same}",
                      flush=True)
                continue
            for case in k13_cases:
                ms = time_ms(lambda: k13(fn, case), 200)
                same = ""
                if name in EXACT:
                    c, nn, pa, pb, sm, g = case
                    same = (", = plain" if torch.equal(g, LD.ld_gram_pair_plain(pa, pb, sm))
                            else ", DIFFERS from plain")
                    dev_us, host_us = device_us(lambda: k13(fn, case))
                    same += f"; device {dev_us:.1f} us, enqueue {host_us:.1f} us"
                print(f"K13 {name}: {ms:.4f} ms [{case[0]}x{case[0]} chunks, "
                      f"n={case[1]}]{same}", flush=True)
    ms = time_ms(lambda: P.king_gram(pk, vm, 0, 0, s, s, n=n, thresh=0.0442), 10)
    print(f"K7 through its wrapper: {ms:.4f} ms", flush=True)
    for c, nn, pa, pb, sm, _ in k13_cases:
        ms = time_ms(lambda: LD.ld_gram_pair(pa, pb, sm), 200)
        qa = LD._planes_rav(pa, sm).to(torch.bfloat16)[None]
        qb = LD._planes_rav(pb, sm).to(torch.bfloat16).t()[None]
        lib = time_ms(lambda: torch.bmm(qa, qb, out_dtype=torch.float32), 200)
        dev_w, host_w = device_us(lambda: LD.ld_gram_pair(pa, pb, sm))
        dev_l, host_l = device_us(lambda: torch.bmm(qa, qb, out_dtype=torch.float32))
        print(f"K13 wrapper: device {dev_w:.1f} us, enqueue {host_w:.1f} us; bmm: device "
              f"{dev_l:.1f} us, enqueue {host_l:.1f} us", flush=True)
        print(f"K13 through its wrapper: {ms:.4f} ms, bf16 bmm {lib:.4f} ms "
              f"[{c}x{c}, n={nn}]", flush=True)


if __name__ == "__main__":
    main()
