"""Where K19's time goes on the card (plink_torch/csrc/linear_perm.cu).

Builds the kernel as it is and with parts of its stage loop taken out (the
wgmmas, the plane decode, the Z^T formation, the copies of later stages:
the source's K19_CUT_* macros), each with nvcc into a temporary
directory, and times every build at the shape of chip_smoke's phase 3e:
2,048 variants x 500,000 samples, dc = 12, P = 1, B = 134 permutations
padded to 136 as the permutation paths build Y (`perm_batch_width`),
random codes and data.  A build with a part taken out computes wrong sums;
only its time is read.  Then the kernel on 512 and 1,024 of the variants
(fewer CTAs than the card holds at once), and the drift of the yy row
(valid Y^2, all terms positive) against f64 on 128 variants at f32 runs of
2,048 and 512 samples: the tensor cores truncate as they accumulate.

Needs the card and nvcc; run from the repository root:

    python3 tools/k19_breakdown.py
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from plink_torch.ops import _cuda  # noqa: E402
from plink_torch.ops import glm as G  # noqa: E402

SRC = os.path.join(_cuda._CSRC, "linear_perm.cu")
# name: the parts of the stage loop left out (the kernel's K19_CUT_* hooks)
BUILDS = {
    "kernel": [],
    "no wgmma": ["WGMMA"],
    "no Z formation": ["FORM"],
    "no decode": ["DECODE"],
    "no copies after the first stages": ["COPIES"],
    "wgmma only": ["FORM", "DECODE", "COPIES"],
    "copies only": ["WGMMA", "FORM", "DECODE"],
    "loop only": ["WGMMA", "FORM", "DECODE", "COPIES"],
}


def build(tmp):
    """One nvcc per build, all at once; -> {name: the C entry point}."""
    procs = {}
    for name, cuts in BUILDS.items():
        so = os.path.join(tmp, name.replace(" ", "_") + ".so")
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *[f"-DK19_CUT_{c}" for c in cuts],
               "-o", so, SRC]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), so)
    entries = {}
    for name, (proc, so) in procs.items():
        out = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        fn = getattr(ctypes.CDLL(so), _cuda._ENTRY["linear_perm_xty"][0])
        fn.argtypes = _cuda._ENTRY["linear_perm_xty"][1]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def time_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    vb, n, B, dc = 2048, 500_000, 136, 12
    nb = n // 4
    g = torch.Generator(device="cuda").manual_seed(1)
    packed = torch.randint(0, 256, (vb, nb), dtype=torch.uint8, device=dev, generator=g)
    c = torch.randn(n, dc, device=dev, generator=g)
    c[:, 0] = 1
    mask = (torch.rand(n, device=dev, generator=g) < 0.98).float()
    Y = ((torch.randn(n, B, device=dev, generator=g) * 2 + 1) * mask[:, None]).contiguous()
    gw = torch.tensor([1.0, 2.0, 0.0], device=dev).expand(vb, 1, 3).contiguous()
    xty = torch.empty((vb, dc + 1, B), dtype=torch.float32, device=dev)
    yy = torch.empty((vb, B), dtype=torch.float32, device=dev)
    cj = torch.tensor([-1], dtype=torch.int32, device=dev)

    def launch(fn, run):
        rc = fn(packed.data_ptr(), nb, vb, gw.data_ptr(), 1, c.data_ptr(), dc,
                Y.data_ptr(), B, mask.data_ptr(), cj.data_ptr(), None, run,
                xty.data_ptr(), yy.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc

    with tempfile.TemporaryDirectory() as tmp:
        entries = build(tmp)
        for name, fn in entries.items():
            ms = time_ms(lambda: launch(fn, G._PERM_RUN))
            print(f"K19 {name}: {ms:.3f} ms [{vb}x{n}, P=1, B={B}]", flush=True)
        for v in (512, 1024):  # fewer variant tiles: fewer CTAs than slots
            def part(v=v):
                rc = entries["kernel"](
                    packed.data_ptr(), nb, v, gw.data_ptr(), 1, c.data_ptr(), dc,
                    Y.data_ptr(), B, mask.data_ptr(), cj.data_ptr(), None, G._PERM_RUN,
                    xty.data_ptr(), yy.data_ptr(), torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc
            print(f"K19 kernel on the first {v} variants: {time_ms(part):.3f} ms",
                  flush=True)
        sub = slice(0, 128)
        ref = G.linear_perm_xty_plain(packed[sub], gw[sub].double(), c.double(),
                                      Y.double(), mask.double())[1]
        for run in (2048, G._PERM_RUN):
            launch(entries["kernel"], run)
            rel = (yy[sub].double() - ref) / ref
            print(f"K19 yy drift at {run}-sample f32 runs: max |rel| "
                  f"{float(rel.abs().max()):.3e}, mean {float(rel.mean()):.3e}",
                  flush=True)


if __name__ == "__main__":
    main()
