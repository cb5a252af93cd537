"""plink_torch: the plink_tpu GWAS engine ported to PyTorch and CUDA.

Same CLI flags, filesets and report files as plink_tpu; the device work runs
in hand-written CUDA kernels (csrc/) on an NVIDIA Hopper card, each with a
plain PyTorch version beside it that runs on the CPU.

Entry points run on the CUDA device.  PLINK_TORCH_DEVICE=cpu asks for the
CPU (the plain versions); without a CUDA device and without that request,
`resolve_device` raises instead of carrying on quietly on the CPU.
"""

import os

__version__ = "0.1.0"


class DeviceError(RuntimeError):
    """No usable device for the run."""


class NotPortedError(ValueError):
    """A flag, modifier or input that plink_torch does not run yet."""


def resolve_device():
    """The run's torch.device: cuda unless PLINK_TORCH_DEVICE=cpu.  Turns
    TF32 off for float32 products on the card."""
    import torch

    want = os.environ.get("PLINK_TORCH_DEVICE", "cuda")
    if want == "cpu":
        return torch.device("cpu")
    if want != "cuda":
        raise DeviceError(f"PLINK_TORCH_DEVICE must be 'cuda' or 'cpu', not {want!r}")
    if not torch.cuda.is_available():
        raise DeviceError(
            "no CUDA device is available; plink_torch runs on an NVIDIA GPU "
            "(set PLINK_TORCH_DEVICE=cpu to run the plain PyTorch versions "
            "on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")
