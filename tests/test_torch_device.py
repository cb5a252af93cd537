"""plink_torch's device choice and its refusals: no quiet CPU fallback, and a
clear "not yet ported" error for everything outside the ported slice."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(args, cwd, device="cpu", extra_env=None):
    env = dict(os.environ)
    env.pop("PLINK_TORCH_DEVICE", None)
    if device:
        env["PLINK_TORCH_DEVICE"] = device
    env["PYTHONPATH"] = REPO
    env.update(extra_env or {})
    return subprocess.run([sys.executable, "-m", "plink_torch.cli", *args],
                          cwd=cwd, env=env, capture_output=True, text=True)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A 40-sample x 24-variant panel with a SEX + 1 covariate file and a
    quantitative phenotype file."""
    from plink_torch.bench_gen import gen_panel, make_cov

    d = tmp_path_factory.mktemp("tiny")
    prefix = str(d / "t")
    gen_panel(prefix, 40, 24, miss_rate=0.05, seed=3)
    make_cov(prefix, 4, n_pcs=1)
    rng = np.random.default_rng(2)
    with open(prefix + ".qt", "w") as f:
        f.write("#IID\tQT1\n")
        for i in range(40):
            f.write(f"per{i}\t{rng.normal():.4f}\n")
    return prefix


def test_no_cuda_refuses_without_cpu_request(tiny, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would go to the card")
    r = _cli(["--pfile", tiny, "--glm", "hide-covar", "--covar", tiny + ".cov",
              "--out", str(tmp_path / "o")], tmp_path, device=None)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and "PLINK_TORCH_DEVICE=cpu" in r.stderr
    assert not os.path.exists(str(tmp_path / "o.PHENO1.glm.logistic.hybrid"))


def _main(args, monkeypatch, capsys, device="cpu"):
    """plink_torch.cli.main in this process: (return code, stderr)."""
    from plink_torch.cli import main

    monkeypatch.setenv("PLINK_TORCH_DEVICE", device)
    rc = main(args)
    return rc, capsys.readouterr().err


def test_bad_device_name_refused(tiny, tmp_path, monkeypatch, capsys):
    rc, err = _main(["--pfile", tiny, "--glm", "--covar", tiny + ".cov",
                     "--out", str(tmp_path / "o")], monkeypatch, capsys, "tpu")
    assert rc != 0 and "PLINK_TORCH_DEVICE" in err


@pytest.mark.parametrize("args", [
    ["--blocks", "no-pheno-req"],
    ["--freq", "cols=+machr2"],
    ["--glm", "interaction", "--covar", "{p}.cov"],
    ["--glm", "cc-residualize", "hide-covar", "--covar", "{p}.cov"],
    ["--glm", "--covar", "{p}.cov", "--maf", "0.01", "--af-pseudocount", "1"],
    ["--glm", "hide-covar", "qt-residualize", "--covar", "{p}.cov", "--pheno",
     "{p}.qt"],
], ids=["blocks", "freq", "interaction", "cc-residualize", "maf-filter",
        "quantitative"])
def test_unported_flag_says_so(tiny, tmp_path, args, monkeypatch, capsys):
    args = [a.format(p=tiny) for a in args]
    rc, err = _main(["--pfile", tiny, *args, "--out", str(tmp_path / "o"),
                     "--silent"], monkeypatch, capsys)
    assert rc != 0
    assert "not yet ported" in err, err[-2000:]


def test_cpu_request_runs_the_glm(tiny, tmp_path, monkeypatch, capsys):
    rc, err = _main(["--pfile", tiny, "--glm", "hide-covar", "--covar",
                     tiny + ".cov", "--out", str(tmp_path / "o"), "--silent"],
                    monkeypatch, capsys)
    assert rc == 0, err[-2000:]
    with open(tmp_path / "o.PHENO1.glm.logistic.hybrid") as f:
        assert len(f.readlines()) == 25


def test_vb_env(monkeypatch):
    from plink_torch.commands.glm import _auto_vb

    monkeypatch.delenv("PLINK_TORCH_VB", raising=False)
    assert _auto_vb(500_000) == 2048
    assert _auto_vb(40_000_000) == 64
    monkeypatch.setenv("PLINK_TORCH_VB", "100")
    assert _auto_vb(500_000) == 96


def test_kernel_entry_argtypes_match_c_signatures():
    """Each kernel entry's ctypes argtypes match its C function's parameters
    (the stream included): a missing pointer type would pass a 64-bit
    pointer as a 32-bit int."""
    import re

    from plink_torch.ops import _cuda

    for name, (fn, argtypes) in _cuda._ENTRY.items():
        src = _cuda._SOURCE.get(name, name)
        with open(os.path.join(_cuda._CSRC, src + ".cu")) as f:
            text = f.read()
        m = re.search(r"PT_EXPORT int " + fn + r"\(([^)]*)\)", text)
        assert m, (name, fn)
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(argtypes), (name, params)
        for p, t in zip(params, argtypes):
            want = (_cuda._P if "*" in p else _cuda._D if p.startswith("double")
                    else _cuda._L if "long long" in p else _cuda._I)
            assert t is want, (name, p, t)
