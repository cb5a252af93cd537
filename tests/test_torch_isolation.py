"""plink_torch stands alone: it imports neither jax nor plink_tpu.

The import check runs in a subprocess because this pytest process's conftest
has already imported jax.
"""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "plink_tpu")


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import plink_torch, plink_torch.cli, plink_torch.pipeline\n"
        "import plink_torch.commands.glm, plink_torch.ops.glm\n"
        "import plink_torch.commands.basic_reports, plink_torch.commands.filters\n"
        "import plink_torch.ops.counts, plink_torch.stats.hwe, plink_torch.stats.hwe_x\n"
        "import plink_torch.bench_gen, plink_torch.ops.pairwise\n"
        "import plink_torch.commands.king, plink_torch.commands.grm\n"
        "import plink_torch.commands.pca, plink_torch.ops.pca\n"
        "import plink_torch.commands.ld, plink_torch.ops.ld\n"
        "import plink_torch.commands.vcor, plink_torch.commands.ld_console\n"
        "import plink_torch.commands.clump, plink_torch.stats.phased_ld\n"
        "import plink_torch.help_data, plink_torch.commands.glm_dosage\n"
        "import plink_torch.commands.glm_perm, plink_torch.commands.perm_report\n"
        "import plink_torch.commands.adjust, plink_torch.testing\n"
        "import plink_torch.commands.het, plink_torch.commands.check_sex\n"
        "import plink_torch.commands.score, plink_torch.commands.vscore\n"
        "import plink_torch.commands.sample_counts\n"
        "import plink_torch.commands.distance, plink_torch.commands.genome\n"
        "import plink_torch.commands.cluster, plink_torch.commands.ibs_test\n"
        "import plink_torch.commands.groupdist\n"
        "import plink_torch.stats.sfmt, plink_torch.stats.perm19\n"
        "import plink_torch.commands.epistasis, plink_torch.ops.epistasis\n"
        "import plink_torch.commands.sets, plink_torch.commands.fst\n"
        "import plink_torch.commands.assoc19, plink_torch.commands.model_perm\n"
        "import plink_torch.stats.assoc_perm19, plink_torch.stats.binom19\n"
        "import plink_torch.stats.cdflib19\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def _sources():
    for root, _dirs, files in os.walk(os.path.join(REPO, "plink_torch")):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(root, fn)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for nm in names:
            assert nm.split(".")[0] not in FORBIDDEN, f"{path}: imports {nm}"


def test_kernel_argtypes_match_c_signatures():
    """Each kernel entry point's ctypes argument types (the stream last)
    are as many as its C function's parameters: a missing one makes ctypes
    pass the stream handle as a 32-bit int."""
    import re

    from plink_torch.ops import _cuda

    for name, (fn, argtypes) in _cuda._ENTRY.items():
        with open(os.path.join(_cuda._CSRC, _cuda._SOURCE.get(name, name) + ".cu")) as f:
            src = f.read()
        m = re.search(r"PT_EXPORT int " + fn + r"\((.*?)\)\s*\{", src, re.S)
        assert m, (name, fn)
        params = [a for a in m.group(1).split(",") if a.strip()]
        assert len(params) == len(argtypes), (name, len(params), len(argtypes))
        assert "stream" in params[-1], (name, params[-1])
