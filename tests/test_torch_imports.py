"""The PyTorch port imports neither JAX nor the JAX package.

Other test files in the same worker import JAX, so the import check runs in
a fresh interpreter; the AST scan catches imports on paths no test takes.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT_FILES = sorted(p.relative_to(ROOT).as_posix()
                    for p in (SRC / "repro_torch").rglob("*.py")) \
    + ["chip_smoke.py", "examples/train_lm_torch.py"]

_PROBE = """
import importlib, json, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
mods = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                    "repro_torch."))
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({{"mods": mods, "bad": bad}}))
"""


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def test_port_modules_import_without_jax_or_repro():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(src=str(SRC), root=str(ROOT))],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    for mod in ("repro_torch.kernels.ops", "repro_torch.kernels.ssd",
                "repro_torch.kernels.gmm", "repro_torch.models.moe",
                "repro_torch.kernels.nvcc", "repro_torch.models.ssm",
                "repro_torch.models.model",
                "repro_torch.launch.serve", "repro_torch.checkpoint.bridge",
                "repro_torch.configs.deepseek_7b", "repro_torch.optim",
                "repro_torch.optim.adamw", "repro_torch.data",
                "repro_torch.data.pipeline", "repro_torch.checkpoint.ckpt",
                "repro_torch.launch.train", "repro_torch.launch.profile_train",
                "repro_torch.launch.lr_probe", "repro_torch.runtime",
                "repro_torch.runtime.fault", "repro_torch.core",
                "repro_torch.core.nemesis", "repro_torch.sync.plan",
                "repro_torch.sync.overlap", "repro_torch.launch.roofline"):
        assert mod in out["mods"]


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno)
