"""The port stands alone: no module of mxq_tpu_torch, and not chip_smoke.py,
imports jax or anything of mxq_tpu, and the package imports with those
names blocked."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "mxq_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "mxq_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, bad


BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in %r):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import mxq_tpu_torch
for m in pkgutil.walk_packages(mxq_tpu_torch.__path__, "mxq_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = [m for m in sys.modules if any(m == f or m.startswith(f + ".")
                                     for f in %r)]
assert not bad, bad
print("ok")
""" % (FORBIDDEN, FORBIDDEN)


def test_package_imports_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_chip_smoke_refuses_without_a_card_or_package(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line on a host
    without CUDA, and when the package is not beside it."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
