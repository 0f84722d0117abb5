"""The port stands alone: it imports neither JAX nor the JAX package.

A fresh interpreter imports ``repro_torch`` and every module under it and
must end with no ``jax*``, no ``ml_dtypes`` and no ``repro``/``repro.*``
module loaded.
``chip_smoke.py`` imports neither either, and refuses to run (non-zero
exit, no result line) without CUDA or outside a checkout.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("repro", "ml_dtypes") or m.split(".")[0].startswith("jax"))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 15 else 0)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def test_port_imports_no_jax_and_no_reference_package():
    r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                       env=_env(), cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_source_names_jax_or_the_reference_package():
    files = [REPO / "chip_smoke.py", *sorted((REPO / "src" / "repro_torch").rglob("*.py"))]
    for f in files:
        roots = _imported_roots(f)
        assert not {r for r in roots
                    if r in ("repro", "ml_dtypes") or r.startswith("jax")}, (f, roots)


def test_chip_smoke_fails_without_cuda_or_outside_the_repo(tmp_path):
    """Here there is no card: the script exits non-zero and prints no result.
    Alone in a directory it cannot find the port and fails as well."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (alone, tmp_path)):
        r = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                           cwd=cwd, timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert r.returncode != 0, r.stdout + r.stderr
        assert '"ok"' not in r.stdout
