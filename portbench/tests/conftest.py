"""The benchmark's CPU tests: the harness (``portbench/``) and the port
(``src/``) on the path, as ``portbench/run.py`` puts them."""

import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
for p in (_ROOT / "src", _ROOT / "portbench"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
