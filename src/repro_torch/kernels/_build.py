"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` compiles it in seconds.  It is built for Hopper
(``sm_90a``) into ``build/lib<name>-<hash>.so`` next to this package,
where ``<hash>`` covers the source text, the shared headers
(``csrc/*.cuh``) and the compiler flags: an edited source or header
builds anew, an unchanged one loads the library already there.

:func:`build_all` starts one ``nvcc`` per source, all at once, and waits
for them; :func:`library` builds (if needed) and loads one, and
:func:`entry` gives a wrapper its C entry point with the argument types
set.  :func:`libraries_from` puts another build of the same C interface
(an earlier commit's, to time it beside this tree's) behind every
wrapper for the length of a ``with`` block.  Every C entry point returns
``cudaGetLastError()`` after its launch, and :func:`check` raises on a
nonzero code.  A missing ``nvcc`` raises too:
a CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

__all__ = [
    "SOURCES", "build_all", "check", "entry", "libraries_from", "library", "nvcc_path",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

#: The kernel sources, by library name.
SOURCES = ("ingress_pack", "fused_infer", "clause_eval", "class_sum", "threefry")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: Entry points with their argument types set, by (library, symbol).
_entries: Dict[tuple, ctypes._CFuncPtr] = {}
#: Libraries loaded by :func:`libraries_from`, by directory.
_foreign: Dict[Path, Dict[str, ctypes.CDLL]] = {}
#: ptxas resource report (registers, shared memory, spills) per library.
PTXAS_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError(
        f"nvcc not found (neither on PATH nor at {default}): the CUDA kernels "
        f"cannot be built, and a CUDA tensor has no other route"
    )


def _target(name: str) -> Path:
    # The shared headers count too: an edited header rebuilds every source.
    text = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together; returns the library paths.  Raises with the
    compiler's output when a build fails."""
    with _lock:
        names = list(names)
        targets = {n: _target(n) for n in names}
        todo = {n: t for n, t in targets.items() if not t.exists()}
        if not todo:
            return targets
        nvcc = nvcc_path()
        BUILD.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n, t in todo.items():
            tmp = t.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            PTXAS_LOG[n] = out
            if proc.returncode != 0:
                failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, todo[n])      # atomic: a reader sees all or nothing
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return targets


def _open(path: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(path))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all([name])[name]
        with _lock:
            lib = _loaded.setdefault(name, _open(path))
    return lib


def entry(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of :func:`library` ``(name)``, returning a
    C int, with ``argtypes`` set; cached per loaded library, so it follows
    :func:`libraries_from`."""
    lib = library(name)
    fn = _entries.get((lib, symbol))
    if fn is None:
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[lib, symbol] = fn
    return fn


@contextlib.contextmanager
def libraries_from(directory: Path):
    """Inside the block, :func:`library` returns ``directory/lib<name>.so``
    for every source built there (another build of the same C interface,
    such as the parent commit's) in place of this tree's, and so every
    wrapper launches that build's kernels (a source it lacks, this
    tree's); after it, this tree's again."""
    directory = Path(directory)
    libs = _foreign.get(directory)
    if libs is None:
        libs = {}
        for n in SOURCES:
            path = directory / f"lib{n}.so"
            if path.exists():        # a source the other build lacks: this tree's
                libs[n] = _open(path)
        _foreign[directory] = libs
    with _lock:
        saved = dict(_loaded)
        _loaded.clear()
        _loaded.update(libs)
    try:
        yield libs
    finally:
        with _lock:
            _loaded.clear()
            _loaded.update(saved)


def check(name: str, code: int) -> None:
    """Raise when a C entry point reported a CUDA error for its launch."""
    if code != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {code}")
