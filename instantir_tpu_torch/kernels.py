"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into a shared library that ``ctypes`` loads -- no PyTorch headers, so
a build takes seconds. Libraries land in ``_build/`` inside the package (listed
in ``.gitignore``) under a name keyed by a hash of the sources and flags, so an
edit rebuilds and an unchanged tree reuses the earlier build. Nothing is built
at import: the first call that needs a kernel builds it.

The target is ``sm_90a``, not plain ``sm_90``: both sources use ``wgmma``
(through the PTX wrappers of ``csrc/hopper.cuh``, whose bytes are part of every
build's key), which exists only there. They need nothing beyond the CUDA
toolkit's own headers and runtime (no ``-lcuda``, no extra include path): their
tile copies are ``cp.async``, so no tensor map is encoded on the host.
``-Xptxas -v`` keeps each kernel's registers, spills and warnings in
``build_logs``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("flash_fwd", "flash_bwd")

_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's stderr (ptxas register / shared-memory report) of builds made by this process
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin, default /usr/local/cuda)")
    return path


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every listed source that has no current build, one ``nvcc``
    per source, all started together. Raises with nvcc's output on failure."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, out in todo.items():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), tmp, out)
        failures = []
        for name, (proc, tmp, out) in procs.items():
            stdout, stderr = proc.communicate()
            build_logs[name] = stdout + stderr
            if proc.returncode != 0:
                failures.append(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{stdout}{stderr}")
            else:
                os.replace(tmp, out)
        if failures:
            raise RuntimeError("\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        path = build([name])[name]
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
