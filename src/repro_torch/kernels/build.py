"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source in `repro_torch/csrc/` compiles on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds), at
first use, into `build/repro_torch/` at the repository root.  The file name
carries a hash of the source, of every header in `csrc/` and of the flags,
so an edited source or shared header rebuilds and an unchanged one is
reused.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return str(path)


def library_path(source: str) -> Path:
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(sources: Sequence[str]) -> Dict[str, str]:
    """Compile every source whose library is missing, all nvcc processes
    started together.  Returns the compiler's output (register and spill
    report) per source built; raises with nvcc's message on failure."""
    todo = [s for s in sources if not library_path(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for s in todo:
        tmp = library_path(s).with_suffix(f".{os.getpid()}.tmp")
        procs[s] = (tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for s, (tmp, proc) in procs.items():
        logs[s] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {s}:\n{logs[s]}")
            continue
        os.replace(tmp, library_path(s))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """The built library of `source` (building it first if needed)."""
    build([source])
    return ctypes.CDLL(str(library_path(source)))
