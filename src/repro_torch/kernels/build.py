"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source in `repro_torch/csrc/` compiles on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds), at
first use, into `build/repro_torch/` at the repository root.  The file name
carries a hash of the source, of every header in `csrc/` and of the flags,
so an edited source or shared header rebuilds and an unchanged one is
reused.  Nothing here runs at import time.

A translation unit generated by `repro_torch.translate` (an object with the
unit's ``name`` and ``text``, `translate.units.Unit`) builds the same way
under `GEN_DIR`, ``build/repro_torch/gen/``, with ``-I csrc``: its source
and library are keyed by a hash of its text, every header and the flags,
so the first use of a new right-hand side compiles it once and a later
process compiles nothing (`load_generated`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
GEN_DIR = BUILD_DIR / "gen"
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


def _name(source) -> str:
    return source if isinstance(source, str) else source.name


def _hash(text: bytes) -> str:
    h = hashlib.sha256(text)
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(source) -> Path:
    """The library of a source of csrc/ (by name) or of a generated unit."""
    if isinstance(source, str):
        src = CSRC / source
        return BUILD_DIR / f"{src.stem}-{_hash(src.read_bytes())}.so"
    return GEN_DIR / f"gen-{_hash(source.text.encode())}.so"


def _source_file(source) -> Path:
    """The .cu nvcc compiles: csrc/`source`, or a generated unit's text
    written under GEN_DIR beside its library."""
    if isinstance(source, str):
        return CSRC / source
    path = library_path(source).with_suffix(".cu")
    if not path.exists() or path.read_text() != source.text:
        GEN_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(source.text)
        os.replace(tmp, path)
    return path


def build(sources: Sequence[Union[str, object]]) -> Dict[str, str]:
    """Compile every source (a name in csrc/, or a generated unit) whose
    library is missing, all nvcc processes started together.  Returns the
    compiler's output (register and spill report) per source built, keyed
    by its name, also kept beside each library (`build_log`); raises with
    nvcc's message on failure."""
    todo = []
    for s in sources:
        if not library_path(s).exists() and all(
                library_path(s) != library_path(o) for o in todo):
            todo.append(s)
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for s in todo:
        tmp = library_path(s).with_suffix(f".{os.getpid()}.tmp")
        procs[_name(s)] = (s, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(_source_file(s))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (s, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}:\n{logs[name]}")
            continue
        library_path(s).with_suffix(".log").write_text(logs[name])
        os.replace(tmp, library_path(s))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def build_log(source) -> Optional[str]:
    """nvcc's output when the library of `source` was built, or None where
    the library was built without one kept."""
    path = library_path(source).with_suffix(".log")
    return path.read_text() if path.exists() else None


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """The built library of `source` (building it first if needed)."""
    build([source])
    return ctypes.CDLL(str(library_path(source)))


@functools.lru_cache(maxsize=None)
def load_generated(unit) -> ctypes.CDLL:
    """The built library of a generated unit (building it first if
    needed), cached in the process: a wrapper's second launch of the same
    functor reads no file."""
    build([unit])
    return ctypes.CDLL(str(library_path(unit)))
