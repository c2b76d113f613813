"""Build the port's CUDA sources with ``nvcc`` into shared libraries with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers: a build of
seconds).

Each ``csrc/*.cu`` becomes ``_build/<stem>_<hash>.so``, keyed by a hash of
the source, the shared headers and the flags, so an edited source is
rebuilt and an unchanged one is not. ``build`` starts one ``nvcc`` per
source that is not built yet, all at once, and waits for them.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}_{h.hexdigest()[:16]}.so"


def build(*sources: Path) -> Dict[str, Tuple[Path, str]]:
    """Compile the sources not built yet, in parallel. Returns, per source
    stem, (library path, compiler log — ptxas's register and spill report;
    empty when the library was already built)."""
    out: Dict[str, Tuple[Path, str]] = {}
    running = []
    for src in sources:
        lib = library_path(src)
        if lib.exists():
            out[src.stem] = (lib, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in running:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc {src.name} failed ({proc.returncode}):\n"
                          f"{log}")
            continue
        os.replace(tmp, lib)   # atomic: concurrent builds never see a torn
        out[src.stem] = (lib, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out
