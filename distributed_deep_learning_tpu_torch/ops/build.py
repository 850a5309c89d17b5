"""Build a CUDA source of ``csrc/`` into a shared library at first use.

Each kernel source has a plain C interface, so ``nvcc`` compiles it in
seconds (a source that includes PyTorch's headers takes minutes) and the
wrapper loads it with ``ctypes``.  Libraries go to ``build/torch_kernels/``
at the repository root, named after the source and keyed by a hash of the
source and the flags, so a changed source rebuilds.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def build_library(source: Path) -> tuple[Path, str]:
    """Compile ``source`` unless this source and these flags were built
    before; returns the library's path and ``nvcc``'s output (kept beside
    the library, so a library built before returns it too).  Needs
    ``nvcc`` (the CUDA toolkit)."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        return lib_path, (log_path.read_text() if log_path.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one temporary file a builder: two threads of one process may build
    # the same source at once, and the second rename must not find the
    # first's file gone
    tmp = lib_path.with_name(
        f"{lib_path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode})"
                           f":\n{proc.stdout}{proc.stderr}")
    log_path.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib_path)
    return lib_path, proc.stdout + proc.stderr


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels need the "
                           "CUDA toolkit to build")
    return found
