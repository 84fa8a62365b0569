"""Build the package's CUDA sources into shared libraries and load them.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) with a plain C
interface and loaded with ``ctypes``; nothing includes PyTorch's headers, so
a build takes seconds. The output goes to ``build/kernels/`` at the
repository root, named by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME/bin`` (default
    /usr/local/cuda). Raises if neither has it."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA toolkit "
        "is needed to build the package's kernels")


def library_path(name: str, sources: list[str]) -> Path:
    """Where the library built from ``sources`` (names under csrc/) lives.
    The hash covers every header in csrc/ too, since any source may include
    one."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p.name for p in CSRC_DIR.glob("*.cuh"))
    for src in [*sources, *headers]:
        digest.update(src.encode())
        digest.update((CSRC_DIR / src).read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def compile_once(out: Path, cmd: list[str], report: Path | None = None) -> None:
    """Run the compiler command ``cmd`` (its output file appended as ``-o
    <tmp>``) unless ``out`` exists, and move the result to ``out``
    atomically, so a concurrent loader sees all of it or nothing; the
    compiler's own output goes to ``report`` first, when given. A failed
    build raises ``RuntimeError`` with the compiler's output."""
    if out.exists():
        return
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [*cmd, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{Path(cmd[0]).name} failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        if report is not None:
            report.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_library(name: str, sources: list[str]) -> ctypes.CDLL:
    """Compile ``sources`` into ``build/kernels/<name>-<hash>.so`` unless
    that file exists, then load it. ptxas's report (registers, shared
    memory and spills of each kernel) is kept beside it as ``.ptxas.txt``."""
    out = library_path(name, sources)
    if not out.exists():
        compile_once(out, [find_nvcc(), *NVCC_FLAGS, *[str(CSRC_DIR / s) for s in sources]],
                     report=out.with_suffix(".ptxas.txt"))
    return ctypes.CDLL(str(out))
