"""Build and bind the port's CUDA kernels.

Each kernel source ``facegen_torch/csrc/<name>.cu`` exposes a plain C
interface. The first call of ``load(name)`` in a process compiles it
with ``nvcc`` into ``facegen_torch/_build/<name>-<digest>.so`` (the
digest covers the source, every ``csrc/*.cuh`` header and the flags, so
an edited source or header rebuilds)
and loads it with ctypes. Nothing is built at import time. A missing
``nvcc`` or a failed build raises: a CUDA tensor has no other path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
# sm_90a, not sm_90: Hopper-only instructions (wgmma, setmaxnreg) exist
# only for the "a" target. -Xptxas -v puts registers and spills in the log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME/bin (default /usr/local/cuda)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH or in $CUDA_HOME/bin: the port's CUDA "
        "kernels cannot be built, and CUDA tensors have no other path"
    )


def _paths(name: str):
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):  # what a source may include
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    stem = BUILD_DIR / f"{name}-{digest}"
    return src, stem.with_suffix(".so"), stem.with_suffix(".log")


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library is already built; return
    the library's path. Safe against concurrent builds (atomic rename)."""
    src, lib_path, log_path = _paths(name)
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        log_path.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                f"{proc.stderr[-4000:]}"
            )
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def build_log(name: str) -> str:
    """nvcc's output for the current build of csrc/<name>.cu ('' if none)."""
    log_path = _paths(name)[2]
    return log_path.read_text() if log_path.exists() else ""


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, built on first use."""
    return ctypes.CDLL(str(build(name)))


def sass_counts(name: str, opcode: str) -> dict[str, int]:
    """For each kernel of the built csrc/<name>.cu, the number of SASS
    instructions whose opcode starts with ``opcode`` (e.g. ``HGMMA``, the
    wgmma tensor-core instruction), from ``cuobjdump -sass`` of the
    library. Builds it first if needed."""
    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    proc = subprocess.run([cuobjdump, "-sass", str(build(name))],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {name} (exit {proc.returncode}):\n"
                           f"{proc.stderr[-2000:]}")
    counts: dict[str, int] = {}
    kernel = None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :", 1)[1].strip()
            counts[kernel] = 0
        elif kernel is not None:
            # "/*0a50*/  [@P0] HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], ... ;"
            words = line.split("*/", 1)[-1].replace("{", " ").split()[:2]
            if any(word.startswith(opcode) for word in words):
                counts[kernel] += 1
    return counts
