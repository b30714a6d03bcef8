"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``_build/lib<name>-<hash>.so`` inside the package (git-ignored). The
hash covers the source, the shared headers and the flags, so an edited
source builds afresh and an unchanged one is reused. Nothing compiles at
import: the package must import on a host with no nvcc and no card, and a
kernel's wrapper loads its library on its first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# sm_90a, not sm_90: wgmma and setmaxnreg exist only for the "a" target.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    dirs = [Path(os.environ["CUDA_HOME"]) / "bin"] if os.environ.get("CUDA_HOME") else []
    dirs.append(Path("/usr/local/cuda/bin"))
    for d in dirs:
        cand = d / "nvcc"
        if cand.is_file() and os.access(cand, os.X_OK):
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def sources() -> list[str]:
    """Names of every kernel source under csrc/."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed on sources and flags."""
    digest = hashlib.sha256()
    for p in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(p.name.encode() + b"\0" + p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless it is built already.

    Returns the library path, the seconds the build took (0.0 when it was
    already built) and the compiler's output (``-Xptxas -v`` lines
    included). Raises RuntimeError with the compiler's output if it fails.
    """
    out = library_path(name)
    if out.exists():
        return {"path": out, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "log": proc.stdout}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)["path"]))
            _libs[name] = lib
        return lib
