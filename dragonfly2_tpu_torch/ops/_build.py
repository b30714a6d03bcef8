"""Build the port's native sources and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
with nvcc into ``_build/lib<name>-<hash>.so`` inside the package
(git-ignored). Each ``csrc/<name>.cc`` (the host-side C++ scorer) compiles
with g++ the same way (``build_gxx``/``load_gxx``). The hash covers the
source, the shared headers and the flags (for g++ also the host CPU that
``-march=native`` targets), so an edited source builds afresh and an
unchanged one is reused. A build writes a pid-named temporary file and
renames it into place, so processes building the same library at once
cannot tear it. Nothing compiles at import: the package must import on a
host with no nvcc and no card, and a library is built on its first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import re
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

# g++ flags of the host-side scorer, as the JAX package builds its copy
# (dragonfly2_tpu/native/scorer.py): then the best of the steps below that
# the compiler accepts, native SIMD with OpenMP down to neither
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffast-math", "-funroll-loops")
GXX_STEPS = (("-march=native", "-fopenmp"), ("-march=native",), ())

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


def _host_cpu() -> bytes:
    """What ``-march=native`` targets: the CPU's model name and flags (a
    library built on one host must not load on another)."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.machine().encode()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))][:2]
    return "\n".join([platform.machine(), *keep]).encode()


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
    included). nvcc's output is kept beside the library, so a call that
    finds the library built returns the log of the build that made it.
    Raises RuntimeError with the compiler's output if it fails.
    """
    out = library_path(name)
    log = out.with_suffix(".log")
    if out.exists():
        return {"path": out, "seconds": 0.0, "log": log.read_text() if log.exists() else ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{proc.stdout}")
    # the log first, each renamed into place whole: a library found built
    # always has its whole log beside it
    tmp_log = log.with_name(f"{log.name}.{os.getpid()}.tmp")
    tmp_log.write_text(proc.stdout)
    os.replace(tmp_log, log)
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "log": proc.stdout}


def gxx_library_path(name: str) -> Path:
    """Where ``csrc/<name>.cc`` builds to, keyed on source, flags and host CPU."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cc").read_bytes())
    digest.update(repr((GXX_FLAGS, GXX_STEPS)).encode())
    digest.update(_host_cpu())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_gxx(name: str) -> dict:
    """Compile ``csrc/<name>.cc`` with g++ unless it is built already.

    Tries ``GXX_FLAGS`` with each of ``GXX_STEPS`` in turn and keeps the
    first that compiles. Returns the library path, the seconds the build
    took (0.0 when it was already built) and the flags used (read back from
    the log kept beside the library). Raises RuntimeError with the last
    compiler output if every step fails.
    """
    out = gxx_library_path(name)
    log = out.with_suffix(".log")
    if out.exists():
        return {"path": out, "seconds": 0.0, "flags": log.read_text() if log.exists() else ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    src = str(CSRC_DIR / f"{name}.cc")
    t0 = time.perf_counter()
    err = ""
    for extra in GXX_STEPS:
        flags = [*GXX_FLAGS, *extra]
        proc = subprocess.run(["g++", *flags, "-o", str(tmp), src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode == 0:
            break
        err = proc.stdout
    else:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on csrc/{name}.cc:\n{err}")
    seconds = time.perf_counter() - t0
    tmp_log = log.with_name(f"{log.name}.{os.getpid()}.tmp")
    tmp_log.write_text(" ".join(flags))
    os.replace(tmp_log, log)
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "flags": " ".join(flags)}


def ptxas_usage(log: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes of each kernel in a build's ``-Xptxas -v``
    output, by mangled name."""
    usage: dict[str, dict[str, int]] = {}
    current = None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            current = usage.setdefault(m.group(1), {"registers": 0, "spill_stores": 0, "spill_loads": 0})
        elif current is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif current is not None and (m := re.search(r"Used (\d+) registers", line)):
            current["registers"] = int(m.group(1))
    return usage


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)["path"]))
            _libs[name] = lib
        return lib


def load_gxx(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cc``, built with g++ on first use."""
    key = f"{name}.cc"
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build_gxx(name)["path"]))
            _libs[key] = lib
        return lib
