"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` file compiles with `nvcc` for `sm_90a` into its own shared
library with a plain C interface, loaded with `ctypes`.  Libraries are built
at first use into `build/repro_torch/` at the repository root (listed in
`.gitignore`), named by a digest of the source, the shared headers and the
flags, so an edited source is rebuilt and an unchanged one is reused.
`build()` starts one `nvcc` per source, all at once.  Macros given as
`defines` (the variants tools' REPRO_*_VARIANTS) build a library of their
own beside the shipped one.  A failed build raises; nothing falls back to
the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "build", "digest", "library",
           "library_path", "nvcc_path"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("p2p.cu", "p2p_stream.cu", "mac.cu", "attention.cu",
           "attention_bwd.cu", "wkv.cu", "wkv_bwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then
    /usr/local/cuda/bin/nvcc.  Raises when none exists."""
    cands = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def _flags(defines=()) -> tuple:
    return (*NVCC_FLAGS, *(f"-D{d}" for d in defines))


def digest(source: str, defines=()) -> str:
    """The 16 hex digits that name a source's library: a digest of the
    source, the shared headers and the flags (with `defines`)."""
    h = hashlib.sha256()
    h.update((CSRC / source).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return h.hexdigest()[:16]


def library_path(source: str, defines=()) -> Path:
    """Where the library of one source (built with `defines`) lives."""
    return BUILD_DIR / f"{Path(source).stem}-{digest(source, defines)}.so"


def build(sources=SOURCES, defines=()) -> dict:
    """Compile every source whose library is missing, one `nvcc` process per
    source, all started together, each with the macros `defines` defined.
    Returns {source: compiler output} for the
    sources built now (ptxas reports registers and shared memory per kernel);
    raises RuntimeError naming the source when a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    try:
        for src in sources:
            target = library_path(src, defines)
            if target.exists():
                continue
            nvcc = nvcc or nvcc_path()
            tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *_flags(defines), "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / src)]
            procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, target)
        logs = {}
        for src, (proc, tmp, target) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} (exit "
                                   f"{proc.returncode}):\n{out}")
            os.replace(tmp, target)
            logs[src] = out
        return logs
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()


def library(source: str, defines=()) -> ctypes.CDLL:
    """The loaded library of one source (built with the macros `defines`),
    built first if missing."""
    key = (source, tuple(defines))
    lib = _LIBS.get(key)
    if lib is None:
        target = library_path(source, defines)
        if not target.exists():
            build((source,), defines)
        lib = ctypes.CDLL(str(target))
        _LIBS[key] = lib
    return lib

