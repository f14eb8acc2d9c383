"""Build the port's CUDA kernels with ``nvcc`` at first use and bind them with ``ctypes``.

Each ``csrc/*.cu`` source has a plain C interface and compiles on its own into
a shared library under ``vihmc_torch/_build/`` (listed in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and the flags, so an edited
source never loads a stale build. Nothing is compiled when a module is
imported; :func:`build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

#: kernel library name -> its source under csrc/
SOURCES = {"paired_sums": "paired_sums.cu"}

#: ctypes signatures of each library's C functions
_SIGNATURES = {
    "paired_sums": {
        "vihmc_paired_sums_scratch": (ctypes.c_int, [ctypes.c_int, ctypes.c_int]),
        "vihmc_paired_sums": (ctypes.c_int, [ctypes.c_void_p] * 7
                              + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    },
}

_loaded: dict = {}
#: ptxas output of the builds this process made (name -> text)
build_logs: dict = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from csrc/ at first use")
    return found


def library_path(name: str) -> str:
    src = os.path.join(CSRC, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:16]}.so")


def build_all(names=None) -> dict:
    """Compile every library not built yet, one ``nvcc`` per source, in
    parallel. Returns ``{name: seconds}`` for the ones it compiled; raises
    with the compiler's output if any fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    times, failed = {}, []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        times[n] = time.perf_counter() - t0
        build_logs[n] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, library_path(n))  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The bound library ``name``, built first if needed (cached per process)."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(library_path(name))
        for fn, (restype, argtypes) in _SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[name] = lib
    return lib
