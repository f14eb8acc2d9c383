"""Build the port's CUDA kernels with ``nvcc`` at first use and bind them with ``ctypes``.

Each ``csrc/*.cu`` source has a plain C interface and compiles on its own into
a shared library under ``vihmc_torch/_build/`` (listed in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

``paired_sums.cu`` and ``merge_sums.cu`` share their tensor-core mainloop,
``csrc/split_mma.cuh``, found beside them by ``#include "..."``
(``field_stack.cu`` and ``fno_project.cu`` take two small helpers from it);
no other include path is given (no kernel uses CUTLASS or CuTe). Their tensor
maps are encoded with ``cuTensorMapEncodeTiled``, reached at run time
through ``cudaGetDriverEntryPoint``, so nothing links ``libcuda`` beyond
what the CUDA runtime loads. The library name carries a hash of the flags,
the source and every ``csrc/`` header it includes, so an edited source or
header never loads a stale build. Nothing is compiled when a module is
imported; :func:`build_all` starts one ``nvcc`` per source, all at once.
``-Xptxas -v`` prints each kernel's registers, shared memory and spills into
:data:`build_logs`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time

from vihmc_torch.core.profiling import span

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

#: kernel library name -> its source under csrc/
SOURCES = {"paired_sums": "paired_sums.cu", "merge_sums": "merge_sums.cu",
           "leapfrog_update": "leapfrog_update.cu", "field_stack": "field_stack.cu",
           "fno_project": "fno_project.cu"}

#: ctypes signatures of each library's C functions
_SIGNATURES = {
    "paired_sums": {
        "vihmc_paired_sums_scratch": (ctypes.c_int, [ctypes.c_int, ctypes.c_int]),
        "vihmc_paired_sums": (ctypes.c_int, [ctypes.c_void_p] * 7
                              + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
        "vihmc_paired_sums_small": (ctypes.c_int, [ctypes.c_void_p] * 8
                                    + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    },
    "merge_sums": {
        "vihmc_merge_sums_scratch": (ctypes.c_int, [ctypes.c_int, ctypes.c_int]),
        "vihmc_merge_sums": (ctypes.c_int, [ctypes.c_void_p] * 5
                             + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
        "vihmc_merge_sums_small": (ctypes.c_int, [ctypes.c_void_p] * 6
                                   + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    },
    "leapfrog_update": {
        "vihmc_leapfrog_update": (ctypes.c_int, [ctypes.c_void_p] * 6
                                  + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                     ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    },
    "field_stack": {
        "vihmc_field_forward": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
        "vihmc_field_backward": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
    },
    "fno_project": {
        "vihmc_fno_project": (ctypes.c_int, [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                             ctypes.c_void_p]),
        "vihmc_fno_project_occupancy": (ctypes.c_int, [ctypes.c_int, ctypes.c_int]),
        "vihmc_fno_project_slot_words": (ctypes.c_int, [ctypes.c_int]),
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_files(name: str) -> list:
    """The source of library ``name`` and every ``csrc/`` header it includes
    (with ``#include "..."``, transitively), in a fixed order."""
    seen, todo = [], [SOURCES[name]]
    while todo:
        rel = todo.pop(0)
        if rel in seen:
            continue
        seen.append(rel)
        with open(os.path.join(CSRC, rel), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())
                     if os.path.exists(os.path.join(CSRC, m.decode()))]
    return seen


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for rel in source_files(name):
        with open(os.path.join(CSRC, rel), "rb") as f:
            h.update(rel.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all(names=None) -> dict:
    """Compile every library not built yet, one ``nvcc`` per source, in
    parallel. Returns ``{name: seconds}`` for the ones it compiled; raises
    with the compiler's output if any fails. Span ``vihmc.kernel_build``."""
    with span("vihmc.kernel_build"):
        return _build(names)


def _build(names) -> dict:
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
