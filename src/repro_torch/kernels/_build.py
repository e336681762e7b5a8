"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.  The
libraries go to ``build/repro_torch/`` at the root of the checkout (listed
in ``.gitignore``), named by a hash of
their source and flags, so a changed source is rebuilt and an unchanged one
is loaded as it is.  All sources compile in parallel, one ``nvcc`` each.
Nothing here runs when a module is imported: the first launch of a kernel
builds everything.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("quant_matmul", "flash_decode", "flash_decode_fused",
           "decode_loop", "decode_glue", "mamba2_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return CSRC.parent.parent.parent / "build" / "repro_torch"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source that has no up-to-date library, all at once.
    Returns {name: library path}; raises with nvcc's output on failure.
    ``-Xptxas -v`` (registers, shared memory, spills) goes to
    ``<name>.log`` beside the library."""
    out = {n: _target(n) for n in SOURCES}
    todo = [n for n, p in out.items() if not p.exists()]
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT))
    errors = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        (build_dir() / f"{n}.log").write_bytes(log)
        if p.returncode != 0:
            errors.append(f"nvcc failed on {n}.cu:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def _declare(lib: ctypes.CDLL) -> None:
    P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    sigs = {
        "qmm_a16": (P, P, P, P, P, I, I, I, I, I, I, I, P),
        "qmm_a16_tc": (P, P, P, P, I, I, I, I, P),
        "qmm_a16_gemv": (P, P, P, P, I, I, I, I, I, I, P),
        "qmm_a8": (P, P, P, P, P, I, I, I, I, I, I, I, P),
        "qmm_a8_tc": (P, P, P, P, P, I, I, I, I, P),
        "flash_decode": (P, P, P, P, I, P, P, I, I, I, I, I, F, I, I, P),
        "flash_decode_paged": (P, P, P, P, P, I, P, P, I, I, I, I, I, I, L,
                               L, L, F, I, I, P),
        "flash_decode_fused": (P,) * 11 + (P, I, P, I) + (P,) * 6
        + (I,) * 6 + (F, F) + (I,) * 8 + (P,),
        "flash_decode_fused_paged": (P,) * 12 + (P, I, P, I) + (P,) * 6
        + (I,) * 7 + (L, L, L) + (F, F) + (I,) * 8 + (P,),
        "decode_loop_build": (P, P, P, P, P, P, I, P, P),
        "decode_loop_launch": (P, P),
        "decode_loop_destroy": (P,),
        "graph_kernel_nodes": (P, P),
        "add_norm": (P, P, P, P, P, I, I, I, I, F, I, P),
        "rope_qk_write": (P,) * 5 + (I,) + (P,) * 4 + (I,) * 8
        + (L, L, L, I, P),
        "mamba2_decode": (P,) * 11 + (I,) * 6 + (F, I, P),
    }
    for fn, args in sigs.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = ctypes.c_int


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (building all on first use)."""
    if name not in _LIBS:
        for n, path in build_all().items():
            if n not in _LIBS:
                lib = ctypes.CDLL(str(path))
                _declare(lib)
                _LIBS[n] = lib
    return _LIBS[name]


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
