"""Build the hand-written CUDA kernels and bind them with ctypes.

Each ``kernels/csrc/<name>.cu`` compiles on its own, at first use, with
``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface under ``build/`` at the repository root; the library name
carries a hash of the sources and flags, so an edited source rebuilds and
an unchanged one is loaded as it is. A build that fails raises with the
compiler's output. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every C entry point: pointers and the stream as c_void_p
# (a bare Python int would be passed as a 32-bit int and cut the pointer)
SIGNATURES = {
    "ragged_prefill_attention":
        (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "batched_decode_attention":
        (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    "flash_attention":
        (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    found = str(path) if path.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {path} and on PATH); "
                           f"the CUDA kernels cannot be built")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> List[str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns the names it compiled; raises
    ``RuntimeError`` with the compiler output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    errors = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        out = _library_path(name)
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
        else:
            out.with_suffix(f".{os.getpid()}.tmp").replace(out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return list(procs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            fn = getattr(lib, name)
            fn.argtypes = SIGNATURES[name]
            fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = (ctypes.c_int,)
            lib.cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(name: str, lib: ctypes.CDLL, err: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        text = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({text})")
