"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`csrc/build/<name>-<digest>.so` (the digest covers the source, every
`csrc/` header it includes, and the flags, so an edited source or header is
rebuilt). Nothing is built or loaded at
import: `function` compiles its library the first time a kernel is called,
and `build` compiles several at once (one nvcc process per source).

Compiled for sm_90a (H100): `-gencode arch=compute_90a,code=sm_90a`.
`kernel_operands` validates what a wrapper passes as pointers, and `check`
turns the cudaError_t that every C launcher returns (cudaGetLastError after
the launch) into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("flash_attention", "flash_attention_bwd", "fused_cross_attention", "geglu",
           "fused_cross_attention_int8", "geglu_int8", "conv_halo", "flash_attention_ilv",
           "flash_attention_nomax", "flash_attention_int8", "fused_self_attention")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, /usr/local/cuda, PATH)")
    return found


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def source_files(name: str) -> list[Path]:
    """`csrc/<name>.cu` and every `csrc/` header it includes, directly or
    through another header."""
    files, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(path.read_bytes())
                 if (CSRC / inc.decode()).is_file()]
    return files


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile the named sources in parallel; skip those already built.

    Returns {name: {"seconds": float, "log": str}} (the log holds ptxas's
    register and shared-memory report). Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (time.perf_counter(), tmp, out,
                       subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
    report, failed = {}, []
    for name, (t0, tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def function(lib: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """The C function `fn` of library `lib`, built on first use, with its
    argtypes set and an int (cudaError_t) return."""
    key = (lib, fn)
    if key not in _functions:
        if lib not in _libs:
            build([lib])
            _libs[lib] = ctypes.CDLL(str(library_path(lib)))
        f = getattr(_libs[lib], fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _functions[key] = f
    return _functions[key]


def check(err: int, what: str):
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def kernel_operands(what, *tensors, dtype=torch.bfloat16):
    """The tensors as contiguous CUDA operands of a kernel, of `dtype`
    (bfloat16 unless the int8 weights are asked for); raises on another
    dtype or device, or data not 32-byte aligned (WMMA loads)."""
    out = []
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != dtype:
            raise TypeError(f"{what}: takes {dtype} CUDA tensors, got "
                            f"{t.dtype} on {t.device}")
        t = t.contiguous()
        if t.data_ptr() % 32:
            raise ValueError(f"{what}: tensor data must be 32-byte aligned")
        out.append(t)
    return out
