"""Builds and loads the hand-written CUDA kernels under `csrc/`.

The kernels have a plain C interface. At first use every `csrc/*.cu` is
compiled by its own `nvcc` process, all started together, and the objects
are linked into one shared library that is loaded with ctypes. The library
lands in `foundpose_torch/_build/`, named by a hash of the sources and flags,
so a changed source rebuilds and an unchanged one loads the cached file.
Nothing here runs at import: a machine without `nvcc` or a GPU imports the
package and uses the kernels' plain PyTorch twins on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "fp_vit_block": [_P] * 21 + [_I] * 6 + [_F, _F, _I, _I, _I] + [_I, _P, _P, _I, _P],
    "fp_cycle_distances": [_P] * 9 + [_I] * 7 + [_P],
    "fp_score_hypotheses": [_P] * 7 + [_F, _P] + [_I] * 3 + [ctypes.c_longlong] * 7 + [_P],
    "fp_attention": [_P] * 4 + [_I] * 5 + [_F, _P],
    "fp_mm_bf16": [_P] * 3 + [_I] * 3 + [_P],
    "fp_mm_int8": [_P] * 3 + [_I] * 3 + [_P],
    "fp_refine_lo_lm": [_P] * 9 + [_F, _F, _I, _I] + [_P] * 4 + [_I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log: str = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    cu, cuh = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + cuh:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    tag = digest.hexdigest()[:16]
    so = _BUILD / f"libfoundpose_kernels_{tag}.so"
    t0 = time.perf_counter()
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        objs = [_BUILD / f"{path.stem}_{tag}.{os.getpid()}.o" for path in cu]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(path)] for o, path in zip(objs, cu)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(f"== {path.name}\n{log}" for path, log in zip(cu, logs))
        for cmd, proc in zip(cmds, procs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{build_log}")
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{build_log}")
        for o in objs:
            o.unlink()
        os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raises if a kernel entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} failed with cudaError {rc}")


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The common device of `tensors`, which must all be contiguous CUDA
    tensors on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return dev
