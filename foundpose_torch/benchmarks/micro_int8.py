"""The int8-versus-bf16 GEMM probe on the card (counterpart of
benchmarks/micro_int8.py, which timed the TPU's int8 matmul mode).

    python -m foundpose_torch.benchmarks.micro_int8     # needs a CUDA GPU

Both products are hand-written tensor-core kernels (csrc/micro_mm.cu) at
the TPU probe's shapes: [64, 912, 384] x [384, 1536], bf16 -> f32 and
int8 -> int32. Each wrapper has a plain twin and a launch counter. At these
shapes the 358 MB 4-byte output, not the arithmetic, bounds both kernels.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from foundpose_torch import _kernels

SHAPE = (64, 912, 384, 1536)  # B, T, D, H
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.int8: 1979e12}


def mm_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., D] x [D, H]: bf16 -> f32 (f32 accumulation of exact products),
    int8 -> int32 (exact through f64)."""
    if a.dtype == torch.int8:
        return (a.double() @ w.double()).to(torch.int32)
    return a.float() @ w.float()


def _mm(a: torch.Tensor, w: torch.Tensor, name: str, dtype: torch.dtype, out_dtype) -> torch.Tensor:
    if a.dtype != dtype or w.dtype != dtype:
        raise ValueError(f"{name}: inputs must be {dtype}, got {a.dtype} and {w.dtype}")
    k, n = w.shape
    if a.shape[-1] != k:
        raise ValueError(f"{name}: a {tuple(a.shape)} does not match w {tuple(w.shape)}")
    m = a.numel() // k
    if m % 128 or n % 128 or k % 32:
        raise ValueError(f"{name}: needs rows and H multiples of 128 and D a multiple of 32")
    dev = _kernels.require_cuda(name, a, w)
    if a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name}: inputs must be 16-byte aligned")
    out = torch.empty(*a.shape[:-1], n, dtype=out_dtype, device=dev)
    fn = getattr(_kernels.library(), f"fp_{name}")
    _kernels.check(fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, _kernels.stream_ptr(dev)),
                   f"fp_{name}")
    return out


def mm_bf16(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [..., D] bf16 x w [D, H] bf16 -> [..., H] f32: the kernel for CUDA
    tensors, the twin for CPU tensors."""
    if a.device.type == "cpu":
        return mm_plain(a, w)
    out = _mm(a, w, "mm_bf16", torch.bfloat16, torch.float32)
    mm_bf16.launches += 1
    return out


def mm_int8(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [..., D] int8 x w [D, H] int8 -> [..., H] int32: the kernel for
    CUDA tensors, the twin for CPU tensors."""
    if a.device.type == "cpu":
        return mm_plain(a, w)
    out = _mm(a, w, "mm_int8", torch.int8, torch.int32)
    mm_int8.launches += 1
    return out


mm_bf16.launches = 0
mm_int8.launches = 0


def probe_inputs(device, seed: int = 0, shape=None):
    """The TPU probe's inputs at `shape` (default SHAPE): standard normals
    as bf16, and the same scaled by 10, rounded and clipped to [-127, 127]
    as int8."""
    b, t, d, h = shape or SHAPE
    rng = np.random.default_rng(seed)
    a_f = rng.standard_normal((b, t, d)).astype(np.float32)
    w_f = rng.standard_normal((d, h)).astype(np.float32)
    q8 = lambda x: torch.as_tensor(np.clip(np.round(x * 10), -127, 127).astype(np.int8), device=device)
    return {
        torch.bfloat16: (torch.as_tensor(a_f, device=device).bfloat16(),
                         torch.as_tensor(w_f, device=device).bfloat16()),
        torch.int8: (q8(a_f), q8(w_f)),
    }


def bound_ms(m: int, k: int, n: int, dtype: torch.dtype) -> tuple:
    """Least time of an [m, k] x [k, n] product on an H100 SXM (data-sheet
    peaks): (ms, "bytes" or "operations"), each input read once and the
    4-byte output written once."""
    esize = torch.empty(0, dtype=dtype).element_size()
    t_bytes = ((m * k + k * n) * esize + m * n * 4) / HBM_BYTES_PER_S
    t_ops = 2.0 * m * k * n / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean milliseconds per call by CUDA events, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run(device="cuda") -> dict:
    """Times both kernels at the probe's shapes by CUDA events:
    {"bfloat16" | "int8": {ms, rate_T_per_s, bound_ms, bound_by}}."""
    b, t, d, h = SHAPE
    ops = 2.0 * b * t * d * h
    rows = {}
    for dtype, (a, w) in probe_inputs(torch.device(device)).items():
        fn = mm_bf16 if dtype == torch.bfloat16 else mm_int8
        ms = cuda_ms(lambda: fn(a, w))
        bms, by = bound_ms(b * t, d, h, dtype)
        rows[str(dtype).split(".")[-1]] = dict(
            ms=ms, rate_T_per_s=ops / ms / 1e9, bound_ms=bms, bound_by=by
        )
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("micro_int8: needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    rows = run()
    for name, r in rows.items():
        print(f"{name}: {r['ms']:.4f} ms -> {r['rate_T_per_s']:.1f} T(FL)OP/s; "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    print(json.dumps({"card": card, "shape": SHAPE, "kernels": rows}))


if __name__ == "__main__":
    main()
