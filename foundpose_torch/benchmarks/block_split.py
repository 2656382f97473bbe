"""Per-launch split of the fused ViT block kernel on the card.

    python3 foundpose_torch/benchmarks/block_split.py [--root DIR]   # needs a CUDA GPU

`fp_vit_block` (csrc/vit_block.cu) launches seven kernels in sequence:
LN1, the qkv GEMM, attention, the proj GEMM, LN2, the fc1 GEMM and the fc2
GEMM. `launch_split` times each over a few block calls under
torch.profiler (device time, in launch order). `yardsticks` times the
PyTorch calls of the same shapes: `torch.nn.functional.linear` in bf16 at
each GEMM's shape (bias, no epilogue) and `scaled_dot_product_attention`
in bf16 over the block's heads. The port never calls either.

Run alone, the script builds a seeded [16, 905, 384] bf16 input and one
ViT-S/14 layer of random weights and prints one JSON line. `--root`
imports foundpose_torch from another checkout (for example a parent commit
unpacked into the ignored `_parent/`), so that two versions of the kernel
are timed by one script on the same inputs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

LAUNCHES = ("LN1", "qkv GEMM", "attention", "proj GEMM", "LN2", "fc1 GEMM", "fc2 GEMM")


def cuda_ms(fn, reps=20, warm=3):
    """Mean milliseconds per call of `fn` by CUDA events, after warm-up."""
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


def launch_split(block, x, p, calls=5, **kw):
    """Device ms of each kernel that one `block(x, p, **kw)` call launches,
    in launch order, averaged over `calls` profiled calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    block(x, p, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            block(x, p, **kw)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    per_call = len(kernels) // calls
    if per_call == 0 or per_call * calls != len(kernels):
        raise RuntimeError(f"{len(kernels)} device kernels in {calls} block calls")
    rows = []
    for i in range(per_call):
        evs = kernels[i::per_call]
        rows.append(dict(
            launch=LAUNCHES[i] if per_call == len(LAUNCHES) else f"#{i}",
            kernel=evs[0].name,
            ms=sum(e.time_range.elapsed_us() for e in evs) / len(evs) / 1e3,
        ))
    return rows


def yardsticks(x, p, num_heads, head_dim):
    """Milliseconds of the PyTorch calls at the block's shapes, bf16."""
    F = torch.nn.functional
    b, t, d = x.shape
    hidden = p["fc1_weight"].shape[0]
    gen = torch.Generator(device=x.device).manual_seed(0)
    a_d = x.reshape(b * t, d)
    a_h = torch.randn(b * t, hidden, generator=gen, device=x.device).to(x.dtype)
    gemms = {
        "qkv GEMM": (a_d, "qkv"), "proj GEMM": (a_d, "proj"),
        "fc1 GEMM": (a_d, "fc1"), "fc2 GEMM": (a_h, "fc2"),
    }
    out = {}
    for name, (a, w) in gemms.items():
        weight, bias = p[f"{w}_weight"], p[f"{w}_bias"]
        out[f"F.linear {name[:-5]} {list(a.shape)}x{list(weight.shape)}"] = cuda_ms(
            lambda: F.linear(a, weight, bias))
    q, k, v = (torch.randn(b, num_heads, t, head_dim, generator=gen, device=x.device).to(x.dtype)
               for _ in range(3))
    out[f"SDPA {list(q.shape)}"] = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    return out


def seeded_layer(d=384, hidden=1536, seed=0, device="cuda"):
    """One layer of random block weights (nn.Linear layout), bf16."""
    gen = torch.Generator().manual_seed(seed)

    def n(*shape, scale=0.02):
        return (torch.randn(shape, generator=gen) * scale).to(device, torch.bfloat16)

    return {
        "norm1_scale": 1 + n(d), "norm1_bias": n(d),
        "qkv_weight": n(3 * d, d, scale=0.1), "qkv_bias": n(3 * d),
        "proj_weight": n(d, d), "proj_bias": n(d), "ls1": 0.1 + n(d),
        "norm2_scale": 1 + n(d), "norm2_bias": n(d), "ls2": 0.1 + n(d),
        "fc1_weight": n(hidden, d), "fc1_bias": n(hidden),
        "fc2_weight": n(d, hidden), "fc2_bias": n(d),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="checkout whose foundpose_torch is timed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("block_split: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from foundpose_torch.ops.vit_block import fused_vit_block

    gen = torch.Generator().manual_seed(1)
    x = torch.randn(16, 905, 384, generator=gen).to("cuda", torch.bfloat16)
    p = seeded_layer()
    kw = dict(num_heads=6, head_dim=64, approx_gelu=True, softmax_stabilizer="capped")
    rows = launch_split(fused_vit_block, x, p, **kw)
    res = dict(root=os.path.abspath(args.root), shape=list(x.shape), stabilizer="capped",
               block_ms=cuda_ms(lambda: fused_vit_block(x, p, **kw)), launches=rows,
               sum_ms=sum(r["ms"] for r in rows), yardsticks_ms=yardsticks(x, p, 6, 64))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
