"""Per-launch split of the fused ViT block kernel on the card.

    python3 foundpose_torch/benchmarks/block_split.py [--root DIR] [--vitg | --vitl]   # needs a CUDA GPU

`fp_vit_block` (csrc/vit_block.cu) launches seven kernels in sequence:
LN1, the qkv GEMM, attention, the proj GEMM, LN2, the fc1 GEMM and the fc2
GEMM (SwiGLU layers: the w12 GEMM with the SwiGLU epilogue and the w3
GEMM). `launch_split` times each over a few block calls under
torch.profiler (device time, in launch order). `yardsticks` times the
PyTorch calls of the same shapes: `torch.nn.functional.linear` in bf16 at
each GEMM's shape (bias, no epilogue), `scaled_dot_product_attention` in
bf16 over the block's heads and, for SwiGLU, `F.silu(a) * b` over the
hidden units. The port never calls any of them.

Run alone, the script builds a seeded [16, 905, 384] bf16 input and one
ViT-S/14 layer of random weights (`--vitg`: [16, 905, 1536] and one
ViT-G/14 SwiGLU layer, hidden 4096; `--vitl`: [16, 901, 1024] and one
ViT-L/14 GELU layer, 16 heads, hidden 4096) and prints one JSON line. `--root`
imports foundpose_torch from another checkout (for example a parent commit
unpacked into the ignored `_parent/`), so that two versions of the kernel
are timed by one script on the same inputs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

LAUNCHES = {
    "gelu": ("LN1", "qkv GEMM", "attention", "proj GEMM", "LN2", "fc1 GEMM", "fc2 GEMM"),
    "swiglu": ("LN1", "qkv GEMM", "attention", "proj GEMM", "LN2", "w12 GEMM + SwiGLU",
               "w3 GEMM"),
}


def _variant(p):
    return "swiglu" if "w12_weight" in p else "gelu"


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


class ProfilerLostKernels(RuntimeError):
    """torch.profiler kept fewer device kernels than the calls launched, on
    every try: the figure is not measured (never reported from a part)."""

    def __init__(self, seen, want, names):
        super().__init__(f"{seen} device kernels kept, want {want}: {names}")
        self.seen, self.want = seen, want


def is_launch_call(e) -> bool:
    """A host-side runtime call that launches one device kernel."""
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CPU and e.name.startswith(
        ("cudaLaunchKernel", "cuLaunchKernel"))


def profiled_kernels(fn, calls, want=None, pads=(0.5, 3.0, 3.0)):
    """The device kernels (in launch order) and the host launch calls of
    `calls` calls of `fn` under torch.profiler, after one unprofiled call.

    torch.profiler sometimes keeps only part of a window's device kernels:
    late in a long process 10 and 13 of 35 in a ViT-G window that closed at
    the synchronize, and 20 of 35 (ViT-L, batch 16) or 33 of 35 (ViT-L,
    batch 128, in a process of its own) on every try of a window held open
    after it. So each try, one profiler session, holds its window open
    `pads[i]` seconds after the synchronize, and counts as whole when it
    kept `want` kernels or, without `want`, at least one for each host
    launch call it recorded (a launch the runtime tracing misses adds a
    kernel without a call); if no try is whole, ProfilerLostKernels is
    raised."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for pad in pads:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        events = prof.events()
        kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                          and not e.name.startswith(("Memcpy", "Memset"))),
                         key=lambda e: e.time_range.start)
        launches = sum(1 for e in events if is_launch_call(e))
        if len(kernels) == want if want is not None else len(kernels) >= launches:
            return kernels, launches
    raise ProfilerLostKernels(len(kernels), launches if want is None else want,
                              sorted({e.name[:60] for e in kernels}))


def launch_split(block, x, p, calls=5, pads=(0.5, 3.0, 3.0), **kw):
    """Device ms of each of the seven kernels that one `block(x, p, **kw)`
    call launches, in launch order, averaged over `calls` profiled calls
    (`profiled_kernels`, which raises ProfilerLostKernels unless a try kept
    every kernel)."""
    names = LAUNCHES[_variant(p)]
    kernels, _ = profiled_kernels(lambda: block(x, p, **kw), calls, calls * len(names), pads)
    rows = []
    for i, launch in enumerate(names):
        evs = kernels[i::len(names)]
        rows.append(dict(
            launch=launch, kernel=evs[0].name,
            ms=sum(e.time_range.elapsed_us() for e in evs) / len(evs) / 1e3,
        ))
    return rows


def yardstick_inputs(x, p, num_heads, head_dim):
    """Seeded operands of the PyTorch calls at the block's shapes: the
    [B*T, D] and [B*T, hidden] activations and q, k, v [B, heads, T, hd]."""
    b, t, d = x.shape
    w2 = "w3" if _variant(p) == "swiglu" else "fc2"
    hidden = p[f"{w2}_weight"].shape[1]
    gen = torch.Generator(device=x.device).manual_seed(0)
    a_h = torch.randn(b * t, hidden, generator=gen, device=x.device).to(x.dtype)
    q, k, v = (torch.randn(b, num_heads, t, head_dim, generator=gen, device=x.device).to(x.dtype)
               for _ in range(3))
    return x.reshape(b * t, d), a_h, (q, k, v)


def yardsticks(x, p, num_heads, head_dim):
    """Milliseconds of the PyTorch calls at the block's shapes, bf16."""
    F = torch.nn.functional
    a_d, a_h, (q, k, v) = yardstick_inputs(x, p, num_heads, head_dim)
    w1, w2 = ("w12", "w3") if _variant(p) == "swiglu" else ("fc1", "fc2")
    gemms = {
        "qkv GEMM": (a_d, "qkv"), "proj GEMM": (a_d, "proj"),
        f"{w1} GEMM": (a_d, w1), f"{w2} GEMM": (a_h, w2),
    }
    out = {}
    for name, (a, w) in gemms.items():
        weight, bias = p[f"{w}_weight"], p[f"{w}_bias"]
        out[f"F.linear {name[:-5]} {list(a.shape)}x{list(weight.shape)}"] = cuda_ms(
            lambda: F.linear(a, weight, bias))
    out[f"SDPA {list(q.shape)}"] = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    if w1 == "w12":
        out[f"F.silu(a) * b {list(a_h.shape)}"] = cuda_ms(lambda: F.silu(a_h) * a_h)
    return out


def library_composite(x, p, num_heads, head_dim):
    """One call's worth of the PyTorch calls at the block's shapes: the
    four F.linear, SDPA and, for SwiGLU, F.silu(a) * b (no LayerNorm, no
    residuals). Returns a callable for cuda_ms."""
    F = torch.nn.functional
    a_d, a_h, (q, k, v) = yardstick_inputs(x, p, num_heads, head_dim)
    swi = _variant(p) == "swiglu"
    w1, w2 = ("w12", "w3") if swi else ("fc1", "fc2")

    def call():
        F.linear(a_d, p["qkv_weight"], p["qkv_bias"])
        F.scaled_dot_product_attention(q, k, v)
        F.linear(a_d, p["proj_weight"], p["proj_bias"])
        F.linear(a_d, p[f"{w1}_weight"], p[f"{w1}_bias"])
        if swi:
            F.silu(a_h) * a_h
        F.linear(a_h, p[f"{w2}_weight"], p[f"{w2}_bias"])

    return call


def seeded_layer(d=384, hidden=1536, seed=0, device="cuda", swiglu=False):
    """One layer of random block weights (nn.Linear layout), bf16; with
    `swiglu`, w12 [2 * hidden, d] and w3 [d, hidden] in place of fc1/fc2."""
    gen = torch.Generator().manual_seed(seed)

    def n(*shape, scale=0.02):
        return (torch.randn(shape, generator=gen) * scale).to(device, torch.bfloat16)

    p = {
        "norm1_scale": 1 + n(d), "norm1_bias": n(d),
        "qkv_weight": n(3 * d, d, scale=0.1), "qkv_bias": n(3 * d),
        "proj_weight": n(d, d), "proj_bias": n(d), "ls1": 0.1 + n(d),
        "norm2_scale": 1 + n(d), "norm2_bias": n(d), "ls2": 0.1 + n(d),
    }
    if swiglu:
        p.update(w12_weight=n(2 * hidden, d), w12_bias=n(2 * hidden),
                 w3_weight=n(d, hidden), w3_bias=n(d))
    else:
        p.update(fc1_weight=n(hidden, d), fc1_bias=n(hidden),
                 fc2_weight=n(d, hidden), fc2_bias=n(d))
    return p


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="checkout whose foundpose_torch is timed")
    width = ap.add_mutually_exclusive_group()
    width.add_argument("--vitg", action="store_true",
                       help="a ViT-G/14 SwiGLU layer (d 1536, 24 heads, hidden 4096)")
    width.add_argument("--vitl", action="store_true",
                       help="a ViT-L/14 GELU layer (d 1024, 16 heads, hidden 4096, 901 tokens)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("block_split: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from foundpose_torch.ops.vit_block import fused_vit_block

    tokens, d, heads, hidden = ((905, 1536, 24, 4096) if args.vitg else (901, 1024, 16, 4096)
                                if args.vitl else (905, 384, 6, 1536))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(16, tokens, d, generator=gen).to("cuda", torch.bfloat16)
    p = seeded_layer(d, hidden, swiglu=args.vitg)
    kw = dict(num_heads=heads, head_dim=64, approx_gelu=True, softmax_stabilizer="capped")
    rows = launch_split(fused_vit_block, x, p, **kw)
    res = dict(root=os.path.abspath(args.root), shape=list(x.shape), stabilizer="capped",
               mlp=_variant(p), block_ms=cuda_ms(lambda: fused_vit_block(x, p, **kw)),
               launches=rows, sum_ms=sum(r["ms"] for r in rows),
               yardsticks_ms=yardsticks(x, p, heads, 64),
               library_ms=cuda_ms(library_composite(x, p, heads, 64)))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
