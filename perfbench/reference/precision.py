"""The reference's arithmetic, and the control's one precision below it.

The reference computes in float32 with TF32 off (its warp and its DLT in
float64). The control is the reference in the program's place with some
stages one precision below what the configuration states for them:

- `features`: the ViT, PCA, word assignment, tf-idf and buddies, stated
  bfloat16: both operands of every matrix product rounded to fp8 e4m3;
- `warp`: the crop cameras' source-pixel coordinates, stated float32:
  rounded to bfloat16;
- `solve`: the DLT's normal matrix, stated float32: its operands rounded to
  bfloat16.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # the largest finite float8 e4m3fn
STAGES = ("features", "warp", "solve")


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale, back in f32."""
    x = x.float()
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, back in its own dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


class Precision:
    """Which stages run one precision below the configuration's: `lowp`
    is False (the reference), True (every stage: the control) or an
    iterable of names from STAGES."""

    def __init__(self, lowp=False):
        names = STAGES if lowp is True else tuple(lowp or ())
        unknown = set(names) - set(STAGES)
        if unknown:
            raise ValueError(f"no stage {sorted(unknown)}; the stages are {STAGES}")
        self.lowp = frozenset(names)

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return fp8(x) if "features" in self.lowp else x.float()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b, a product of the features stage."""
        return self.round(a) @ self.round(b)

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """x @ w.T + b, w in nn.Linear's (out, in) layout."""
        return self.mm(x, w.t()) + b.float()

    def solve_mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b of the solve, in float64 (bfloat16 operands when lowered)."""
        a, b = a.double(), b.double()
        if "solve" in self.lowp:
            a, b = bf16(a), bf16(b)
        return a @ b

    def coords(self, x: torch.Tensor) -> torch.Tensor:
        """Source-pixel coordinates of the warp (bfloat16 when lowered)."""
        return bf16(x) if "warp" in self.lowp else x


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
