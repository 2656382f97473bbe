"""Smallest-k selection with index tie-break (counterpart of
foundpose_tpu/ops/selection.py).

The JAX module selects without a sort (a radix descent plus one-hot
compaction), a workaround for sorting on a TPU. Here the same int32 keys go
through `torch.topk`, and the chosen slots are ordered by element index, as
the JAX compaction orders them: the result is the same set in the same
order.
"""

from __future__ import annotations

import torch

# Values at or above this stand for "invalid".
INVALID_SENTINEL = 1e30


def unique_keys(values: torch.Tensor, index_bits: int) -> torch.Tensor:
    """Strictly ordered int32 keys for non-negative f32 values: the IEEE
    bits with the low `index_bits` replaced by the element index."""
    raw = values.float().contiguous().view(torch.int32)
    idx = torch.arange(values.shape[-1], dtype=torch.int32, device=values.device)
    low = (1 << index_bits) - 1
    return (raw & ~low) | (idx & low)


def compact_smallest_k(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [..., k] of the k smallest entries of each row, ascending by
    element index. Entries >= INVALID_SENTINEL are chosen only when fewer
    than k valid ones exist."""
    q = values.shape[-1]
    if k > q:
        raise ValueError(f"k={k} > Q={q}")
    index_bits = max(1, (q - 1).bit_length())
    keys = unique_keys(torch.clamp_max(values.float(), INVALID_SENTINEL), index_bits)
    ids = torch.topk(keys, k, dim=-1, largest=False, sorted=False).indices
    return torch.sort(ids, dim=-1).values
