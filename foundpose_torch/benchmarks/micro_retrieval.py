"""The retrieval stage's substages on one NVIDIA GPU at LM-O scale
(counterpart of benchmarks/micro_retrieval.py).

    python -m foundpose_torch.benchmarks.micro_retrieval  # needs a CUDA GPU

Splits the tf-idf retrieval of `pipeline/inference.retrieve_batch` over B =
64 crops of Q = 900 bf16 query features (256-d) against 2,048 words and 798
template descriptors, on the JAX script's inputs (normal features and
words, |normal| idfs and descriptors, 70% of queries valid):

  assign_words          ops/knn.knn_search, the 3 nearest words (squared L2)
  tfidf_segment_sum     ops/tfidf.calc_tfidf (a scatter-add over words)
  tfidf_onehot_matmul   the same descriptor as a [Q * 3, W] one-hot product
  cosine_topk           cosine similarity to the templates (bf16), top 5

and prints the largest difference between the two tf-idf forms, as the JAX
script does. Each substage reports bench.substage_times' three numbers
(CUDA-event ms a call, device ms a call under torch.profiler, host launch
calls a call). Prints one JSON line. `run(device="cpu")` runs it on the
CPU (host clock; no device numbers).
"""

from __future__ import annotations

import json
import sys
from typing import Any, Callable, Dict, Tuple

import torch

from foundpose_torch.benchmarks import bench
from foundpose_torch.ops import tfidf
from foundpose_torch.ops.knn import knn_search

B, Q, DIM, W, T, KNN_K, TOP_N = 64, 900, 256, 2048, 798, 3, 5


def problem(device, b: int = B, q: int = Q, dim: int = DIM, w: int = W, t: int = T,
            seed: int = 0) -> Dict[str, torch.Tensor]:
    """The micro's inputs, made on `device` from one generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bf16 = torch.bfloat16
    return dict(
        feats=torch.randn(b, q, dim, generator=gen, device=device).to(bf16),
        words=torch.randn(w, dim, generator=gen, device=device).to(bf16),
        idfs=torch.randn(w, generator=gen, device=device).abs(),
        descs=torch.randn(t, w, generator=gen, device=device).abs().to(bf16),
        qmask=(torch.rand(b, q, generator=gen, device=device) > 0.3).to(bf16),
    )


def assign(p, k: int = KNN_K) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distances, word ids) [B, Q, k] of each query's k nearest words."""
    d2, ids = knn_search(p["feats"], p["words"], k=k, metric="l2")
    return torch.sqrt(torch.clamp_min(d2, 0.0)), ids


def tfidf_onehot(ids, dists, idfs, qmask) -> torch.Tensor:
    """calc_tfidf's hard-assignment descriptor [B, W] as the JAX script's
    one-hot product: unit weights per feature, masked, over the valid
    count, then (tf * idf) summed per word through a [B, Q * k, W] one-hot."""
    weights = torch.ones_like(dists)
    weights = weights / torch.clamp_min(torch.linalg.vector_norm(weights, dim=-1, keepdim=True),
                                        1e-12)
    m = qmask.float()
    weights = weights * m[..., None]
    num = torch.clamp_min(m.sum(-1), 1.0)
    tf = (weights / num[:, None, None]).reshape(ids.shape[0], -1)  # [B, Nk]
    onehot = (ids.reshape(ids.shape[0], -1, 1)
              == torch.arange(idfs.shape[0], device=ids.device)).float()  # [B, Nk, W]
    w_idf = onehot @ idfs  # [B, Nk]: a gather-free idf lookup
    return ((tf * w_idf)[:, None] @ onehot)[:, 0]


def cosine_topk(tv, descs, top_n: int = TOP_N):
    """(scores, template ids) [B, top_n] by bf16 cosine similarity."""
    qn = tv / torch.clamp_min(torch.linalg.vector_norm(tv, dim=-1, keepdim=True), 1e-12)
    df = descs.float()
    tn = df / torch.clamp_min(torch.linalg.vector_norm(df, dim=-1, keepdim=True), 1e-12)
    return torch.topk(qn.to(torch.bfloat16) @ tn.to(torch.bfloat16).T, top_n, dim=-1)


def substages(p: Dict[str, torch.Tensor]) -> Tuple[Dict[str, Callable[[], Any]], float]:
    """The four substages on the problem `p`, each returning its outputs,
    and the largest absolute difference between the two tf-idf forms."""
    dists, ids = assign(p)
    seg = lambda: tfidf.calc_tfidf(ids, dists, p["idfs"], feature_mask=p["qmask"])
    onehot = lambda: tfidf_onehot(ids, dists, p["idfs"], p["qmask"])
    tv = seg()
    err = float((tv - onehot()).abs().max())
    return {
        "assign_words": lambda: assign(p),
        "tfidf_segment_sum": seg,
        "tfidf_onehot_matmul": onehot,
        "cosine_topk": lambda: cosine_topk(tv, p["descs"]),
    }, err


def run(device="cuda", b: int = B, q: int = Q, dim: int = DIM, w: int = W,
        t: int = T) -> Dict[str, Any]:
    """The micro at its sizes (smaller ones for tests) on `device`."""
    device = bench.require_device(device)
    with torch.no_grad():
        subs, err = substages(problem(device, b, q, dim, w, t))
    print(f"[micro_retrieval] segment-vs-onehot max abs diff: {err:.2e}", file=sys.stderr)
    return dict(batch=b, queries=q, words=w, templates=t, segment_vs_onehot_max_abs=err,
                card=bench.card(device),
                substages=bench.substage_report(subs, device, "micro_retrieval", b))


def main() -> int:
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
