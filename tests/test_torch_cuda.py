"""The port's CUDA kernels against their plain PyTorch twins on the GPU.

These tests need a CUDA GPU and skip without one. On a machine with a card
and no JAX they run with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from foundpose_torch.benchmarks import micro_int8
from foundpose_torch.ops import sampling
from foundpose_torch.ops.attention import attention_plain, fused_attention_bhtd
from foundpose_torch.ops.buddies_kernel import cycle_distances, cycle_distances_plain
from foundpose_torch.ops.vit_block import fused_vit_block, fused_vit_block_plain
from foundpose_torch.pose import pnp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def block_weights(gen, d, hidden, dev):
    def n(*s, scale=0.05):
        return (torch.randn(s, generator=gen) * scale).to(dev, torch.bfloat16)

    return {
        "norm1_scale": 1 + n(d), "norm1_bias": n(d),
        "qkv_weight": n(3 * d, d, scale=0.2), "qkv_bias": n(3 * d),
        "proj_weight": n(d, d), "proj_bias": n(d), "ls1": 0.5 + n(d),
        "norm2_scale": 1 + n(d), "norm2_bias": n(d), "ls2": 0.5 + n(d),
        "fc1_weight": n(hidden, d), "fc1_bias": n(hidden),
        "fc2_weight": n(d, hidden), "fc2_bias": n(d),
    }


@pytest.mark.parametrize("stabilizer", ["capped", "column"])
@pytest.mark.parametrize("tokens,seq_len", [(150, 150), (160, 141)])
def test_vit_block_kernel_matches_twin(dev, stabilizer, tokens, seq_len):
    """Relative L2 error <= 1e-2 on the rows below seq_len (bf16)."""
    gen = torch.Generator().manual_seed(0)
    d, hidden = 128, 512
    p = block_weights(gen, d, hidden, dev)
    x = torch.randn(2, tokens, d, generator=gen).to(dev, torch.bfloat16)
    kw = dict(seq_len=seq_len, num_heads=2, head_dim=64, approx_gelu=stabilizer == "capped",
              softmax_stabilizer=stabilizer)
    before = fused_vit_block.launches
    got = fused_vit_block(x, p, **kw)[:, :seq_len].float()
    ref = fused_vit_block_plain(x, p, **kw)[:, :seq_len].float()
    assert fused_vit_block.launches == before + 1
    assert float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref)) < 1e-2


def test_buddies_kernel_matches_twin(dev):
    """Ragged Q and F (not multiples of the 64-wide tiles): q2o equal on
    >= 99% of valid queries, cycle distances equal where q2o is."""
    gen = torch.Generator().manual_seed(1)
    b, tn, q, f, d = 2, 3, 200, 100, 64
    bank = torch.randn(b, tn, f, d, generator=gen)
    rows = torch.randint(0, f, (b, q), generator=gen)
    qf = bank[:, 0].gather(1, rows[..., None].expand(b, q, d)) + 0.3 * torch.randn(b, q, d, generator=gen)
    qmask = torch.rand(b, q, generator=gen) > 0.3
    bmask = torch.rand(b, tn, f, generator=gen) > 0.2
    qpts = torch.rand(q, 2, generator=gen) * 400
    args = [t.to(dev) for t in (qf.bfloat16(), qmask, qpts, bank.bfloat16(), bmask)]
    cd_k, q2o_k = cycle_distances(*args)
    cd_p, q2o_p = cycle_distances_plain(*args)
    valid = args[1][:, None, :].expand_as(cd_k)
    same = (q2o_k == q2o_p) & valid
    assert float(same.sum() / valid.sum()) >= 0.99
    assert float(((cd_k - cd_p).abs() <= 1e-4)[same].float().mean()) >= 0.99
    assert bool((cd_k[~valid] == 1e30).all())


def test_score_kernel_matches_twin(dev):
    """Counts equal bit for bit (the kernel rounds in the twin's order)."""
    gen = torch.Generator().manual_seed(2)
    s, n, h = 6, 150, 90
    pts3d = (torch.rand(s, n, 3, generator=gen) - 0.5) * 0.1
    uv = pts3d[..., :2] / (pts3d[..., 2:] + 0.5) * 600 + 209.5 + torch.randn(s, n, 2, generator=gen)
    rs = torch.eye(3) + 0.02 * torch.randn(s, h, 3, 3, generator=gen)
    ts = torch.tensor([0.0, 0.0, 0.5]) + 0.004 * torch.randn(s, h, 3, generator=gen)
    valid = (torch.rand(s, n, generator=gen) > 0.1).float()
    k_f = torch.full((s, 2), 600.0)
    k_c = torch.full((s, 2), 209.5)
    ops = pnp._score_inputs(*(t.to(dev) for t in (uv, pts3d, valid, rs, ts, k_f, k_c)), 10.0)
    got = pnp.score_hypotheses(*ops)
    np.testing.assert_array_equal(got.cpu().numpy(), pnp.score_hypotheses_plain(*ops).cpu().numpy())
    assert float(got.max()) > 0


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("tokens,seq_len", [(905, 905), (150, 141), (33, 33)])
def test_attention_kernel_matches_twin(dev, dtype, tol, tokens, seq_len):
    """Relative L2 error <= 1e-5 (f32) / 1e-2 (bf16) over all rows; T not a
    multiple of any tile, keys past seq_len masked."""
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 3, tokens, 64, generator=gen).to(dev, dtype) for _ in range(3))
    q = q * 2
    before = fused_attention_bhtd.launches
    got = fused_attention_bhtd(q, k, v, seq_len=seq_len).float()
    ref = attention_plain(q, k, v, seq_len=seq_len).float()
    assert fused_attention_bhtd.launches == before + 1
    assert float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref)) < tol


@pytest.mark.parametrize("dtype,tokens", [(torch.float32, 1408), (torch.bfloat16, 1088)])
def test_attention_kernel_at_its_longest_sequence(dev, dtype, tokens):
    """The longest T whose logits fit one block's shared memory."""
    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(1, 2, tokens, 64, generator=gen).to(dev, dtype) for _ in range(3))
    got = fused_attention_bhtd(q, k, v).float()
    ref = attention_plain(q, k, v).float()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref)) < tol


def test_unfused_vit_on_the_card_matches_the_cpu(dev):
    """A small unfused f32 ViT (head_dim 64): card (attention kernel, full
    f32 matmuls) vs CPU (twins), feature maps within 1e-4."""
    from foundpose_torch.models import dinov2

    cfg = dinov2.DinoV2Config(embed_dim=128, depth=2, num_heads=2, pos_grid=6, layer=1)
    torch.manual_seed(0)
    model = dinov2.DinoV2(cfg).eval()
    imgs = torch.rand(2, 84, 84, 3, generator=torch.Generator().manual_seed(5))
    ref = dinov2.extract_facet(model, imgs)["feature_maps"]
    before = fused_attention_bhtd.launches
    got = dinov2.extract_facet(model.to(dev), imgs.to(dev))["feature_maps"].cpu()
    assert fused_attention_bhtd.launches == before + 2
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4)


def test_probe_kernels_match_twins(dev):
    """int8 -> int32 exact; bf16 -> f32 within relative L2 1e-5."""
    ins = micro_int8.probe_inputs(dev, seed=1, shape=(2, 128, 96, 256))
    a8, w8 = ins[torch.int8]
    np.testing.assert_array_equal(micro_int8.mm_int8(a8, w8).cpu().numpy(),
                                  micro_int8.mm_plain(a8, w8).cpu().numpy())
    abf, wbf = ins[torch.bfloat16]
    got, ref = micro_int8.mm_bf16(abf, wbf), micro_int8.mm_plain(abf, wbf)
    assert float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref)) < 1e-5


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    p = block_weights(torch.Generator().manual_seed(3), 128, 512, dev)
    with pytest.raises(ValueError):
        fused_vit_block(torch.zeros(1, 8, 128, device=dev), p, num_heads=2, head_dim=64)
    with pytest.raises(ValueError):
        fused_vit_block(torch.zeros(1, 8, 96, device=dev, dtype=torch.bfloat16), p,
                        num_heads=3, head_dim=32)
    grid = sampling.grid_points((84, 84), 14.0, device=dev)
    with pytest.raises(ValueError):
        cycle_distances(torch.zeros(1, 36, 16, device=dev), torch.ones(1, 36, dtype=torch.bool, device=dev),
                        grid, torch.zeros(1, 1, 8, 16, device=dev),
                        torch.ones(1, 1, 8, dtype=torch.bool, device=dev))
    with pytest.raises(ValueError):  # head_dim 32
        fused_attention_bhtd(*(torch.zeros(1, 2, 40, 32, device=dev) for _ in range(3)))
    with pytest.raises(RuntimeError):  # the kernel refuses T > 1408: shared memory
        fused_attention_bhtd(*(torch.zeros(1, 1, 1409, 64, device=dev) for _ in range(3)))
    with pytest.raises(ValueError):  # rows not a multiple of 128
        micro_int8.mm_int8(torch.zeros(100, 64, dtype=torch.int8, device=dev),
                           torch.zeros(64, 128, dtype=torch.int8, device=dev))
