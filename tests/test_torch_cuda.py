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
from foundpose_torch.parallel import launch
from foundpose_torch.parallel import mesh as mesh_mod
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
@pytest.mark.parametrize("batch,tokens,seq_len", [(2, 150, 150), (2, 160, 141), (3, 150, 141)])
def test_vit_block_kernel_matches_twin(dev, stabilizer, batch, tokens, seq_len):
    """Relative L2 error <= 1e-2 on the rows below seq_len (bf16). 3 x 150
    rows is not a multiple of the GEMMs' 128-row tiles (ragged M)."""
    gen = torch.Generator().manual_seed(0)
    d, hidden = 128, 512
    p = block_weights(gen, d, hidden, dev)
    x = torch.randn(batch, tokens, d, generator=gen).to(dev, torch.bfloat16)
    kw = dict(seq_len=seq_len, num_heads=2, head_dim=64, approx_gelu=stabilizer == "capped",
              softmax_stabilizer=stabilizer)
    before = fused_vit_block.launches
    got = fused_vit_block(x, p, **kw)[:, :seq_len].float()
    ref = fused_vit_block_plain(x, p, **kw)[:, :seq_len].float()
    assert fused_vit_block.launches == before + 1
    assert float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref)) < 1e-2


@pytest.mark.parametrize("stabilizer", ["capped", "column"])
@pytest.mark.parametrize("approx_gelu", [True, False])
def test_vit_block_kernel_at_full_width(dev, stabilizer, approx_gelu):
    """ViT-S/14 widths (d 384, 6 heads, hidden 1536; fc2's K is 1536, so its
    weights stream through the ring): relative L2 <= 1e-2 on the output and
    on the residual branches (out - x), which a wrong head would move."""
    gen = torch.Generator().manual_seed(7)
    d, hidden = 384, 1536
    p = block_weights(gen, d, hidden, dev)
    x = torch.randn(2, 905, d, generator=gen).to(dev, torch.bfloat16)
    kw = dict(num_heads=6, head_dim=64, approx_gelu=approx_gelu, softmax_stabilizer=stabilizer)
    got = fused_vit_block(x, p, **kw).float()
    ref = fused_vit_block_plain(x, p, **kw).float()
    xf = x.float()
    for a, b in ((got, ref), (got - xf, ref - xf)):
        assert float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)) < 1e-2


def test_buddies_kernel_matches_twin(dev):
    """Ragged Q and F (not multiples of the tiles): q2o equal on >= 99% of
    valid queries, cycle distances equal where q2o is."""
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


def test_buddies_kernel_is_exact_across_query_tiles(dev):
    """Q 200 over two 128-query tiles, the first wholly masked; F 100 over
    four 32-row bank tiles; bank rows duplicated, so that equal distances
    (ties) fall in different tiles. Features on a 1/4 grid make every
    product and sum exact in f32, so kernel and twin see the same
    distances: q2o equal at every valid query, cycle distances equal
    everywhere."""
    gen = torch.Generator().manual_seed(8)
    b, tn, q, f, d = 2, 3, 200, 100, 64
    bank = torch.randint(-4, 5, (b, tn, f, d), generator=gen) / 4.0
    bank[:, :, 60:90] = bank[:, :, 10:40]  # duplicates 50 rows apart
    rows = torch.randint(0, f, (b, q), generator=gen)
    qf = bank[:, 0].gather(1, rows[..., None].expand(b, q, d))
    qf = qf + torch.randint(-1, 2, qf.shape, generator=gen) / 4.0
    qmask = torch.rand(b, q, generator=gen) > 0.2
    qmask[:, :128] = False
    bmask = torch.rand(b, tn, f, generator=gen) > 0.1
    bmask[:, :, 60:90] = bmask[:, :, 10:40]
    qpts = torch.rand(q, 2, generator=gen) * 400
    args = [t.to(dev) for t in (qf.bfloat16(), qmask, qpts, bank.bfloat16(), bmask)]
    cd_k, q2o_k = cycle_distances(*args)
    cd_p, q2o_p = cycle_distances_plain(*args)
    valid = args[1][:, None, :].expand_as(cd_k)
    assert bool((q2o_k[valid] == q2o_p[valid]).all())
    # A tie between duplicates goes to the lower one, so no valid query
    # lands on rows 60-89.
    assert not bool(((q2o_k >= 60) & (q2o_k < 90))[valid].any())
    np.testing.assert_array_equal(cd_k.cpu().numpy(), cd_p.cpu().numpy())


def test_buddies_kernel_at_the_main_path_shapes(dev):
    """[16, 900, 256] x [16, 5, 512, 256] with the bench's crop masks (about
    79% of queries masked): q2o equal on >= 99% of valid queries, cycle
    distances within 1e-4 there and equal at masked queries."""
    gen = torch.Generator().manual_seed(9)
    b, tn, q, f, d = 16, 5, 900, 512, 256
    bank = torch.randn(b, tn, f, d, generator=gen)
    rows = torch.randint(0, f, (b, q), generator=gen)
    qf = bank[:, 0].gather(1, rows[..., None].expand(b, q, d)) + 0.3 * torch.randn(b, q, d, generator=gen)
    inner = (torch.rand(b, 260, 260, generator=gen) > 0.4).float()
    masks = torch.zeros(b, 420, 420)
    masks[:, 80:340, 80:340] = inner
    grid = sampling.grid_points((420, 420), 14.0)
    qmask = sampling.points_in_mask(grid, masks)
    bmask = torch.rand(b, tn, f, generator=gen) > 0.2
    args = [t.to(dev) for t in (qf.bfloat16(), qmask, grid, bank.bfloat16(), bmask)]
    cd_k, q2o_k = cycle_distances(*args)
    cd_p, q2o_p = cycle_distances_plain(*args)
    valid = args[1][:, None, :].expand_as(cd_k)
    same = (q2o_k == q2o_p) & valid
    assert float(same.sum() / valid.sum()) >= 0.99
    assert float(((cd_k - cd_p).abs() <= 1e-4)[same].float().mean()) >= 0.99
    assert bool((cd_k[~valid] == cd_p[~valid]).all())


def score_problem(s, n, h, seed=2):
    """Raw scorer operands near a pose at 0.5 m (f 600, c 209.5, 30%
    outliers, 85% valid). Set 0 has no valid point; every third hypothesis
    of set 1 is ransac_pnp's sanitized identity (R = I, t = (0, 0, 1)); the
    last set's hypotheses are lane-major (the DLT's layout), so rs and ts
    reach the kernel strided."""
    from foundpose_torch.benchmarks.score_time import score_operands

    ops = score_operands(s, n, h, seed=seed, device="cpu")
    ops["validf"][0] = 0.0
    if s > 1:
        ops["rs"][1, ::3] = torch.eye(3)
        ops["ts"][1, ::3] = torch.tensor([0.0, 0.0, 1.0])
    ops["rs"] = ops["rs"].permute(2, 3, 0, 1).contiguous().permute(2, 3, 0, 1)
    ops["ts"] = ops["ts"].permute(2, 0, 1).contiguous().permute(1, 2, 0)
    return ops


@pytest.mark.parametrize("s,n,h", [(80, 300, 200), (80, 300, 400), (4, 300, 1), (4, 300, 37),
                                   (4, 7, 64), (4, 301, 64), (3, 1100, 50)])
def test_score_kernel_matches_twin(dev, s, n, h):
    """Counts equal bit for bit (the kernel folds and rounds in the twin's
    order) at the lmo.json and lmo_exact.json shapes, one hypothesis, a
    ragged tile (37), fewer points than warps (7), a ragged warp split
    (301) and more points than one shared-memory chunk (1100)."""
    ops = {k: v.to(dev) for k, v in score_problem(s, n, h).items()}
    before = pnp.score_hypotheses.launches
    got = pnp.score_hypotheses(**ops, inlier_thresh=10.0)
    assert pnp.score_hypotheses.launches == before + 1
    assert not ops["rs"].is_contiguous() and not ops["ts"].is_contiguous()
    ref = pnp.score_hypotheses_plain(**ops, inlier_thresh=10.0)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
    assert float(got[0].abs().max()) == 0.0 and float(got.max()) > 0


def test_ransac_pnp_launches_the_scorer_once(dev):
    """One scorer launch a ransac_pnp call, whatever the number of sets."""
    ops = score_problem(6, 120, 50)
    args = [ops[k].to(dev) for k in ("pts2d", "pts3d")]
    valid = ops["validf"].to(dev) > 0
    before = pnp.score_hypotheses.launches
    res = pnp.ransac_pnp(*args, valid, ops["k_f"].to(dev), ops["k_c"].to(dev),
                         num_hypotheses=50, generator=torch.Generator(device=dev).manual_seed(0))
    assert pnp.score_hypotheses.launches == before + 1
    assert bool(res.success[1:].all()) and not bool(res.success[0])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-3)])
@pytest.mark.parametrize("tokens,seq_len", [(905, 905), (150, 141), (33, 33)])
def test_attention_kernel_matches_twin(dev, dtype, tol, tokens, seq_len):
    """Relative L2 error <= 1e-5 (f32) / 1e-3 (bf16) over all rows; T not a
    multiple of any tile, keys past seq_len masked."""
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 3, tokens, 64, generator=gen).to(dev, dtype) for _ in range(3))
    q = q * 2
    before = fused_attention_bhtd.launches
    got = fused_attention_bhtd(q, k, v, seq_len=seq_len).float()
    ref = attention_plain(q, k, v, seq_len=seq_len).float()
    assert fused_attention_bhtd.launches == before + 1
    assert float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref)) < tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens,seq_len", [(2048, 2048), (4100, 4097)])
def test_attention_kernel_at_long_sequences(dev, dtype, tokens, seq_len):
    """Sequences past any shared-memory limit: nothing of length T stays
    resident, so long T is only more key tiles."""
    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(1, 2, tokens, 64, generator=gen).to(dev, dtype) for _ in range(3))
    got = fused_attention_bhtd(q * 2, k, v, seq_len=seq_len).float()
    ref = attention_plain(q * 2, k, v, seq_len=seq_len).float()
    tol = 1e-5 if dtype == torch.float32 else 1e-3
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


def test_builder_ops_on_the_card_match_the_cpu(dev):
    """The builder's plain PyTorch ops on the card against the CPU: 12
    well-separated blobs through Lloyd from one init (assignments 100%
    equal, centroids within 1e-4), the k-means++ init's law on the card
    (distinct, valid ids; no id of a masked row), the PCA projector
    (reconstruction within 1e-4 relative L2), and depth lifting (1e-4)."""
    from foundpose_torch.ops import kmeans, pca

    rng = np.random.default_rng(0)
    centres = rng.normal(size=(12, 16)) * 10.0
    x = (centres[:, None] + 0.5 * rng.normal(size=(12, 50, 16))).reshape(-1, 16)
    x = torch.from_numpy(np.concatenate([x, rng.normal(size=(20, 16)) + 300.0]).astype(np.float32))
    mask = torch.arange(len(x)) < 600
    init = x[torch.arange(0, 600, 50)]
    ref = kmeans._lloyd(x, init, mask, 10)
    got = kmeans._lloyd(x.to(dev), init.to(dev), mask.to(dev), 10)
    assert torch.equal(got.assignments.cpu(), ref.assignments)
    np.testing.assert_allclose(got.centroids.cpu().numpy(), ref.centroids.numpy(), atol=1e-4)
    ids = kmeans._kmeanspp_init(x.to(dev), 40, torch.Generator(dev).manual_seed(0), mask.to(dev))
    ids = ids.cpu()
    assert len(set(ids.tolist())) == 40 and bool(mask[ids].all())

    p_ref = pca.fit_pca(x[mask], 8)
    p_got = pca.fit_pca(x[mask].to(dev), 8)
    rec = [pca.pca_inverse_transform(p, pca.pca_transform(p, x[mask].to(p.mean.device))).cpu()
           for p in (p_ref, p_got)]
    assert float(torch.linalg.vector_norm(rec[1] - rec[0]) / torch.linalg.vector_norm(rec[0])) < 1e-4

    depth = torch.rand(2, 30, 40, generator=torch.Generator().manual_seed(1)) * 500 + 100
    pts = torch.rand(25, 2, generator=torch.Generator().manual_seed(2)) * 40
    f, c = torch.tensor([[300.0, 301.0]] * 2), torch.tensor([[20.0, 15.0]] * 2)
    lifted = sampling.lift_points_to_3d(pts.to(dev), depth.to(dev), f.to(dev), c.to(dev)).cpu()
    np.testing.assert_allclose(lifted.numpy(), sampling.lift_points_to_3d(pts, depth, f, c).numpy(),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 128, 96, 256), (3, 132 * 128, 384, 1536)])
def test_probe_kernels_match_twins(dev, shape):
    """int8 -> int32 exact; bf16 -> f32 within relative L2 1e-5. The first
    shape's D (96) is not a whole 128-byte slice; the second's rows span
    several tiles of every persistent block on a 132-SM card."""
    ins = micro_int8.probe_inputs(dev, seed=1, shape=shape)
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
    with pytest.raises(ValueError):  # rows not a multiple of 128
        micro_int8.mm_int8(torch.zeros(100, 64, dtype=torch.int8, device=dev),
                           torch.zeros(64, 128, dtype=torch.int8, device=dev))
    with pytest.raises(ValueError):  # a [D, 128] panel of w past shared memory
        micro_int8.mm_bf16(torch.zeros(128, 448, dtype=torch.bfloat16, device=dev),
                           torch.zeros(448, 128, dtype=torch.bfloat16, device=dev))


def _gloo_rank(rank, world, out_dir):
    """Both collectives of the multi-device layer on cuda:0 from one of
    two gloo ranks sharing the card."""
    dev = torch.device("cuda", 0)
    mesh = mesh_mod.make_mesh((1, 2))
    x = torch.tensor([-0.0, 1.5, float("nan"), -3.25 - rank], device=dev)
    local = {str(dt): x.to(dt) for dt in (torch.bfloat16, torch.float32)}
    local["bool"] = x > rank
    got = {k: mesh_mod._all_gather(v, mesh, "bank").cpu() for k, v in local.items()}
    got["psum"] = mesh_mod._psum(torch.full((3,), rank + 0.5, device=dev), mesh, "bank").cpu()
    torch.save({"got": got, "local": {k: v.cpu() for k, v in local.items()}},
               f"{out_dir}/rank{rank}.pt")


def test_gloo_collectives_on_one_card(dev, tmp_path):
    """Two gloo ranks on cuda:0 (NCCL refuses two ranks on one device):
    _all_gather is bit-exact for bf16, f32 (-0.0 and NaN included) and
    bool, in rank order on both ranks; _psum sums."""
    launch.run(_gloo_rank, 2, str(tmp_path))
    out = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    bits = {str(torch.bfloat16): torch.int16, str(torch.float32): torch.int32,
            "bool": torch.uint8}
    for r in range(2):
        got = out[r]["got"]
        for k, b in bits.items():
            want = torch.stack([out[i]["local"][k] for i in range(2)])
            assert torch.equal(got[k].view(b), want.view(b)), (k, got[k].view(b), want.view(b))
        assert torch.equal(got["psum"], torch.full((3,), 2.0))
