"""Parity of the port's online ops and representation I/O with the JAX
package, in f32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)

from foundpose_torch import repre as t_repre
from foundpose_torch.ops import knn as t_knn
from foundpose_torch.ops import pca as t_pca
from foundpose_torch.ops import sampling as t_sampling
from foundpose_torch.ops import selection as t_selection
from foundpose_torch.ops import tfidf as t_tfidf
from foundpose_torch.synthetic import realistic_repre
from foundpose_tpu import repre as j_repre
from foundpose_tpu.ops import knn as j_knn
from foundpose_tpu.ops import pca as j_pca
from foundpose_tpu.ops import sampling as j_sampling
from foundpose_tpu.ops import selection as j_selection
from foundpose_tpu.ops import tfidf as j_tfidf
from foundpose_tpu.structs import PinholeCamera as JCamera


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("size,cell", [((420, 420), 14.0), ((84, 98), 14.0), ((100, 60), 10.0)])
def test_grid_points_and_mask_validity(rng, size, cell):
    ref = np.asarray(j_sampling.grid_points(size, cell))
    pts = t_sampling.grid_points(size, cell)
    # jnp.linspace under XLA lands some centres an ulp or two off the exact
    # (i + 0.5) * cell that torch.linspace gives.
    np.testing.assert_allclose(pts.numpy(), ref, rtol=0, atol=1e-4)
    masks = (rng.uniform(size=(3, size[1], size[0])) > 0.5).astype(np.float32)
    valid = t_sampling.points_in_mask(pts, T(masks))
    for i in range(3):
        np.testing.assert_array_equal(
            valid[i].numpy(), np.asarray(j_sampling.points_in_mask(jnp.asarray(ref), masks[i]))
        )


def test_sample_grid_features_reshape_path(rng):
    fmap = rng.normal(size=(2, 30, 30, 8)).astype(np.float32)
    pts = j_sampling.grid_points((420, 420), 14.0)
    ref = j_sampling.sample_grid_features(jnp.asarray(fmap[1]), pts, (420, 420), 14.0)
    out = t_sampling.sample_grid_features(T(fmap), T(pts), (420, 420), 14.0)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref))
    # Off the texel grid (10-px cells on a 30x30 map) the points are
    # sampled bilinearly, per crop, as in the JAX package.
    pts10 = j_sampling.grid_points((420, 420), 10.0)
    out10 = t_sampling.sample_grid_features(T(fmap), T(pts10), (420, 420), 10.0)
    ref10 = j_sampling.sample_grid_features(jnp.asarray(fmap[1]), pts10, (420, 420), 10.0)
    np.testing.assert_array_equal(out10[1].numpy(), np.asarray(ref10))


@pytest.mark.parametrize("whiten", [False, True])
def test_pca_transform(rng, whiten):
    mean = rng.normal(size=(16,)).astype(np.float32)
    comp = rng.normal(size=(6, 16)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, size=(6,)).astype(np.float32)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    ref = j_pca.pca_transform(j_pca.PCA(mean=mean, components=comp, explained_variance=var,
                                        whiten=whiten), jnp.asarray(x))
    out = t_pca.pca_transform(t_pca.PCA(T(mean), T(comp), T(var), whiten), T(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_knn_search(rng, metric):
    q = rng.normal(size=(40, 12)).astype(np.float32)
    bank = rng.normal(size=(64, 12)).astype(np.float32)
    dj, ij = j_knn.knn_search(jnp.asarray(q), jnp.asarray(bank), k=3, metric=metric)
    dt, it = t_knn.knn_search(T(q), T(bank), k=3, metric=metric)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5, atol=1e-5)


def test_compact_smallest_k_matches_radix_selection(rng):
    """Same selected set in the same (element-index) order, including ties,
    invalid entries and fewer valid entries than k."""
    vals = np.round(rng.uniform(0, 5, size=(4, 50)), 1).astype(np.float32)
    vals[1, 10:] = j_selection.INVALID_SENTINEL
    vals[2, ::3] = 0.0
    for k in (1, 17, 50):
        onehot, _ = j_selection.compact_smallest_k(jnp.asarray(vals), k)
        ref = np.argmax(np.asarray(onehot), axis=-2)
        np.testing.assert_array_equal(t_selection.compact_smallest_k(T(vals), k).numpy(), ref)


def _tfidf_world(rng, t=6, per=40, d=16, w=32):
    feats = rng.normal(size=(t * per, d)).astype(np.float32)
    tpl = np.repeat(np.arange(t), per).astype(np.int32)
    words = rng.normal(size=(w, d)).astype(np.float32)
    mask = rng.uniform(size=(t * per,)) > 0.2
    return feats, tpl, words, mask


@pytest.mark.parametrize("soft", [False, True])
def test_template_descriptors_and_idfs(rng, soft):
    feats, tpl, words, mask = _tfidf_world(rng)
    cfg_j = j_tfidf.TfidfConfig(soft_assign=soft)
    cfg_t = t_tfidf.TfidfConfig(soft_assign=soft)
    dj, ij = j_tfidf.calc_template_tfidf_descriptors(
        jnp.asarray(feats), jnp.asarray(tpl), jnp.asarray(words), 6, cfg_j,
        feature_mask=jnp.asarray(mask),
    )
    dt, it = t_tfidf.calc_template_tfidf_descriptors(
        T(feats), T(tpl), T(words), 6, cfg_t, feature_mask=T(mask)
    )
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=1e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5, atol=1e-7)


def test_tfidf_retrieve(rng):
    """Retrieval ids equal (masked templates included), scores rtol 1e-5."""
    feats, tpl, words, mask = _tfidf_world(rng)
    cfg = j_tfidf.TfidfConfig()
    descs, idfs = j_tfidf.calc_template_tfidf_descriptors(
        jnp.asarray(feats), jnp.asarray(tpl), jnp.asarray(words), 6, cfg
    )
    queries = feats[rng.choice(len(feats), size=(3, 30))] + 0.1 * rng.normal(size=(3, 30, 16))
    queries = queries.astype(np.float32)
    qmask = rng.uniform(size=(3, 30)) > 0.3
    tmask = np.array([True, True, False, True, True, True])
    ids_t, sc_t = t_tfidf.tfidf_retrieve(
        T(queries), T(words), T(idfs), T(descs), top_n=6,
        config=t_tfidf.TfidfConfig(), query_mask=T(qmask), template_mask=T(tmask),
    )
    for i in range(3):
        ids_j, sc_j = j_tfidf.tfidf_retrieve(
            jnp.asarray(queries[i]), jnp.asarray(words), idfs, descs, top_n=6, config=cfg,
            query_mask=jnp.asarray(qmask[i], jnp.float32), template_mask=jnp.asarray(tmask),
        )
        np.testing.assert_array_equal(ids_t[i].numpy(), np.asarray(ids_j))
        np.testing.assert_allclose(sc_t[i].numpy(), np.asarray(sc_j), rtol=1e-5)


def test_load_repre_reads_jax_save_repre(tmp_path, rng):
    feats, tpl, words, mask = _tfidf_world(rng)
    descs, idfs = j_tfidf.calc_template_tfidf_descriptors(
        jnp.asarray(feats), jnp.asarray(tpl), jnp.asarray(words), 6, j_tfidf.TfidfConfig()
    )
    cams = JCamera(
        f=jnp.full((6, 2), 600.0), c=jnp.full((6, 2), 209.5),
        T_world_from_eye=jnp.tile(jnp.eye(4)[None], (6, 1, 1)), width=420, height=420,
    )
    pca = j_pca.PCA(mean=jnp.ones(16), components=jnp.eye(16)[:8],
                    explained_variance=jnp.ones(8), whiten=True)
    verts = rng.normal(size=(len(feats), 3)).astype(np.float32)
    ref = j_repre.make_repre(
        feats, verts, tpl, words, np.asarray(idfs), np.asarray(descs), cams,
        raw_projector=pca, extractor_name="dinov2_vits14-reg", feat_mask=mask,
    )
    j_repre.save_repre(ref, str(tmp_path))
    got = t_repre.load_repre(str(tmp_path), device="cpu")
    for name in ("vertices", "feat_vectors", "feat_to_template_ids", "feat_mask",
                 "word_centroids", "word_idfs", "template_descs", "bank_feats",
                 "bank_vertices", "bank_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    np.testing.assert_array_equal(got.template_cameras.T_world_from_eye.numpy(),
                                  np.asarray(cams.T_world_from_eye))
    assert got.raw_projector.whiten and got.raw_projector.components.shape == (8, 16)
    assert got.extractor_name == "dinov2_vits14-reg"
    assert got.tfidf_config == t_tfidf.TfidfConfig()
    half = got.cast_banks(torch.bfloat16)
    assert half.bank_feats.dtype == torch.bfloat16 and half.bank_vertices.dtype == torch.float32


def test_realistic_repre_is_consistent():
    r = realistic_repre(0, num_templates=12, fmax=64, feat_dim=16, num_words=32,
                        raw_dim=24, n_points=128)
    assert r.bank_feats.shape == (12, 64, 16) and r.template_descs.shape == (12, 32)
    descs, idfs = t_tfidf.calc_template_tfidf_descriptors(
        r.feat_vectors, r.feat_to_template_ids, r.word_centroids, 12, r.tfidf_config,
        feature_mask=r.feat_mask,
    )
    np.testing.assert_allclose(descs.numpy(), r.template_descs.numpy(), rtol=1e-6)
    assert bool(torch.isfinite(idfs).all()) and bool(r.bank_mask[:, :32].all())
    again = realistic_repre(0, num_templates=12, fmax=64, feat_dim=16, num_words=32,
                            raw_dim=24, n_points=128)
    assert torch.equal(again.bank_feats, r.bank_feats)


def test_geometry_matches_jax(rng):
    from foundpose_torch import geometry as t_geo
    from foundpose_tpu import geometry as j_geo

    rvec = np.concatenate([rng.normal(0, 0.5, (4, 3)), np.zeros((1, 3)), [[1e-9, 0, 0]]])
    rvec = rvec.astype(np.float32)
    r = t_geo.rodrigues(T(rvec))
    np.testing.assert_allclose(r.numpy(), np.asarray(j_geo.rodrigues(jnp.asarray(rvec))), atol=1e-6)
    t = rng.normal(size=(6, 3)).astype(np.float32)
    m = t_geo.as_4x4_rt(r, T(t))
    np.testing.assert_array_equal(m.numpy(), np.asarray(j_geo.as_4x4_rt(jnp.asarray(r.numpy()),
                                                                         jnp.asarray(t))))
    pts = rng.normal(size=(6, 3)).astype(np.float32)
    np.testing.assert_allclose(
        t_geo.transform_points(m, T(pts)).numpy(),
        np.asarray(j_geo.transform_points(jnp.asarray(m.numpy()), jnp.asarray(pts))), atol=1e-6,
    )
    np.testing.assert_allclose(
        t_geo.rotation_error_deg(r, r[[1, 2, 3, 4, 5, 0]]).numpy(),
        np.asarray(j_geo.rotation_error_deg(jnp.asarray(r.numpy()),
                                            jnp.asarray(r.numpy()[[1, 2, 3, 4, 5, 0]]))),
        atol=1e-3,
    )


def test_subsample_points_keeps_at_most_max_count(rng):
    valid = T(rng.uniform(size=(3, 50)) > 0.3)
    kept = t_sampling.subsample_points(valid, 10, torch.Generator().manual_seed(0))
    assert bool((kept <= valid).all())
    np.testing.assert_array_equal(kept.sum(-1).numpy(), np.minimum(valid.sum(-1).numpy(), 10))
