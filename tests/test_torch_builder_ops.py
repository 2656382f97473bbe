"""The representation builder's ops in the port against the JAX package, on
the CPU: view sampling, depth lifting, the depth warp, the kNN extras, the
PCA fit and its inverse, k-means, pad_templates and load_torch_repre.
Every comparison states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)

from foundpose_torch import cameras as t_cam
from foundpose_torch import repre as t_repre
from foundpose_torch.ops import kmeans as t_km
from foundpose_torch.ops import knn as t_knn
from foundpose_torch.ops import pca as t_pca
from foundpose_torch.ops import sampling as t_sampling
from foundpose_torch.ops import warp as t_warp
from foundpose_torch.structs import PinholeCamera as TCamera
from foundpose_tpu import cameras as j_cam
from foundpose_tpu import repre as j_repre
from foundpose_tpu.ops import kmeans as j_km
from foundpose_tpu.ops import knn as j_knn
from foundpose_tpu.ops import pca as j_pca
from foundpose_tpu.ops import sampling as j_sampling
from foundpose_tpu.ops import warp as j_warp
from foundpose_tpu.structs import PinholeCamera as JCamera


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# --- view sampling: float64 numpy on both sides, within 1e-12 ---------------


@pytest.mark.parametrize("n_views,radius", [(57, 408.4), (9, 300.0), (42, 1.0)])
def test_view_sampling_matches_jax(n_views, radius):
    t_views = t_cam.sample_views(n_views, radius=radius)
    j_views = j_cam.sample_views(n_views, radius=radius)
    assert len(t_views) == len(j_views) == n_views + (n_views % 2 == 0)
    t_rot = t_cam.inplane_rotated_views(t_views, 14)
    j_rot = j_cam.inplane_rotated_views(j_views, 14)
    assert len(t_rot) == len(j_rot) == 14 * len(j_views)
    for a, b in zip(t_rot, j_rot):
        np.testing.assert_allclose(a["R"], b["R"], rtol=0, atol=1e-12)
        np.testing.assert_allclose(a["t"], b["t"], rtol=0, atol=1e-12 * radius)
    np.testing.assert_allclose(t_cam.fibonacci_sphere(n_views | 1, radius),
                               j_cam.fibonacci_sphere(n_views | 1, radius), rtol=0,
                               atol=1e-12 * radius)


@pytest.mark.parametrize("depth_range,n", [((400.0, 800.0), 1), ((400.0, 800.0), 3)])
def test_view_sphere_radii_match_jax(depth_range, n):
    np.testing.assert_allclose(t_cam.view_sphere_radii(depth_range, n),
                               j_cam.view_sphere_radii(depth_range, n), rtol=0, atol=1e-12)


def test_fibonacci_sphere_refuses_an_even_count():
    with pytest.raises(ValueError):
        t_cam.fibonacci_sphere(10)


# --- small ops --------------------------------------------------------------


def test_lift_points_to_3d_matches_jax(rng):
    """Per template (vmapped in JAX, batched here), points inside and
    outside the image (clamped pixel reads): within 1e-5 relative."""
    b, h, w, n = 3, 30, 40, 50
    depth = rng.uniform(100, 900, (b, h, w)).astype(np.float32)
    pts = rng.uniform(-5, 45, (n, 2)).astype(np.float32)
    f = rng.uniform(200, 600, (b, 2)).astype(np.float32)
    c = rng.uniform(10, 30, (b, 2)).astype(np.float32)
    ref = jax.vmap(j_sampling.lift_points_to_3d, in_axes=(None, 0, 0, 0))(
        jnp.asarray(pts), jnp.asarray(depth), jnp.asarray(f), jnp.asarray(c))
    got = t_sampling.lift_points_to_3d(torch.from_numpy(pts), torch.from_numpy(depth),
                                       torch.from_numpy(f), torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)
    one = t_sampling.lift_points_to_3d(torch.from_numpy(pts), torch.from_numpy(depth[0]),
                                       torch.from_numpy(f[0]), torch.from_numpy(c[0]))
    np.testing.assert_allclose(one.numpy(), got[0].numpy(), rtol=0, atol=0)


def _look_at(eye, target):
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    side = np.cross(fwd, [0.0, 1.0, 0.0])
    side /= np.linalg.norm(side)
    up = np.cross(fwd, side)
    t = np.eye(4)
    t[:3, :3] = np.stack([side, up, fwd], axis=1)
    t[:3, 3] = eye
    return t.astype(np.float32)


def test_warp_depth_image_matches_jax():
    """A depth image of a slanted plane re-projected into a second camera at
    the same centre, turned ~4 degrees (the warp maps rays, as between a
    camera and its crop cameras): equal on >= 99.5% of pixels (nearest-pixel
    picks at f32 rounding boundaries may differ), the rest within the
    plane's depth step."""
    h, w = 48, 64
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = (400.0 + 2.0 * xs + 1.0 * ys).astype(np.float32)
    depth[:6, :10] = 0.0
    src_t = np.eye(4, dtype=np.float32)
    dst_t = _look_at(np.zeros(3), np.array([30.0, -15.0, 450.0]))
    cams = {}
    for name, t in (("src", src_t), ("dst", dst_t)):
        cams[name] = (
            JCamera.create(f=(80.0, 82.0), c=(31.5, 23.5), width=w, height=h,
                           T_world_from_eye=t),
            TCamera(f=torch.tensor([80.0, 82.0]), c=torch.tensor([31.5, 23.5]),
                    T_world_from_eye=torch.from_numpy(t), width=w, height=h),
        )
    ref = np.asarray(j_warp.warp_depth_image(cams["src"][0], cams["dst"][0], jnp.asarray(depth)))
    got = t_warp.warp_depth_image(cams["src"][1], cams["dst"][1], torch.from_numpy(depth)).numpy()
    assert got.shape == ref.shape == (h, w)
    equal = np.isclose(got, ref, rtol=1e-5, atol=1e-3)
    assert equal.mean() >= 0.995, equal.mean()
    assert np.abs(got - ref)[~equal].max(initial=0.0) <= 6.0
    assert (ref > 0).mean() > 0.5


def test_knn_extras_match_jax(rng):
    """knn_search_tiled (ragged last tile, masked bank rows), radius_search,
    argmin_dist, cosine_sim and the masked knn_search on random data (no
    ties): ids equal, distances within 1e-4 relative."""
    q = rng.normal(size=(37, 16)).astype(np.float32)
    bank = rng.normal(size=(300, 16)).astype(np.float32)
    mask = rng.uniform(size=300) > 0.2
    tq, tb, tm = torch.from_numpy(q), torch.from_numpy(bank), torch.from_numpy(mask)
    jq, jb, jm = jnp.asarray(q), jnp.asarray(bank), jnp.asarray(mask)

    jd, ji = j_knn.knn_search_tiled(jq, jb, 7, tile=64, bank_mask=jm)
    td, ti = t_knn.knn_search_tiled(tq, tb, 7, tile=64, bank_mask=tm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)
    md, mi = t_knn.knn_search(tq, tb, 7, bank_mask=tm)
    np.testing.assert_array_equal(mi.numpy(), ti.numpy())

    radius = float(np.median(np.asarray(jd)))
    jr = j_knn.radius_search(jq, jb, radius, 7, bank_mask=jm)
    tr = t_knn.radius_search(tq, tb, radius, 7, bank_mask=tm)
    np.testing.assert_array_equal(tr[2].numpy(), np.asarray(jr[2]))
    np.testing.assert_array_equal(tr[1].numpy()[tr[2].numpy()], np.asarray(jr[1])[np.asarray(jr[2])])
    np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]), rtol=1e-4, atol=1e-4)

    ja = j_knn.argmin_dist(jq, jb, bank_mask=jm)
    ta = t_knn.argmin_dist(tq, tb, bank_mask=tm)
    np.testing.assert_array_equal(ta[1].numpy(), np.asarray(ja[1]))
    np.testing.assert_allclose(ta[0].numpy(), np.asarray(ja[0]), rtol=1e-4, atol=1e-4)

    np.testing.assert_allclose(t_knn.cosine_sim(tq, tb).numpy(),
                               np.asarray(j_knn.cosine_sim(jq, jb)), rtol=0, atol=1e-5)


# --- PCA --------------------------------------------------------------------


def _gapped(rng, n=600, d=24, c=8):
    """Samples whose covariance has c leading variances spaced well apart
    (64 ... 8) above a flat floor (0.05): eigenvectors are well defined."""
    basis, _ = np.linalg.qr(rng.normal(size=(d, d)))
    scales = np.concatenate([np.linspace(8.0, 2.8, c), np.full(d - c, 0.22)])
    x = (rng.normal(size=(n, d)) * scales) @ basis.T + rng.normal(size=d) * 3.0
    return x.astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("whiten", [False, True])
def test_fit_pca_matches_jax(rng, masked, whiten):
    """Mean and variances within 1e-4 relative; the projector, compared by
    pca_inverse_transform(pca_transform(x)), within 1e-4 relative L2;
    components equal up to sign within 1e-4 (signs are arbitrary on both
    sides)."""
    x = _gapped(rng)
    mask = (rng.uniform(size=len(x)) > 0.3) if masked else None
    if masked:
        x[~mask] += 100.0  # masked rows would move the fit if counted
    ref = j_pca.fit_pca(jnp.asarray(x), 8, whiten=whiten,
                        sample_mask=None if mask is None else jnp.asarray(mask))
    got = t_pca.fit_pca(torch.from_numpy(x), 8, whiten=whiten,
                        sample_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(ref.mean), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.explained_variance.numpy(), np.asarray(ref.explained_variance),
                               rtol=1e-4)
    signs = np.sign(np.sum(got.components.numpy() * np.asarray(ref.components), axis=1))
    np.testing.assert_allclose(got.components.numpy() * signs[:, None],
                               np.asarray(ref.components), rtol=0, atol=1e-4)
    rec_t = t_pca.pca_inverse_transform(got, t_pca.pca_transform(got, torch.from_numpy(x)))
    rec_j = j_pca.pca_inverse_transform(ref, j_pca.pca_transform(ref, jnp.asarray(x)))
    rec_j = np.asarray(rec_j)
    rel = np.linalg.norm(rec_t.numpy() - rec_j) / np.linalg.norm(rec_j)
    assert rel <= 1e-4, rel


@pytest.mark.parametrize("whiten", [False, True])
def test_pca_inverse_transform_matches_jax(rng, whiten):
    """The same projector on both sides: within 1e-5 relative."""
    mean = rng.normal(size=12).astype(np.float32)
    comp = np.linalg.qr(rng.normal(size=(12, 12)))[0][:5].astype(np.float32)
    var = rng.uniform(0.5, 4.0, 5).astype(np.float32)
    y = rng.normal(size=(7, 5)).astype(np.float32)
    ref = j_pca.pca_inverse_transform(
        j_pca.PCA(mean=jnp.asarray(mean), components=jnp.asarray(comp),
                  explained_variance=jnp.asarray(var), whiten=whiten), jnp.asarray(y))
    got = t_pca.pca_inverse_transform(
        t_pca.PCA(mean=torch.from_numpy(mean), components=torch.from_numpy(comp),
                  explained_variance=torch.from_numpy(var), whiten=whiten), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# --- k-means ----------------------------------------------------------------


def _clusters(rng, k=12, per=40, d=8, pad=37):
    """k well-separated Gaussian blobs (centres ~N(0, 10), spread 0.5),
    shuffled, plus `pad` masked rows far away."""
    centres = rng.normal(size=(k, d)) * 10.0
    x = (centres[:, None] + 0.5 * rng.normal(size=(k, per, d))).reshape(-1, d)
    x = np.concatenate([x, rng.normal(size=(pad, d)) * 50.0 + 200.0])
    mask = np.concatenate([np.ones(k * per, bool), np.zeros(pad, bool)])
    perm = rng.permutation(len(x))
    return x[perm].astype(np.float32), mask[perm]


def test_lloyd_from_jax_init_matches_jax_kmeans(rng):
    """From the JAX package's own k-means++ init, the port's Lloyd loop
    gives the JAX kmeans result: 100% equal assignments (well-separated
    clusters: no argmin tie within f32 rounding), centroids within 1e-4,
    distances within 1e-3 relative."""
    x, mask = _clusters(rng)
    key = jax.random.PRNGKey(3)
    ref = j_km.kmeans(jnp.asarray(x), 12, key, num_iters=20, sample_mask=jnp.asarray(mask))
    init = np.array(j_km._kmeanspp_init(jnp.asarray(x), 12, key, jnp.asarray(mask)))
    got = t_km._lloyd(torch.from_numpy(x), torch.from_numpy(init), torch.from_numpy(mask), 20)
    np.testing.assert_array_equal(got.assignments.numpy(), np.asarray(ref.assignments))
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(ref.centroids), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.distances.numpy(), np.asarray(ref.distances), rtol=1e-3,
                               atol=1e-3)
    assert np.all(got.distances.numpy()[~mask] == 0.0)


def test_lloyd_keeps_an_empty_clusters_centroid(rng):
    """A centroid far from every valid row gets no member and keeps its
    place, as in the JAX package."""
    x, mask = _clusters(rng, k=3, pad=5)
    init = np.concatenate([x[mask][:3], np.full((1, x.shape[1]), 1e4, np.float32)])
    got = t_km._lloyd(torch.from_numpy(x), torch.from_numpy(init), torch.from_numpy(mask), 5)
    np.testing.assert_array_equal(got.centroids[3].numpy(), init[3])
    assert not (got.assignments.numpy()[mask] == 3).any()


def test_chunked_assignment_equals_one_block(rng):
    """Row chunks (a ragged last one) give the one-block assignments and
    distances exactly: 100% equal."""
    x = torch.from_numpy(rng.normal(size=(1000, 16)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(50, 16)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=1000) > 0.1)
    a1, d1 = t_km._assign(x, c, mask, chunk=1000)
    a2, d2 = t_km._assign(x, c, mask, chunk=64)
    np.testing.assert_array_equal(a1.numpy(), a2.numpy())
    np.testing.assert_array_equal(d1.numpy(), d2.numpy())


def test_draw_is_torch_multinomials_draw():
    """The init's draw takes the same index as torch.multinomial(w, 1) from
    the same generator state, for 50 seeds."""
    w = torch.rand(500) * (torch.rand(500) > 0.3)
    for seed in range(50):
        a = torch.multinomial(w, 1, generator=torch.Generator().manual_seed(seed))
        b = t_km._draw(w, torch.Generator().manual_seed(seed))
        assert a.item() == b.item()


def test_kmeanspp_init_law(rng):
    """On distinct data the K ids are distinct and all valid rows; with
    fewer distinct valid rows than K, every id is still a valid row; the
    far-away masked rows are never chosen. Checked over 5 seeds."""
    x, mask = _clusters(rng)
    for seed in range(5):
        ids = t_km._kmeanspp_init(torch.from_numpy(x), 60, torch.Generator().manual_seed(seed),
                                  torch.from_numpy(mask)).numpy()
        assert len(set(ids.tolist())) == 60
        assert mask[ids].all()
    # 4 distinct valid rows (5 copies each) behind 3 masked rows, 8 clusters:
    # once the distinct rows are drawn, the draws stay on valid rows (the
    # JAX init then takes row 0 whatever its mask: ROADMAP.md Queue 3).
    few = np.concatenate([x[~mask][:3], np.repeat(x[mask][:4], 5, axis=0)])
    few_mask = np.arange(len(few)) >= 3
    ids = t_km._kmeanspp_init(torch.from_numpy(few), 8, torch.Generator().manual_seed(0),
                              torch.from_numpy(few_mask)).numpy()
    assert few_mask[ids].all()
    assert len({tuple(r) for r in few[ids[:4]]}) == 4  # every distinct row is drawn first


def test_kmeans_clusters_the_blobs(rng):
    """The whole port kmeans (its own init) finds the 12 blobs: every blob
    in one cluster, distances near the blobs' spread."""
    x, mask = _clusters(rng)
    res = t_km.kmeans(torch.from_numpy(x), 12, torch.Generator().manual_seed(0),
                      num_iters=20, sample_mask=torch.from_numpy(mask))
    assert len(np.unique(res.assignments.numpy()[mask])) == 12
    assert float(res.distances.max()) < 16.0


# --- pad_templates and load_torch_repre -------------------------------------


def _reference_pth(rng, path, t=5, f=40, d=8, w=6, whiten=True):
    """A reference-layout repre.pth (the reference dataclass's fields)."""
    cams = [{"f": torch.tensor([500.0 + i, 501.0]), "c": torch.tensor([69.5, 69.5]),
             "T_world_from_eye": torch.from_numpy(_look_at(
                 rng.normal(size=3) * 300, np.zeros(3))), "width": 140, "height": 140}
            for i in range(t)]
    obj = {
        "feat_vectors": torch.from_numpy(rng.normal(size=(f, d)).astype(np.float32)),
        "vertices": torch.from_numpy(rng.normal(size=(f, 3)).astype(np.float32)),
        "feat_to_template_ids": torch.from_numpy(np.sort(rng.integers(0, t, f))),
        "feat_cluster_centroids": torch.from_numpy(rng.normal(size=(w, d)).astype(np.float32)),
        "feat_cluster_idfs": torch.from_numpy(rng.uniform(0, 2, w).astype(np.float32)),
        "template_descs": torch.from_numpy(rng.uniform(0, 1, (t, w)).astype(np.float32)),
        "template_cameras_cam_from_model": cams,
        "feat_raw_projectors": [{"mean": torch.zeros(12), "components": torch.eye(12)[:d],
                                 "explained_variances": torch.ones(d),
                                 "whiten": torch.tensor(whiten)}],
        "template_desc_opts": {"tfidf_knn_k": 2, "tfidf_knn_metric": "l2",
                               "tfidf_soft_assign": True, "tfidf_soft_sigma_squared": 4.0},
        "feat_opts": {"extractor_name": "dinov2_version=vits14-reg_stride=14_facet=token"},
    }
    torch.save(obj, path)


def _assert_repre_equal(got, ref, fields):
    for name in fields:
        np.testing.assert_array_equal(getattr(got, name).cpu().numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    for name in ("f", "c", "T_world_from_eye"):
        np.testing.assert_array_equal(getattr(got.template_cameras, name).numpy(),
                                      np.asarray(getattr(ref.template_cameras, name)))


def test_load_torch_repre_matches_jax(rng, tmp_path):
    """Both packages read one reference repre.pth into equal fields."""
    path = str(tmp_path / "repre.pth")
    _reference_pth(rng, path)
    ref = j_repre.load_torch_repre(path)
    got = t_repre.load_torch_repre(path, device="cpu")
    _assert_repre_equal(got, ref, ("feat_vectors", "vertices", "feat_to_template_ids",
                                   "word_centroids", "word_idfs", "template_descs",
                                   "bank_feats", "bank_vertices", "bank_mask"))
    assert got.tfidf_config._asdict() == ref.tfidf_config._asdict()
    assert got.extractor_name == ref.extractor_name
    assert got.raw_projector.whiten == ref.raw_projector.whiten is True
    assert (got.template_cameras.width, got.template_cameras.height) == (140, 140)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("multiple", [4, 5])
def test_pad_templates_matches_jax(rng, tmp_path, stacked, multiple):
    """Padded to a multiple (5 templates: to 8, or unchanged at 5), single
    and stacked: every padded field equal to the JAX package's."""
    path = str(tmp_path / "repre.pth")
    _reference_pth(rng, path)
    jr, tr = j_repre.load_torch_repre(path), t_repre.load_torch_repre(path, device="cpu")
    if stacked:
        jr, tr = j_repre.stack_repres([jr, jr]), t_repre.stack_repres([tr, tr])
    ref = j_repre.pad_templates(jr, multiple)
    got = t_repre.pad_templates(tr, multiple)
    _assert_repre_equal(got, ref, ("template_descs", "bank_feats", "bank_vertices",
                                   "bank_mask", "template_mask"))
    assert got.template_descs.shape[int(stacked)] == (8 if multiple == 4 else 5)

