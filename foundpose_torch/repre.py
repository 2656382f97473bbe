"""Feature-based object representation (counterpart of
foundpose_tpu/repre.py).

The serialized form is the JAX package's own: `repre.npz` plus
`repre_meta.json`, as `foundpose_tpu.repre.save_repre` and `save_repre`
here write them; either package reads the other's files.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from foundpose_torch.ops.pca import PCA
from foundpose_torch.ops.tfidf import TfidfConfig
from foundpose_torch.structs import PinholeCamera


@dataclasses.dataclass
class ObjectRepre:
    """Visual object features registered in 3D, plus retrieval structures."""

    vertices: torch.Tensor  # [F, 3]
    feat_vectors: torch.Tensor  # [F, D]
    feat_to_template_ids: torch.Tensor  # [F]
    feat_mask: torch.Tensor  # [F] bool
    word_centroids: torch.Tensor  # [W, D]
    word_idfs: torch.Tensor  # [W]
    template_descs: torch.Tensor  # [T, W]
    bank_feats: torch.Tensor  # [T, Fmax, D]
    bank_vertices: torch.Tensor  # [T, Fmax, 3]
    bank_mask: torch.Tensor  # [T, Fmax] bool
    template_cameras: PinholeCamera
    raw_projector: Optional[PCA] = None
    template_mask: Optional[torch.Tensor] = None  # [T] bool
    tfidf_config: TfidfConfig = TfidfConfig()
    extractor_name: str = ""
    # Template images [T, 3, H, W] on the host, for visualisation only.
    templates: Optional[np.ndarray] = None

    @property
    def num_templates(self) -> int:
        return self.template_descs.shape[0]

    def cast_banks(self, dtype: torch.dtype) -> "ObjectRepre":
        """Casts the feature banks, codebook and template descriptors to
        `dtype` (e.g. bfloat16) at rest; geometry and the projector stay."""
        return dataclasses.replace(
            self,
            feat_vectors=self.feat_vectors.to(dtype),
            word_centroids=self.word_centroids.to(dtype),
            template_descs=self.template_descs.to(dtype),
            bank_feats=self.bank_feats.to(dtype),
        )

    def to(self, device) -> "ObjectRepre":
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(
            self,
            **moved,
            template_cameras=self.template_cameras.to(device),
            raw_projector=(
                self.raw_projector.to(device) if self.raw_projector is not None else None
            ),
        )


def stack_repres(repres) -> ObjectRepre:
    """One multi-object repre with a leading object axis on every tensor
    field, ragged template counts, bank widths and flat feature counts
    zero-padded; `template_mask` [O, T] marks the real templates. All repres
    share the feature dim, the word count and the tf-idf config."""
    t_max = max(r.template_descs.shape[0] for r in repres)
    f_max = max(r.bank_feats.shape[1] for r in repres)
    flat_max = max(r.feat_vectors.shape[0] for r in repres)

    def stack(get, shape):
        out = get(repres[0]).new_zeros((len(repres), *shape))
        for i, r in enumerate(repres):
            a = get(r)
            out[(i, *(slice(0, s) for s in a.shape))] = a
        return out

    d = repres[0].feat_vectors.shape[1]
    w = repres[0].word_centroids.shape[0]
    tmask = torch.zeros(len(repres), t_max, dtype=torch.bool, device=repres[0].template_descs.device)
    for i, r in enumerate(repres):
        tmask[i, : r.template_descs.shape[0]] = True
    cam = PinholeCamera(
        f=stack(lambda r: r.template_cameras.f, (t_max, 2)),
        c=stack(lambda r: r.template_cameras.c, (t_max, 2)),
        T_world_from_eye=stack(lambda r: r.template_cameras.T_world_from_eye, (t_max, 4, 4)),
        width=repres[0].template_cameras.width,
        height=repres[0].template_cameras.height,
    )
    proj = None
    if repres[0].raw_projector is not None:
        proj = PCA(
            mean=torch.stack([r.raw_projector.mean for r in repres]),
            components=torch.stack([r.raw_projector.components for r in repres]),
            explained_variance=torch.stack([r.raw_projector.explained_variance for r in repres]),
            whiten=repres[0].raw_projector.whiten,
        )
    return ObjectRepre(
        vertices=stack(lambda r: r.vertices, (flat_max, 3)),
        feat_vectors=stack(lambda r: r.feat_vectors, (flat_max, d)),
        feat_to_template_ids=stack(lambda r: r.feat_to_template_ids, (flat_max,)),
        feat_mask=stack(lambda r: r.feat_mask.bool(), (flat_max,)),
        word_centroids=stack(lambda r: r.word_centroids, (w, d)),
        word_idfs=stack(lambda r: r.word_idfs, (w,)),
        template_descs=stack(lambda r: r.template_descs, (t_max, w)),
        bank_feats=stack(lambda r: r.bank_feats, (t_max, f_max, d)),
        bank_vertices=stack(lambda r: r.bank_vertices, (t_max, f_max, 3)),
        bank_mask=stack(lambda r: r.bank_mask.bool(), (t_max, f_max)),
        template_cameras=cam,
        raw_projector=proj,
        template_mask=tmask,
        tfidf_config=repres[0].tfidf_config,
        extractor_name=repres[0].extractor_name,
    )


def pad_templates(repre: ObjectRepre, multiple: int) -> ObjectRepre:
    """Pads the template axis up to a multiple of `multiple`, so the
    template-major banks split evenly over devices. Pad templates get
    template_mask=False (retrieval scores them -inf, so they are never
    selected), zero banks and edge-replicated cameras (never read for pad
    rows, but zero intrinsics would be a trap for host code). Works on
    single-object ([T, ...]) and stacked ([O, T, ...]) representations."""
    axis = repre.template_descs.dim() - 2  # 0 = single, 1 = stacked
    t = repre.template_descs.shape[axis]
    t_pad = -(-t // multiple) * multiple
    tmask = repre.template_mask
    if tmask is None:
        tmask = torch.ones(repre.template_descs.shape[: axis + 1], dtype=torch.bool,
                           device=repre.template_descs.device)
    if t_pad == t:
        return dataclasses.replace(repre, template_mask=tmask)

    def pad(a, edge=False):
        extra = list(a.shape)
        extra[axis] = t_pad - t
        if edge:
            last = a.narrow(axis, t - 1, 1)
            return torch.cat([a, last.expand(*extra)], dim=axis)
        return torch.cat([a, a.new_zeros(extra)], dim=axis)

    cams = repre.template_cameras
    return dataclasses.replace(
        repre,
        template_descs=pad(repre.template_descs),
        bank_feats=pad(repre.bank_feats),
        bank_vertices=pad(repre.bank_vertices),
        bank_mask=pad(repre.bank_mask),
        template_mask=pad(tmask),
        template_cameras=dataclasses.replace(
            cams, f=pad(cams.f, True), c=pad(cams.c, True),
            T_world_from_eye=pad(cams.T_world_from_eye, True),
        ),
    )


def build_padded_banks(
    feat_vectors: np.ndarray,
    vertices: np.ndarray,
    feat_to_template_ids: np.ndarray,
    num_templates: int,
    max_feats_per_template: Optional[int] = None,
    pad_multiple: int = 128,
):
    """Reorganizes flat feature arrays into padded [T, Fmax, ...] banks,
    Fmax rounded up to `pad_multiple`."""
    counts = np.bincount(feat_to_template_ids, minlength=num_templates)
    fmax = int(counts.max()) if max_feats_per_template is None else max_feats_per_template
    fmax = max(-(-fmax // pad_multiple) * pad_multiple, pad_multiple)
    d = feat_vectors.shape[1]
    bank_feats = np.zeros((num_templates, fmax, d), dtype=feat_vectors.dtype)
    bank_vertices = np.zeros((num_templates, fmax, 3), dtype=vertices.dtype)
    bank_mask = np.zeros((num_templates, fmax), dtype=bool)
    for t in range(num_templates):
        sel = np.nonzero(feat_to_template_ids == t)[0][:fmax]
        k = len(sel)
        bank_feats[t, :k] = feat_vectors[sel]
        bank_vertices[t, :k] = vertices[sel]
        bank_mask[t, :k] = True
    return bank_feats, bank_vertices, bank_mask


def make_repre(
    feat_vectors: np.ndarray,
    vertices: np.ndarray,
    feat_to_template_ids: np.ndarray,
    word_centroids: np.ndarray,
    word_idfs: np.ndarray,
    template_descs: np.ndarray,
    template_cameras: PinholeCamera,
    raw_projector: Optional[PCA] = None,
    tfidf_config: TfidfConfig = TfidfConfig(),
    extractor_name: str = "",
    feat_mask: Optional[np.ndarray] = None,
    templates: Optional[np.ndarray] = None,
    device="cuda",
) -> ObjectRepre:
    """ObjectRepre on `device` from flat host arrays (banks built here)."""
    num_templates = template_descs.shape[0]
    bank_feats, bank_vertices, bank_mask = build_padded_banks(
        feat_vectors, vertices, feat_to_template_ids, num_templates
    )
    if feat_mask is None:
        feat_mask = np.ones(len(feat_vectors), dtype=bool)

    def place(a):
        return torch.as_tensor(np.asarray(a), device=device)

    return ObjectRepre(
        vertices=place(vertices),
        feat_vectors=place(feat_vectors),
        feat_to_template_ids=place(feat_to_template_ids),
        feat_mask=place(feat_mask),
        word_centroids=place(word_centroids),
        word_idfs=place(word_idfs),
        template_descs=place(template_descs),
        bank_feats=place(bank_feats),
        bank_vertices=place(bank_vertices),
        bank_mask=place(bank_mask),
        template_cameras=template_cameras.to(device),
        raw_projector=raw_projector.to(device) if raw_projector is not None else None,
        tfidf_config=tfidf_config,
        extractor_name=extractor_name,
        templates=templates,
    )


def save_repre(repre: ObjectRepre, repre_dir: str) -> None:
    """Writes `<dir>/repre.npz` + `<dir>/repre_meta.json` in the JAX
    package's layout (uncompressed, as there: the f32 banks barely
    compress). Tensors on the card are copied to the host here."""
    os.makedirs(repre_dir, exist_ok=True)
    cams = repre.template_cameras
    arrays = {
        "vertices": repre.vertices,
        "feat_vectors": repre.feat_vectors,
        "feat_to_template_ids": repre.feat_to_template_ids,
        "feat_mask": repre.feat_mask,
        "word_centroids": repre.word_centroids,
        "word_idfs": repre.word_idfs,
        "template_descs": repre.template_descs,
        "cam_f": cams.f,
        "cam_c": cams.c,
        "cam_T": cams.T_world_from_eye,
    }
    proj = repre.raw_projector
    if proj is not None:
        arrays.update(pca_mean=proj.mean, pca_components=proj.components,
                      pca_variance=proj.explained_variance)
    arrays = {k: v.detach().cpu().numpy() for k, v in arrays.items()}
    if repre.templates is not None:
        arrays["templates"] = np.asarray(repre.templates)
    np.savez(os.path.join(repre_dir, "repre.npz"), **arrays)
    meta = {
        "tfidf_config": repre.tfidf_config._asdict(),
        "extractor_name": repre.extractor_name,
        "cam_width": cams.width,
        "cam_height": cams.height,
        "pca_whiten": bool(proj.whiten) if proj is not None else None,
    }
    with open(os.path.join(repre_dir, "repre_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_repre(repre_dir: str, device="cuda") -> ObjectRepre:
    """Reads `<dir>/repre.npz` + `<dir>/repre_meta.json` written by the JAX
    package's `save_repre`."""
    with np.load(os.path.join(repre_dir, "repre.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    with open(os.path.join(repre_dir, "repre_meta.json")) as f:
        meta = json.load(f)
    cameras = PinholeCamera(
        f=torch.as_tensor(arrays["cam_f"]),
        c=torch.as_tensor(arrays["cam_c"]),
        T_world_from_eye=torch.as_tensor(arrays["cam_T"]),
        width=int(meta["cam_width"]),
        height=int(meta["cam_height"]),
    )
    projector = None
    if "pca_mean" in arrays:
        projector = PCA(
            mean=torch.as_tensor(arrays["pca_mean"]),
            components=torch.as_tensor(arrays["pca_components"]),
            explained_variance=torch.as_tensor(arrays["pca_variance"]),
            whiten=bool(meta.get("pca_whiten")),
        )
    return make_repre(
        feat_vectors=arrays["feat_vectors"],
        vertices=arrays["vertices"],
        feat_to_template_ids=arrays["feat_to_template_ids"],
        word_centroids=arrays["word_centroids"],
        word_idfs=arrays["word_idfs"],
        template_descs=arrays["template_descs"],
        template_cameras=cameras,
        raw_projector=projector,
        tfidf_config=TfidfConfig(**meta["tfidf_config"]),
        extractor_name=meta.get("extractor_name", ""),
        feat_mask=arrays["feat_mask"],
        templates=arrays.get("templates"),
        device=device,
    )


def load_torch_repre(repre_path: str, device="cuda") -> ObjectRepre:
    """Reads a reference `repre.pth` (a torch pickle of the reference's
    representation dataclass fields, utils/repre_util.py:34-83) into an
    ObjectRepre on `device`. The file is unpickled, so read only files
    this project or the reference wrote."""
    obj = torch.load(repre_path, map_location="cpu", weights_only=False)

    def arr(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    cams = obj["template_cameras_cam_from_model"]
    cameras = PinholeCamera(
        f=torch.as_tensor(np.stack([arr(c["f"]) for c in cams]), dtype=torch.float32),
        c=torch.as_tensor(np.stack([arr(c["c"]) for c in cams]), dtype=torch.float32),
        T_world_from_eye=torch.as_tensor(
            np.stack([arr(c["T_world_from_eye"]) for c in cams]), dtype=torch.float32),
        width=int(cams[0]["width"]),
        height=int(cams[0]["height"]),
    )
    projector = None
    if obj.get("feat_raw_projectors"):
        p = obj["feat_raw_projectors"][0]
        projector = PCA(
            mean=torch.as_tensor(arr(p["mean"])),
            components=torch.as_tensor(arr(p["components"])),
            explained_variance=torch.as_tensor(arr(p["explained_variances"])),
            whiten=bool(arr(p.get("whiten", np.asarray(False)))),
        )
    tdo = obj.get("template_desc_opts") or {}
    cfg = TfidfConfig(
        knn_k=int(tdo.get("tfidf_knn_k", 3)),
        metric=str(tdo.get("tfidf_knn_metric", "l2")),
        soft_assign=bool(tdo.get("tfidf_soft_assign", False)),
        soft_sigma_squared=float(tdo.get("tfidf_soft_sigma_squared", 10.0)),
    )
    feat_opts = obj.get("feat_opts") or {}
    return make_repre(
        feat_vectors=arr(obj["feat_vectors"]).astype(np.float32),
        vertices=arr(obj["vertices"]).astype(np.float32),
        feat_to_template_ids=arr(obj["feat_to_template_ids"]).astype(np.int32),
        word_centroids=arr(obj["feat_cluster_centroids"]).astype(np.float32),
        word_idfs=arr(obj["feat_cluster_idfs"]).astype(np.float32),
        template_descs=arr(obj["template_descs"]).astype(np.float32),
        template_cameras=cameras,
        raw_projector=projector,
        tfidf_config=cfg,
        extractor_name=str(feat_opts.get("extractor_name", "")),
        templates=arr(obj["templates"]) if "templates" in obj else None,
        device=device,
    )
