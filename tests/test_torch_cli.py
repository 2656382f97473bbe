"""The port's CLI plumbing against the JAX package's on the same inputs:
utils/config (options from JSON, YAML, flags, layering), utils/logging_util
(Timer), parallel/host_shard, the infer CLI's BatchRunner and prefetch
loader, prepare_bop_submission, eval_ar and sweep (with infer replaced, as
tests/test_sweep.py does). Mirrors tests/test_config_data.py,
test_host_shard.py, test_batch_runner.py and test_sweep.py."""

import dataclasses
import json
import os
import time
from typing import List, NamedTuple, Optional, Tuple
from unittest import mock

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)

from foundpose_torch.data.ply import Mesh, save_ply
from foundpose_torch.parallel import host_shard as t_shard
from foundpose_torch.pipeline import eval_ar as t_eval_ar
from foundpose_torch.pipeline import infer as t_infer
from foundpose_torch.pipeline import inference as t_inf
from foundpose_torch.pipeline import prepare_bop_submission as t_sub
from foundpose_torch.pipeline import sweep as t_sweep
from foundpose_torch.utils import config as t_cfg
from foundpose_torch.utils import logging_util as t_log
from foundpose_tpu.parallel import host_shard as j_shard
from foundpose_tpu.pipeline import eval_ar as j_eval_ar
from foundpose_tpu.pipeline import infer as j_infer
from foundpose_tpu.pipeline import prepare_bop_submission as j_sub
from foundpose_tpu.pipeline import sweep as j_sweep
from foundpose_tpu.utils import config as j_cfg
from foundpose_tpu.utils import logging_util as j_log

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LMO_JSON = os.path.join(ROOT, "configs", "infer", "lmo.json")


@dataclasses.dataclass(frozen=True)
class DemoOpts:
    version: str
    object_lids: Optional[List[int]] = None
    crop_size: Tuple[int, int] = (420, 420)
    use_detections: bool = True
    crop_rel_pad: float = 0.2
    batch_size: int = 4


# ---------------------------------------------------------------------------
# utils/config
# ---------------------------------------------------------------------------


def _both(fn):
    """fn(config module) for the JAX package's module and the port's."""
    return fn(j_cfg), fn(t_cfg)


@pytest.mark.parametrize("argv", [
    ["--version", "v2", "--object-lids", "3", "7", "--crop-rel-pad", "0.5",
     "--use-detections", "false"],
    ["--set", "batch_size=32", "--set", 'version="patched"'],
    ["--version", "v9", "--batch-size", "9", "--set", "batch_size=11"],
])
def test_load_opts_from_flags_matches_jax(argv):
    j, t = _both(lambda m: m.load_opts(DemoOpts, argv))
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_load_opts_layering_matches_jax(tmp_path):
    """--opts-path, --opts-extra (JSON and YAML) and --set, and the
    snapshot save_opts writes, resolve to the same options in both."""
    import yaml

    base = tmp_path / "base.json"
    base.write_text(json.dumps({"demo_opts": {"version": "v1", "object_lids": [1, 5],
                                              "crop_size": [630, 476], "batch_size": 8}}))
    extra = tmp_path / "extra.yaml"
    extra.write_text(yaml.safe_dump({"demo_opts": {"batch_size": 16, "use_detections": False}}))
    argv = ["--opts-path", str(base), "--opts-extra", str(extra), "--set", "crop_rel_pad=0.3"]
    j, t = _both(lambda m: m.load_opts(DemoOpts, argv))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.crop_size, t.batch_size, t.use_detections, t.crop_rel_pad) == ((630, 476), 16,
                                                                           False, 0.3)
    t_cfg.save_opts(t, str(tmp_path / "t.json"))
    j_cfg.save_opts(j, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert t_cfg.load_opts(DemoOpts, ["--opts-path", str(tmp_path / "t.json")]) == t


@pytest.mark.parametrize("envelope,match", [
    ({"demo_opts": {"version": "v1", "bogus": 1}}, "bogus"),
    ({"demo_opts": {}}, "version"),
    ({"other_opts": {"version": "v1"}}, "demo_opts"),
])
def test_load_opts_rejects_what_jax_rejects(tmp_path, envelope, match):
    p = tmp_path / "opts.json"
    p.write_text(json.dumps(envelope))
    for m in (j_cfg, t_cfg):
        with pytest.raises(ValueError, match=match):
            m.load_opts(DemoOpts, ["--opts-path", str(p)])


def test_merge_helpers_and_names_match_jax():
    base = {"a": {"x": 1, "y": 2}, "b": [1, 2], "c": "keep"}
    upd = {"a": {"y": 20, "z": 30}, "b": [9]}
    for fn, args in ((lambda m, *a: m.merge_json(*a), (base, upd)),
                     (lambda m, *a: m.merge_json_at_path(*a), (base, "a.y", 99)),
                     (lambda m, *a: m.merge_json_at_path(*a), ({}, "p.q.r", {"v": 1})),
                     (lambda m, *a: m.camel_to_snake(*a), ("GenTemplatesOpts",))):
        j, t = _both(lambda m: fn(m, *args))
        assert j == t
    assert base["a"] == {"x": 1, "y": 2}


def test_infer_opts_from_the_shipped_configs_match_jax():
    """Every shipped infer config loads into the port's InferOpts with the
    JAX package's values (the port adds only `device`, "cuda" by default)."""
    for name in sorted(os.listdir(os.path.join(ROOT, "configs", "infer"))):
        argv = ["--opts-path", os.path.join(ROOT, "configs", "infer", name)]
        j = dataclasses.asdict(j_cfg.load_opts(j_infer.InferOpts, argv))
        t = dataclasses.asdict(t_cfg.load_opts(t_infer.InferOpts, argv))
        assert t.pop("device") == "cuda"
        assert t == j, name


def test_yaml_twin_and_unknown_extension(tmp_path):
    """A YAML twin of lmo.json loads identically; other extensions raise."""
    import yaml

    with open(LMO_JSON) as f:
        envelope = json.load(f)
    yaml_path = tmp_path / "lmo.yaml"
    yaml_path.write_text(yaml.safe_dump(envelope))
    assert t_cfg.load_opts(t_infer.InferOpts, ["--opts-path", LMO_JSON]) == t_cfg.load_opts(
        t_infer.InferOpts, ["--opts-path", str(yaml_path)])
    with pytest.raises(ValueError, match=".json or .yaml"):
        t_cfg.load_envelope_file(str(tmp_path / "lmo.toml"))


# ---------------------------------------------------------------------------
# utils/logging_util
# ---------------------------------------------------------------------------


def test_timer_matches_jax():
    """Disabled or not started: None in both; started: a non-negative time,
    after waiting on the value's device where it is a CUDA tensor."""
    for mod in (j_log, t_log):
        assert mod.Timer(enabled=False).elapsed() is None
        assert mod.Timer().elapsed() is None
    jt, tt = j_log.Timer(), t_log.Timer()
    jt.start()
    tt.start()
    assert jt.elapsed("x", sync_on=np.zeros(3)) >= 0.0
    assert tt.elapsed("x", sync_on=torch.zeros(3)) >= 0.0
    cuda_value = mock.MagicMock(spec=torch.Tensor, is_cuda=True, device="cuda:0")
    with mock.patch.object(torch.cuda, "synchronize") as sync:
        assert tt.elapsed("y", sync_on=cuda_value) >= 0.0
    sync.assert_called_once_with("cuda:0")
    assert t_log.get_logger().name == "foundpose_torch"


# ---------------------------------------------------------------------------
# parallel/host_shard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,count", [(0, 3), (7, 3), (100, 8), (3, 8)])
def test_shard_keys_match_jax(n, count):
    keys = [(s, i) for s in range(2) for i in range(n)][:n]
    for idx in range(count):
        assert t_shard.shard_keys(keys, idx, count) == j_shard.shard_keys(keys, idx, count)
        for base in ("estimated-poses.json", "metrics.tsv"):
            assert t_shard.sharded_name(base, idx, count) == j_shard.sharded_name(base, idx, count)


@pytest.mark.parametrize("args", [(5, 5), (-1, 5), (0, -2), (3, 0)])
def test_resolve_shard_rejects_what_jax_rejects(args):
    for mod in (j_shard, t_shard):
        with pytest.raises(ValueError):
            mod.resolve_shard(*args)


def test_resolve_shard_auto_from_torch_distributed(tmp_path):
    """shard_count=0: (0, 1) in one process, as jax.process_index() /
    process_count() give there; the rank and world size of an initialized
    process group otherwise."""
    import torch.distributed as dist

    assert t_shard.resolve_shard(0, 0) == j_shard.resolve_shard(0, 0) == (0, 1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        with mock.patch.object(dist, "get_rank", return_value=2), \
                mock.patch.object(dist, "get_world_size", return_value=4):
            assert t_shard.resolve_shard(0, 0) == (2, 4)
    finally:
        dist.destroy_process_group()


def _record(scene_id, img_id, obj_id):
    return {"scene_id": scene_id, "img_id": img_id, "obj_id": obj_id, "score": 0.5,
            "R": np.eye(3).tolist(), "t": [0.0, 0.0, 100.0], "time": {"total": 0.01},
            "cnos_time": 0.02}


@pytest.mark.parametrize("files,error", [
    ({"estimated-poses_shard0of2.json": [_record(1, 0, 1)],
      "estimated-poses_shard1of2.json": [_record(1, 1, 1), _record(2, 0, 1)]}, None),
    ({"estimated-poses.json": [_record(1, 0, 1)],
      "estimated-poses_shard0of2.json": [_record(1, 0, 1)]}, "BOTH"),
    ({"estimated-poses_shard0of2.json": [], "estimated-poses_shard0of4.json": []},
     "different shard_counts"),
    ({"estimated-poses_shard0of2.json": [_record(1, 0, 1)]}, "missing shards"),
])
def test_load_object_estimates_matches_jax(tmp_path, files, error):
    for name, recs in files.items():
        (tmp_path / name).write_text(json.dumps(recs))
    if error:
        for mod in (j_shard, t_shard):
            with pytest.raises(ValueError, match=error):
                mod.load_object_estimates(str(tmp_path))
    else:
        assert t_shard.load_object_estimates(str(tmp_path)) == j_shard.load_object_estimates(
            str(tmp_path))
    assert t_shard.load_object_estimates(str(tmp_path / "nope")) == ([], [])


def test_empty_shard_sentinel_matches_jax(tmp_path):
    t_path = t_shard.write_empty_shard_sentinel(str(tmp_path / "t"), 1, 2)
    j_path = j_shard.write_empty_shard_sentinel(str(tmp_path / "j"), 1, 2)
    assert os.path.basename(t_path) == os.path.basename(j_path)
    assert open(t_path).read() == open(j_path).read() == "[]"


# ---------------------------------------------------------------------------
# pipeline/infer: BatchRunner, HostFetch, prefetch
# ---------------------------------------------------------------------------


class _JOut(NamedTuple):
    success: np.ndarray
    R_m2w: np.ndarray
    t_m2w: np.ndarray
    R_m2c: np.ndarray
    t_m2c: np.ndarray
    quality: np.ndarray
    score: np.ndarray
    best_template: np.ndarray
    num_queries: np.ndarray
    template_ids: np.ndarray
    best_corresp_2d: np.ndarray
    best_corresp_2d_ids: np.ndarray
    best_corresp_3d: np.ndarray
    best_corresp_conf: np.ndarray
    best_corresp_valid: np.ndarray


def _fake_fields(tags):
    n = len(tags)
    return dict(
        success=np.ones(n, bool), R_m2w=np.broadcast_to(np.eye(3), (n, 3, 3)).copy(),
        t_m2w=np.zeros((n, 3)), R_m2c=np.broadcast_to(np.eye(3), (n, 3, 3)).copy(),
        t_m2c=np.zeros((n, 3)), quality=np.asarray(tags, np.float32),
        score=np.zeros(n, np.float32), best_template=np.zeros(n, np.int64),
        num_queries=np.zeros(n, np.float32), template_ids=np.zeros((n, 5), np.int64),
        best_corresp_2d=np.zeros((n, 4, 2), np.float32),
        best_corresp_2d_ids=np.zeros((n, 4), np.int64),
        best_corresp_3d=np.zeros((n, 4, 3), np.float32),
        best_corresp_conf=np.zeros((n, 4), np.float32),
        best_corresp_valid=np.zeros((n, 4), np.float32),
    )


def _torch_out(tags):
    f = {k: torch.from_numpy(v) for k, v in _fake_fields(tags).items()}
    n = len(tags)
    return t_inf.PoseOutputs(
        template_scores=torch.zeros(n, 5), per_template_quality=torch.zeros(n, 5),
        **{k: v for k, v in f.items()},
    )


def _pending(mod, tag):
    return mod.PendingInstance(
        scene_id=0, im_id=0, inst_id=tag, obj_id=1, det_score=1.0, det_time=0.0,
        crop_image=np.zeros((4, 4, 3), np.uint8), crop_mask=np.zeros((4, 4), np.uint8),
        crop_camera=None, orig_camera=None, gt=None, times={"prep": 0.0},
    )


def _run(mod, batch, n, make_out, max_in_flight=4, between=None):
    seen, high = [], []

    def dispatch_one(seq, padded):
        seen.append((seq, [p.inst_id for p in padded]))
        return make_out([p.inst_id for p in padded])

    runner = mod.BatchRunner(batch, dispatch_one, max_in_flight=max_in_flight)
    for i in range(n):
        runner.push([_pending(mod, i)])
        high.append(len(runner._in_flight))
        if between:
            between()
    return runner.results(), seen, max(high)


@pytest.mark.parametrize("batch,n,max_in_flight", [(4, 11, 4), (1, 8, 2), (3, 3, 1)])
def test_batch_runner_matches_jax(batch, n, max_in_flight):
    """Padded tails sliced away, push order kept, each result from its own
    lane, batches dispatched with the same sequence numbers and padding,
    in-flight batches bounded."""
    jr, js, jh = _run(j_infer, batch, n, lambda tags: _JOut(**_fake_fields(tags)), max_in_flight)
    tr, ts, th = _run(t_infer, batch, n, _torch_out, max_in_flight)
    assert ts == js
    assert th == jh <= max_in_flight
    assert [p.inst_id for p, _ in tr] == [p.inst_id for p, _ in jr] == list(range(n))
    for (_, a), (_, b) in zip(tr, jr):
        assert set(a) == set(b) | {"template_scores"}
        assert a["quality"] == b["quality"] and a["success"] == b["success"]
        np.testing.assert_array_equal(a["R_m2w"], b["R_m2w"])


def test_batch_runner_pipeline_time_excludes_host_prep():
    results, _, _ = _run(t_infer, 2, 4, _torch_out, between=lambda: time.sleep(0.1))
    assert sum(p.times["pipeline"] for p, _ in results) < 0.15
    assert all(p.times["prep"] == 0.0 for p, _ in results)


def test_host_fetch_widens_to_f32_numpy():
    out = _torch_out([0, 1])
    out.best_corresp_conf = out.best_corresp_conf.to(torch.bfloat16) + 0.5
    host = t_infer.HostFetch(out).wait()
    assert isinstance(host.best_corresp_conf, np.ndarray)
    assert host.best_corresp_conf.dtype == np.float32 and host.best_corresp_conf[0, 0] == 0.5
    assert host.success.dtype == np.bool_ and host.template_ids.dtype == np.int64


def test_prefetch_worker_stops_when_generator_abandoned():
    loads = []

    def load_fn(scene_id, im_id):
        loads.append((scene_id, im_id))
        return np.zeros((4, 4, 3), np.uint8)

    gen = t_infer._iter_samples_prefetched([(0, i) for i in range(100)], load_fn, depth=2)
    next(gen)
    gen.close()
    time.sleep(0.5)
    n = len(loads)
    time.sleep(0.5)
    assert len(loads) == n <= 6


@pytest.mark.parametrize("mod", [j_infer, t_infer], ids=["jax", "torch"])
def test_prefetch_loader_exception_reraises_in_consumer(mod):
    def load_fn(scene_id, im_id):
        if im_id == 1:
            raise RuntimeError("corrupt image")
        return im_id

    gen = mod._iter_samples_prefetched([(0, 0), (0, 1), (0, 2)], load_fn, depth=1)
    assert next(gen)[1] == 0
    with pytest.raises(RuntimeError, match="corrupt image"):
        list(gen)


# ---------------------------------------------------------------------------
# prepare_bop_submission, eval_ar, sweep
# ---------------------------------------------------------------------------


def test_prepare_submission_matches_jax(tmp_path):
    """A 2-shard object and an unsharded one flatten into byte-equal CSVs;
    a missing object raises in both."""
    base = tmp_path / "demo" / "v1"
    (base / "1").mkdir(parents=True)
    (base / "2").mkdir(parents=True)
    (base / "1" / "estimated-poses_shard0of2.json").write_text(json.dumps([_record(1, 0, 1)]))
    (base / "1" / "estimated-poses_shard1of2.json").write_text(json.dumps([_record(1, 1, 1)]))
    (base / "2" / "estimated-poses.json").write_text(json.dumps([_record(1, 0, 2)]))
    paths = []
    for sub, name in ((j_sub, "j.csv"), (t_sub, "t.csv")):
        paths.append(sub.prepare(sub.PrepareBopSubmissionOpts(
            object_dataset="demo", version="v1", results_dir=str(tmp_path),
            output_path=str(tmp_path / name))))
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    (base / "3").mkdir()
    for sub in (j_sub, t_sub):
        with pytest.raises(FileNotFoundError):
            sub.prepare(sub.PrepareBopSubmissionOpts(
                object_dataset="demo", version="v1", object_lids=[3],
                results_dir=str(tmp_path)))


def _eval_split(tmp_path, rng):
    """A BOP split without images: one scene of two images with GT for
    objects 1 (two instances) and 2, their models and a symmetric model
    info, and a submission CSV of perturbed GT poses."""
    from scipy.spatial.transform import Rotation

    scene = tmp_path / "demo" / "test" / "000001"
    scene.mkdir(parents=True)
    models = tmp_path / "demo" / "models"
    models.mkdir(parents=True)
    k = [572.4, 0.0, 325.3, 0.0, 573.6, 242.0, 0.0, 0.0, 1.0]
    (scene / "scene_camera.json").write_text(json.dumps(
        {str(i): {"cam_K": k, "depth_scale": 1.0} for i in range(2)}))
    gts, rows = {}, ["scene_id,im_id,obj_id,score,R,t,time"]
    for im in range(2):
        gts[str(im)] = []
        for obj in (1, 1, 2):
            r = Rotation.from_rotvec(rng.uniform(-1, 1, 3)).as_matrix()
            t = rng.uniform([-50, -50, 500], [50, 50, 900])
            gts[str(im)].append({"obj_id": obj, "cam_R_m2c": r.flatten().tolist(),
                                 "cam_t_m2c": t.tolist()})
            re = Rotation.from_rotvec(rng.normal(size=3) * 0.05).as_matrix() @ r
            te = t + rng.normal(size=3) * 5.0
            rows.append(f"1,{im},{obj},{rng.uniform():.4f},{' '.join(map(str, re.flatten()))},"
                        f"{' '.join(map(str, te))},0.1")
    (scene / "scene_gt.json").write_text(json.dumps(gts))
    (scene / "scene_gt_info.json").write_text(json.dumps(
        {str(i): [{"visib_fract": 0.8}] * 3 for i in range(2)}))
    for obj in (1, 2):
        save_ply(str(models / f"obj_{obj:06d}.ply"),
                 Mesh(vertices=rng.uniform(-40, 40, (50, 3)).astype(np.float32)))
    (models / "models_info.json").write_text(json.dumps({
        "1": {"diameter": 120.0},
        "2": {"diameter": 90.0, "symmetries_continuous": [{"axis": [0, 0, 1],
                                                           "offset": [0, 0, 0]}]}}))
    csv = tmp_path / "sub.csv"
    csv.write_text("\n".join(rows))
    return str(csv)


def test_eval_ar_matches_jax(tmp_path, rng):
    csv = _eval_split(tmp_path, rng)
    out = {}
    for name, ev in (("jax", j_eval_ar), ("torch", t_eval_ar)):
        out[name] = ev.evaluate(ev.EvalArOpts(
            object_dataset="demo", submission_path=csv, bop_root=str(tmp_path),
            max_sym_disc_step=0.05, output_path=str(tmp_path / f"{name}.json")))
    assert set(out["torch"]) == set(out["jax"])
    for key, v in out["jax"].items():
        np.testing.assert_allclose(out["torch"][key], v, atol=1e-6)
    assert 0.0 < out["torch"]["bop_ar"] < 1.0
    assert json.load(open(tmp_path / "torch.json")) == out["torch"]


def _fake_infer(calls):
    def fake_infer(opts):
        calls.append((opts.object_dataset, getattr(opts, "device", None)))
        out = os.path.join(opts.output_dir, opts.object_dataset, opts.version, "1")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "estimated-poses.json"), "w") as f:
            json.dump([{"scene_id": "1", "img_id": "0", "obj_id": "1", "score": "0.5",
                        "R": np.eye(3).tolist(), "t": [[0.0], [0.0], [1.0]],
                        "time": {"pipeline": 0.01}, "cnos_time": 0.1}], f)
    return fake_infer


@pytest.mark.parametrize("shard", [(0, 1), (0, 0), (0, 2)])
def test_sweep_matches_jax(tmp_path, monkeypatch, shard):
    """Each dataset is inferred in turn; unsharded (shard_count 1, or 0
    resolving to one process) sweeps end in a CSV per dataset, a 2-shard
    sweep defers it. The port passes its `device` on to infer."""
    out = {}
    for name, mod in (("jax", j_sweep), ("torch", t_sweep)):
        calls = []
        monkeypatch.setattr(mod.infer_mod, "infer", _fake_infer(calls))
        kw = dict(datasets=["lmo", "tudl"], output_dir=str(tmp_path / name),
                  detections_dir=str(tmp_path), bop_root=str(tmp_path), repre_dir=str(tmp_path),
                  shard_index=shard[0], shard_count=shard[1])
        if name == "torch":
            kw["device"] = "cpu"
        res = mod.sweep(mod.SweepOpts(**kw))
        out[name] = ({k: os.path.relpath(v, tmp_path / name) for k, v in res.items()}, calls)
    assert out["torch"][0] == out["jax"][0]
    assert [c[0] for c in out["torch"][1]] == [c[0] for c in out["jax"][1]] == ["lmo", "tudl"]
    assert all(c[1] == "cpu" for c in out["torch"][1])
    for ds, rel in out["torch"][0].items():
        path = tmp_path / "torch" / rel
        if shard[1] == 2:
            assert path.is_dir()
        else:
            lines = path.read_text().strip().split("\n")
            assert lines[0].startswith("scene_id,") and len(lines) == 2
