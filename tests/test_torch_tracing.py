"""The port's span and op-count recorder (utils/profiling) on the CPU: off
it records nothing and opens no profiler range; on, the step, the solve and
PoseEngine.estimate give their span trees with request ids, self times and
op counts; the recorder closes on an exception; traces hold the spans."""

import json
import os

import numpy as np
import pytest
import torch

from foundpose_torch.engine import PoseEngine
from foundpose_torch.models.dinov2 import DinoV2Config
from foundpose_torch.models.weights import load_or_init
from foundpose_torch.pipeline import inference
from foundpose_torch.structs import PinholeCamera
from foundpose_torch.synthetic import realistic_repre
from foundpose_torch.utils import profiling

STEP_PATHS = [
    "step", "step/vit", "step/retrieval", "step/match", "step/solve", "step/solve/ransac",
    "step/solve/ransac/dlt", "step/solve/ransac/score", "step/solve/refine",
    "step/solve/refine/lo_lm",
]
CROP = 84
TINY_VIT = dict(embed_dim=32, depth=2, num_heads=2, pos_grid=6)
EXTRACTOR = "dinov2_version=vits14-reg_stride=14_facet=token_layer=1_norm=1"
K = np.array([[100.0, 0, 63.5], [0, 100.0, 47.5], [0, 0, 1]])
BOXES = [np.array(b, np.float32) for b in ([10, 10, 50, 50], [30, 20, 90, 80], [5, 5, 40, 60])]


@pytest.fixture(scope="module")
def world():
    model = load_or_init(DinoV2Config(layer=1, **TINY_VIT), seed=0)
    repre = realistic_repre(0, num_templates=8, fmax=32, feat_dim=16, num_words=16, raw_dim=32,
                            n_points=256)
    config = inference.InferenceConfig(crop_size=(CROP, CROP), top_n_templates=2,
                                       top_k_buddies=20, pnp_ransac_iter=16)
    g = torch.Generator().manual_seed(1)
    b = 3
    crops = torch.randint(0, 256, (b, CROP, CROP, 3), dtype=torch.uint8, generator=g)
    cams = PinholeCamera(f=torch.full((b, 2), 100.0), c=torch.full((b, 2), CROP / 2 - 0.5),
                         T_world_from_eye=torch.eye(4).expand(b, 4, 4), width=CROP,
                         height=CROP)
    return model, repre, config, crops, torch.ones(b, CROP, CROP), cams


def step(world, seed=0):
    model, repre, config, crops, masks, cams = world
    return inference.pose_from_crops(model, crops, masks, cams, repre, config,
                                     generator=torch.Generator().manual_seed(seed))


def children(records, i):
    return [r for r in records if r.parent == i]


def assert_tree(records):
    """Parents close around their children; a child's path is its parent's
    and its own name; a root's request is new, a child's its parent's;
    self time is the duration less the children's."""
    roots = [r.request for r in records if r.parent is None]
    assert len(set(roots)) == len(roots)
    for i, r in enumerate(records):
        if r.parent is None:
            assert r.path == r.name
        else:
            p = records[r.parent]
            assert r.path == p.path + "/" + r.name and r.request == p.request
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
        assert r.host_ms == pytest.approx((r.end_ns - r.start_ns) / 1e6)
        kids = sum(c.host_ms for c in children(records, i))
        assert r.self_host_ms == pytest.approx(r.host_ms - kids, abs=1e-9)
        assert r.self_host_ms >= 0


def test_off_the_recorder_records_nothing_and_opens_no_range(world):
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        pass
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(world)
    names = {e.name for e in prof.events()}
    assert not [n for n in names if n.startswith(profiling.RANGE_PREFIX)]
    assert any(n.startswith("aten::") for n in names)


def test_pose_from_crops_span_tree(world):
    with profiling.record() as rec:
        step(world)
    records = rec.spans()
    assert [r.path for r in records] == STEP_PATHS
    assert {r.request for r in records} == {0}
    assert all(r.ops is None for r in records)
    assert all((r.device_ms is None) != torch.cuda.is_available() for r in records)
    assert_tree(records)


@pytest.mark.parametrize("mixed", [False, True])
def test_engine_span_tree_one_request_id_per_call(world, mixed):
    """estimate and estimate_mixed (the stacked multi-object step) give the
    same tree: 3 boxes in chunks of 2."""
    model, repre, config = world[:3]
    engine = PoseEngine(extractor_name=EXTRACTOR, config=config, batch_size=2,
                        extractor_overrides=TINY_VIT, device="cpu", model=model)
    engine.register_object(1, repre)
    engine.register_object(2, repre)
    image = np.random.default_rng(0).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    dets = [{"obj_id": 1 + i % 2, "box_xyxy": b} for i, b in enumerate(BOXES)]
    with profiling.record() as rec:
        for _ in range(2):
            if mixed:
                engine.estimate_mixed(image, dets, K)
            else:
                engine.estimate(1, image, BOXES, K)
    records = rec.spans()
    step_paths = ["estimate/" + p for p in STEP_PATHS]
    one = (["estimate", "estimate/prepare"] + (["estimate/warp"] + step_paths) * 2
           + ["estimate/fetch"] * 2)
    assert [r.path for r in records] == one * 2
    assert [r.request for r in records] == [0] * len(one) + [1] * len(one)
    assert_tree(records)


def test_op_counts_repeat_and_count_the_kernel_wrappers(world, monkeypatch):
    counts = []
    for _ in range(2):
        with profiling.record(count_ops=True) as rec:
            step(world)
        counts.append({r.path: r.ops for r in rec.spans()})
    assert counts[0] == counts[1]
    c = counts[0]
    assert c["step/solve"] > 0
    assert c["step/solve"] >= c["step/solve/ransac"] + c["step/solve/refine"]
    assert c["step"] >= sum(c[p] for p in ("step/vit", "step/retrieval", "step/match",
                                           "step/solve"))

    def stub(n):
        stub.launches += n

    stub.launches = 0
    monkeypatch.setattr(profiling, "kernel_counters", lambda: {"stub": stub})
    with profiling.record(count_ops=True) as rec:
        with profiling.span("outer"):
            stub(2)
            with profiling.span("inner"):
                stub(3)
    assert [(r.path, r.ops) for r in rec.spans()] == [("outer", 5), ("outer/inner", 3)]


def test_recorder_is_off_after_an_exception_in_a_span():
    with pytest.raises(ValueError):
        with profiling.record():
            with profiling.span("a"):
                with profiling.span("b"):
                    raise ValueError("inside")
    assert profiling.span("a") is profiling.span("b")
    with profiling.record() as rec:
        with profiling.span("c"):
            with pytest.raises(ValueError):
                rec.spans()
    assert [(r.path, r.parent) for r in rec.spans()] == [("c", None)]


def test_trace_holds_the_program_spans(world, tmp_path):
    with profiling.trace(str(tmp_path)):
        step(world)
    with open(os.path.join(tmp_path, profiling.TRACE_FILE)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "foundpose/step/solve" in names and "foundpose/step/solve/ransac/dlt" in names


def test_kernel_counters_are_the_main_path_wrappers():
    from foundpose_torch.benchmarks import bench

    main = profiling.kernel_counters()
    assert list(main) == ["vit_block", "buddies", "ransac_dlt", "ransac_score", "attention",
                          "refine"]
    assert all(isinstance(fn.launches, int) for fn in main.values())
    assert list(bench.kernel_counters()) == list(main) + ["mm_bf16", "mm_int8"]


DINOV3 = dict(embed_dim=256, num_heads=2, depth=2)
DINOV3_NAME = "dinov3_version=vit7b16_stride=16_facet=token_layer=1_norm=1"


@pytest.fixture(scope="module")
def world_dinov3():
    """`world` with a tiny DINOv3 (heads of 128, RoPE, 4 storage tokens) at
    96 px crops, a 6 x 6 grid of patch 16."""
    import dataclasses

    from foundpose_torch.models import dinov3

    cfg = dataclasses.replace(dinov3.parse_model_name(DINOV3_NAME), **DINOV3)
    model = load_or_init(cfg, seed=0)
    repre = realistic_repre(0, num_templates=8, fmax=32, feat_dim=16, num_words=16, raw_dim=256,
                            n_points=256)
    crop = 96
    config = inference.InferenceConfig(crop_size=(crop, crop), grid_cell_size=16.0,
                                       top_n_templates=2, top_k_buddies=20, pnp_ransac_iter=16)
    g = torch.Generator().manual_seed(1)
    b = 3
    crops = torch.randint(0, 256, (b, crop, crop, 3), dtype=torch.uint8, generator=g)
    cams = PinholeCamera(f=torch.full((b, 2), 100.0), c=torch.full((b, 2), crop / 2 - 0.5),
                         T_world_from_eye=torch.eye(4).expand(b, 4, 4), width=crop,
                         height=crop)
    return model, repre, config, crops, torch.ones(b, crop, crop), cams


def test_dinov3_step_span_tree_and_counters(world_dinov3, monkeypatch):
    """Inside `step/vit`, DINOv3 opens `rope`, `embed`, `blocks` and `facet`;
    `dinov3.rope_tables.builds` counts the tables' cache misses (one for a
    new grid, none after); `fused_vit_block.rope_launches` counts the
    kernel's launches with tables and stays out of `kernel_counters()`, so
    the launch total does not count them twice (the CPU runs the twin, no
    launch)."""
    from foundpose_torch.models import dinov3
    from foundpose_torch.ops.vit_block import fused_vit_block

    monkeypatch.setattr(dinov3, "_ROPE_CACHE", {})
    builds, rope_launches = dinov3.rope_tables.builds, fused_vit_block.rope_launches
    with profiling.record() as rec:
        step(world_dinov3)
        step(world_dinov3)
    vit = ["step/vit/rope", "step/vit/embed", "step/vit/blocks", "step/vit/facet"]
    one = STEP_PATHS[:2] + vit + STEP_PATHS[2:]
    records = rec.spans()
    assert [r.path for r in records] == one * 2
    assert_tree(records)
    assert dinov3.rope_tables.builds == builds + 1
    assert fused_vit_block.rope_launches == rope_launches
    assert "rope" not in " ".join(profiling.kernel_counters())

