"""The port's PoseEngine on a device mesh, in f32 on the CPU:
PoseEngine(mesh_shape=(2, 2)) against the single-device PoseEngine, and the
errors of both entry points without a process group.

As in tests/test_torch_parallel.py, the ranks are gloo processes spawned
once for the module, and JAX (which builds the world) is imported only
inside the fixture.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)
from test_torch_parallel import read_ranks, run_ranks

from foundpose_torch import engine as t_engine
from foundpose_torch.pipeline import infer as t_infer


def engine_calls(engine, image, boxes, masks, k):
    """The compared calls, in order: estimate() of objects 3 and 7 (three
    boxes: two chunks of batch 2, the second padded; object 7 with bool
    masks), then estimate_mixed() over both."""
    dets = [{"obj_id": o, "box_xyxy": b} for o, b in zip((3, 7, 3), boxes)]
    return [engine.estimate(3, image, boxes, k), engine.estimate(7, image, boxes, k, masks),
            engine.estimate_mixed(image, dets, k)]


def _engine_rank(rank, world, in_path, out_dir):
    with open(in_path, "rb") as f:
        p = pickle.load(f)
    engine = t_engine.PoseEngine(mesh_shape=(2, 2), device="cpu", **p["kw"])
    engine.max_cached_mesh_steps = 1
    for obj_id, r in p["repres"].items():
        engine.register_object(obj_id, r)
    res = {"calls": engine_calls(engine, p["image"], p["boxes"], p["masks"], p["K"]),
           "cached_steps": list(engine._mesh_steps), "jax_loaded": "jax" in sys.modules}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The single-device engine's results and every mesh rank's, for the
    world of tests/test_torch_serving.py."""
    from test_torch_serving import BOXES, K_IMAGE, TINY_VIT, crop_world, tiny_engines
    from test_torch_pipeline import torch_repre

    d = tmp_path_factory.mktemp("engine")
    je, te = tiny_engines(d)
    rng = np.random.default_rng(0)
    image = (rng.uniform(size=(240, 320, 3)) * 255).astype(np.uint8)
    masks = [np.zeros((240, 320), bool) for _ in BOXES]
    for m, (x1, y1, x2, y2) in zip(masks, BOXES.astype(int)):
        m[max(y1, 0) : y2, max(x1, 0) : x2] = True
    repres = {k: torch_repre(r) for k, r in crop_world(
        rng, je, image, np.ones((3, 240, 320), np.float32), {3: [0, 2], 7: [1]}).items()}
    kw = dict(weights_path=str(d / "tiny.pth"), config=te.config, batch_size=2,
              extractor_overrides=TINY_VIT)
    single = t_engine.PoseEngine(device="cpu", **kw)
    for obj_id, r in repres.items():
        single.register_object(obj_id, r)
    p = dict(kw=kw, repres=repres, image=image, boxes=list(BOXES), masks=masks, K=K_IMAGE)
    ref = engine_calls(single, p["image"], p["boxes"], p["masks"], p["K"])
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(p, f)
    run_ranks(_engine_rank, 4, str(d / "inputs.pkl"), str(d))
    return ref, read_ranks(d, 4)


def test_mesh_engine_matches_single_device_engine(engines):
    """estimate() twice and estimate_mixed() on a (2, 2) mesh: on every
    rank the single-device engine's winners, success, counts and scores,
    poses within 1e-4 (R) and 1e-5 (t); the LRU keeps one object's step."""
    ref, ranks = engines
    assert [[r["success"] for r in call] for call in ref] == [
        [True, False, True], [False, True, False], [True, True, True]]
    for rank in ranks:
        assert not rank["jax_loaded"]
        assert rank["cached_steps"] == [7]
        for got_call, ref_call in zip(rank["calls"], ref):
            assert len(got_call) == len(ref_call)
            for g, r in zip(got_call, ref_call):
                assert (g["best_template"], g["success"], g["quality"]) == (
                    r["best_template"], r["success"], r["quality"])
                np.testing.assert_allclose(g["R_m2c"], r["R_m2c"], atol=1e-4)
                np.testing.assert_allclose(g["t_m2c"], r["t_m2c"], atol=1e-5)
                np.testing.assert_allclose(g["score"], r["score"], atol=1e-6)


def test_engine_and_cli_need_a_process_group(tmp_path):
    """Without an initialized process group of the mesh's size the engine
    and the CLI raise ValueError naming torchrun; a data axis that does not
    divide the batch raises first."""
    with pytest.raises(ValueError, match="torchrun"):
        t_engine.PoseEngine(mesh_shape=(2, 2), device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        t_infer._build_mesh(t_infer.InferOpts(batch_size=4, mesh_shape=(2, 2)))
    with pytest.raises(ValueError, match="batch_size=3"):
        t_infer._build_mesh(t_infer.InferOpts(batch_size=3, mesh_shape=(2, 4)))
    with pytest.raises(ValueError, match="batch_size=3"):
        t_engine.PoseEngine(mesh_shape=(2, 2), batch_size=3, device="cpu")
