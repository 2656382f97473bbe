"""The port's offline CLI on a device mesh (InferOpts.mesh_shape), in f32
on the CPU: on 2 ranks and under torchrun, against the single-device CLI.

As in tests/test_torch_parallel.py, the ranks are gloo processes spawned
once for the module, and JAX (which builds the split) is imported only
inside the fixture.
"""

import dataclasses
import json
import os
import pickle
import sys

import numpy as np
import pytest
from test_torch_parallel import read_ranks

from foundpose_torch.parallel import launch
from foundpose_torch.pipeline import infer as t_infer

MODES = ("single", "multi")


def _cli_rank(rank, world, fields, out_dir):
    calls = []
    finalize = t_infer.finalize_object_results
    t_infer.finalize_object_results = lambda *a, **k: calls.append(a[1]) or finalize(*a, **k)
    counts = {}
    try:
        for mode, shape in zip(MODES, ((2, 1), (1, 2))):
            opts = t_infer.InferOpts(**fields, mesh_shape=shape, device="cpu",
                                     output_dir=os.path.join(out_dir, f"mesh_{mode}"))
            fn = t_infer.infer_multi_object if mode == "multi" else t_infer.infer
            counts[mode] = fn(opts)
    finally:
        t_infer.finalize_object_results = finalize
    shards = [t_infer.shard_of(dataclasses.replace(opts, shard_index=i, shard_count=c))
              for i, c in ((0, 0), (1, 2))]
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"finalized": calls, "counts": counts, "shards": shards}, f)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """tests/test_torch_infer.py's split through the single-device CLI and,
    on 2 ranks, the CLI at mesh_shape (2, 1) (single-object) and (1, 2)
    (multi-object), with the same batch draws (Generator(seq))."""
    from test_torch_infer import build_split

    root = str(tmp_path_factory.mktemp("split"))
    fields = build_split(root, np.random.default_rng(0))
    counts = {}
    for mode in MODES:
        opts = t_infer.InferOpts(**fields, device="cpu",
                                 output_dir=os.path.join(root, f"single_{mode}"))
        counts[mode] = (t_infer.infer_multi_object if mode == "multi" else t_infer.infer)(opts)
    launch.run(_cli_rank, 2, fields, root)
    return root, fields, counts, read_ranks(root, 2)


@pytest.mark.parametrize("mode", MODES)
def test_mesh_cli_writes_the_single_device_files(cli, mode):
    """Each object's estimated-poses.json from the mesh run holds the
    single-device run's records (poses within 1e-4 / 1e-5, scores within
    1e-6; the times differ); only rank 0 finalized (wrote) objects."""
    root, fields, counts, ranks = cli
    assert ranks[0]["counts"][mode] == ranks[1]["counts"][mode] == counts[mode]
    assert sorted(ranks[0]["finalized"]) == sorted(fields["object_lids"] * 2)
    assert ranks[1]["finalized"] == []
    records = 0
    for lid in fields["object_lids"]:
        paths = [os.path.join(root, f"{run}_{mode}", "lmo", "v1", str(lid),
                              "estimated-poses.json") for run in ("single", "mesh")]
        single, mesh = (json.load(open(p)) for p in paths)
        assert len(mesh) == len(single)
        records += len(mesh)
        for a, b in zip(mesh, single):
            assert set(a) == set(b)
            for k in ("scene_id", "img_id", "obj_id", "inst_id", "hypothesis_id"):
                assert a[k] == b[k], k
            np.testing.assert_allclose(float(a["score"]), float(b["score"]), atol=1e-6)
            np.testing.assert_allclose(a["R"], b["R"], atol=1e-4)
            np.testing.assert_allclose(a["t"], b["t"], atol=1e-5)
    assert records >= 4


def test_cli_main_under_torchrun(cli, tmp_path):
    """`torchrun --nproc-per-node 2 -m foundpose_torch.pipeline.infer ...
    --set mesh_shape=[1,2]` (main() initializes the gloo group from
    torchrun's environment) writes the single-device run's poses."""
    import subprocess

    root, fields, _, _ = cli
    path = tmp_path / "opts.json"
    path.write_text(json.dumps({"infer_opts": dict(fields, object_lids=[1])}))
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "foundpose_torch.pipeline.infer", "--opts-path", str(path), "--set", "device=cpu",
         "--set", "mesh_shape=[1,2]", "--set", f"output_dir={out}"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), capture_output=True,
        text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.load(open(out / "lmo" / "v1" / "1" / "estimated-poses.json"))
    want = json.load(open(os.path.join(root, "single_single", "lmo", "v1", "1",
                                       "estimated-poses.json")))
    assert [(a["img_id"], a["inst_id"]) for a in got] == [(a["img_id"], a["inst_id"]) for a in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["R"], b["R"], atol=1e-4)
        np.testing.assert_allclose(a["t"], b["t"], atol=1e-5)


def test_mesh_cli_resolves_auto_shards_to_one(cli):
    """Under a mesh of the whole process group, shard_count=0 resolves to
    (0, 1) on every rank (host_shard would give each rank its own shard);
    explicit values compose with the mesh."""
    for rank in cli[3]:
        assert rank["shards"] == [(0, 1), (1, 2)]
