"""The PyTorch port stands alone: no JAX import anywhere in its package;
PIL, tabulate and cv2 imported only where an image is read or drawn, a
table written or a reference replica solves, and sklearn and transformers
nowhere, so every module imports without them; chip_smoke.py refuses to
run without a GPU; and torch in a test process keeps to its share of the
cores (tests/torch_cpu.py)."""

import json
import os
import re
import shutil
import signal
import subprocess
import sys

import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "foundpose_torch")
BLOCKED = ("jax", "flax", "foundpose_tpu", "PIL", "tabulate", "cv2", "sklearn",
           "transformers")


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def test_no_jax_import_statements():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|foundpose_tpu)\b", re.M)
    offenders = [p for p in _sources() if pattern.search(open(p).read())]
    assert not offenders, offenders


# One interpreter blocks BLOCKED, imports torch and numpy once, forks a child
# per module of argv[1] that imports it with no other foundpose_torch module
# loaded, then imports every module itself; it prints one JSON object: each
# module's traceback ("" when it imported), and the count of all modules or
# the traceback that stopped them.
_IMPORT_CHECK = f"""
import importlib, json, os, pkgutil, sys, traceback
for name in {BLOCKED!r}:
    sys.modules[name] = None
import numpy, torch

def alone(module):
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        try:
            importlib.import_module(module)
            msg = ""
        except BaseException:
            msg = traceback.format_exc()
        with os.fdopen(w, "w") as f:
            f.write(msg)
        os._exit(0)
    os.close(w)
    with os.fdopen(r) as f:
        msg = f.read()
    status = os.waitpid(pid, 0)[1]
    return msg or ("" if status == 0 else f"the child exited with status {{status}}")

each = {{m: alone(m) for m in json.loads(sys.argv[1])}}
try:
    import foundpose_torch
    names = [m.name for m in pkgutil.walk_packages(foundpose_torch.__path__, "foundpose_torch.")]
    for n in names:
        importlib.import_module(n)
    every = len(names)
except BaseException:
    every = traceback.format_exc()
print(json.dumps({{"each": each, "all": every}}))
"""
# Seconds the import check's interpreter may take, its children included.
IMPORT_DEADLINE = 600

SERVING_MODULES = [
    "foundpose_torch.cameras", "foundpose_torch.engine", "foundpose_torch.ops.warp",
    "foundpose_torch.ops.attention", "foundpose_torch.pipeline.multi_object",
    "foundpose_torch.benchmarks.micro_int8",
    "foundpose_torch.pose.featuremetric", "foundpose_torch.ops.sampling",
    "foundpose_torch.ops.morphology", "foundpose_torch.eval.errors",
    "foundpose_torch.eval.evaluator", "foundpose_torch.eval.bop_ar", "foundpose_torch.data.ply",
    "foundpose_torch.data.bop", "foundpose_torch.data.detections",
    "foundpose_torch.utils.config", "foundpose_torch.utils.logging_util",
    "foundpose_torch.parallel.host_shard", "foundpose_torch.pipeline.infer",
    "foundpose_torch.pipeline.prepare_bop_submission", "foundpose_torch.pipeline.eval_ar",
    "foundpose_torch.pipeline.sweep", "foundpose_torch.renderer.base",
    "foundpose_torch.renderer.rasterizer", "foundpose_torch.vis.base",
    "foundpose_torch.vis.inference_vis", "foundpose_torch.vis.html_report",
    "foundpose_torch.ops.kmeans", "foundpose_torch.pipeline.gen_templates",
    "foundpose_torch.pipeline.gen_repre", "foundpose_torch.parallel.mesh",
    "foundpose_torch.parallel.sharded_inference", "foundpose_torch.parallel.tp_vit",
    "foundpose_torch.parallel.launch", "foundpose_torch.models.dinov2",
    "foundpose_torch.models.weights", "foundpose_torch.models.bench_weights",
    "foundpose_torch.utils.flops", "foundpose_torch.utils.profiling",
    "foundpose_torch.benchmarks.block_split", "foundpose_torch.benchmarks.bench",
    "foundpose_torch.benchmarks.latency", "foundpose_torch.benchmarks.featuremetric_bench",
    "foundpose_torch.benchmarks.sync_count", "foundpose_torch.benchmarks.micro_pnp",
    "foundpose_torch.benchmarks.micro_buddies", "foundpose_torch.benchmarks.micro_retrieval",
    "foundpose_torch.benchmarks.vit_stage_bench", "foundpose_torch.benchmarks.cli_throughput",
    "foundpose_torch.benchmarks.builder_full_scale",
    "foundpose_torch.benchmarks.cross_parity", "foundpose_torch.benchmarks.solve_sweep_harness",
    "foundpose_torch.benchmarks.ransac_sweep", "foundpose_torch.benchmarks.lm_iters_sweep",
    "foundpose_torch.benchmarks.select_iter_sweep", "foundpose_torch.benchmarks.hf_dinov2",
    "foundpose_torch.benchmarks.host_standins", "foundpose_torch.benchmarks.reference_baseline",
    "foundpose_torch.benchmarks.reference_offline_baseline",
]


@pytest.fixture(scope="module")
def import_check():
    """The import check's result, from one fresh interpreter (never a fork of
    this process, which holds JAX's threads); killed with its children, and
    the tests failed, past IMPORT_DEADLINE."""
    proc = subprocess.Popen([sys.executable, "-c", _IMPORT_CHECK, json.dumps(SERVING_MODULES)],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=IMPORT_DEADLINE)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the import check did not finish in {IMPORT_DEADLINE} s")
    assert proc.returncode == 0, err
    return json.loads(out.strip().splitlines()[-1])


def test_every_module_imports_with_jax_blocked(import_check):
    assert isinstance(import_check["all"], int), import_check["all"]
    assert import_check["all"] >= 66


@pytest.mark.parametrize("module", SERVING_MODULES)
def test_serving_modules_import_with_jax_blocked(import_check, module):
    """Each module of the serving, refinement, evaluation, CLI, builder,
    multi-device, ViT-G, bench and measurement slices, of the
    cross-parity oracle and the solve sweeps, and of the reference
    replicas, imports on its own with jax, flax, foundpose_tpu, PIL,
    tabulate, cv2, sklearn and transformers blocked."""
    assert import_check["each"][module] == "", import_check["each"][module]


def test_torch_threads_follow_the_worker_share():
    """torch in this test process runs on its share of the cores: all of
    them alone, cpu_count // workers (at least one) in an xdist worker."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert torch.get_num_threads() == max(1, os.cpu_count() // workers)


@pytest.mark.parametrize("isolated", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, isolated):
    """On a CPU-only machine (and in a directory holding chip_smoke.py
    alone) the script exits non-zero and prints no result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if isolated:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, script], cwd=cwd, capture_output=True, text=True, timeout=120, env=env
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("loader", ["make_repre", "load_repre", "load_torch_repre"])
def test_repre_loaders_default_to_the_card(loader):
    """The representation loaders are entry points: they put the
    representation on the card unless the caller asks for the CPU."""
    import inspect

    from foundpose_torch import repre

    assert inspect.signature(getattr(repre, loader)).parameters["device"].default == "cuda"


def test_gen_repre_defaults_to_the_card_and_never_falls_back():
    """GenRepreOpts.device is "cuda", as the shipped configs leave it; asked
    for the card on a machine without CUDA, the builder raises."""
    from foundpose_torch.pipeline import gen_repre

    with open(os.path.join(ROOT, "configs", "gen_repre", "lmo.json")) as f:
        opts = gen_repre.GenRepreOpts(**json.load(f)["gen_repre_opts"])
    assert opts.device == "cuda"
    assert gen_repre.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gen_repre.resolve_device(opts.device)


def test_inference_config_from_lmo_json():
    from foundpose_torch.pipeline import inference

    with open(os.path.join(ROOT, "configs", "infer", "lmo.json")) as f:
        opts = json.load(f)
    cfg = inference.inference_config_from_opts(opts)
    assert cfg.crop_size == (420, 420)
    assert (cfg.top_n_templates, cfg.top_k_buddies, cfg.pnp_ransac_iter) == (5, 300, 200)
    assert cfg.approx_topk and cfg.compute_dtype == torch.bfloat16
    vit = inference.vit_config_from_opts(opts)
    assert (vit.embed_dim, vit.layer, vit.num_register_tokens) == (384, 9, 4)
    assert vit.approx_gelu and vit.softmax_stabilizer == "capped"
    assert vit.use_fused_block
    with open(os.path.join(ROOT, "configs", "infer", "lmo_exact.json")) as f:
        exact_opts = json.load(f)
    exact = inference.inference_config_from_opts(exact_opts)
    assert exact.pnp_ransac_iter >= cfg.pnp_ransac_iter


def test_lmo_exact_json_resolves_to_the_unfused_f32_path():
    """configs/infer/lmo_exact.json: unfused ViT-S/14-reg at full width,
    f32, erf GELU; exact top-k, 400 RANSAC hypotheses."""
    from foundpose_torch.pipeline import inference

    with open(os.path.join(ROOT, "configs", "infer", "lmo_exact.json")) as f:
        opts = json.load(f)
    cfg = inference.inference_config_from_opts(opts)
    vit = inference.vit_config_from_opts(opts)
    assert not vit.use_fused_block and not vit.approx_gelu
    assert (vit.embed_dim, vit.num_heads, vit.mlp_hidden, vit.layer) == (384, 6, 1536, 9)
    assert cfg.compute_dtype == torch.float32 and not cfg.approx_topk
    assert (cfg.top_n_templates, cfg.top_k_buddies, cfg.pnp_ransac_iter) == (5, 300, 400)
