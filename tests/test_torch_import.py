"""The PyTorch port stands alone: no JAX import anywhere in its package;
PIL, tabulate and cv2 imported only where an image is read or drawn or a
table written, so every module imports without them; and chip_smoke.py
refuses to run without a GPU."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "foundpose_torch")
BLOCKED = ("jax", "flax", "foundpose_tpu", "PIL", "tabulate", "cv2")


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def test_no_jax_import_statements():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|foundpose_tpu)\b", re.M)
    offenders = [p for p in _sources() if pattern.search(open(p).read())]
    assert not offenders, offenders


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import foundpose_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(foundpose_torch.__path__, 'foundpose_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 60


@pytest.mark.parametrize("module", [
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
    "foundpose_torch.parallel.launch",
])
def test_serving_modules_import_with_jax_blocked(module):
    """Each module of the serving, refinement, evaluation, CLI, builder and
    multi-device slices imports on its own with jax, flax, foundpose_tpu, PIL, tabulate and cv2
    blocked."""
    code = (
        "import sys, importlib\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"importlib.import_module({module!r})\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


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

    import torch

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

    import torch

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

    import torch

    with open(os.path.join(ROOT, "configs", "infer", "lmo_exact.json")) as f:
        opts = json.load(f)
    cfg = inference.inference_config_from_opts(opts)
    vit = inference.vit_config_from_opts(opts)
    assert not vit.use_fused_block and not vit.approx_gelu
    assert (vit.embed_dim, vit.num_heads, vit.mlp_hidden, vit.layer) == (384, 6, 1536, 9)
    assert cfg.compute_dtype == torch.float32 and not cfg.approx_topk
    assert (cfg.top_n_templates, cfg.top_k_buddies, cfg.pnp_ransac_iter) == (5, 300, 400)
