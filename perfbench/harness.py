"""One run of one cell: set-up, the measured window, the traced readings and
the check of what the window produced.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is found by name: `BENCHMARK.json` names the cell's
configuration file and mix; the mix is `traffic/<mix>.json`, whose `kind`
names a generator module `traffic/<kind>.py`; a per-layer metric's reader
is `metrics/<metric>.py`; the cell's limits on the numbers that decide
`correct` are `limits/<cell>.json`; the backbone family, the first field of
the configuration's extractor name, is `models/<family>.py` with its
reference `reference/<family>.py`.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Any, Callable, Dict, Optional

import torch

from perfbench import judge, models, trace, world as world_mod

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DEVICE = "cuda"
WARM_STEPS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "foundpose_tpu")


def load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict[str, Any]:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_parts(m: Dict[str, Any], cell: str):
    """(cell entry, configuration file, mix file, limits file) by name."""
    cells = {w["name"]: w for w in m["workloads"]}
    if cell not in cells:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    w = cells[cell]
    conf = {c["name"]: c for c in m["configs"]}[w["config"]]
    config = load_json(os.path.join(ROOT, conf["file"]))
    mix = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(HERE, "limits", f"{cell}.json"))
    return w, config, mix, limits


def kind_module(mix: Dict[str, Any]):
    return importlib.import_module(f"perfbench.traffic.{mix['kind']}")


def reader(metric: str):
    """metrics/<metric>.py's `read`."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(m: Dict[str, Any], cell: str, section: str):
    """The metrics of `section` ("end_to_end" or "per_layer") this cell reports."""
    return [x for x in m[section] if cell in x.get("workloads", [cell])]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Setup:
    """What a run builds before its window. `ref_vit(images, prec)` is the
    family's reference `feature_maps` on the run's weights and shape."""

    family: str
    shape: Any
    ref_vit: Callable
    config: Any
    world: Dict[str, Any]
    traffic: Any
    system: Any
    kind: Any
    cell_px: float
    split: Dict[str, float]


def setup(config, mix, seed: int, device, t0: float) -> Setup:
    """Builds weights, traffic, world and the program; times each part
    (`split`, seconds: start, CUDA context, kernel library load or build,
    weights, world, the reference's templates, the program's system)."""
    from foundpose_torch import _kernels
    from foundpose_torch.pipeline import inference

    split, mark = {}, [t0]

    def lap(name):
        torch.cuda.synchronize(device)
        now = time.perf_counter()
        split[name] = now - mark[0]
        mark[0] = now

    # From process start: the interpreter, torch's import, the CUDA driver's
    # start (run.py's check for a card) and the program's imports.
    lap("start_s")
    torch.cuda.init()
    torch.zeros(1, device=device)
    lap("cuda_s")
    _kernels.library()
    lap("library_s")
    opts = config["infer_opts"]
    family = models.name(opts)
    fam = models.family(family)
    inf_cfg = inference.inference_config_from_opts(opts)
    shape = fam.shape(opts)
    w = fam.make_weights(shape, seed, device)
    model, extractor, overrides = fam.program(w, opts, device)
    ref_vit = functools.partial(models.reference(family).feature_maps, w, shape)
    lap("weights_s")
    kind = kind_module(mix)
    crop_px = int(opts["crop_size"][0])
    traffic = kind.Traffic(mix["params"], seed + 1, crop_px, device)
    r = config["repre"]
    wld = world_mod.base(seed + 2, device, r["num_templates"], r["fmax"], r["pca_components"],
                         r["cluster_num"], fam.feat_dim(shape))
    lap("world_s")
    # The reference's own work (its warp and its float32 ViT over the
    # solvable crops): timed apart and left out of `setup_s`.
    cell_px = float(opts["grid_cell_size"])
    world_mod.put_crops(wld, ref_vit, *traffic.templates(), cell_px, seed + 3)
    lap("reference_s")
    repre = world_mod.program_repre(wld, extractor)
    torch.cuda.reset_peak_memory_stats(device)
    system = kind.System(model, repre, inf_cfg, traffic, extractor, overrides)
    lap("program_s")
    return Setup(family, shape, ref_vit, inf_cfg, wld, traffic, system, kind, cell_px, split)


def device_info(device, count: int) -> Dict[str, Any]:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def free_program(s: Setup) -> None:
    s.system.close()
    gc.collect()
    torch.cuda.empty_cache()


def warm(s: Setup, device) -> None:
    """The kind's warm-up: every shape its window uses, WARM_STEPS times."""
    t_warm = time.perf_counter()
    s.kind.warm(s.system, WARM_STEPS)
    torch.cuda.synchronize(device)
    s.split["warmup_s"] = time.perf_counter() - t_warm


def measure(s: Setup, seconds: float):
    """The measured window: (attempted, end-to-end metrics, answers)."""
    return s.kind.measure(s.system, seconds, WARM_STEPS)


def run(cell: str, seed: int, seconds: float, traced: bool,
        t0: Optional[float] = None) -> Dict[str, Any]:
    """One run; returns the result line's object (see run.py)."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(DEVICE)
    m = manifest()
    w, config, mix, limits = cell_parts(m, cell)
    torch.set_grad_enabled(False)
    s = setup(config, mix, seed, device, t0)
    warm(s, device)
    setup_s = time.perf_counter() - t0 - s.split["reference_s"]
    print("[perfbench] set-up split s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in s.split.items()) + f"; setup_s {setup_s:.3f} (without "
        f"reference_s)", file=sys.stderr)
    attempted, e2e, answers = measure(s, seconds)
    e2e["setup_s"] = setup_s
    result: Dict[str, Any] = {}
    errors: list = []
    rec: Dict[str, Any] = {}
    if traced:
        rec = s.kind.traced(s, e2e, errors)
    dev = device_info(device, w["chips"])
    if traced and rec.get("idle") is not None:
        win = rec["idle"]
        if not win.whole:
            print(f"[perfbench] busy_s and the breakdown from a profiler window that kept "
                  f"{len(win.kernels)} device kernels of {win.launches} launches (no try "
                  f"kept all)", file=sys.stderr)
        dev["busy_s"] = trace.union_seconds([(a, b) for _, a, b in win.kernels + win.copies])
        dev["window_s"] = win.wall_s
        result["breakdown"] = trace.breakdown(win)

    free_program(s)
    numbers = s.kind.check(s, answers, seed)
    failed = int(numbers.get("nonfinite", 0))
    correct, checks = judge.verdict(numbers, limits)

    if traced:
        metrics = {}
        for spec in cell_metrics(m, cell, "per_layer"):
            value = trace.guarded(spec["name"], lambda: reader(spec["name"])(rec), errors)
            if value is None:
                print(f"[perfbench] {spec['name']}: nothing to read", file=sys.stderr)
            else:
                metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    else:
        metrics = {spec["name"]: {"value": float(e2e[spec["name"]]), "unit": spec["unit"]}
                   for spec in cell_metrics(m, cell, "end_to_end")}
    for e in errors:
        print(f"[perfbench] {e}", file=sys.stderr)
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": failed,
           "metrics": metrics, "device": dev}
    out.update(result)
    out["checks"] = checks
    return out
