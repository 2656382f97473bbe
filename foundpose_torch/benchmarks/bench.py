"""End-to-end throughput of the online coarse-pose step on one NVIDIA GPU:
detection crops per second (counterpart of the repository's bench.py).

    python -m foundpose_torch.benchmarks.bench          # needs a CUDA GPU
    BENCH_BATCH=128 BENCH_EXTRACTOR=dinov2_version=vitl14_stride=14_facet=key_layer=18_norm=1 \\
        BENCH_STAGES=1 BENCH_SELECT_ITER=0 python -m foundpose_torch.benchmarks.bench

Runs `pipeline.inference.pose_from_crops` at configs/infer/lmo.json's
switches (bf16, fused block, tanh GELU, capped softmax, approximate top-k)
with the extractor `BENCH_EXTRACTOR` (default ViT-S/14-reg, layer-9
token facet; the ViT-L/14 DSL above is configs/infer/lmo_vitl.json's model
and `dinov2_version=vitg14-reg_stride=14_facet=token_layer=39_norm=1`
ViT-G/14's) on `BENCH_BATCH` crops (default 128) of 420 px against an
LM-O-scale synthetic representation (798 templates of 512 features, 2,048
words, bf16 banks). The weights are bench_weights' calibrated random
weights from seed 0, built on the card one block at a time; their maximum
attention logit at 420 px must stay below 99, the capped softmax's window.
Crops, masks and cameras are made on the card from a torch.Generator.

Timing: windows of 5 steps, each ended by a synchronize, until two window
medians agree within 5%; one step under the CUDA sync debug mode, which
raises at any host sync; then 8 steps launched back to back between two
CUDA events, best of 3 windows. Eager PyTorch elides nothing, so the JAX
bench's checksummed scan carry has no counterpart: every step's outputs
are summed into one device scalar, fetched once after each window as a
finiteness check. MFU is `utils/flops.pipeline_flops_per_crop` times the
batch over the time of a step and the card's bf16 dense peak, looked up by
`torch.cuda.get_device_name` (an unknown card raises).

Prints one JSON line with bench.py's keys plus `card` (nvidia-smi's name
and power limit). `vs_baseline` divides by 18.85 crops/s, a CPU replica of
the reference measured on another host (BASELINE.md), not on this machine;
`python -m foundpose_torch.benchmarks.reference_baseline` measures the same
replica on the card's own machine, its ViT on the card.
`BENCH_STAGES=1` adds `stage_ms_per_batch` (vit, retrieval, buddies,
pnp_select: `extract_facet`, `retrieve_batch`, `match_batch` and
`solve_batch`, each timed by CUDA events over calls made back to back on
inputs made once) and `device_crops_per_sec` (the batch over their sum);
`flops_per_step_cost_analysis` is XLA's cost analysis in bench.py and is
null here. The runner `run()` (`prepare()`, then `measure()`) takes `device`,
"cuda" by default; a CPU run (`device="cpu"`, the tests' small
configurations) times by the host clock and reports no MFU.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from foundpose_torch.models import bench_weights, dinov2
from foundpose_torch.models.weights import module_from_jax_params
from foundpose_torch.pipeline import inference
from foundpose_torch.structs import PinholeCamera
from foundpose_torch.synthetic import realistic_repre
from foundpose_torch.utils.flops import pipeline_flops_per_crop
from foundpose_torch.utils.profiling import no_host_sync

DEFAULT_EXTRACTOR = "dinov2_version=vits14-reg_stride=14_facet=token_layer=9_norm=1"
# configs/infer/lmo.json's ViT switches.
FAST_SWITCHES = dict(approx_gelu=True, use_fused_block=True, softmax_stabilizer="capped")
# The representation at LM-O scale (configs/gen_repre/lmo.json); raw_dim
# is the extractor's width.
LMO_SCALE = dict(num_templates=798, fmax=512, feat_dim=256, num_words=2048)
CROP_PX = 420
LOGIT_WINDOW = 99.0  # the capped softmax is exact below it

# bench.py's denominator: benchmarks/reference_baseline.py's replica of the
# reference, adjusted in the reference's favour (BASELINE.md).
REFERENCE_CROPS_PER_SEC = 18.85
BASELINE_METHOD = ("CPU replica of the reference, measured on another host and adjusted in the "
                   "reference's favour (BASELINE.md); not measured on this machine")
WEIGHT_SOURCE = ("calibrated random (bench_weights.realistic_params: per-layer max |attn logit| "
                 "= 30, layerscale 0.1; no pretrained checkpoint in the repository)")

# bf16 dense peak by torch.cuda.get_device_name (NVIDIA's data sheet, at
# the full power limit): the MFU denominator. An unknown card raises
# rather than report MFU against the wrong peak.
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}

WARM_WINDOW, WARM_SETTLE, WARM_MAX_WINDOWS = 5, 0.05, 12
N_ITERS, WINDOWS = 8, 3
STAGES = ("vit", "retrieval", "buddies", "pnp_select")
# The micro-benches' profiler windows: a solve substage's holds thousands of
# launches, which torch.profiler takes seconds to parse, so 2 calls a
# window, held open 0.2, 0.5 and 1 s after the synchronize on its tries.
SUBSTAGE_CALLS, SUBSTAGE_PADS = 2, (0.2, 0.5, 1.0)


def bench_configs(extractor: str = DEFAULT_EXTRACTOR, select_iter: int = 0,
                  vit_overrides: Optional[Dict[str, Any]] = None):
    """(DinoV2Config, InferenceConfig) at lmo.json's switches for
    `extractor`; `vit_overrides` shrink the ViT for tests."""
    vit_cfg = dataclasses.replace(dinov2.parse_model_name(extractor), **FAST_SWITCHES,
                                  **(vit_overrides or {}))
    config = inference.InferenceConfig(compute_dtype=torch.bfloat16, approx_topk=True,
                                       pnp_select_iter=select_iter)
    return vit_cfg, config


def require_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU: the bench measures the card (pass device='cpu' to run "
                           "it on the CPU, untimed as a device)")
    return device


def card(device) -> str:
    """The card as nvidia-smi names it, with its power limit; "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[torch.device(device).index or 0]


def peak_flops(device) -> Optional[float]:
    """The card's bf16 dense peak; None on the CPU; an unknown card raises."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    if name not in PEAK_BF16_FLOPS:
        raise RuntimeError(f"unknown card {name!r}: add its bf16 dense peak to PEAK_BF16_FLOPS")
    return PEAK_BF16_FLOPS[name]


def step_flops(vit_cfg, config, batch: int, scale: Dict[str, int] = LMO_SCALE) -> int:
    """Analytic operations of one step over `batch` crops against a
    representation of `scale` (PCA from the ViT's width)."""
    return pipeline_flops_per_crop(
        vit_cfg, crop_px=config.crop_size[0], pca_in=vit_cfg.embed_dim,
        pca_out=scale["feat_dim"], num_words=scale["num_words"], bank_fmax=scale["fmax"],
        top_n_templates=config.top_n_templates,
    ) * batch


@torch.no_grad()
def calibrated_model(vit_cfg, device, seed: int = 0) -> Tuple[dinov2.DinoV2, float]:
    """bench_weights' calibrated weights as a module on `device` (built
    block by block) and its maximum attention logit on one 420 px probe
    image, which must stay inside the capped softmax's window."""
    model = module_from_jax_params(bench_weights.realistic_params(seed, vit_cfg), vit_cfg, device)
    probe = torch.as_tensor(bench_weights._probe_images(CROP_PX, 1), device=device)
    logit_max = float(bench_weights.model_logit_maxima(model, probe).max())
    if not logit_max < LOGIT_WINDOW:
        raise RuntimeError(f"attention logit {logit_max} leaves the capped window (< {LOGIT_WINDOW})")
    return model, logit_max


def crop_masks(gen: torch.Generator, batch: int, device) -> torch.Tensor:
    """The bench's crop masks: a 260 px box at 80..340 with 60% density."""
    inner = (torch.rand(batch, 260, 260, generator=gen, device=device) > 0.4).float()
    masks = torch.zeros(batch, CROP_PX, CROP_PX, device=device)
    masks[:, 80:340, 80:340] = inner
    return masks


def bench_inputs(batch: int, device, seed: int = 7):
    """`batch` random 420 px crops, their masks and identity-extrinsics
    crop cameras (f 600, c 209.5), made on `device` from one generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    crops = torch.rand(batch, CROP_PX, CROP_PX, 3, generator=gen, device=device)
    masks = crop_masks(gen, batch, device)
    cams = PinholeCamera(
        f=torch.full((batch, 2), 600.0, device=device),
        c=torch.full((batch, 2), 209.5, device=device),
        T_world_from_eye=torch.eye(4, device=device).expand(batch, 4, 4).contiguous(),
        width=CROP_PX, height=CROP_PX,
    )
    return crops, masks, cams


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _leaves(out):
    """The tensors of a step's output: a dataclass's fields, or a tensor."""
    if dataclasses.is_dataclass(out):
        return [getattr(out, f.name) for f in dataclasses.fields(out)]
    return [out]


def wall_seconds(fn: Callable[[], Any], device) -> float:
    """Host-clock seconds of one call of `fn`, ended by a synchronize."""
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t0


def settle(fn: Callable[[], Any], device) -> Tuple[float, List[float], bool]:
    """One call of `fn`, then calls in windows of WARM_WINDOW (each call
    ended by a synchronize) until two window medians in a row agree within
    WARM_SETTLE, at most WARM_MAX_WINDOWS windows. Returns (the first
    call's seconds, the window medians in seconds, whether they settled)."""
    first = wall_seconds(fn, device)
    medians, settled = [], False
    for _ in range(WARM_MAX_WINDOWS):
        medians.append(float(np.median([wall_seconds(fn, device) for _ in range(WARM_WINDOW)])))
        settled = len(medians) >= 2 and abs(medians[-1] / medians[-2] - 1) <= WARM_SETTLE
        if settled:
            break
    return first, medians, settled


def window_seconds(fn: Callable[[], Any], device, checksum: bool = False) -> float:
    """Seconds per call of `fn`, the best of WINDOWS windows of N_ITERS
    calls launched back to back (CUDA events on the card, the host clock
    on the CPU). With `checksum`, every call's outputs are summed into one
    device scalar, fetched after each window; a non-finite sum raises."""
    best = math.inf
    for _ in range(WINDOWS):
        chk = torch.zeros((), device=device)
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(N_ITERS):
            out = fn()
            if checksum:
                for t in _leaves(out):
                    chk = chk + t.float().sum()
        if device.type == "cuda":
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            secs = time.perf_counter() - t0
        if checksum and not math.isfinite(float(chk)):
            raise RuntimeError("the step's outputs are not finite")
        best = min(best, secs)
    return best / N_ITERS


def kernel_counters() -> Dict[str, Callable]:
    """The port's kernel wrappers by kernel name: the main path's
    (profiling.kernel_counters) and the probe's; each counts its launches
    in its `launches` attribute."""
    from foundpose_torch.benchmarks import micro_int8
    from foundpose_torch.utils import profiling

    return {**profiling.kernel_counters(), "mm_bf16": micro_int8.mm_bf16,
            "mm_int8": micro_int8.mm_int8}


def substage_times(fn: Callable[[], Any], device) -> Dict[str, Any]:
    """The micro-benches' numbers for one substage `fn` on inputs made
    once: `kernel_launches`, the port's kernel launches in its first call
    (kernel_counters); after `settle`, `ms`, its time a call by
    window_seconds (on the card, CUDA events around calls launched back to
    back); on the card also `device_ms`, the time of its device kernels a
    call, and `host_launches`, the host's kernel-launch calls a call, both
    over SUBSTAGE_CALLS calls under torch.profiler
    (block_split.profiled_kernels, one try a pad of SUBSTAGE_PADS), or
    "not measured" when no try kept every kernel (`profiler_kept`: the
    kernels kept and the launch calls recorded in the last try). The gap
    between `ms` and `device_ms` is the time the card waits on the host.
    On the CPU the two are None."""
    from foundpose_torch.benchmarks import block_split

    counters = kernel_counters()
    before = {name: w.launches for name, w in counters.items()}
    fn()
    _sync(device)
    launches = {name: w.launches - before[name] for name, w in counters.items()}
    settle(fn, device)
    out = dict(ms=window_seconds(fn, device) * 1e3, device_ms=None, host_launches=None,
               kernel_launches=launches)
    if device.type == "cuda":
        try:
            kernels, host_calls = block_split.profiled_kernels(fn, SUBSTAGE_CALLS,
                                                               pads=SUBSTAGE_PADS)
        except block_split.ProfilerLostKernels as e:
            out.update(device_ms="not measured", host_launches="not measured",
                       profiler_kept=[e.seen, e.want])
        else:
            n = SUBSTAGE_CALLS
            out.update(device_ms=sum(e.time_range.elapsed_us() for e in kernels) / n / 1e3,
                       host_launches=host_calls / n, device_kernels=len(kernels) / n)
    return out


@torch.no_grad()
def substage_report(subs: Dict[str, Callable[[], Any]], device, tag: str,
                    batch: int) -> Dict[str, Dict[str, Any]]:
    """substage_times of each of a micro-bench's substages (name ->
    callable), one line each on stderr."""
    device = torch.device(device)
    out = {}
    for name, fn in subs.items():
        r = out[name] = substage_times(fn, device)
        print(f"[{tag}] {name:22s} {r['ms']:8.3f} ms/batch-{batch}; device ms {r['device_ms']}, "
              f"host launches {r['host_launches']}", file=sys.stderr)
    return out


def step_seconds(fn: Callable[[], Any], device):
    """The bench's timing of one step `fn`: warm-up windows until settled,
    one call under the CUDA sync debug mode (a host sync raises), then
    window_seconds with the checksum. Returns (seconds per step, warm-up
    window medians)."""
    _, medians, _ = settle(fn, device)
    with no_host_sync(device):
        fn()
    _sync(device)
    return window_seconds(fn, device, checksum=True), medians


@torch.no_grad()
def stage_seconds(model, repre, config, crops, masks, cams, gen, device) -> Dict[str, float]:
    """Seconds per call of each stage of the step, on inputs made once."""
    def vit():
        images = inference.preprocess_crops(crops, config)
        return dinov2.extract_facet(model, images)["feature_maps"].float()

    fm = vit()
    feats, valid, tids, tsc = inference.retrieve_batch(fm, masks, repre, config)
    cors = inference.match_batch(feats, valid, tids, tsc, repre, config)
    calls = {
        "vit": vit,
        "retrieval": lambda: inference.retrieve_batch(fm, masks, repre, config),
        "buddies": lambda: inference.match_batch(feats, valid, tids, tsc, repre, config),
        "pnp_select": lambda: inference.solve_batch(fm, valid, tids, tsc, cors, cams, repre,
                                                    config, generator=gen),
    }
    out = {}
    for name in STAGES:
        calls[name]()
        _sync(device)
        out[name] = window_seconds(calls[name], device)
    return out


@dataclasses.dataclass
class BenchSetup:
    """What a bench run steps on: the model, the representation, one
    batch of inputs and the RANSAC generator, made once."""

    batch: int
    extractor: str
    vit_cfg: Any
    config: inference.InferenceConfig
    scale: Dict[str, int]
    device: torch.device
    model: dinov2.DinoV2
    logit_max: float
    repre: Any
    crops: torch.Tensor
    masks: torch.Tensor
    cams: PinholeCamera
    gen: torch.Generator

    def step(self):
        """One `pose_from_crops` over the batch: the step the bench times."""
        return inference.pose_from_crops(self.model, self.crops, self.masks, self.cams,
                                         self.repre, self.config, generator=self.gen)


@torch.no_grad()
def prepare(batch: int = 128, extractor: str = DEFAULT_EXTRACTOR, select_iter: int = 0,
            device="cuda", vit_overrides: Optional[Dict[str, Any]] = None,
            scale: Dict[str, int] = LMO_SCALE) -> BenchSetup:
    """The bench's set-up (see the module docstring); `vit_overrides` and
    `scale` shrink the model and the representation for tests."""
    device = require_device(device)
    vit_cfg, config = bench_configs(extractor, select_iter, vit_overrides)
    peak_flops(device)  # an unknown card raises before the weights are built
    model, logit_max = calibrated_model(vit_cfg, device)
    repre = realistic_repre(0, device, raw_dim=vit_cfg.embed_dim, **scale).cast_banks(
        config.compute_dtype)
    crops, masks, cams = bench_inputs(batch, device)
    return BenchSetup(batch=batch, extractor=extractor, vit_cfg=vit_cfg, config=config,
                      scale=scale, device=device, model=model, logit_max=logit_max, repre=repre,
                      crops=crops, masks=masks, cams=cams,
                      gen=torch.Generator(device=device).manual_seed(1))


@torch.no_grad()
def measure(s: BenchSetup, stages: bool = False):
    """The bench's result for the set-up `s` as a dict (see the module
    docstring)."""
    batch, device = s.batch, s.device
    sec, medians = step_seconds(s.step, device)
    crops_per_sec = batch / sec
    flops = step_flops(s.vit_cfg, s.config, batch, s.scale)
    peak = peak_flops(device)
    mfu = None if peak is None else flops / sec / peak
    result = {
        "metric": "lmo_coarse_pose_crops_per_sec_per_chip",
        "value": crops_per_sec,
        "unit": "crops/sec",
        "vs_baseline": crops_per_sec / REFERENCE_CROPS_PER_SEC,
        "baseline_crops_per_sec": REFERENCE_CROPS_PER_SEC,
        "baseline_method": BASELINE_METHOD,
        "batch": batch,
        "extractor": s.extractor,
        "mfu": mfu,
        "flops_per_step_analytic": flops,
        "weight_source": WEIGHT_SOURCE,
        "attn_logit_max": s.logit_max,
        "card": card(device),
    }
    note = ""
    if stages:
        st = stage_seconds(s.model, s.repre, s.config, s.crops, s.masks, s.cams, s.gen, device)
        result["stage_ms_per_batch"] = {k: v * 1e3 for k, v in st.items()}
        result["device_crops_per_sec"] = batch / sum(st.values())
        result["flops_per_step_cost_analysis"] = None
        note = f"; stage ms/batch {result['stage_ms_per_batch']}"
    print(f"[bench] batch={batch} {s.extractor}: {sec * 1e3:.3f} ms a step (best of {WINDOWS} "
          f"windows of {N_ITERS}; warm-up window medians ms "
          + ", ".join(f"{m * 1e3:.2f}" for m in medians)
          + f") -> {crops_per_sec:.2f} crops/s, mfu {mfu}{note}; {result['card']}",
          file=sys.stderr)
    return result


def run(batch: int = 128, extractor: str = DEFAULT_EXTRACTOR, select_iter: int = 0,
        stages: bool = False, device="cuda", vit_overrides: Optional[Dict[str, Any]] = None,
        scale: Dict[str, int] = LMO_SCALE):
    """`measure(prepare(...))`: the bench's result as a dict."""
    return measure(prepare(batch, extractor, select_iter, device, vit_overrides, scale), stages)


def main() -> int:
    result = run(
        batch=int(os.environ.get("BENCH_BATCH", "128")),
        extractor=os.environ.get("BENCH_EXTRACTOR", DEFAULT_EXTRACTOR),
        select_iter=int(os.environ.get("BENCH_SELECT_ITER", "0")),
        stages=os.environ.get("BENCH_STAGES") == "1",
    )
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
