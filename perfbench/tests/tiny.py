"""A cell of the benchmark shrunk to run on the CPU in seconds: 84 px
crops, 40 templates, 16 crops or 4 frames, and the ViT cut by its backbone
family's `tiny`. The configuration, mix and limits files stay the cell's
own otherwise, or a test gives a configuration in the cell's place; the
program runs its kernels' plain twins. The harness has the card's path only: `on_the_cpu`
stands in for what only a card has."""

from __future__ import annotations

import contextlib
import copy
from unittest import mock

import torch

from perfbench import harness, models

SEED = 2147483659  # over 31 bits: seeds may be
CELL_PARTS = harness.cell_parts  # the cell's own files, before `on_the_cpu` shrinks them


def parts(cell: str, config=None):
    """(config, mix) of `cell`, shrunk; with `config` in place of the
    cell's own configuration."""
    _, own, mix, _ = CELL_PARTS(harness.manifest(), cell)
    config, mix = copy.deepcopy(own if config is None else config), copy.deepcopy(mix)
    o = models.family(models.name(config["infer_opts"])).tiny(config["infer_opts"])
    config["infer_opts"] = o
    o["crop_size"] = [84, 84]
    o["match_top_k_buddies"] = 20
    config["repre"] = {"num_templates": 40, "fmax": 48, "pca_components": 16, "cluster_num": 32}
    p = mix["params"]
    if mix["kind"] == "offline":
        p.update(pool=16, batch=8, passes=8)
    else:
        p.update(images=4, boxes=4, image_hw=[96, 128], box_side_px=[20, 60], batch=4, passes=8)
    return config, mix


class _Done:
    """A CUDA event stand-in: on the CPU every copy has finished."""

    def record(self):
        pass

    def synchronize(self):
        pass


@contextlib.contextmanager
def on_the_cpu(config=None):
    """The harness on the CPU with every cell shrunk by `parts` (with
    `config` in its own's place): CUDA's clock, memory readings and events,
    pinned host memory and the port's kernel library get stand-ins."""
    empty = torch.empty

    def shrunk(m, cell):
        w, _, _, limits = CELL_PARTS(m, cell)
        return (w, *parts(cell, config), limits)

    def unpinned(*args, pin_memory=False, **kwargs):
        return empty(*args, **kwargs)

    nothing = lambda *args, **kwargs: None  # noqa: E731
    with contextlib.ExitStack() as stack:
        for target, name, value in [
            (harness, "DEVICE", "cpu"), (harness, "cell_parts", shrunk),
            (torch, "empty", unpinned), (torch.cuda, "Event", _Done),
            (torch.cuda, "synchronize", nothing), (torch.cuda, "init", nothing),
            (torch.cuda, "empty_cache", nothing), (torch.cuda, "reset_peak_memory_stats", nothing),
            (torch.cuda, "get_device_name", lambda *args: "cpu"),
            (torch.cuda, "max_memory_allocated", lambda *args: 0),
            ("foundpose_torch._kernels", "library", nothing),
        ]:
            stack.enter_context(mock.patch(f"{target}.{name}", value) if isinstance(target, str)
                                else mock.patch.object(target, name, value))
        yield


def run(cell: str, seconds: float = 0.5, seed: int = SEED, config=None):
    with on_the_cpu(config):
        return harness.run(cell, seed, seconds, False)


def setup(cell: str, seed: int = SEED, config=None):
    config, mix = parts(cell, config)
    torch.set_grad_enabled(False)
    with on_the_cpu():
        return harness.setup(config, mix, seed, torch.device("cpu"), 0.0)


def control_numbers(cell: str, control, seconds: float = 0.3, seed: int = SEED):
    """The judge's numbers of the control lowered at `control` (True or some
    stages), after a short window of the program."""
    s = setup(cell, seed)
    with on_the_cpu():
        harness.warm(s, torch.device("cpu"))
        _, _, answers = harness.measure(s, seconds)
        harness.free_program(s)
    return s.kind.check(s, answers, seed, control=control)
