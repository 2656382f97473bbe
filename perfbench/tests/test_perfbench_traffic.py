"""Every traffic generator is deterministic for a seed."""

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def _make(cell, seed):
    config, mix = tiny.parts(cell)
    kind = harness.kind_module(mix)
    return kind.Traffic(mix["params"], seed, int(config["infer_opts"]["crop_size"][0]),
                        torch.device("cpu"))


def _arrays(t):
    return {k: np.asarray(v.cpu() if torch.is_tensor(v) else v) for k, v in vars(t).items()
            if torch.is_tensor(v) or isinstance(v, np.ndarray)}


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_traffic(cell):
    a, b = _arrays(_make(cell, tiny.SEED)), _arrays(_make(cell, tiny.SEED))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("cell", CELLS)
def test_other_seed_other_inputs_same_sizes(cell):
    a, b = _arrays(_make(cell, tiny.SEED)), _arrays(_make(cell, tiny.SEED + 1))
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}
    assert any(not np.array_equal(a[k], b[k]) for k in a)


def test_offline_solvable_share_and_cycling():
    config, mix = tiny.parts("vits14reg_offline_b128")
    t = _make("vits14reg_offline_b128", tiny.SEED)
    p = mix["params"]
    assert int((t.own >= 0).sum()) == round(p["pool"] * p["solvable_share"])
    per_pass = p["pool"] // p["batch"]
    one_pass = torch.cat([t.indices(i) for i in range(per_pass)])
    assert sorted(one_pass.tolist()) == list(range(p["pool"]))
    assert not torch.equal(t.indices(0), t.indices(per_pass))
