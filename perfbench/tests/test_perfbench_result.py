"""The result line: its keys, and no result without a card."""

import json
import subprocess
import sys

import pytest

from perfbench import harness, run
from perfbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_untraced_line_keys():
    res = tiny.run("vits14reg_offline_b128")
    assert list(res) == KEYS
    assert set(res["metrics"]) == {"crops_per_s", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    json.dumps(res)


def test_serving_line_reports_its_tail():
    res = tiny.run("vits14reg_serve_16box")
    assert set(res["metrics"]) == {"estimate_ms_p95", "setup_s"}
    assert res["metrics"]["estimate_ms_p95"]["value"] > 0


def test_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "vits14reg_offline_b128", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.manifest()["workloads"]])
def test_traced_line_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", cell, "--seed",
                          str(tiny.SEED), "--seconds", "2", "--trace", "1"],
                         capture_output=True, text=True, cwd=harness.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
    names = {x["name"] for x in harness.cell_metrics(harness.manifest(), cell, "per_layer")}
    assert set(res["metrics"]) <= names
