"""BENCHMARK.json against the benchmark's contract, and every part of every
cell found by name."""

import json
import os
import re

import pytest

from perfbench import harness, models

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
M = harness.manifest()
E2E = {x["name"]: x for x in M["end_to_end"]}


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len(json.dumps(M)) < 64 * 1024
    assert M["paths"] == ["perfbench"]
    assert all(not w.startswith("/") and ".." not in w for w in M["command"])


def test_names_and_units():
    names = [x["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer")
             for x in M[sec]]
    names += [w[k] for w in M["workloads"] for k in ("config", "traffic")]
    names += [k for c in M["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for sec in ("end_to_end", "per_layer"):
        assert len({x["name"] for x in M[sec]}) == len(M[sec])
        for x in M[sec]:
            assert UNIT.match(x["unit"]), x["unit"]
            assert x["better"] in ("lower", "higher")
    for text in [w["why"] for w in M["workloads"]] + [x["layer"] for x in M["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entry_keys():
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in M["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in M["workloads"])
    for x in M["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert x["source"] in ("host_clock", "device_trace") and 0.01 <= x["bound"] <= 0.25
    for x in M["per_layer"]:
        assert set(x) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def reported(metric, cell):
    return cell in metric.get("workloads", [w["name"] for w in M["workloads"]])


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda x: x["name"])
def test_moves_an_end_to_end_metric_of_each_of_its_cells(metric):
    moved = E2E[metric["moves"]]
    for cell in metric["workloads"]:
        assert reported(moved, cell), (metric["name"], cell)


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda w: w["name"])
def test_cell_parts_found_by_name(cell):
    w, config, mix, limits = harness.cell_parts(M, cell["name"])
    assert w["chips"] == 1
    assert os.path.exists(os.path.join(harness.HERE, "traffic", f"{mix['kind']}.py"))
    assert {"infer_opts", "repre", "reduced", "assumed", "deployment"} <= set(config)
    family = models.name(config["infer_opts"])
    assert models.family(family) and models.reference(family)
    assert limits and all("limit" in v for k, v in limits.items() if not k.startswith("_"))
    assert reported(E2E["setup_s"], w["name"])
    assert sum(reported(x, w["name"]) for x in M["end_to_end"]) >= 2
    per_layer = harness.cell_metrics(M, w["name"], "per_layer")
    assert per_layer
    for x in per_layer:
        assert callable(harness.reader(x["name"]))


def test_every_config_used_and_its_file_under_paths():
    used = {w["config"] for w in M["workloads"]}
    files = [c["file"] for c in M["configs"]]
    assert used == {c["name"] for c in M["configs"]}
    assert len(set(files)) == len(files)
    assert all(f.startswith("perfbench/") and os.path.exists(os.path.join(harness.ROOT, f))
               for f in files)
