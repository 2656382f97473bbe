"""The metric arithmetic on made-up inputs."""

import numpy as np
import pytest

from perfbench import stats, trace
from perfbench.models import dinov2
from perfbench.reference.dinov2 import parse_extractor


def test_rate_is_all_work_over_all_time():
    assert stats.rate(1280, 10.0) == 128.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


@pytest.mark.parametrize("q", [50, 95, 99])
def test_percentile_over_every_sample(q):
    v = np.random.default_rng(0).exponential(size=333)
    assert stats.percentile(list(v), q) == pytest.approx(np.percentile(v, q))


def test_tail_is_not_a_median_of_chunks():
    v = [1.0] * 90 + [100.0] * 10
    assert stats.percentile(v, 95) == 100.0
    chunks = [stats.percentile(v[i : i + 10], 95) for i in range(0, 100, 10)]
    assert np.median(chunks) == 1.0


def test_idle_share_from_a_union_of_intervals():
    busy = trace.union_seconds([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)])
    assert busy == pytest.approx(3.0)
    assert stats.idle_share_pct(busy, 6.0) == pytest.approx(50.0)


def test_roofline_takes_the_binding_bound():
    # 1e12 operations at 1e15/s bound 1 ms; 1e9 bytes at 1e12 B/s bound 1 ms too.
    assert stats.roofline_pct(2e12, 1e9, 0.004, 1e15, 1e12) == pytest.approx(50.0)
    assert stats.roofline_pct(1e12, 4e9, 0.008, 1e15, 1e12) == pytest.approx(50.0)


def test_mfu():
    assert stats.mfu_pct(1e9, 1000.0, 1e13) == pytest.approx(10.0)


def test_vit_flops_match_the_published_shapes():
    s = parse_extractor("dinov2_version=vits14-reg_stride=14_facet=token_layer=9_norm=1")
    n_tok = 30 * 30 + 1 + 4
    layer = 2 * (n_tok * (4 * 384 * 384 + 2 * 384 * 1536) + 2 * n_tok * n_tok * 384)
    assert dinov2.vit_flops_per_crop(s, 420) == 2 * 900 * 588 * 384 + 10 * layer
    k = parse_extractor("dinov2_version=vitl14_stride=14_facet=key_layer=18_norm=1")
    assert k.blocks_run == 18 and k.registers == 0 and k.mlp_hidden == 4096


class _FakeWindow:
    def __init__(self):
        self.kernels = [("gemm", 0.0, 1.0), ("gemm", 3.0, 4.0)]
        self.copies = [("Memcpy DtoH", 4.0, 4.5)]
        self.spans = [("step", 0.0, 5.0)]
        self.ops = [(0.5, 3.5, "aten::mm")]
        self.wall_s = 5.0


def test_breakdown_names_gaps_by_host_span_and_op():
    b = trace.breakdown(_FakeWindow())
    assert b["device_ops"][0] == ["gemm", 2.0]
    assert b["idle_gaps"] == [["step/aten::mm", 2.0]]
