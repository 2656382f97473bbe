"""The winners' LO and LM refinement on the CPU: `pnp.refine_lo_lm` takes its
plain twin there (lo_refine, then refine_pose_lm_guarded, bit for bit);
`inference.refine_winner` and `pnp.ransac_pnp` route their LO and LM
through it; the kernel path checks its operands before any launch and
passes the C entry point the arguments its ctypes signature names. The
kernel itself runs only on a card (tests/test_torch_cuda.py)."""

import dataclasses

import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)

from foundpose_torch import _kernels
from foundpose_torch.pipeline import inference
from foundpose_torch.pose import pnp
from refine_data import MIN_GAP_PX, first_refit, refine_operands, threshold_gaps

ITERS = [(2, 10), (0, 10), (2, 0), (0, 0)]


def outputs_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("lo_iters,lm_iters", ITERS)
def test_refine_lo_lm_on_cpu_is_lo_refine_then_lm(lo_iters, lm_iters):
    ops = refine_operands(8, 60, seed=3)
    got = pnp.refine_lo_lm(**ops, inlier_thresh=10.0, lo_iters=lo_iters, lm_iters=lm_iters)
    r, t, inl, cnt = ops["r"], ops["t"], ops["inliers"], ops["count"]
    args = (ops["pts2d"], ops["pts3d"])
    if lo_iters:
        r, t, inl, cnt = pnp.lo_refine(r, t, *args, ops["valid"], ops["k_f"], ops["k_c"],
                                       inlier_thresh=10.0, iters=lo_iters, inliers=inl,
                                       count=cnt)
    if lm_iters:
        r, t = pnp.refine_pose_lm_guarded(r, t, *args, inl, ops["k_f"], ops["k_c"],
                                          iters=lm_iters)
    assert outputs_equal(got, (r, t, inl, cnt))


@pytest.mark.parametrize("lo_iters,lm_iters", ITERS[:3])
def test_refine_lo_lm_keeps_the_pose_it_cannot_refine(lo_iters, lm_iters):
    """The sets the card's test relies on: a NaN in an invalid entry keeps
    the input pose in every mode (refits are not finite, LM costs are NaN);
    the degenerate set (one 3D point) refuses its LO refits, and so does
    set 5, whose refits lose inliers, so without LM their poses stay too;
    set 4 (no base inlier at the start) moves only by its refit, and every
    normal set moves."""
    ops = refine_operands(8, 60, seed=5)
    r, t, inl, cnt = pnp.refine_lo_lm(**ops, inlier_thresh=10.0, lo_iters=lo_iters,
                                      lm_iters=lm_iters)
    kept = [3] + ([2, 5] if lm_iters == 0 else []) + ([4] if lo_iters == 0 else [])
    assert torch.equal(r[kept], ops["r"][kept]) and torch.equal(t[kept], ops["t"][kept])
    assert torch.equal(inl[kept], ops["inliers"][kept])
    assert torch.equal(cnt[kept], ops["count"][kept])
    assert not any(torch.equal(r[k], ops["r"][k]) for k in range(4, 8) if k not in kept)


def test_refine_operands_keep_points_away_from_the_thresholds():
    """On the card test's own operands: every valid point of every posed
    set (4 on) lies at least MIN_GAP_PX from the threshold it is tested
    against at each inlier test of the twin's start and LO refits; some
    points lie between the base and the widened threshold at the start, in
    set 4 and in the normal sets; set 4's first refit is accepted at a
    higher count, set 5's loses inliers and is refused."""
    for s in (1, 16, 128):
        for n in (37, 300, 1000):
            ops = refine_operands(s, n, seed=s * 7 + n)
            posed = slice(4, None) if s >= 4 else slice(None)
            assert float(threshold_gaps(ops)[posed].min()) >= MIN_GAP_PX
            wide, _ = pnp._inliers(ops["r"], ops["t"], ops["pts2d"], ops["pts3d"],
                                   ops["valid"], ops["k_f"], ops["k_c"], 20.0)
            between = (wide & ~ops["inliers"]).sum(-1)
            assert int(between[6:].sum() if s >= 6 else between.sum()) > 0
            if s >= 6:
                r, _, _, count = first_refit(ops)
                assert int(between[4]) > 0 and float(count[4]) > float(ops["count"][4])
                assert torch.equal(r[5], ops["r"][5])


def faulty_lo_refine(widen_first, refuse):
    """pnp.lo_refine with its first refit at the base threshold
    (widen_first False) or with no count-based refusal (refuse False)."""
    def lo_refine(r, t, pts2d, pts3d, valid, k_f, k_c, inlier_thresh, iters, inliers, count):
        rays = (pts2d - k_c[:, None]) / k_f[:, None]
        for li in range(iters):
            widen = 2.0 if li == 0 and widen_first else 1.0
            fit, _ = pnp._inliers(r, t, pts2d, pts3d, valid, k_f, k_c, inlier_thresh * widen)
            r_lo, t_lo = (x[:, 0] for x in pnp._dlt_pose_many(pts3d, rays, valid.float(),
                                                              fit.float()[:, None, :]))
            finite = torch.isfinite(r_lo).all(-1).all(-1) & torch.isfinite(t_lo).all(-1)
            r_lo = torch.where(finite[:, None, None], r_lo, r)
            t_lo = torch.where(finite[:, None], t_lo, t)
            inl_lo, cnt_lo = pnp._inliers(r_lo, t_lo, pts2d, pts3d, valid, k_f, k_c,
                                          inlier_thresh)
            better = finite & (cnt_lo >= count) if refuse else finite
            r = torch.where(better[:, None, None], r_lo, r)
            t = torch.where(better[:, None], t_lo, t)
            inliers = torch.where(better[:, None], inl_lo, inliers)
            count = torch.where(better, cnt_lo, count)
        return r, t, inliers, count
    return lo_refine


@pytest.mark.parametrize("widen_first,refuse", [(False, True), (True, False)],
                         ids=["base_threshold_first", "no_refusal"])
def test_refine_operands_tell_a_faulty_lo_loop(monkeypatch, widen_first, refuse):
    """What the card's test compares (counts and masks equal, R within
    1e-4 and t within 0.05 mm over sets 4 on) fails for an LO loop whose
    first refit skips the widened threshold or that keeps a refit losing
    inliers, on that test's 16 x 300 operands."""
    ops = refine_operands(16, 300, seed=16 * 7 + 300)
    iters = dict(inlier_thresh=10.0, lo_iters=2, lm_iters=0)
    ref = pnp.refine_lo_lm_plain(**ops, **iters)
    monkeypatch.setattr(pnp, "lo_refine", faulty_lo_refine(widen_first, refuse))
    got = pnp.refine_lo_lm_plain(**ops, **iters)
    same = (torch.equal(got[3], ref[3]) and torch.equal(got[2], ref[2])
            and float((got[0][4:] - ref[0][4:]).abs().max()) < 1e-4
            and float((got[1][4:] - ref[1][4:]).abs().max()) < 0.05)
    assert not same


class Stub:
    """Stands in for pnp.refine_lo_lm: records its threshold and iteration
    counts and returns the twin's answer."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args[-3:])
        return pnp.refine_lo_lm_plain(*args)


@pytest.mark.parametrize("lo_iters,refine_lm", [(2, True), (0, True), (2, False), (0, False)])
def test_refine_winner_routes_through_refine_lo_lm(monkeypatch, lo_iters, refine_lm):
    ops = refine_operands(6, 50, seed=2)
    config = dataclasses.replace(inference.InferenceConfig(), pnp_lo_iters=lo_iters,
                                 pnp_refine_lm=refine_lm, lm_iters=7)
    args = (ops["r"], ops["t"], ops["inliers"], ops["count"], ops["pts2d"], ops["pts3d"],
            ops["valid"], ops["k_f"], ops["k_c"], config)
    expected = inference.refine_winner(*args)
    stub = Stub()
    monkeypatch.setattr(pnp, "refine_lo_lm", stub)
    got = inference.refine_winner(*args)
    want = [(config.pnp_inlier_thresh, lo_iters, 7 if refine_lm else 0)]
    assert stub.calls == (want if lo_iters or refine_lm else [])
    assert outputs_equal(got, expected)


@pytest.mark.parametrize("lo_iters,refine_lm", [(2, True), (0, True), (2, False), (0, False)])
def test_ransac_pnp_routes_through_refine_lo_lm(monkeypatch, lo_iters, refine_lm):
    ops = refine_operands(6, 50, seed=4)
    draws = torch.randint(0, 50, (6, 16, 6), generator=torch.Generator().manual_seed(0))
    args = (ops["pts2d"], ops["pts3d"], ops["valid"], ops["k_f"], ops["k_c"])
    kw = dict(num_hypotheses=16, lo_iters=lo_iters, refine_lm=refine_lm, lm_iters=5, draws=draws)
    expected = pnp.ransac_pnp(*args, **kw)
    stub = Stub()
    monkeypatch.setattr(pnp, "refine_lo_lm", stub)
    got = pnp.ransac_pnp(*args, **kw)
    want = [(lo_iters, 5 if refine_lm else 0)]
    assert [c[1:] for c in stub.calls] == (want if lo_iters or refine_lm else [])
    assert all(torch.equal(getattr(got, f.name), getattr(expected, f.name))
               for f in dataclasses.fields(got))


def meta_operands(s=3, n=20):
    ops = refine_operands(s, n, seed=1, special=False)
    return {k: v.to("meta") for k, v in ops.items()}


@pytest.mark.parametrize("bad", [
    dict(r=torch.empty(3, 3, 4)), dict(t=torch.empty(3, 4)), dict(pts2d=torch.empty(3, 20, 3)),
    dict(pts3d=torch.empty(3, 21, 3)), dict(valid=torch.empty(3, 20, 1, dtype=torch.bool)),
    dict(k_f=torch.empty(2, 2)), dict(inliers=torch.empty(3, 19, dtype=torch.bool)),
    dict(count=torch.empty(3, 1)), dict(valid=torch.empty(3, 20)),
    dict(pts3d=torch.empty(3, 20, 3, dtype=torch.float64)),
], ids=["r", "t", "pts2d", "pts3d", "valid", "k_f", "inliers", "count", "valid_dtype",
        "pts3d_dtype"])
def test_refine_lo_lm_rejects_bad_operands_before_a_launch(monkeypatch, bad):
    """Off the CPU (meta tensors stand in for a card's) a wrong shape or
    dtype raises before the kernel library is touched."""
    def no_library():
        raise AssertionError("the library was reached")

    monkeypatch.setattr(_kernels, "library", no_library)
    ops = {**meta_operands(), **{k: v.to("meta") for k, v in bad.items()}}
    before = pnp.refine_lo_lm.launches
    with pytest.raises(ValueError, match="refine_lo_lm"):
        pnp.refine_lo_lm(**ops, inlier_thresh=10.0, lo_iters=2, lm_iters=10)
    assert pnp.refine_lo_lm.launches == before


def test_refine_lo_lm_rejects_a_device_that_is_not_cuda(monkeypatch):
    monkeypatch.setattr(_kernels, "library", lambda: pytest.fail("the library was reached"))
    with pytest.raises(ValueError, match="CUDA device"):
        pnp.refine_lo_lm(**meta_operands(), inlier_thresh=10.0, lo_iters=2, lm_iters=10)


def test_refine_lo_lm_passes_its_signature(monkeypatch):
    """One call of the entry point with as many arguments as its ctypes
    signature, the squared base and widened thresholds, the sizes, and one
    more launch counted; the outputs have the inputs' shapes."""
    seen = []

    class Lib:
        def fp_refine_lo_lm(self, *args):
            seen.append(args)
            return 0

    monkeypatch.setattr(_kernels, "library", Lib)
    monkeypatch.setattr(_kernels, "require_cuda", lambda name, *ts: ts[0].device)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: 0)
    ops = meta_operands(3, 20)
    before = pnp.refine_lo_lm.launches
    r, t, inl, cnt = pnp.refine_lo_lm(**ops, inlier_thresh=7.5, lo_iters=2, lm_iters=10)
    assert pnp.refine_lo_lm.launches == before + 1
    (args,) = seen
    assert len(args) == len(_kernels._SIGNATURES["fp_refine_lo_lm"])
    assert args[9:13] == (56.25, 225.0, 2, 10) and args[17:19] == (3, 20)
    assert (r.shape, t.shape, inl.shape, inl.dtype, cnt.shape) == (
        (3, 3, 3), (3, 3), (3, 20), torch.bool, (3,))
