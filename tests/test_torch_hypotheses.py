"""RANSAC's samples and minimal solves on the CPU: `pnp.dlt_hypotheses`
takes its plain twin there (sample_counts, _dlt_pose_many and the finite
fix, bit for bit); `pnp.ransac_pnp` routes through it; the kernel path
checks its operands before any launch and passes the C entry point the
arguments its ctypes signature names. The kernel itself runs only on a
card (tests/test_torch_cuda.py)."""

import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)

from foundpose_torch import _kernels
from foundpose_torch.pose import pnp
from hypotheses_data import hypothesis_operands


@pytest.mark.parametrize("s,n,h", [(6, 40, 16), (4, 9, 5)])
def test_dlt_hypotheses_on_cpu_is_the_twin(s, n, h):
    """Equal bit for bit to sample_counts + _dlt_pose_many + the finite fix
    as ransac_pnp ran them before; the sets with a NaN in an invalid
    model point (2) or pixel (3) give R = I, t = (0, 0, 1) everywhere, and
    the draws far outside [0, n) of the last set are reduced as torch's %."""
    ops = hypothesis_operands(s, n, h, seed=s + n)
    rs, ts = pnp.dlt_hypotheses(**ops)
    rays = (ops["pts2d"] - ops["k_c"][:, None]) / ops["k_f"][:, None]
    counts = pnp.sample_counts(ops["valid"], ops["draws"])
    r_ref, t_ref = pnp._dlt_pose_many(ops["pts3d"], rays, ops["valid"].float(), counts)
    finite = torch.isfinite(r_ref).all(-1).all(-1) & torch.isfinite(t_ref).all(-1)
    r_ref = torch.where(finite[..., None, None], r_ref, torch.eye(3))
    t_ref = torch.where(finite[..., None], t_ref, torch.tensor([0.0, 0.0, 1.0]))
    assert torch.equal(rs, r_ref) and torch.equal(ts, t_ref)
    assert bool((rs[2:4] == torch.eye(3)).all()) and bool((ts[2:4] == t_ref[2, 0]).all())
    assert float(ts[2, 0, 2]) == 1.0 and bool(torch.isfinite(rs[4:]).all())
    assert int(ops["draws"][-1].abs().max()) > n and bool((ops["draws"][-1] < 0).any())
    assert float(counts[-1].sum()) == 6 * h


def test_ransac_pnp_routes_through_dlt_hypotheses(monkeypatch):
    """One call a ransac_pnp, with the draws it was given as int64 on the
    points' device, and the result unchanged."""
    ops = hypothesis_operands(6, 40, 16, seed=1)
    args = [ops[k] for k in ("pts2d", "pts3d", "valid", "k_f", "k_c")]
    kw = dict(num_hypotheses=16, lo_iters=0, refine_lm=False, draws=ops["draws"].int())
    expected = pnp.ransac_pnp(*args, **kw)
    calls = []

    def stub(*a):
        calls.append(a[-1])
        return pnp.dlt_hypotheses_plain(*a)

    monkeypatch.setattr(pnp, "dlt_hypotheses", stub)
    got = pnp.ransac_pnp(*args, **kw)
    (draws,) = calls
    assert draws.dtype == torch.int64 and torch.equal(draws, kw["draws"].long())
    assert torch.equal(got.R, expected.R) and torch.equal(got.t, expected.t)
    assert torch.equal(got.quality, expected.quality)


def meta_operands(s=3, n=20, h=8):
    return {k: v.to("meta") for k, v in hypothesis_operands(s, n, h, special=False).items()}


@pytest.mark.parametrize("bad", [
    dict(pts2d=torch.empty(3, 20, 3)), dict(pts3d=torch.empty(3, 21, 3)),
    dict(valid=torch.empty(3, 20, 1, dtype=torch.bool)), dict(k_f=torch.empty(2, 2)),
    dict(k_c=torch.empty(3, 3)), dict(draws=torch.empty(3, 8, 5, dtype=torch.int64)),
    dict(draws=torch.empty(3, 8, 6, dtype=torch.int32)), dict(valid=torch.empty(3, 20)),
    dict(pts3d=torch.empty(3, 20, 3, dtype=torch.float64)),
    dict(pts2d=torch.empty(3, pnp.DLT_MAX_POINTS + 1, 2),
         pts3d=torch.empty(3, pnp.DLT_MAX_POINTS + 1, 3),
         valid=torch.empty(3, pnp.DLT_MAX_POINTS + 1, dtype=torch.bool)),
], ids=["pts2d", "pts3d", "valid", "k_f", "k_c", "draws", "draws_dtype", "valid_dtype",
        "pts3d_dtype", "too_many_points"])
def test_dlt_hypotheses_rejects_bad_operands_before_a_launch(monkeypatch, bad):
    """Off the CPU (meta tensors stand in for a card's) a wrong shape or
    dtype, or more points than the kernel's shared memory holds, raises
    before the kernel library is touched."""
    monkeypatch.setattr(_kernels, "library", lambda: pytest.fail("the library was reached"))
    ops = {**meta_operands(), **{k: v.to("meta") for k, v in bad.items()}}
    before = pnp.dlt_hypotheses.launches
    with pytest.raises(ValueError, match="dlt_hypotheses"):
        pnp.dlt_hypotheses(**ops)
    assert pnp.dlt_hypotheses.launches == before


def test_dlt_hypotheses_rejects_a_device_that_is_not_cuda(monkeypatch):
    monkeypatch.setattr(_kernels, "library", lambda: pytest.fail("the library was reached"))
    with pytest.raises(ValueError, match="CUDA device"):
        pnp.dlt_hypotheses(**meta_operands())


def test_dlt_hypotheses_passes_its_signature(monkeypatch):
    """One call of the entry point with as many arguments as its ctypes
    signature, the sizes, and one more launch counted; the outputs are
    [S, H, 3, 3] and [S, H, 3] f32, the layout kernel 2 reads."""
    seen = []

    class Lib:
        def fp_dlt_hypotheses(self, *args):
            seen.append(args)
            return 0

    monkeypatch.setattr(_kernels, "library", Lib)
    monkeypatch.setattr(_kernels, "require_cuda", lambda name, *ts: ts[0].device)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: 0)
    before = pnp.dlt_hypotheses.launches
    rs, ts = pnp.dlt_hypotheses(**meta_operands(3, 20, 8))
    assert pnp.dlt_hypotheses.launches == before + 1
    (args,) = seen
    assert len(args) == len(_kernels._SIGNATURES["fp_dlt_hypotheses"])
    assert args[8:11] == (3, 20, 8)
    assert (rs.shape, ts.shape, rs.dtype, ts.dtype) == ((3, 8, 3, 3), (3, 8, 3), torch.float32,
                                                        torch.float32)
