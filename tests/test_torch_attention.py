"""The port's attention op and int8/bf16 GEMM probe against the JAX package,
on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)

from foundpose_torch.benchmarks import micro_int8 as t_probe
from foundpose_torch.ops import attention as t_att
from foundpose_tpu.ops.attention import fused_attention as j_fused_attention
from foundpose_tpu.ops.attention import fused_attention_bhtd as j_fused_attention_bhtd


def qkv(rng, shape, dtype=np.float32):
    return [rng.normal(size=shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("t", [37, 128])
def test_attention_twin_matches_pallas_kernel(rng, t):
    """Head-major entry, f32; odd T is padded to 128 and masked inside the
    Pallas kernel (interpret mode). atol 2e-5 as tests/test_attention.py."""
    q, k, v = qkv(rng, (2, 3, t, 16))
    ref = j_fused_attention_bhtd(*map(jnp.asarray, (q, k, v)), block_q=128, interpret=True)
    got = t_att.fused_attention_bhtd(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_attention_token_major_entry_matches_pallas_kernel(rng):
    q, k, v = qkv(rng, (2, 37, 3, 16))
    ref = j_fused_attention(*map(jnp.asarray, (q, k, v)), block_q=128, interpret=True)
    got = t_att.fused_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == (2, 37, 3, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_attention_bf16_twin_matches_pallas_kernel(rng):
    """bf16 inputs: f32 logits and softmax, weights cast to bf16 before the
    value product, bf16 out. Within one bf16 rounding (rtol 1e-2)."""
    q, k, v = qkv(rng, (1, 2, 45, 16))
    as_bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    ref = j_fused_attention_bhtd(as_bf(q), as_bf(k), as_bf(v), block_q=128, interpret=True)
    got = t_att.fused_attention_bhtd(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref, np.float32), rtol=1e-2, atol=1e-2
    )


def test_attention_seq_len_masks_trailing_keys(rng):
    """Keys at or past seq_len contribute nothing."""
    q, k, v = map(torch.from_numpy, qkv(rng, (2, 1, 20, 8)))
    got = t_att.fused_attention_bhtd(q, k, v, seq_len=13)
    ref = t_att.attention_plain(q, k[..., :13, :], v[..., :13, :])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)


def test_probe_twins_match_jnp_einsum():
    """The probe's inputs (the TPU probe's recipe) through the twins: int8
    exact, bf16 within relative L2 1e-5 of jnp.einsum with f32 output."""
    shape = (2, 24, 64, 128)
    ins = t_probe.probe_inputs("cpu", seed=3, shape=shape)
    rng = np.random.default_rng(3)
    a_f = rng.standard_normal(shape[:3]).astype(np.float32)
    np.testing.assert_array_equal(
        ins[torch.int8][0].numpy(), np.clip(np.round(a_f * 10), -127, 127).astype(np.int8)
    )
    a8, w8 = (jnp.asarray(x.numpy()) for x in ins[torch.int8])
    ref8 = jnp.einsum("btd,dh->bth", a8, w8, preferred_element_type=jnp.int32)
    got8 = t_probe.mm_int8(*ins[torch.int8])
    assert got8.dtype == torch.int32
    np.testing.assert_array_equal(got8.numpy(), np.asarray(ref8))

    abf, wbf = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in ins[torch.bfloat16])
    ref = np.asarray(jnp.einsum("btd,dh->bth", abf, wbf, preferred_element_type=jnp.float32))
    got = t_probe.mm_bf16(*ins[torch.bfloat16]).numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 1e-5


def test_probe_bound_is_the_output_bytes():
    """At the probe's shapes both products are bound by writing the 358 MB
    output (~0.12 ms at 3.35 TB/s), not by the 69 GFLOP."""
    b, t, d, h = t_probe.SHAPE
    for dtype in (torch.bfloat16, torch.int8):
        ms, by = t_probe.bound_ms(b * t, d, h, dtype)
        assert by == "bytes"
        assert 0.1 < ms < 0.125
