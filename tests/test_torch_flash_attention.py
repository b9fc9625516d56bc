"""The port's ``flash_attention`` (its plain version, which the wrapper runs
on CPU tensors) against the reference's, on the CPU.

The reference ``repro.kernels.ops.flash_attention`` takes [B, H, S, D]; the
port takes the models' layout, q [B, Sq, H, D] and k, v [B, Sk, KV, D]; the
tests transpose.  Shapes and bounds are ``tests/test_kernels.py``'s: the
Pallas kernel in interpret mode and the oracle (``force_ref=True``) at
rtol = atol = 2e-5 in float32 and 3e-2 in bf16.  Grouped queries (KV heads
shared by ``rep = 2`` query heads) are held to the oracle on K and V
repeated per query head, and lengths that are not a multiple of the
Pallas block (which the Pallas wrapper refuses) to ``flash_attention_ref``
head by head.  The CUDA kernel is held to the plain version in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as ref_flash
from repro.kernels import ref as kref

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import MAX_HEAD_DIM, flash_attention_cuda

F32_TOL = 2e-5
BF16_TOL = 3e-2


def _port(q, k, v, causal, dtype=torch.float32):
    """The port on [B, H, S, D] numpy inputs; returns [B, H, S, D] float32."""
    t = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))).to(dtype)
         for a in (q, k, v)]
    before = dict(ops.launches)
    out = ops.flash_attention(*t, causal=causal)
    assert ops.launches == before  # a CPU tensor takes the plain version
    assert out.dtype == dtype
    return out.float().numpy().transpose(0, 2, 1, 3)


def _normals(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("s,d,causal", [
    (256, 128, True),
    (256, 128, False),
    (512, 64, True),
    (128, 256, True),
])
def test_matches_pallas_and_oracle(s, d, causal):
    q, k, v = _normals(7, *[(2, 2, s, d)] * 3)
    got = _port(q, k, v, causal)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for force_ref in (False, True):
        want = ref_flash(jq, jk, jv, causal=causal, force_ref=force_ref)
        np.testing.assert_allclose(got, np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


def test_bf16_matches_pallas_and_oracle():
    q, k, v = _normals(8, *[(1, 2, 256, 128)] * 3)
    got = _port(q, k, v, True, torch.bfloat16)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    for force_ref in (False, True):
        want = np.asarray(ref_flash(jq, jk, jv, force_ref=force_ref), np.float32)
        np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)


def test_rectangular_kv_matches_pallas():
    """Cross-attention shape: S_q != S_kv, no causal mask."""
    q, k, v = _normals(9, (1, 1, 128, 64), (1, 1, 384, 64), (1, 1, 384, 64))
    got = _port(q, k, v, False)
    for force_ref in (False, True):
        want = ref_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=False, force_ref=force_ref)
        np.testing.assert_allclose(got, np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_grouped_queries_match_pallas_on_repeated_kv(causal):
    """rep = 2: query head h reads KV head h // 2, as ``jnp.repeat`` in the
    reference's ``_sdpa`` lays it out."""
    q, k, v = _normals(10, (2, 4, 256, 64), (2, 2, 256, 64), (2, 2, 256, 64))
    got = _port(q, k, v, causal)
    kr, vr = (jnp.repeat(jnp.asarray(a), 2, axis=1) for a in (k, v))
    for force_ref in (False, True):
        want = ref_flash(jnp.asarray(q), kr, vr, causal=causal, force_ref=force_ref)
        np.testing.assert_allclose(got, np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("sq,sk,causal", [(200, 200, True), (77, 77, True), (100, 300, False),
                                          (1, 1, True)])
def test_any_length_matches_oracle(sq, sk, causal):
    q, k, v = _normals(11, (1, 4, sq, 16), (1, 2, sk, 16), (1, 2, sk, 16))
    got = _port(q, k, v, causal)
    for h in range(4):
        want = kref.flash_attention_ref(jnp.asarray(q[0, h]), jnp.asarray(k[0, h // 2]),
                                        jnp.asarray(v[0, h // 2]), causal)
        np.testing.assert_allclose(got[0, h], np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


def test_kernel_route_refuses_what_it_does_not_take():
    f32 = torch.zeros((1, 4, 2, 8))
    with pytest.raises(TypeError):
        flash_attention_cuda(f32.double(), f32.double(), f32.double())
    with pytest.raises(ValueError, match="multiple of KV"):
        flash_attention_cuda(torch.zeros((1, 4, 3, 8)), f32, f32)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 4, 2, MAX_HEAD_DIM + 2))
        flash_attention_cuda(big, big, big)
