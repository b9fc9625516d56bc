"""The forward's log-sum-exp and the backward's contract around it, on the CPU.

``flash_attention_lse_plain`` (the oracle of the lse the forward kernels
write, which the backward pair reads) against numpy's float64 logsumexp of
the reference's scores (``repro.kernels.ref.flash_attention_ref``'s
scaling and -1e30 causal mask), and its defining property: exp(s - lse)
is the plain version's softmax, so it rebuilds the plain output.  The
backward wrapper's checks of lse (before any build), its CPU route (which
needs no lse), and the kernel build's hash over the shared headers.  The
kernels themselves are held to these on the card in
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as kref

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA


def _inputs(seed, b, sq, sk, h, kvh, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d), (b, sq, h, d))]


def _numpy_lse(q, k, causal):
    """float64 logsumexp over the keys of q k^T / sqrt(D), -1e30 where
    kpos > qpos, as [B, H, Sq]."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    kk = np.repeat(k.astype(np.float64), h // kvh, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) * d**-0.5
    if causal:
        s = np.where(np.arange(sk)[None, :] <= np.arange(sq)[:, None], s, -1e30)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal", [
    (2, 40, 40, 4, 2, 16, True), (1, 77, 77, 2, 1, 64, True), (2, 30, 53, 4, 4, 32, False),
    (1, 53, 30, 8, 2, 16, True),
])
def test_lse_plain_equals_numpy_logsumexp(b, sq, sk, h, kvh, d, causal):
    q, k, _, _ = _inputs(sq + d, b, sq, sk, h, kvh, d)
    got = FA.flash_attention_lse_plain(torch.from_numpy(q), torch.from_numpy(k), causal)
    assert got.dtype == torch.float32 and got.shape == (b, h, sq)
    np.testing.assert_allclose(got.numpy(), _numpy_lse(q, k, causal), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_exp_of_scores_less_lse_rebuilds_the_reference_output(causal):
    """p = exp(s - lse), the backward's rebuild, times v is the reference
    oracle's attention, head by head."""
    b, sq, h, kvh, d = 1, 48, 4, 2, 32
    q, k, v, _ = _inputs(3, b, sq, sq, h, kvh, d)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    lse = FA.flash_attention_lse_plain(tq, tk, causal)
    s = FA._scores(tq, tk, causal).reshape(b, h, sq, sq)
    p = torch.exp(s - lse[..., None])
    for hi in range(h):
        got = p[0, hi] @ torch.from_numpy(v[0, :, hi // (h // kvh)])
        want = kref.flash_attention_ref(jnp.asarray(q[0, :, hi]), jnp.asarray(k[0, :, hi // 2]),
                                        jnp.asarray(v[0, :, hi // 2]), causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bad", ["shape", "dtype", "none", "missing_on_cuda_wrapper"])
def test_bwd_refuses_a_wrong_lse_before_any_build(bad):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(0, 1, 8, 8, 2, 1, 16))
    out = FA.flash_attention_plain(q, k, v, True)
    lse = FA.flash_attention_lse_plain(q, k, True)
    if bad == "shape":
        with pytest.raises(ValueError, match="lse must be the forward's"):
            FA.flash_attention_bwd_cuda(q, k, v, out, do, True, lse=lse[:, :, :-1])
    elif bad == "dtype":
        with pytest.raises(ValueError, match="lse must be the forward's"):
            FA.flash_attention_bwd_cuda(q, k, v, out, do, True, lse=lse.double())
    elif bad == "none":  # what the wrapper passes on when given no lse
        with pytest.raises(ValueError, match="lse must be the forward's"):
            FA.flash_attention_bwd_cuda(q, k, v, out, do, True, lse=None)
    else:
        with pytest.raises(TypeError):
            FA.flash_attention_bwd_cuda(q, k, v, out, do, True)  # lse is keyword-only, required


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_wrapper_on_cpu_takes_the_plain_route_with_or_without_lse(causal):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 2, 24, 24 if causal else 17, 4, 2, 16))
    out = FA.flash_attention(q, k, v, causal)
    before = dict(_build.launches)
    plain = FA.flash_attention_bwd(q, k, v, out, do, causal)
    given = FA.flash_attention_bwd(q, k, v, out, do, causal,
                                   lse=FA.flash_attention_lse_plain(q, k, causal))
    assert _build.launches == before
    assert all(torch.equal(a, b) for a, b in zip(plain, given))


def test_library_name_hashes_the_shared_headers(tmp_path, monkeypatch):
    """An edit to a csrc/*.cuh renames every library, so none is stale."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._lib_path("k")
    assert _build._lib_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _build._lib_path("k")
    (tmp_path / "g.cuh").write_text("// new\n")
    third = _build._lib_path("k")
    assert len({first, second, third}) == 3
    assert first.name.startswith("libk-") and first.suffix == ".so"
