"""Softmax attention with an online softmax (the prefill and forward
attention of the dense models): CUDA kernel, plain version, wrapper.

Counterpart of ``repro.kernels.flash_attention`` (the Pallas TPU kernel
``_flash_kernel`` / ``flash_attention_pallas``, oracle
``repro.kernels.ref.flash_attention_ref``).  Both versions here take the
models' layout, q [B, Sq, H, D] and k, v [B, Sk, KV, D] with H a multiple
of KV (query head h reads KV head h // (H // KV)), in float32 or bf16, and
return softmax(q k^T * D**-0.5) v in q's dtype [B, Sq, H, D]; ``causal``
masks the keys with kpos > qpos (both counted from 0).  Any Sq and Sk.

The kernels are in ``csrc/flash_attention.cu``, one per dtype.  bf16 (the
models' route) runs on the tensor cores: TMA loads of K and V tiles into a
ring in shared memory, ``wgmma`` for q k^T and for p v, the online softmax
in registers, and p carried as two bf16 terms (hi = bf16(p), lo =
bf16(p - hi)), about 16 bits of the float32 probabilities the reference
multiplies by; it agrees with the plain version to bf16 output rounding
(3e-2 held).  A bf16 head dim that is not a multiple of 8, an unaligned
base pointer or Sk = 0 (what a TMA tensor map cannot describe) takes the
scalar kernel instead, chosen in the C entry point from the shapes and
pointers.
float32 takes the scalar kernel (CUDA cores, float32 products), within
2e-5.  ``flash_attention_plain`` is the oracle's arithmetic (float32
scores, -1e30 masking, a float32 softmax and float32 ``p @ v``).

Both forward kernels can also write each row's log-sum-exp, lse [B, H, Sq]
float32 in natural log: ``_flash_attention_fwd_cuda`` returns (out, lse),
``flash_attention_cuda`` asks for none, nor does the wrapper's Function
when no input requires grad (prefill, decode), and the output's bits are
the same either way.  ``flash_attention_lse_plain`` is its oracle
(``torch.logsumexp`` of the plain version's scaled, masked scores).

The gradient (training) is the kernel pair of ``csrc/flash_attention_bwd.cu``
behind a ``torch.autograd.Function``: its forward launches the forward
kernel and saves q, k, v, the output and lse, its backward launches the
pair (``flash_attention_bwd_cuda``), which rebuilds p = exp(s - lse) from
the saved lse and writes dq, dk and dv with no atomics (one summation
order, the same bits every run).  bf16 with D % 8 == 0, D <= 192 and
aligned pointers takes the tensor-core pair (wgmma, TMA); float32 and
every other bf16 shape the scalar pair, chosen in the C entry point.
``last_route`` names the route each kernel's last launch took.  The
wrapper goes through that Function for a CUDA tensor; on the CPU the
plain version is differentiable as it is.  ``flash_attention_cuda``
itself records nothing for autograd, so it raises for an input that
requires grad while grad mode is on.  ``flash_attention_bwd_plain``
(autograd through the plain version) is the backward kernel's oracle.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_bwd_cuda",
           "flash_attention_bwd_plain", "flash_attention_cuda", "flash_attention_lse_plain",
           "flash_attention_plain", "last_route"]

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ROUTES = ("scalar", "tensor cores")  # the C entry points' *route
MAX_HEAD_DIM = 256

# the route ("tensor cores" or "scalar") of each kernel's last launch
last_route: dict[str, str] = {}


def _scores(q, k, causal: bool):
    """float32 [B, KV, H / KV, Sq, Sk]: q k^T * D**-0.5, -1e30 where masked."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * d**-0.5
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, -1e30)
    return s


def flash_attention_plain(q, k, v, causal: bool = True):
    b, sq, h, d = q.shape
    p = torch.softmax(_scores(q, k, causal), dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def flash_attention_lse_plain(q, k, causal: bool = True):
    """lse [B, H, Sq] float32: ``torch.logsumexp`` over the keys of the
    plain version's scaled, masked scores (the forward kernel's lse)."""
    b, sq, h, _ = q.shape
    return torch.logsumexp(_scores(q, k, causal), dim=-1).reshape(b, h, sq)


_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]


def _check(q, k, v) -> None:
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bf16 q, k, v; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError("flash_attention takes q [B, Sq, H, D] and k, v [B, Sk, KV, D]")
    b, sq, h, d = q.shape
    kb, sk, kvh, kd = k.shape
    if kb != b or kd != d or kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "do not match (H must be a multiple of KV)")
    if d > MAX_HEAD_DIM or d % 2:
        raise ValueError(f"flash_attention takes an even head dim up to {MAX_HEAD_DIM}, got {d}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")


def _flash_attention_fwd_cuda(q, k, v, causal: bool = True, with_lse: bool = True):
    """Launch ``csrc/flash_attention.cu``: (out, lse), out as
    :func:`flash_attention_plain`, lse [B, H, Sq] float32 as
    :func:`flash_attention_lse_plain` (None unless ``with_lse``).  Records
    no gradient."""
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel() == 0:
        return out, lse
    fn = _build.function("flash_attention", f"flash_attention_{_SUFFIX[q.dtype]}", _ARGS)
    route = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, sq, sk, h, kvh, d, d**-0.5, int(causal),
            torch.cuda.current_stream().cuda_stream, ctypes.byref(route),
        )
    _build.check(rc, "flash_attention")
    _build.launches["flash_attention"] += 1
    last_route["flash_attention"] = _ROUTES[route.value]
    return out, lse


def flash_attention_cuda(q, k, v, causal: bool = True):
    """Launch ``csrc/flash_attention.cu`` without lse; same contract as
    :func:`flash_attention_plain`.  No gradient: an input that requires
    grad raises while grad mode is on (the wrapper's Function carries it)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attention_cuda records no gradient: call flash_attention "
                           "(its autograd Function) for inputs that require grad")
    return _flash_attention_fwd_cuda(q, k, v, causal, with_lse=False)[0]


def flash_attention_bwd_plain(q, k, v, out, dout, causal: bool = True):
    """(dq, dk, dv) in the inputs' dtype: autograd through
    :func:`flash_attention_plain` (``out`` is not needed there)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        y = flash_attention_plain(*leaves, causal)
        return torch.autograd.grad(y, leaves, dout)


_BWD_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]


def flash_attention_bwd_cuda(q, k, v, out, dout, causal: bool = True, *, lse):
    """Launch the pair of ``csrc/flash_attention_bwd.cu`` (dq over query
    tiles, then dk and dv over key tiles) given the forward's ``lse``
    (:func:`_flash_attention_fwd_cuda`); same contract as
    :func:`flash_attention_bwd_plain`."""
    _check(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype \
            or dout.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: out and dout must be q's shape and dtype")
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if lse is None or lse.shape != (b, h, sq) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        got = None if lse is None else (lse.dtype, tuple(lse.shape), lse.device)
        raise ValueError(f"flash_attention_bwd: lse must be the forward's float32 {(b, h, sq)} "
                         f"on q's device, got {got}")
    q, k, v, out, dout, lse = (t.contiguous() for t in (q, k, v, out, dout, lse))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if sk == 0:
        return dq.zero_(), dk, dv
    if b * sq * h == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty_like(lse)  # scratch: the dq launch writes it for the dkdv launch
    fn = _build.function("flash_attention_bwd", f"flash_attention_bwd_{_SUFFIX[q.dtype]}",
                         _BWD_ARGS)
    route = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            b, sq, sk, h, kvh, d, d**-0.5, int(causal), torch.cuda.current_stream().cuda_stream,
            ctypes.byref(route),
        )
    _build.check(rc, "flash_attention_bwd")
    _build.launches["flash_attention_bwd"] += 1
    last_route["flash_attention_bwd"] = _ROUTES[route.value]
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, dout, causal: bool = True, *, lse=None):
    """The backward wrapper: the kernel pair for a CUDA tensor (given the
    forward's ``lse``, as :func:`flash_attention_bwd_cuda`), autograd
    through the plain version for a CPU tensor (``lse`` unused)."""
    if q.is_cuda:
        return flash_attention_bwd_cuda(q, k, v, out, dout, causal, lse=lse)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    return flash_attention_bwd_plain(q, k, v, out, dout, causal)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        # lse only when a gradient may be asked for (not at prefill or decode)
        out, lse = _flash_attention_fwd_cuda(q, k, v, causal, any(ctx.needs_input_grad[:3]))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, dout, ctx.causal, lse=lse)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True):
    """The wrapper: the kernel (through its autograd Function, whose
    forward saves lse when an input requires grad and whose backward is the
    kernel pair) for a CUDA tensor, the plain version for a CPU tensor.
    Returns [B, Sq, H, D] in q's dtype."""
    if q.is_cuda:
        return _FlashAttention.apply(q, k, v, causal)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    return flash_attention_plain(q, k, v, causal)
