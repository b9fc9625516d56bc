"""The port's step cost counter (``launch.cost_analysis``), the counterpart
of the reference's HLO cost model (``tests/test_roofline.py``).

Its units: a plain matmul counts ``2 m n k`` on meta and on the CPU; a
Python loop of L layers counts L times one layer (the port has no while
loop to correct, so the reference's trip-count fix has no counterpart);
bytes are positive and grow with L; one device issues no collective; an
all-reduce over a fake 16-rank group counts twice its bytes, an
all-gather its result's.  The kernel hook: ``flash_attention`` (forward
and backward) and ``base_fit`` record the analytic work of their function
on meta and on the CPU, and the plain route's own ops are not counted as
well; a kernel another thread launches during a count is not counted.
The step's inputs (dataclass fields included), their views and in-place
writes to them are not counted as its temporaries.  A reduced model's
train step (and a prefill) counts the same on meta tensors as on the
CPU.  Every count here is exact: integers, no tolerance.
"""
import dataclasses
import threading

import pytest
import torch
import torch.distributed as dist
from torch_dist_helpers import dist_guard  # noqa: F401

import repro_torch.configs as PC
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch.cost_analysis import StepCost, analyze_step
from repro_torch.launch.dryrun import fake_world
from repro_torch.models import build_model
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_step import make_prefill_step, make_train_step

DEVICES = ["meta", "cpu"]


@pytest.mark.parametrize("device", DEVICES)
def test_matmul_counts_2mnk(device):
    a = torch.ones((64, 32), device=device)
    b = torch.ones((32, 48), device=device)
    _, c = analyze_step(lambda: a @ b)
    assert (c.flops, c.dot_count) == (2 * 64 * 32 * 48, 1)
    assert c.bytes == (64 * 32 + 32 * 48 + 64 * 48) * 4
    x = torch.ones((3, 8, 16), device=device)
    _, c = analyze_step(lambda: torch.bmm(x, x.transpose(1, 2)))
    assert (c.flops, c.dot_count) == (2 * 3 * 8 * 16 * 8, 1)
    _, c = analyze_step(lambda: torch.addmm(torch.ones(48, device=device), a, b))
    assert c.flops == 2 * 64 * 32 * 48


def _layers(x, w, n: int):
    for _ in range(n):
        x = torch.tanh(x @ w)
    return x


@pytest.mark.parametrize("device", DEVICES)
def test_layer_loop_counts_every_layer(device):
    x = torch.ones((16, 32), device=device)
    w = torch.ones((32, 32), device=device)
    one = analyze_step(_layers, x, w, 1)[1]
    for n in (2, 5):
        c = analyze_step(_layers, x, w, n)[1]
        assert (c.flops, c.bytes, c.dot_count) == (n * one.flops, n * one.bytes, n)
    assert one.bytes > 0 and one.collective_bytes == 0


def test_collective_bytes_zero_on_one_device():
    m = build_model(PC.reduced_config(PC.get_config("qwen3-0.6b")))
    params = m.init_shapes()
    batch = m.input_specs(ShapeSpec("t", 32, 2, "train"))
    _, c = analyze_step(make_train_step(m), params, adamw_init(params), batch)
    assert (c.collective_bytes, c.collective_by_type) == (0, {})
    assert c.flops > 0 and c.bytes > 0


def test_collectives_over_a_fake_group_count_by_type():
    x = torch.empty((1000,), dtype=torch.float32, device="meta")
    with fake_world(16):
        def step():
            dist.all_reduce(x)
            out = torch.empty((16 * 1000,), dtype=torch.float32, device="meta")
            dist.all_gather_into_tensor(out, x)
            return out

        _, c = analyze_step(step)
    assert c.collective_by_type == {"all-reduce": 2 * 4000, "all-gather": 16 * 4000}
    assert c.collective_bytes == 2 * 4000 + 16 * 4000


def _pairs(sq, sk, causal):
    return sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(24, 24), (24, 10), (7, 31)])
def test_flash_hook_counts_the_function(device, causal, sq, sk):
    b, h, kvh, d = 2, 4, 2, 16
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g).to(device).requires_grad_(True)
               for shape in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d)))
    out, c = analyze_step(ops.flash_attention, q, k, v, causal)
    pairs = b * h * _pairs(sq, sk, causal)
    fwd_bytes = 2 * q.numel() * 4 + 2 * k.numel() * 4 + b * h * sq * 4  # q, k, v, out, lse
    assert c.kernels == {"flash_attention": {"calls": 1, "flops": 2 * pairs * 2 * d,
                                             "bytes": fwd_bytes}}
    assert (c.flops, c.dot_count) == (2 * pairs * 2 * d, 0)  # the plain route's einsums unseen
    assert c.bytes == fwd_bytes
    assert out.device.type == device and out.shape == q.shape
    dout = torch.ones_like(out)
    _, c = analyze_step(torch.autograd.grad, out, (q, k, v), dout)
    bwd_bytes = 4 * q.numel() * 4 + 4 * k.numel() * 4 + b * h * sq * 4
    assert c.kernels["flash_attention_bwd"] == {"calls": 1, "flops": 10 * pairs * d,
                                                "bytes": bwd_bytes}
    assert c.dot_count == 0


def test_flash_hook_matches_the_recorded_bounds():
    """The counts behind the flash rows' bounds: 1.375e11 flops forward at
    q [4, 2048, 32, 128], 3.44e11 backward at [2, 4096, 16, 128]."""
    q = torch.empty((4, 2048, 32, 128), dtype=torch.bfloat16, device="meta")
    _, c = analyze_step(ops.flash_attention, q, q[:, :, :8], q[:, :, :8])
    assert c.kernels["flash_attention"]["flops"] == 137_506_062_336
    q = torch.empty((2, 4096, 16, 128), dtype=torch.bfloat16, device="meta")
    _, c = analyze_step(FA.flash_attention_bwd, q, q, q, q, q, True,
                        lse=torch.empty((2, 16, 4096), device="meta"))
    assert c.kernels["flash_attention_bwd"]["flops"] == 343_681_269_760


@pytest.mark.parametrize("device", DEVICES)
def test_base_fit_hook(device):
    xb = torch.ones((10, 256), device=device)
    (theta, slope), c = analyze_step(ops.base_fit, xb)
    assert c.kernels == {"base_fit": {"calls": 1, "flops": 0, "bytes": 10 * 256 * 4 + 2 * 10 * 4}}
    assert c.bytes == 10 * 256 * 4 + 2 * 10 * 4 and c.dot_count == 0
    assert theta.shape == slope.shape == (10,) and theta.device.type == device


def test_meta_routes_raise_where_the_kernel_would():
    with pytest.raises(TypeError):
        ops.base_fit(torch.empty((4, 8), dtype=torch.float64, device="meta"))
    q = torch.empty((1, 4, 2, 7), device="meta")
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError):  # no meta route for the other kernels
        ops.interval_stats(torch.empty((4, 64), device="meta"), 16)
    assert _build.cost_counter() is None


def test_counters_do_not_nest():
    with pytest.raises(RuntimeError, match="already"):
        analyze_step(analyze_step, lambda: None)
    assert _build.cost_counter() is None


def test_another_threads_launches_are_not_counted():
    """The counter is this thread's dispatch mode: a kernel another thread
    launches while a step is counted is neither recorded nor rerouted."""
    q = torch.randn((1, 8, 2, 16), generator=torch.Generator().manual_seed(0))
    seen = {}

    def other():
        seen["counter"] = _build.cost_counter()
        seen["out"] = ops.flash_attention(q, q, q)

    def step():
        t = threading.Thread(target=other)
        t.start()
        t.join()
        return q @ q.transpose(-1, -2)

    _, c = analyze_step(step)
    assert seen["counter"] is None
    assert torch.equal(seen["out"], FA.flash_attention_plain(q, q, q))
    assert c.kernels == {} and c.dot_count == 1


@pytest.mark.parametrize("device", DEVICES)
def test_inputs_views_and_in_place_writes_are_no_temporaries(device):
    x = torch.zeros((64, 32), device=device)
    cache = _Cache(torch.zeros((4, 32), device=device))
    _, c = analyze_step(lambda x, cache: (x.add_(1).view(-1), cache.buf[1:].copy_(x[:3]),
                                          x.t()), x, cache=cache)
    assert c.peak_live_bytes == 0 and c.bytes > 0
    _, c = analyze_step(lambda x: (x + 1).sum(), x)
    assert c.peak_live_bytes == 64 * 32 * 4 + 4  # x + 1 and its sum


@dataclasses.dataclass
class _Cache:
    buf: torch.Tensor


def _cpu_inputs(m, specs, seed=0):
    g = torch.Generator().manual_seed(seed)

    def real(t):
        if t.dtype == torch.int32:
            return torch.randint(0, 500, t.shape, generator=g, dtype=torch.int32)
        return torch.randn(t.shape, generator=g, dtype=t.dtype)

    return {k: real(v) for k, v in specs.items()}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-lite-16b", "rwkv6-1.6b",
                                  "seamless-m4t-medium", "llama-3.2-vision-11b"])
def test_reduced_train_step_counts_the_same_on_meta_and_cpu(arch):
    m = build_model(PC.reduced_config(PC.get_config(arch)))
    shape = ShapeSpec("t", 64, 2, "train")
    costs = []
    for params, batch in ((m.init_shapes(), m.input_specs(shape)),
                          (m.init(0, device="cpu"), _cpu_inputs(m, m.input_specs(shape)))):
        _, c = analyze_step(make_train_step(m), params, adamw_init(params), batch)
        costs.append(c)
    meta, cpu = costs
    assert isinstance(meta, StepCost)
    assert (meta.flops, meta.bytes, meta.dot_count, meta.kernels) == \
        (cpu.flops, cpu.bytes, cpu.dot_count, cpu.kernels)
    assert meta.peak_live_bytes == cpu.peak_live_bytes > 0


def test_reduced_prefill_counts_the_same_on_meta_and_cpu():
    m = build_model(PC.reduced_config(PC.get_config("llama3-8b")))
    shape = ShapeSpec("p", 64, 2, "prefill")
    with torch.no_grad():
        _, meta = analyze_step(make_prefill_step(m), m.init_shapes(), m.input_specs(shape))
        _, cpu = analyze_step(make_prefill_step(m), m.init(0, device="cpu"),
                              _cpu_inputs(m, m.input_specs(shape)))
    assert meta == cpu
    assert meta.kernels["flash_attention"]["calls"] == m.cfg.n_layers
