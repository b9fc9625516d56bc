"""The port's fault tolerance (``repro_torch.training.fault_tolerance``)
against the reference's, on the CPU: ``ShardScheduler`` gives the same
assignments, re-dispatches and completions on a scripted clock; the two
``TrainingRunner``s give the same history and state for the same step
function; and the port's crash and resume land on the same bits as an
uninterrupted run, with a real model's train step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import fault_tolerance as RF

import repro_torch.configs as PC
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import build_model
from repro_torch.training import AdamWConfig, adamw_init, make_train_step
from repro_torch.training import fault_tolerance as PF
from repro_torch.training._tree import leaves


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _script(mod, seed):
    """A scripted run: workers ask for work, complete some, go silent; the
    log of every call's result."""
    clock = Clock()
    s = mod.ShardScheduler(n_workers=4, n_shards=24, timeout=2.0, now=clock)
    rng = np.random.default_rng(seed)
    log = []
    for _ in range(120):
        clock.t += float(rng.choice([0.1, 0.5, 1.5, 3.0]))
        w = int(rng.integers(0, 4))
        if w == 3 and rng.random() < 0.7:
            continue  # a straggler mostly silent
        op = rng.random()
        if op < 0.6:
            log.append(("req", w, s.request_work(w)))
        else:
            held = s.workers[w].assigned
            if held:
                shard = held[int(rng.integers(0, len(held)))]
                s.complete(w, shard)
                log.append(("done", w, shard))
            elif s.done:
                shard = sorted(s.done)[0]
                s.complete(w, shard)  # a duplicate completion is idempotent
                log.append(("dup", w, shard))
        log.append(("state", tuple(s.pending), tuple(sorted(s.done)), s.finished,
                    tuple((k, tuple(v.assigned), v.last_heartbeat)
                          for k, v in s.workers.items())))
    return log, dict(s.completed_by)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shard_scheduler_matches_reference(seed):
    assert _script(PF, seed) == _script(RF, seed)


def _toy(ckpt, mod, tensor, **kw):
    """A runner whose state is one float32 vector and whose step mixes in the
    step's batch: each package's runner on its own arrays."""
    def step_fn(state, batch):
        w = state["w"] * 0.5 + batch
        return {"w": w}, {"loss": (w * w).sum(), "mean": w.mean()}

    def data_fn(step):
        return tensor(np.random.default_rng(step).standard_normal(8).astype(np.float32))

    return mod.TrainingRunner(step_fn, data_fn, {"w": tensor(np.zeros(8, np.float32))},
                              str(ckpt), ckpt_every=3, codec="none", **kw)


def test_runner_history_and_state_match_reference(tmp_path):
    ref = _toy(tmp_path / "ref", RF, jnp.asarray)
    port = _toy(tmp_path / "port", PF, torch.from_numpy)
    want, got = ref.run(10), port.run(10)
    assert got == want
    assert all(isinstance(v, float) for h in got for v in h.values() if v is not h["step"])
    np.testing.assert_array_equal(port.state["w"].numpy(), np.asarray(ref.state["w"]))
    assert sorted(p.name for p in (tmp_path / "port").glob("step_*")) == sorted(
        p.name for p in (tmp_path / "ref").glob("step_*"))
    # each resumes from the other's directory
    assert _toy(tmp_path / "ref", PF, torch.from_numpy).start_step == 10
    assert _toy(tmp_path / "port", RF, jnp.asarray).start_step == 10


def test_crash_resume_bit_identical(tmp_path):
    """The reference's ``test_crash_resume_full_stack`` on the port."""
    cfg = PC.ModelConfig(name="lm-tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                         n_kv_heads=2, d_ff=256, vocab_size=512, head_dim=16,
                         tie_embeddings=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    step_fn = make_train_step(model, None, AdamWConfig(lr=2e-3, warmup_steps=5, decay_steps=60))
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=2, seq_len=16, seed=11)

    def runner_step(state, batch):
        p, o, m = step_fn(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    def data_fn(step):
        return {k: torch.from_numpy(v) for k, v in pipe.batch_at(step).items()}

    init = {"params": params, "opt": adamw_init(params)}
    r1 = PF.TrainingRunner(runner_step, data_fn, init, str(tmp_path / "a"), ckpt_every=4,
                           codec=None)
    h1 = r1.run(10)
    r2 = PF.TrainingRunner(runner_step, data_fn, init, str(tmp_path / "b"), ckpt_every=4,
                           codec=None, fail_at=7)
    with pytest.raises(RuntimeError, match="simulated node failure at step 7"):
        r2.run(10)
    r3 = PF.TrainingRunner(runner_step, data_fn, init, str(tmp_path / "b"), ckpt_every=4,
                           codec=None)
    assert r3.start_step == 5  # the step-4 checkpoint
    h3 = r3.run(10)
    assert h3 == h1[5:]
    for a, b in zip(leaves(r1.state), leaves(r3.state)):
        assert torch.equal(a, b)


def _files(directory):
    return {p.relative_to(directory): p.read_bytes() for p in directory.rglob("*") if p.is_file()}


def test_runner_that_does_not_write_resumes_from_the_writers_directory(tmp_path):
    """``writes=False`` (the data-parallel ranks other than the one that
    saves): it resumes from the writer's checkpoint, runs the same steps
    to the same state as the writer resumed there, and writes nothing."""
    _toy(tmp_path / "ck", PF, torch.from_numpy).run(7)
    before = _files(tmp_path / "ck")
    reader = _toy(tmp_path / "ck", PF, torch.from_numpy, writes=False)
    assert reader.start_step == 7
    history = reader.run(10)
    assert _files(tmp_path / "ck") == before
    writer = _toy(tmp_path / "ck", PF, torch.from_numpy)
    assert writer.run(10) == history and torch.equal(writer.state["w"], reader.state["w"])
    assert (tmp_path / "ck" / "LATEST").read_text() == "9"
    _toy(tmp_path / "fresh", PF, torch.from_numpy, writes=False).run(4)
    assert not list((tmp_path / "fresh").glob("*step_*")) and not (tmp_path / "fresh" /
                                                                   "LATEST").exists()
