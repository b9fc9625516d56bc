"""The port's LM decode loop (``repro_torch.serving.ContinuousBatcher`` and
``launch.serve --mode model``) against the reference, on the CPU.

Both batchers are driven by the same deterministic ``decode_fn``: logits
read from a seeded numpy table by (token, cache index), so the two
schedulers see the same logits for the same tokens and must make the same
schedule: the same token batch and index at every step, the same
completions in the same order, the same generated tokens.  The launcher
runs end to end as a subprocess on the CPU, and its request and token
counts equal the reference launcher's (the prompts are the same seeded
draws and there is no EOS, so the counts do not depend on the weights).
"""
import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as ref_serve
from repro.serving import ContinuousBatcher as RefBatcher
from repro.serving import Request as RefRequest

from repro_torch.serving import ContinuousBatcher, Request

ROOT = pathlib.Path(__file__).resolve().parents[1]
VOCAB = 11


def _table(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((VOCAB, 64, VOCAB)).astype(np.float32)


def _drive(batcher_cls, request_cls, to_np, from_np, n_slots, prompts, max_new, table, eos):
    calls = []

    def decode_fn(tokens, caches, index):
        t, i = to_np(tokens)[:, 0], int(index)
        calls.append((t.tolist(), i, caches))
        return from_np(table[t % VOCAB, i % 64][:, None, :]), caches + 1

    b = batcher_cls(decode_fn, lambda: 0, n_slots=n_slots, eos_token=eos)
    for rid, (p, m) in enumerate(zip(prompts, max_new)):
        b.submit(request_cls(rid=rid, prompt=p, max_new_tokens=m))
    done = b.run()
    return calls, [(r.rid, list(r.generated), r.done) for r in done], b.global_index


@pytest.mark.parametrize("seed,n_slots,eos", [(0, 4, 2), (1, 3, 5), (2, 8, -1)])
def test_same_schedule_and_tokens_as_reference(seed, n_slots, eos):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, VOCAB, size=int(rng.integers(1, 9))).astype(np.int32)
               for _ in range(13)]
    max_new = [int(rng.integers(1, 7)) for _ in prompts]
    table = _table(seed)
    want = _drive(RefBatcher, RefRequest, np.asarray, jnp.asarray, n_slots, prompts, max_new,
                  table, eos)
    got = _drive(lambda *a, **k: ContinuousBatcher(*a, device="cpu", **k), Request,
                 lambda t: t.numpy(), torch.from_numpy, n_slots, prompts, max_new, table, eos)
    assert got == want
    assert len(got[1]) == len(prompts)


def test_batcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(Exception, match="CUDA"):
        ContinuousBatcher(lambda t, c, i: None, lambda: 0, n_slots=1)


def _run_port(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
    )


def test_serve_model_on_the_cpu_matches_reference_counts(capsys):
    out = _run_port("--mode", "model", "--arch", "qwen3-0.6b", "--reduced", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    got = re.search(r"served (\d+) requests, (\d+) tokens, .*failed=0", out.stdout)
    assert got, out.stdout
    assert ref_serve.main(["--mode", "model", "--arch", "qwen3-0.6b", "--reduced"]) == 0
    want = re.search(r"served (\d+) requests, (\d+) tokens", capsys.readouterr().out)
    assert got.groups() == want.groups() and got.group(1) == "16"


def test_serve_model_needs_an_arch():
    out = _run_port("--mode", "model", "--device", "cpu")
    assert out.returncode == 2 and "--arch is required" in out.stderr
