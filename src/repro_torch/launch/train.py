"""Training launcher of the port, counterpart of ``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 100 --batch 8 --seq 256 --ckpt-dir DIR [--reduced] [--device cpu]

Trains the config (``--reduced``: the same family cut small) on one device
(``--device``, default ``cuda``; ``cpu`` runs the kernels' plain versions)
from params drawn from seed 0, on ``TokenPipeline`` batches.  It resumes
from the newest checkpoint in ``--ckpt-dir``; data is a pure function of
the step index, so a restart lands on the same bits (``--ckpt-dir``
defaults to ``repro_train_ckpt`` in the temporary directory).  ``--ckpt-codec``
defaults to the best exact codec that imports (``zstd``, else ``none``).

``--production`` trains on the reference's 16 x 16 ("data", "model") mesh,
one rank a card under ``torchrun --nproc-per-node 8 --nnodes 32 ...``: the
sharded step (``training.train_step``), each rank holding its
``param_specs`` shards of the params and AdamW moments (drawn whole on
each card from seed 0, then placed by ``param_shardings``) and training on
its slice of the global ``--batch``.  Every rank takes part in gathering a
checkpoint's leaves; rank 0 alone writes them into ``--ckpt-dir`` (a
directory every rank can read, the same bytes as one device's) and every
rank resumes from it onto its shards.  A ``moe_ep`` config trains its
experts expert parallel over ``"model"``.  It raises ``ConfigError`` up
front in a world of another size, naming the 256 ranks it needs.

Standard output carries the reference's lines; standard error two more:
the median time of a step (from one step's start to the next's, which
takes in the runner's read-back of the step's metrics) with the tokens a
second it gives, and each of those step times.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from ..configs import get_config, reduced_config
from ..core.device import resolve_device
from ..data.pipeline import TokenPipeline
from ..models import build_model
from ..parallel.partition import param_shardings
from ..parallel.sharding import mesh_axes, place
from ..training._tree import leaves, tree_map
from ..training.checkpoint import default_codec
from ..training.fault_tolerance import TrainingRunner
from ..training.optimizer import AdamWConfig, adamw_init
from ..training.train_step import make_train_step
from .mesh import make_production_mesh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-codec", default=None,
                    help="none | zstd | shrink:<frac> (default: zstd where it imports, else none)")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--production", action="store_true",
                    help="16x16 production mesh (256 ranks under torchrun)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    mesh = None
    if args.production:
        mesh = make_production_mesh()
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = resolve_device(args.device)
    model = build_model(cfg)

    params = model.init(0, device=dev)
    n = sum(p.numel() for p in leaves(params))
    if mesh is not None:
        params = tree_map(lambda p, s: place(p, *s), params, param_shardings(params, cfg, mesh))
    axes = mesh_axes(mesh) if mesh is not None else {"data": 1, "model": 1}
    print(f"arch={cfg.name} params={n/1e6:.1f}M mesh={axes}")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                          decay_steps=args.steps)
    step_fn = make_train_step(model, mesh, opt_cfg)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=args.batch, seq_len=args.seq)

    starts: list[float] = []

    def runner_step(state, batch):
        starts.append(time.perf_counter())
        p, o, metrics = step_fn(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, metrics

    def data_fn(step):
        return {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(step).items()}

    runner = TrainingRunner(
        runner_step, data_fn, {"params": params, "opt": adamw_init(params)},
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        codec=args.ckpt_codec if args.ckpt_codec is not None else default_codec(),
        writes=mesh is None or dist.get_rank() == 0,
    )
    hist = runner.run(args.steps)
    for h in hist[:: max(1, len(hist) // 12)]:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  gnorm {h['grad_norm']:.3f}")
    if hist:  # a resume at or past --steps runs nothing
        print(f"final loss {hist[-1]['loss']:.4f}")
    if len(starts) > 1:
        med = statistics.median(b - a for a, b in zip(starts, starts[1:]))
        print(f"train: {len(hist)} steps on {dev}, median step {med:.4f} s, "
              f"{args.batch * args.seq / med:.1f} tokens/s", file=sys.stderr)
        print("train: step times s " + " ".join(f"{b - a:.4f}" for a, b in zip(starts, starts[1:])),
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
