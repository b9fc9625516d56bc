"""Multi-pod dry run of the port: every (arch x shape x mesh) cell counted
on meta tensors, counterpart of ``repro.launch.dryrun``.

For each cell the dry run:
  1. makes a fake world of 256 or 512 ranks (torch's ``fake`` process
     group: collectives return at once and move nothing) and the
     production mesh on it (16x16 single-pod, 2x16x16 multi-pod);
  2. builds meta stand-ins for the params (``Model.init_shapes``), the
     AdamW state and the batch (``Model.input_specs``): nothing allocated;
  3. runs the port's own step on rank 0 (``make_train_step(model, mesh)``,
     ``make_prefill_step`` or ``make_decode_step``) under
     ``launch.cost_analysis.analyze_step``: the counts are the ops, kernels
     and collectives that step dispatches on one rank;
  4. writes artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__comp].json
     with the reference's keys where they mean the same thing.

The port keeps params and AdamW moments whole on every rank and runs the
ranks along ``"model"`` as replicas (``training.train_step``), so
``memory.argument_bytes`` is the whole state plus this rank's batch, and
``memory.temp_bytes`` the peak of the bytes the step's own ops held
(``StepCost.peak_live_bytes``: activations, gradients and the new state);
``fits`` says whether the two together fit one card (``arguments_fit``
whether the arguments alone do).  A train step slices
the global batch itself; a prefill or decode step is given this rank's
slice (the global batch over the ``("pod", "data")`` ranks where it
divides, else the whole batch, as the reference's ``batch_specs``
replicates it) and caches of the whole sequence.  The data-parallel train
step keeps every expert on each rank, so an ``moe_ep`` config trains with
the dense dispatch (``notes`` says so); its prefill and decode take the
expert-parallel route.  Decode writes cache position ``seq_len - 1``.

``--compressed`` counts the SHRINK cross-pod exchange stage
(``make_crosspod_exchange``) against the plain float32 mean over
``"pod"``, with the analytic wire bytes (``compression_wire_bytes``).

Usage:
    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all                  # single-pod sweep
    python -m repro_torch.launch.dryrun --all --multi-pod
    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k \\
        --multi-pod --compressed     # SHRINK cross-pod collective
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from ..configs import ARCHS, SHAPES, cells_for, get_config
from ..configs.base import ModelConfig, ShapeSpec
from ..models import build_model
from ..parallel.partition import param_specs
from ..training._tree import tree_map
from ..training.grad_compress import (GradCompressConfig, compression_wire_bytes,
                                      make_crosspod_exchange)
from ..training.optimizer import adamw_init
from ..training.train_step import (make_decode_step, make_ef_state, make_prefill_step,
                                   make_train_step)
from .cost_analysis import analyze_step, tensor_bytes
from .mesh import HW, make_production_mesh

__all__ = ["ARTIFACTS", "fake_world", "main", "model_flops_total", "run_cell"]

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of ``world_size`` ranks, this process rank 0,
    on torch's fake backend; destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def model_flops_total(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """The reference's model flops of one step over the global batch: 6 N D
    for train, 2 N D for prefill and decode (N the active params less the
    embedding, D the tokens); an encoder-decoder splits its params over
    their own token streams."""
    mult = 6 if shape.kind == "train" else 2
    if cfg.family == "encdec" and shape.kind != "decode":
        s_enc = int(shape.seq_len * cfg.audio_frames_ratio)
        s_dec = shape.seq_len - s_enc
        d, ff = cfg.d_model, cfg.d_ff
        hd = cfg.resolved_head_dim
        attn = d * cfg.n_heads * hd * 2 + 2 * d * cfg.n_kv_heads * hd
        per_layer = attn + 3 * d * ff
        n_enc = cfg.n_enc_layers * per_layer
        n_dec = cfg.n_layers * (per_layer + attn) + d * cfg.padded_vocab
        return mult * shape.global_batch * (s_enc * n_enc + s_dec * n_dec)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    n_active = cfg.active_param_count() - cfg.padded_vocab * cfg.d_model
    return mult * n_active * tokens


def _rank_batch(shape: ShapeSpec, mesh) -> int:
    """This rank's batch rows: the global batch over the ("pod", "data")
    ranks where that divides it, else all of it."""
    axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n = axes.get("pod", 1) * axes.get("data", 1)
    return shape.global_batch // n if shape.global_batch % n == 0 else shape.global_batch


def _roofline(flops: int, nbytes: int, coll: int, model_flops: int, n_dev: int) -> dict:
    compute_s, memory_s, coll_s = flops / HW.PEAK_BF16_FLOPS, nbytes / HW.HBM_BW, coll / HW.ICI_BW
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": max(("compute", compute_s), ("memory", memory_s),
                        ("collective", coll_s), key=lambda kv: kv[1])[0],
        "model_flops_total": model_flops,
        "useful_flops_ratio": (model_flops / n_dev / flops) if flops else None,
    }


def _exchange(cfg: ModelConfig, mesh, params, overrides: dict) -> dict:
    """The ``--compressed`` cell: the cross-pod exchange, compressed and
    plain, on this rank's shards of every leaf."""
    comp_kw = {k: overrides[f"comp_{k}"] for k in ("bits", "block") if f"comp_{k}" in overrides}
    n_pods = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("pod", 1)
    p_spec = param_specs(params, cfg, mesh, vocab_dim_sharded=False)
    stacked = tree_map(lambda p: torch.empty((n_pods, *p.shape), dtype=p.dtype, device="meta"),
                       params)
    ef = make_ef_state(params)
    out = {}
    for variant, ccfg in (("compressed", GradCompressConfig(**comp_kw)), ("plain_psum", None)):
        _, cost = analyze_step(make_crosspod_exchange(mesh, ccfg, p_spec), stacked, ef)
        out[variant] = {"collective_bytes": cost.collective_bytes,
                        "by_type": cost.collective_by_type,
                        "collective_s": cost.collective_bytes / HW.ICI_BW,
                        "flops": cost.flops, "bytes": cost.bytes,
                        "kernels": cost.kernels}
    comp_b, raw_b = compression_wire_bytes(params, GradCompressConfig(**comp_kw))
    c = out["compressed"]
    return {"exchange": out,
            "analytic_wire": {"compressed_bytes": comp_b, "f32_bytes": raw_b,
                              "ratio": raw_b / max(comp_b, 1)},
            "roofline": _roofline(c["flops"], c["bytes"], c["collective_bytes"], 0, mesh.size())}


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    compressed: bool = False,
    overrides: dict | None = None,
    tag: str = "",
) -> dict:
    overrides = overrides or {}
    cfg = get_config(arch)
    model_ov = {k: v for k, v in overrides.items() if not k.startswith("comp_")}
    if model_ov:
        cfg = dataclasses.replace(cfg, **model_ov)
    shape = SHAPES[shape_name]
    n_dev = 512 if multi_pod else 256
    result: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "compressed": compressed,
        "devices": n_dev,
        "kind": shape.kind,
    }
    notes = []
    t0 = time.time()
    with fake_world(n_dev):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        if compressed:
            result.update(_exchange(cfg, mesh, build_model(cfg).init_shapes(), overrides))
            result.update(seconds={"trace": time.time() - t0}, tag=tag)
            return result
        if shape.kind == "train" and cfg.moe_ep:
            cfg = dataclasses.replace(cfg, moe_ep=False)
            notes.append("moe_ep off in train: the data-parallel step keeps every expert "
                         "on each rank (expert parallelism runs in prefill and decode)")
        model = build_model(cfg)
        params = model.init_shapes()
        rows = _rank_batch(shape, mesh)
        if shape.kind == "train":
            opt = adamw_init(params)
            batch = model.input_specs(shape)
            out, cost = analyze_step(make_train_step(model, mesh), params, opt, batch)
            arg_bytes = (tensor_bytes(params) + tensor_bytes(opt)
                         + tensor_bytes(batch) * rows // shape.global_batch)
        elif shape.kind == "prefill":
            batch = model.input_specs(shape, per_device_batch=rows)
            with torch.no_grad():
                out, cost = analyze_step(make_prefill_step(model, mesh), params, batch)
            arg_bytes = tensor_bytes(params) + tensor_bytes(batch)
        else:
            specs = model.input_specs(shape, per_device_batch=rows)
            with torch.no_grad():
                out, cost = analyze_step(make_decode_step(model, mesh), params, specs["tokens"],
                                         specs["caches"], shape.seq_len - 1)
            arg_bytes = tensor_bytes(params) + tensor_bytes(specs)
            out = out[0]  # the caches are written in place
    trace_s = time.time() - t0
    temp = cost.peak_live_bytes
    result.update(
        seconds={"trace": trace_s},
        cost={"flops_per_device": cost.flops, "bytes_per_device": cost.bytes,
              "dot_count": cost.dot_count, "kernels": cost.kernels,
              "top_ops_by_bytes": dict(sorted(cost.by_op.items(), key=lambda kv: -kv[1][2])[:8])},
        memory={"argument_bytes": arg_bytes, "output_bytes": tensor_bytes(out), "temp_bytes": temp,
                "hbm_bytes": HW.HBM_BYTES, "fits": arg_bytes + temp <= HW.HBM_BYTES,
                "arguments_fit": arg_bytes <= HW.HBM_BYTES},
        collectives={"total_bytes": cost.collective_bytes, "by_type": cost.collective_by_type},
        roofline=_roofline(cost.flops, cost.bytes, cost.collective_bytes,
                           model_flops_total(cfg, shape), n_dev),
        batch_rows_per_device=rows,
        notes=notes,
        tag=tag,
    )
    return result


def _parse_overrides(items: list[str]) -> dict:
    out = {}
    for ov in items:
        k, v = ov.split("=", 1)
        if v in ("True", "False"):
            out[k] = v == "True"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                out[k] = v
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--compressed", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", action="append", default=[],
                    help="ModelConfig field override, e.g. --override rwkv_chunked=64")
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.override)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    if args.all:
        cells = [(arch, shp) for arch, cfg in ARCHS.items() for shp in cells_for(cfg)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    failures = 0
    mesh_tag = "2x16x16" if args.multi_pod else "16x16"
    suffix = ("__comp" if args.compressed else "") + (f"__{args.tag}" if args.tag else "")
    for arch, shp in cells:
        fname = outdir / f"{arch}__{shp}__{mesh_tag}{suffix}.json"
        if fname.exists():
            print(f"[skip] {fname.name} exists")
            continue
        print(f"[dryrun] {arch} x {shp} x {mesh_tag}{suffix} ...", flush=True)
        try:
            res = run_cell(arch, shp, multi_pod=args.multi_pod, compressed=args.compressed,
                           overrides=overrides, tag=args.tag)
            fname.write_text(json.dumps(res, indent=2))
            r = res["roofline"]
            fits = res.get("memory", {}).get("fits")
            print(f"  ok: trace {res['seconds']['trace']:.1f}s | compute {r['compute_s']:.3e}s "
                  f"memory {r['memory_s']:.3e}s collective {r['collective_s']:.3e}s -> "
                  f"{r['dominant']} | fits {fits}", flush=True)
        except Exception:
            failures += 1
            err = traceback.format_exc()
            (outdir / f"FAILED__{arch}__{shp}__{mesh_tag}{suffix}.txt").write_text(err)
            print(f"  FAILED: {err.splitlines()[-1]}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
