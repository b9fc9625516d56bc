"""Seeded weights in the layout that the port's ``Model.prefill`` reads.

The benchmark makes the weights, not the program: one generator on the
device, one draw a leaf (each stacked leaf holds all its layers), in bf16,
the type they are served in.  The reference makes the same tree from the
same seed on the same device, bit for bit, after the program's state is
freed.  Projections are N(0, 1/fan_in), the router N(0, 1/d_model), the
embedding N(0, 0.02), the head N(0, 1/d_model), norm scales 1.

The tree: ``embed`` [V, d], ``ln_f`` [d], ``head`` [d, V]; ``prefix`` a
list of the leading dense layers' blocks (a MoE model's first
``first_dense_layers``); ``groups["pos0"]`` every other layer's leaves
stacked on a leading layer axis; ``tail`` empty.  A block holds ``ln1``,
``ln2``, ``attn`` (``wq wk wv wo``, or MLA's ``wq w_dkv w_krope w_kup w_vup
wo kv_norm``) and ``mlp`` (``wg wu wd``) or ``moe`` (``router``, experts
``wg wu wd`` [E, ...], ``shared``'s ``wg wu wd``).
"""
from __future__ import annotations

import torch

from .common import derive_seed

DTYPE = torch.bfloat16
_NORMS = ("ln1", "ln2", "ln_f", "kv_norm")


def block_shapes(mc: dict, moe: bool) -> dict:
    """Leaf name -> (shape, std) of one block (std None: a norm scale)."""
    d = mc["d_model"]
    h = mc["n_heads"]
    if mc.get("mla"):
        nd, rd, vd, lora = (mc["qk_nope_head_dim"], mc["qk_rope_head_dim"], mc["v_head_dim"],
                            mc["kv_lora_rank"])
        attn = {"wq": (d, h * (nd + rd)), "w_dkv": (d, lora), "w_krope": (d, rd),
                "w_kup": (lora, h * nd), "w_vup": (lora, h * vd), "wo": (h * vd, d),
                "kv_norm": (lora,)}
    else:
        hd = mc.get("head_dim") or d // h
        kv = mc["n_kv_heads"]
        attn = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd), "wo": (h * hd, d)}
    out = {"ln1": (d,), "ln2": (d,), "attn": attn}
    if moe:
        e, ff = mc["n_experts"], mc["moe_d_ff"]
        out["moe"] = {"router": (d, e), "wg": (e, d, ff), "wu": (e, d, ff), "wd": (e, ff, d)}
        if mc.get("n_shared_experts"):
            sff = ff * mc["n_shared_experts"]
            out["moe"]["shared"] = {"wg": (d, sff), "wu": (d, sff), "wd": (sff, d)}
    else:
        ff = mc["d_ff"]
        out["mlp"] = {"wg": (d, ff), "wu": (d, ff), "wd": (ff, d)}
    return out


def layer_counts(mc: dict) -> tuple[int, int]:
    """(leading dense layers, stacked layers)."""
    prefix = mc.get("first_dense_layers", 0) if mc.get("n_experts") else 0
    return prefix, mc["n_layers"] - prefix


def _leaf(gen, shape, name: str, lead: tuple, d_model: int, device) -> torch.Tensor:
    full = lead + tuple(shape)
    if name in _NORMS:
        return torch.ones(full, dtype=DTYPE, device=device)
    std = d_model ** -0.5 if name == "router" else shape[-2] ** -0.5
    x = torch.randn(full, generator=gen, device=device, dtype=DTYPE)
    return x.mul_(std)


def _tree(gen, shapes: dict, lead: tuple, d_model: int, device) -> dict:
    return {k: _tree(gen, v, lead, d_model, device) if isinstance(v, dict)
            else _leaf(gen, v, k, lead, d_model, device) for k, v in shapes.items()}


def make(mc: dict, seed: int, device) -> dict:
    """The whole tree for the port's config dict ``mc`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "weights"))
    d, v = mc["d_model"], mc["vocab_size"]
    embed = torch.randn((v, d), generator=gen, device=device, dtype=DTYPE).mul_(0.02)
    head = torch.randn((d, v), generator=gen, device=device, dtype=DTYPE).mul_(d ** -0.5)
    n_prefix, n_stacked = layer_counts(mc)
    prefix = [_tree(gen, block_shapes(mc, False), (), d, device) for _ in range(n_prefix)]
    groups = {"pos0": _tree(gen, block_shapes(mc, bool(mc.get("n_experts"))), (n_stacked,), d,
                            device)}
    return {"embed": embed, "ln_f": torch.ones((d,), dtype=DTYPE, device=device), "head": head,
            "prefix": prefix, "groups": groups, "tail": []}


def layers(tree: dict) -> list[dict]:
    """The blocks of ``tree`` in order, each a dict of views."""

    def at(node, i):
        return {k: at(x, i) if isinstance(x, dict) else x[i] for k, x in node.items()}

    stacked = tree["groups"]["pos0"]
    return list(tree["prefix"]) + [at(stacked, i) for i in range(stacked["ln1"].shape[0])]
