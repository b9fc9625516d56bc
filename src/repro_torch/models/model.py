"""Top-level model facade in PyTorch, counterpart of ``repro.models.model``:
config -> init / loss / prefill / decode for every family.

Batch conventions as in the reference: ``loss`` takes tokens[B, S] and
labels[B, S] (an encoder-decoder also frames[B, Se, D] for its encoder, a
VLM also vision[B, Nv, D], the stub frontends' embeddings); ``prefill``
takes the same inputs and returns the last position's logits and the
caches; ``decode_step`` takes tokens[B, 1], the caches and a cache index.
``loss`` is the forward pass only (training is ROADMAP queue 1 item 4);
the shape-only tools ``init_shapes`` and ``input_specs`` wait for queue 1
item 6.

As in the reference, an encoder-decoder runs its encoder in ``loss`` and
``prefill`` but its decoder has no cross layer (its block group is
``("attn",)``), so its logits do not depend on the frames.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from ..core.device import resolve_device
from . import transformer as T

__all__ = ["Model", "build_model"]

Params = dict


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, key: int = 0, *, device=None) -> Params:
        """Random params from a generator seeded with the int ``key`` on
        ``device`` (the card unless ``device="cpu"``).  The reference takes
        a JAX PRNG key in this place; the port takes its seed."""
        gen = torch.Generator(device=resolve_device(device)).manual_seed(int(key))
        return T.init_params(gen, self.cfg)

    def _cross(self, params: Params, batch: dict):
        """The cross-attention context: the encoder over the frames (encdec)
        or the vision embeddings (vlm); None for the other families."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return T.encode(params, batch["frames"].to(T.COMPUTE_DTYPE), cfg)
        if cfg.family == "vlm":
            return batch["vision"].to(T.COMPUTE_DTYPE)
        return None

    def loss(self, params: Params, batch: dict) -> tuple[torch.Tensor, dict]:
        """Causal LM loss (mean cross-entropy over tokens) plus the z-loss
        and 1e-2 x the MoE load-balancing aux loss."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        b, s = tokens.shape
        x = T.embed_tokens(params, tokens, cfg)
        x, _, aux = T.apply_stack(params, x, cfg, mode="train",
                                  positions=_positions(b, s, tokens.device),
                                  cross_source=self._cross(params, batch))
        logits = T.logits_from(params, x, cfg).float()
        logz = torch.logsumexp(logits, dim=-1)
        tgt = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
        xent = (logz - tgt).mean()
        z_loss = 1e-4 * torch.mean(logz**2)
        return xent + z_loss + 1e-2 * aux, {"xent": xent, "z_loss": z_loss, "moe_aux": aux}

    def prefill(self, params: Params, batch: dict) -> tuple[torch.Tensor, dict]:
        """Full-sequence forward emitting the caches and the last position's
        logits [B, 1, V]."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = T.embed_tokens(params, tokens, cfg)
        x, caches, _ = T.apply_stack(params, x, cfg, mode="prefill",
                                     positions=_positions(b, s, tokens.device),
                                     cross_source=self._cross(params, batch))
        return T.logits_from(params, x[:, -1:, :], cfg), caches

    def decode_step(self, params: Params, tokens: torch.Tensor, caches: dict,
                    cache_index: int) -> tuple[torch.Tensor, dict]:
        """One token (tokens [B, 1]) against the caches at position
        ``cache_index``; the caches are written in place and returned."""
        cfg = self.cfg
        b = tokens.shape[0]
        x = T.embed_tokens(params, tokens, cfg)
        positions = torch.full((b, 1), int(cache_index), dtype=torch.int32, device=tokens.device)
        x, caches, _ = T.apply_stack(params, x, cfg, mode="decode", positions=positions,
                                     caches=caches, cache_index=cache_index)
        return T.logits_from(params, x, cfg), caches

    def make_decode_caches(self, batch: int, max_seq: int, device=None) -> dict:
        """Empty decode caches for ``batch`` rows of ``max_seq`` positions;
        a VLM's cross caches hold ``vision_tokens``, an encoder-decoder's
        ``max_seq * audio_frames_ratio``."""
        return T.make_decode_caches(self.cfg, batch, max_seq, self._cross_len(max_seq),
                                    resolve_device(device))

    def _cross_len(self, seq: int) -> int:
        if self.cfg.family == "encdec":
            return int(seq * self.cfg.audio_frames_ratio)
        if self.cfg.family == "vlm":
            return self.cfg.vision_tokens
        return 0


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
