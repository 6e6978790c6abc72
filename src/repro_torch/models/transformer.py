"""Decoder-only LM, attention + MLP layers (port of
``repro.models.transformer``).

Parameters are a plain dict of tensors.  Where the reference stacks the
layers of its period pattern along a leading axis and scans over them, the
port keeps a list with one period dict per layer, ``params["layers"][i]
["pos0"]["attn"]["q_proj"]["w"]``, so a projection's policy name is the
reference's (``layers.pos0.attn.q_proj``; list indices are not part of it).
Caches mirror that: a list of ``{"pos0": KVCache}`` per layer.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig

# A hook applied to each freshly initialised sub-tree with its key path
# (e.g. ``("layers", 3)`` or ``("lm_head",)``) — used to quantize a layer
# into its plane store before the next one is made.
PrepareHook = Callable[[Dict[str, Any], Tuple[Any, ...]], Dict[str, Any]]


class LM:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.pattern = cfg.period_pattern()
        if any(m != "attn" or ff != "mlp" for m, ff in self.pattern):
            raise NotImplementedError(
                f"{cfg.name}: only attention + MLP layers are ported; SSM, "
                "hybrid and MoE layers are ROADMAP Queue 1 item 8")

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator, *, device=None,
             prepare: Optional[PrepareHook] = None) -> Dict[str, Any]:
        """Random weights from ``gen`` on ``device`` (default cuda), made
        layer by layer.  ``prepare`` (if given) replaces each layer's float
        tree as soon as it exists, so at most one layer of float weights
        is ever alive."""
        cfg, dev = self.cfg, resolve_device(device)
        dt = cfg.dtype
        emb = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                          device=dev, dtype=torch.float32) * 0.02
        params: Dict[str, Any] = {"embed": {"emb": emb.to(dt)}, "layers": []}
        del emb
        for i in range(cfg.n_periods):
            period: Dict[str, Any] = {}
            for j, _ in enumerate(self.pattern):
                period[f"pos{j}"] = {
                    "mixer_norm": layers.rmsnorm_init(cfg.d_model, dt, dev),
                    "attn": layers.attention_init(gen, cfg, dt, dev),
                    "ff_norm": layers.rmsnorm_init(cfg.d_model, dt, dev),
                    "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, dt, dev),
                }
            if prepare is not None:
                period = prepare(period, ("layers", i))
            params["layers"].append(period)
        params["final_norm"] = layers.rmsnorm_init(cfg.d_model, dt, dev)
        if not cfg.tie_embeddings:
            head = layers.dense_init(gen, cfg.d_model, cfg.padded_vocab, dt,
                                     dev)
            params["lm_head"] = head if prepare is None \
                else prepare(head, ("lm_head",))
        return params

    # ------------------------------------------------------------- internals
    def _embed(self, params: Dict[str, Any],
               tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"]["emb"][tokens.to(torch.int64)]

    def _head(self, params: Dict[str, Any], x: torch.Tensor,
              rt: layers.Runtime, verify_window: bool = False
              ) -> torch.Tensor:
        x = self._norm(params["final_norm"], x, verify_window)
        if self.cfg.tie_embeddings:
            return torch.matmul(x, params["embed"]["emb"].T.to(x.dtype))
        return layers.linear(params["lm_head"], x, rt, "lm_head")

    @staticmethod
    def _norm(g: Dict[str, torch.Tensor], x: torch.Tensor,
              verify_window: bool) -> torch.Tensor:
        """rmsnorm; per window position under ``verify_window`` (see
        ``layers.per_position``)."""
        if verify_window:
            return layers.per_position(lambda t: layers.rmsnorm(g, t), x)
        return layers.rmsnorm(g, x)

    def _stack(self, params: Dict[str, Any], x: torch.Tensor,
               rt: layers.Runtime, caches: Optional[List[Dict[str, Any]]] = None,
               seq_lengths: Optional[torch.Tensor] = None,
               active: Optional[torch.Tensor] = None,
               verify_window: bool = False) -> torch.Tensor:
        cfg = self.cfg
        for li, period in enumerate(params["layers"]):
            for j, _ in enumerate(self.pattern):
                blk = period[f"pos{j}"]
                cache = None if caches is None else caches[li][f"pos{j}"]
                h = self._norm(blk["mixer_norm"], x, verify_window)
                out, _ = layers.attention_apply(
                    blk["attn"], h, rt, cfg, f"layers.pos{j}.attn",
                    cache=cache, seq_lengths=seq_lengths, active=active,
                    verify_window=verify_window)
                x = x + out
                h2 = self._norm(blk["ff_norm"], x, verify_window)
                x = x + layers.mlp_apply(blk["mlp"], h2, rt,
                                         f"layers.pos{j}.mlp",
                                         verify_window=verify_window)
        return x

    # ---------------------------------------------------------------- public
    def forward(self, params: Dict[str, Any], rt: layers.Runtime,
                tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward without a cache.  Returns logits [B, S, V]."""
        x = self._stack(params, self._embed(params, tokens), rt)
        return self._head(params, x, rt)

    def init_cache(self, batch: int, max_len: int, kv_bits: Any = None,
                   device=None) -> List[Dict[str, Any]]:
        """One ``{"pos<j>": KVCache}`` dict per layer; ``kv_bits`` None
        (bf16), 8 (int8), 4 (int4 packed) or a tuple of tier codes such as
        ``(16, 8, 4)`` for the mixed per-slot arena
        (``layers.KVCache.create``).  Every tensor starts at zero — scales
        and the mixed arena's tier codes included — as the reference's
        arena does."""
        cfg, dev = self.cfg, resolve_device(device)
        caches = [{f"pos{j}": layers.KVCache.create(
                      batch, max_len, cfg.num_kv_heads, cfg.head_dim,
                      dtype=cfg.dtype, kv_bits=kv_bits, device=dev)
                   for j, _ in enumerate(self.pattern)}
                  for _ in range(cfg.n_periods)]
        for layer in caches:
            for c in layer.values():
                for t in c.tensors():
                    t.zero_()
        return caches

    def prefill(self, params: Dict[str, Any], rt: layers.Runtime,
                caches: List[Dict[str, Any]], tokens: torch.Tensor,
                seq_lengths: Optional[torch.Tensor] = None):
        """Run the prompt through the stack, filling the caches (in place)
        from position 0.  ``seq_lengths`` [B] supports right-padded batches:
        logits are gathered at each row's last REAL position.
        Returns (logits [B, 1, V], caches)."""
        x = self._stack(params, self._embed(params, tokens), rt,
                        caches=caches, seq_lengths=seq_lengths)
        if seq_lengths is None:
            last = x[:, -1:]
        else:
            idx = torch.clamp(seq_lengths.to(torch.int64) - 1, 0,
                              x.shape[1] - 1)
            last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
        return self._head(params, last, rt), caches

    def decode_step(self, params: Dict[str, Any], rt: layers.Runtime,
                    caches: List[Dict[str, Any]], tokens: torch.Tensor,
                    active: Optional[torch.Tensor] = None):
        """One-token decode against filled caches; ``active`` [B] masks the
        cache writes of finished or empty slots.
        Returns (logits [B, 1, V], caches)."""
        x = self._stack(params, self._embed(params, tokens), rt,
                        caches=caches, active=active)
        return self._head(params, x, rt), caches

    def verify_step(self, params: Dict[str, Any], rt: layers.Runtime,
                    caches: List[Dict[str, Any]], tokens: torch.Tensor,
                    active: Optional[torch.Tensor] = None):
        """Speculative verify: a teacher-forced decode of the [B, W] window
        ``tokens`` at each active slot's own fill point, in ONE forward
        whose projections and LM head run over all B*W rows, and whose
        position-j logits and KV writes are bit-identical to the j-th of W
        sequential :meth:`decode_step` calls (see
        ``layers.attention_apply(verify_window=True)``).  ``active`` [B]
        masks every cache write.  The caches come back appended by W, in
        place; the engine rolls rejected positions back by a length
        truncation (``serve.slots.truncate_kv_lengths``).
        Returns (logits [B, W, V], caches)."""
        x = self._stack(params, self._embed(params, tokens), rt,
                        caches=caches, active=active, verify_window=True)
        return self._head(params, x, rt, verify_window=True), caches
