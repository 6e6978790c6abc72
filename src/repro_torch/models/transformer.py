"""Decoder-only LM stack (port of ``repro.models.transformer``) for every
period pattern: attention or Mamba2 mixers, each followed by a SwiGLU MLP,
an MoE block or nothing (dense, MoE, hybrid and pure-SSM archs).

Parameters are a plain dict of tensors.  Where the reference stacks the
periods of its pattern along a leading axis and scans over them, the port
keeps a list with one dict per period, ``params["layers"][i]["pos0"]
["attn"]["q_proj"]["w"]``, so a projection's policy name is the
reference's (``layers.pos0.attn.q_proj``; list indices are not part of it).
Caches mirror that: a list of ``{"pos<j>": KVCache or SSMCache}`` per
period.

Each public call reads the process's span recorder slot
(``telemetry.trace.CURRENT``) once; with a recorder there it runs on a
``Runtime`` carrying it (``rt.rec``), and records ``embed``, per layer
(``layer``: its index in the stack) ``attn`` or ``ssm`` and ``mlp`` or
``moe``, and ``head``, the blocks adding theirs.  With the slot empty no
span code runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers, moe, ssm
from repro_torch.models.config import ArchConfig
from repro_torch.telemetry import trace as tracing

# A hook applied to each freshly initialised sub-tree with its key path
# (e.g. ``("layers", 3)`` or ``("lm_head",)``) — used to quantize a layer
# into its plane store before the next one is made.
PrepareHook = Callable[[Dict[str, Any], Tuple[Any, ...]], Dict[str, Any]]


class LM:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.pattern = cfg.period_pattern()

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator, *, device=None,
             prepare: Optional[PrepareHook] = None) -> Dict[str, Any]:
        """Random weights from ``gen`` on ``device`` (default cuda), made
        period by period.  ``prepare`` (if given) replaces each period's
        float tree as soon as it exists, so at most one period of float
        weights is ever alive."""
        cfg, dev = self.cfg, resolve_device(device)
        dt = cfg.dtype
        emb = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                          device=dev, dtype=torch.float32) * 0.02
        params: Dict[str, Any] = {"embed": {"emb": emb.to(dt)}, "layers": []}
        del emb
        for i in range(cfg.n_periods):
            period: Dict[str, Any] = {}
            for j, (mixer, ff) in enumerate(self.pattern):
                blk: Dict[str, Any] = {
                    "mixer_norm": layers.rmsnorm_init(cfg.d_model, dt, dev)}
                if mixer == "attn":
                    blk["attn"] = layers.attention_init(gen, cfg, dt, dev)
                else:
                    blk["mamba"] = ssm.ssm_init(gen, cfg, dt, dev)
                if ff is not None:
                    blk["ff_norm"] = layers.rmsnorm_init(cfg.d_model, dt, dev)
                    if ff == "mlp":
                        blk["mlp"] = layers.mlp_init(gen, cfg.d_model,
                                                     cfg.d_ff, dt, dev)
                    else:
                        blk["moe"] = moe.moe_init(gen, cfg, dt, dev)
                period[f"pos{j}"] = blk
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
    def _embed(self, params: Dict[str, Any], rt: layers.Runtime,
               tokens: Optional[torch.Tensor] = None,
               embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings, or the frontend stub's precomputed ``embeds``
        [B, S, d] cast to the model dtype."""
        rec = rt.rec
        if rec is not None:
            span = rec.begin("embed")
        if embeds is not None:
            x = embeds.to(self.cfg.dtype)
        else:
            x = params["embed"]["emb"][tokens.to(torch.int64)]
        if rec is not None:
            rec.end(span)
        return x

    def _head(self, params: Dict[str, Any], x: torch.Tensor,
              rt: layers.Runtime, verify_window: bool = False
              ) -> torch.Tensor:
        rec = rt.rec
        if rec is not None:
            span = rec.begin("head")
        x = self._norm(params["final_norm"], x, verify_window)
        if self.cfg.tie_embeddings:
            y = torch.matmul(x, params["embed"]["emb"].T.to(x.dtype))
        else:
            y = layers.linear(params["lm_head"], x, rt, "lm_head")
        if rec is not None:
            rec.end(span)
        return y

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
               verify_window: bool = False
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                          Optional[List[Dict[str, Any]]]]:
        """The periods over x.  Returns (x, aux, caches): aux the MoE
        load-balancing losses summed in f32 (None without an MoE layer),
        the caches as the mixers return them (the same objects, written in
        place, except a verify window's per-step stacked SSM caches)."""
        cfg = self.cfg
        rec = rt.rec
        aux: Optional[torch.Tensor] = None
        new_caches: Optional[List[Dict[str, Any]]] = \
            None if caches is None else []
        for li, period in enumerate(params["layers"]):
            layer_caches: Dict[str, Any] = {}
            for j, (mixer, ff) in enumerate(self.pattern):
                blk = period[f"pos{j}"]
                cache = None if caches is None else caches[li][f"pos{j}"]
                if rec is not None:
                    layer = li * len(self.pattern) + j
                    span = rec.begin("attn" if mixer == "attn" else "ssm",
                                     layer=layer)
                h = self._norm(blk["mixer_norm"], x, verify_window)
                if mixer == "attn":
                    out, nc = layers.attention_apply(
                        blk["attn"], h, rt, cfg, f"layers.pos{j}.attn",
                        cache=cache, seq_lengths=seq_lengths, active=active,
                        verify_window=verify_window)
                else:
                    out, nc = ssm.ssm_apply(
                        blk["mamba"], h, rt, cfg, f"layers.pos{j}.mamba",
                        cache=cache, seq_lengths=seq_lengths, active=active,
                        verify_window=verify_window)
                x = x + out
                layer_caches[f"pos{j}"] = nc
                if rec is not None:
                    rec.end(span)
                if ff is None:
                    continue
                if rec is not None:
                    span = rec.begin(ff, layer=layer)
                h2 = self._norm(blk["ff_norm"], x, verify_window)
                if ff == "mlp":
                    x = x + layers.mlp_apply(blk["mlp"], h2, rt,
                                             f"layers.pos{j}.mlp",
                                             verify_window=verify_window)
                else:
                    y, a = moe.moe_apply(blk["moe"], h2, rt, cfg,
                                         f"layers.pos{j}.moe",
                                         verify_window=verify_window)
                    x = x + y
                    aux = a if aux is None else aux + a
                if rec is not None:
                    rec.end(span)
            if new_caches is not None:
                new_caches.append(layer_caches)
        return x, aux, new_caches

    # ---------------------------------------------------------------- public
    def forward(self, params: Dict[str, Any], rt: layers.Runtime,
                tokens: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward without a cache (training, profiling) on
        ``tokens`` [B, S] or ``embeds`` [B, S, d].  Returns (logits
        [B, S, V], aux_loss), aux_loss the f32 sum of the MoE layers'
        load-balancing losses (zero without MoE)."""
        if tracing.CURRENT is not None:
            rt = dataclasses.replace(rt, rec=tracing.CURRENT)
        x, aux, _ = self._stack(params,
                                self._embed(params, rt, tokens, embeds), rt)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._head(params, x, rt), aux

    def init_cache(self, batch: int, max_len: int, kv_bits: Any = None,
                   device=None) -> List[Dict[str, Any]]:
        """One ``{"pos<j>": cache}`` dict per period: a ``KVCache`` at
        attention positions, ``kv_bits`` None (bf16), 8 (int8), 4 (int4
        packed) or a tuple of tier codes such as ``(16, 8, 4)`` for the
        mixed per-slot arena (``layers.KVCache.create``), and an
        ``ssm.SSMCache`` at Mamba positions.  Every tensor starts at zero —
        scales and the mixed arena's tier codes included — as the
        reference's arena does."""
        cfg, dev = self.cfg, resolve_device(device)

        def make(mixer: str) -> Any:
            if mixer == "attn":
                return layers.KVCache.create(
                    batch, max_len, cfg.num_kv_heads, cfg.head_dim,
                    dtype=cfg.dtype, kv_bits=kv_bits, device=dev)
            return ssm.SSMCache.create(batch, cfg, device=dev)

        caches = [{f"pos{j}": make(mixer)
                   for j, (mixer, _) in enumerate(self.pattern)}
                  for _ in range(cfg.n_periods)]
        for layer in caches:
            for c in layer.values():
                for t in c.tensors():
                    t.zero_()
        return caches

    def prefill(self, params: Dict[str, Any], rt: layers.Runtime,
                caches: List[Dict[str, Any]],
                tokens: Optional[torch.Tensor] = None,
                seq_lengths: Optional[torch.Tensor] = None, *,
                embeds: Optional[torch.Tensor] = None):
        """Run the prompt through the stack, filling the caches (in place)
        from position 0.  ``seq_lengths`` [B] supports right-padded batches:
        logits are gathered at each row's last REAL position.  ``embeds``
        replaces ``tokens`` for a frontend stub.
        Returns (logits [B, 1, V], caches)."""
        if tracing.CURRENT is not None:
            rt = dataclasses.replace(rt, rec=tracing.CURRENT)
        x, _, _ = self._stack(params, self._embed(params, rt, tokens, embeds),
                              rt, caches=caches, seq_lengths=seq_lengths)
        if seq_lengths is None:
            last = x[:, -1:]
        else:
            idx = torch.clamp(seq_lengths.to(torch.int64) - 1, 0,
                              x.shape[1] - 1)
            last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
        return self._head(params, last, rt), caches

    def decode_step(self, params: Dict[str, Any], rt: layers.Runtime,
                    caches: List[Dict[str, Any]],
                    tokens: Optional[torch.Tensor] = None,
                    active: Optional[torch.Tensor] = None, *,
                    embeds: Optional[torch.Tensor] = None):
        """One-token decode against filled caches; ``active`` [B] masks the
        cache writes of finished or empty slots; ``embeds`` [B, 1, d]
        replaces ``tokens`` for a frontend stub.
        Returns (logits [B, 1, V], caches)."""
        if tracing.CURRENT is not None:
            rt = dataclasses.replace(rt, rec=tracing.CURRENT)
        x, _, _ = self._stack(params, self._embed(params, rt, tokens, embeds),
                              rt, caches=caches, active=active)
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
        masks every cache write.  KV caches come back appended by W, in
        place; the engine rolls rejected positions back by a length
        truncation (``serve.slots.truncate_kv_lengths``).  SSM caches are
        not written: the returned list holds, at their positions, the
        per-step states stacked ([W, B, ...]), from which the engine keeps
        each slot's last accepted step (``serve.slots.select_verify_step``).
        Returns (logits [B, W, V], caches)."""
        if tracing.CURRENT is not None:
            rt = dataclasses.replace(rt, rec=tracing.CURRENT)
        x, _, new_caches = self._stack(params, self._embed(params, rt, tokens),
                                       rt, caches=caches, active=active,
                                       verify_window=True)
        return self._head(params, x, rt, verify_window=True), new_caches
