"""The plain reference: the served model's forward over whole sequences in
plain PyTorch, from the float weights (made again from the seed), with no
cache, no batching and no kernel.  Imports nothing of the program.

What it states, and the engine is held to:

* The weight store: per output channel, ``s8 = max(|w|) / 127`` (an IEEE
  division) and ``q8 = clamp(round(w / s8), -128, 127)`` once at 8 bits; a
  tier of ``b`` weight bits reads ``q8 >> (8 - b)`` (floor) at scale
  ``s8 * 2^(8 - b)``, which is what a plane prefix of the MSB-first
  superplane store holds.
* Activations: per row, ``scale = max(|x|, 1e-8) * f32(1 / qmax)``,
  codes ``clamp(round(x / scale), -qmax - 1, qmax)``.
* A projection: the exact integer product (float64 holds every sum),
  then ``f32(acc) * x_scale * w_scale`` in that order, cast to bf16 (the
  head's logits are kept in f32 for the comparison).  A head tied to the
  embedding is not quantized: bf16 operands, an f32 sum, bf16 logits.
* Float work in the served model's types: bf16 activations and residual,
  rmsnorm's variance in f32 with the normalized product rounded to bf16,
  qk-norm, RoPE (split halves), softmax and the SSM recurrence in f32.
  Attention probabilities are rounded to bf16 before the PV product at the
  positions that decode (after the prompt), as the decode path states;
  the SSM's ``dt * x`` is rounded to bf16 over the prompt (the chunked
  scan) and kept in f32 in decode.
* Attention over all earlier positions of the same sequence (causal);
  the SSM over the whole sequence in its quadratic (dual) form.
* The layers block by block through the configuration's pattern
  (``benchlib.parts``): ``mixer_norm`` and the mixer, then, where the
  ff is not null, ``ff_norm`` and the MLP or the MoE, each added to the
  bf16 residual.
* The MoE as the program computes it: the router in f32,
  ``softmax(x @ W_r)``; top-k a stable descending sort, so a tie puts the
  lower expert first; the k weights renormalised over their sum, clamped
  at 1e-9.  Each chosen expert's SwiGLU runs through the quantized
  projection at the row's tier (gate and up read one activation
  quantization: the codes are per row, so computing them twice gives the
  same).  The k outputs (bf16) are weighted in f32, summed over k and cast
  to bf16; the shared expert's MLP is added to that in bf16.  Dropless:
  every token reaches its k experts, as the benchmark builds the engine
  (``Runtime(moe_dropless=True)``, a flag only the program's MoE reads);
  no capacity, and no load-balancing loss (serving drops it).

The departures from the published models are the serving system's own:
the quantized projections, bf16 residuals (Mamba2 publishes an f32
residual), rmsnorm's eps at the configuration file's ``rms_norm_eps``
(the engine fixes 1e-6; Mamba2 publishes 1e-5) and the head over the
vocabulary padded to a multiple of 256.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchlib import parts
from benchlib import weights as W

BF16 = torch.bfloat16
F32 = torch.float32


def _tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------ quantization
def weight_store(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q8 int16 [K, N], s8 f32 [1, N]) of a float weight [K, N]."""
    wf = w.to(F32)
    amax = wf.abs().amax(dim=0, keepdim=True)
    s8 = torch.clamp_min(amax, 1e-8) / torch.full((), 127.0, device=w.device)
    q8 = torch.clamp(torch.round(wf / s8), -128, 127).to(torch.int16)
    return q8, s8


def weight_at(q8: torch.Tensor, s8: torch.Tensor,
              bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``bits``-wide weight of the store: (codes float64, scale f32)."""
    shift = 8 - bits
    return ((q8.to(torch.int32) >> shift).to(torch.float64),
            s8 * float(1 << shift))


def quant_act(x: torch.Tensor, bits: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row signed codes (float64) and scales (f32) of x [M, K]."""
    xf = x.to(F32)
    qmax = (1 << (bits - 1)) - 1
    amax = xf.abs().amax(dim=-1, keepdim=True)
    inv = torch.div(torch.ones((), device=x.device),
                    torch.full((), float(qmax), device=x.device))
    scale = torch.clamp_min(amax, 1e-8) * inv
    q = torch.clamp(torch.round(xf / scale), -qmax - 1, qmax)
    return q.to(torch.float64), scale


def qlinear(x: torch.Tensor, w: Tuple[torch.Tensor, torch.Tensor],
            a_bits: int) -> torch.Tensor:
    """f32 output of a quantized projection of x [..., K]."""
    lead = x.shape[:-1]
    q, xs = quant_act(x.reshape(-1, x.shape[-1]), a_bits)
    codes, ws = w
    acc = (q @ codes).to(F32)
    return ((acc * xs) * ws).reshape(*lead, -1)


# ------------------------------------------------------------- float parts
def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(F32)
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return x * inv.to(x.dtype) * g.to(x.dtype)


def head_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(F32)
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * g.to(F32)).to(x.dtype)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding of x [L, H, Dh] at positions 0..L-1."""
    half = x.shape[-1] // 2
    dev = x.device
    exps = -torch.arange(half, dtype=F32, device=dev) / half
    freqs = torch.pow(torch.full((), theta, dtype=F32, device=dev), exps)
    ang = torch.arange(x.shape[0], dtype=F32, device=dev)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.to(F32).split(half, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              prompt_len: int) -> torch.Tensor:
    """Causal GQA attention, q [L, H, Dh], k/v [L, KVH, Dh] (bf16)."""
    length, h, dh = q.shape
    kvh = k.shape[1]
    g = h // kvh
    dev = q.device
    out = torch.empty_like(q)
    causal = torch.ones((length, length), dtype=torch.bool,
                        device=dev).tril()
    decode_rows = torch.arange(length, device=dev) >= prompt_len
    for j in range(kvh):
        qj = q[:, j * g:(j + 1) * g].to(F32).transpose(0, 1)     # [g, L, Dh]
        kj = k[:, j].to(F32)
        s = (qj @ kj.T) * (1.0 / math.sqrt(dh))
        s = s.masked_fill(~causal, -1e30)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        p = torch.where(decode_rows[None, :, None],
                        p.to(BF16).to(F32), p)
        out[:, j * g:(j + 1) * g] = (p @ v[:, j].to(F32)).transpose(
            0, 1).to(BF16)
    return out


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def ssd(xh: torch.Tensor, dtp: torch.Tensor, a: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
        prompt_len: int) -> torch.Tensor:
    """Mamba2's SSD over a whole sequence in its dual form, f32.
    xh [L, H, P] bf16, dtp [L, H] f32, a [H], b/c [L, N] bf16."""
    length = xh.shape[0]
    dev = xh.device
    dtx = xh.to(F32) * dtp[..., None]
    prompt = (torch.arange(length, device=dev) < prompt_len)[:, None, None]
    dtx = torch.where(prompt, dtx.to(BF16).to(F32), dtx)
    cum = torch.cumsum(a[None, :] * dtp, dim=0)                # [L, H]
    causal = torch.ones((length, length), dtype=torch.bool,
                        device=dev).tril()
    cb = c.to(F32) @ b.to(F32).T                               # [L, L]
    y = torch.empty((length,) + xh.shape[1:], dtype=F32, device=dev)
    for h in range(xh.shape[1]):
        diff = cum[:, h][:, None] - cum[:, h][None, :]
        m = torch.where(causal, torch.exp(torch.clamp_max(diff, 0.0)), 0.0)
        y[:, h] = (cb * m) @ dtx[:, h]
    return y + d_skip[None, :, None] * xh.to(F32)


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over x [L, C] in f32, silu, bf16."""
    width = w.shape[0]
    xp = F.pad(x.to(F32), (0, 0, width - 1, 0))
    out = sum(xp[i:i + x.shape[0]] * w[i].to(F32) for i in range(width))
    out = out + b.to(F32)
    return (out * torch.sigmoid(out)).to(BF16)


def route(w: torch.Tensor, x: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE router on x [M, d] bf16 with w [d, E] f32: (the k weights
    renormalised, f32 [M, k]; the k experts [M, k])."""
    s = x.to(F32) @ w
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w = vals[:, :k]
    top_w = top_w / torch.clamp_min(top_w.sum(dim=-1, keepdim=True), 1e-9)
    return top_w, idx[:, :k]


# ------------------------------------------------------------------ model
class Reference:
    """The forward of one configuration over a set of sequences, block by
    block: each block's weights are made again from the seed, used at
    every width the sequences ask for, and dropped."""

    def __init__(self, cfg: Dict[str, Any], seed: int,
                 device: torch.device) -> None:
        self.cfg = cfg
        self.seed = seed
        self.device = device
        self.eps = float(cfg.get("rms_norm_eps", 1e-6))
        _tf32_off()

    def _store(self, w: torch.Tensor, bits: Sequence[int]
               ) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
        q8, s8 = weight_store(w)
        return {b: weight_at(q8, s8, b) for b in set(bits)}

    def logits(self, seqs: Sequence[torch.Tensor], prompt_lens: Sequence[int],
               tiers: Sequence[Tuple[int, int]], first: Sequence[int]
               ) -> List[torch.Tensor]:
        """f32 logits [L_i - first_i, V] of each sequence (int64 tokens
        [L_i]) at positions ``first_i`` .. ``L_i - 1``, sequence i at
        ``tiers[i]`` = (w_bits, a_bits)."""
        cfg, dev = self.cfg, self.device
        emb = W.make_embed(cfg, self.seed, dev)
        xs = [emb[s.to(dev)] for s in seqs]
        del emb
        wbits = [t[0] for t in tiers]
        for i, (mixer, ff) in enumerate(parts.layers(cfg)):
            blk = W.make_block(cfg, self.seed, i, mixer, ff, dev)
            mix = self._attn if mixer == "attn" else self._mamba
            xs = mix(blk, xs, prompt_lens, tiers, wbits)
            if ff is not None:
                ffn = self._mlp if ff == "mlp" else self._moe
                xs = ffn(blk, xs, tiers, wbits)
            del blk
        g = W.make_final_norm(cfg, self.seed, dev)
        if cfg.get("tie_embeddings"):
            return self._tied_head(xs, g, first)
        q8, s8 = weight_store(W.make_head(cfg, self.seed, dev))
        out: List[torch.Tensor] = [torch.empty(0)] * len(xs)
        for wb in sorted(set(wbits)):
            codes = weight_at(q8, s8, wb)
            for i, (x, (b, ab), f) in enumerate(zip(xs, tiers, first)):
                if b == wb:
                    out[i] = qlinear(rmsnorm(x[f:], g, self.eps), codes, ab)
            del codes
        return out

    def _tied_head(self, xs, g, first) -> List[torch.Tensor]:
        """The head tied to the embedding, as served: bf16 operands, the
        product summed in f32 and rounded to bf16."""
        emb = W.make_embed(self.cfg, self.seed, self.device).to(F32)
        out = [(rmsnorm(x[f:], g, self.eps).to(F32) @ emb.T).to(BF16)
               .to(F32) for x, f in zip(xs, first)]
        del emb
        return out

    def _attn(self, blk, xs, prompt_lens, tiers, wbits):
        cfg = self.cfg
        h, kvh, dh = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
        att = blk["attn"]
        st = {name: self._store(att[name]["w"], wbits)
              for name in ("q_proj", "k_proj", "v_proj", "o_proj")}
        out = []
        for x, p_len, (wb, ab) in zip(xs, prompt_lens, tiers):
            length = x.shape[0]
            hn = rmsnorm(x, blk["mixer_norm"]["g"], self.eps)
            q = qlinear(hn, st["q_proj"][wb], ab).to(BF16).view(length, h, dh)
            k = qlinear(hn, st["k_proj"][wb], ab).to(BF16).view(
                length, kvh, dh)
            v = qlinear(hn, st["v_proj"][wb], ab).to(BF16).view(
                length, kvh, dh)
            if cfg.get("qk_norm"):
                q = head_norm(q, att["q_norm"]["g"], self.eps)
                k = head_norm(k, att["k_norm"]["g"], self.eps)
            q = rope(q, cfg["rope_theta"])
            k = rope(k, cfg["rope_theta"])
            o = attention(q, k, v, p_len).reshape(length, h * dh)
            out.append(x + qlinear(o, st["o_proj"][wb], ab).to(BF16))
        return out

    def _swiglu(self, x, st, wb, ab):
        """A SwiGLU MLP of x [M, d] from its stores at ``(wb, ab)``."""
        gate = qlinear(x, st["gate_proj"][wb], ab).to(BF16)
        up = qlinear(x, st["up_proj"][wb], ab).to(BF16)
        gf = gate.to(F32)
        hid = (gf * torch.sigmoid(gf)).to(BF16) * up
        return qlinear(hid, st["down_proj"][wb], ab).to(BF16)

    def _mlp_stores(self, mlp, wbits):
        return {name: self._store(mlp[name]["w"], wbits)
                for name in ("gate_proj", "up_proj", "down_proj")}

    def _mlp(self, blk, xs, tiers, wbits):
        st = self._mlp_stores(blk["mlp"], wbits)
        return [x + self._swiglu(rmsnorm(x, blk["ff_norm"]["g"], self.eps),
                                 st, wb, ab)
                for x, (wb, ab) in zip(xs, tiers)]

    def _moe(self, blk, xs, tiers, wbits):
        """The MoE block (module docstring), expert by expert: each
        expert's stores are made once, used for every row routed to it,
        and dropped."""
        moe, k = blk["moe"], self.cfg["experts_per_token"]
        hns = [rmsnorm(x, blk["ff_norm"]["g"], self.eps) for x in xs]
        routes = [route(moe["router"]["w"], hn, k) for hn in hns]
        picked = [torch.zeros((x.shape[0], k, x.shape[1]), dtype=BF16,
                              device=x.device) for x in xs]
        for e in range(moe["gate_proj"]["w"].shape[0]):
            st = self._mlp_stores({n: {"w": moe[n]["w"][e]} for n in
                                   ("gate_proj", "up_proj", "down_proj")},
                                  wbits)
            for hn, (_, top_i), y, (wb, ab) in zip(hns, routes, picked,
                                                   tiers):
                rows, slots = (top_i == e).nonzero(as_tuple=True)
                if rows.numel():
                    y[rows, slots] = self._swiglu(hn[rows], st, wb, ab)
            del st
        shared = self._mlp_stores(moe["shared"], wbits) \
            if "shared" in moe else None
        out = []
        for x, hn, (top_w, _), y, (wb, ab) in zip(xs, hns, routes, picked,
                                                  tiers):
            y = (y.to(F32) * top_w[..., None]).sum(dim=1).to(BF16)
            if shared is not None:
                y = y + self._swiglu(hn, shared, wb, ab)
            out.append(x + y)
        return out

    def _mamba(self, blk, xs, prompt_lens, tiers, wbits):
        di, ns, p, h = W.ssm_sizes(self.cfg)
        mb = blk["mamba"]
        st_in = self._store(mb["in_proj"]["w"], wbits)
        st_out = self._store(mb["out_proj"]["w"], wbits)
        a = -torch.exp(mb["A_log"])
        out = []
        for x, p_len, (wb, ab) in zip(xs, prompt_lens, tiers):
            length = x.shape[0]
            hn = rmsnorm(x, blk["mixer_norm"]["g"], self.eps)
            zx = qlinear(hn, st_in[wb], ab).to(BF16)
            z, xin, bm, cm, dt = torch.split(zx, [di, di, ns, ns, h], dim=-1)
            conv = causal_conv(torch.cat([xin, bm, cm], dim=-1),
                               mb["conv_w"], mb["conv_b"])
            xc, bc, cc = torch.split(conv, [di, ns, ns], dim=-1)
            dtp = softplus(dt.to(F32) + mb["dt_bias"][None, :])
            y = ssd(xc.reshape(length, h, p), dtp, a, bc, cc, mb["D"],
                    p_len).reshape(length, di).to(BF16)
            zf = z.to(F32)
            gated = rmsnorm(y, mb["norm"]["g"], self.eps) * \
                (zf * torch.sigmoid(zf)).to(BF16)
            out.append(x + qlinear(gated, st_out[wb], ab).to(BF16))
        return out


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per position: how far the chosen token's logit lies below the best."""
    best = logits.amax(dim=-1)
    chosen = logits.gather(-1, tokens.to(logits.device).long()[:, None])[:, 0]
    return best - chosen


def one_step_lower(tier: Tuple[int, int]) -> Tuple[int, int]:
    """The control's precision: each width at the next one below it (8 ->
    4 and 4 -> 2, the store's plane prefixes; weights 2 -> 1, the store's
    sign bit; activations have no signed width below 2)."""
    w_lower = {8: 4, 4: 2, 2: 1}
    a_lower = {8: 4, 4: 2, 2: 2}
    return w_lower[tier[0]], a_lower[tier[1]]


def control_tokens(ref: Reference, seqs, prompt_lens, tiers, first
                   ) -> List[torch.Tensor]:
    """The control's tokens: at every position of the same sequences, the
    one the one-step-lower reference puts first."""
    low = ref.logits(seqs, prompt_lens, [one_step_lower(t) for t in tiers],
                     first)
    return [lo.argmax(dim=-1) for lo in low]
