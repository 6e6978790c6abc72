"""Mamba2 / SSD (state-space duality) block (port of ``repro.models.ssm``):
a chunked scan for prefill, an O(1)-state update for decode, and the
speculative verify window's replay of that update.

The in and out projections go through ``layers.linear`` (the quantized
plane GEMMs); the conv and the SSD recurrence are elementwise and
outer-product work kept in f32, as in the reference.  Activations stay
bf16 and are rounded where the reference's source casts: ``dtx`` through
bf16 before the scan and the final-state pass, the conv output after its
silu.  The chunked scan is a Python loop over chunks in place of
``lax.scan``.

Unlike the reference, which is functional, the cache is written IN PLACE
by prefill and decode (a slot view shares storage with the arena).  The
verify window writes nothing: it returns its states per step, stacked,
for the engine to select from (``serve.slots.select_verify_step``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers


def ssm_init(gen: torch.Generator, cfg, dtype: torch.dtype,
             device: torch.device) -> Dict[str, Any]:
    """The reference's distributions (the draws differ; tests convert the
    reference's weights)."""
    d, di, ns, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * ns
    conv_w = torch.randn((cfg.ssm_conv, conv_ch), generator=gen,
                         device=device, dtype=torch.float32)
    return {
        # z | x | B | C | dt
        "in_proj": layers.dense_init(gen, d, 2 * di + 2 * ns + h, dtype,
                                     device),
        "out_proj": layers.dense_init(gen, di, d, dtype, device),
        "conv_w": conv_w.to(dtype) * 0.1,
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=device)),
        "dt_bias": torch.full((h,), 0.5, dtype=torch.float32, device=device),
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "norm": {"g": torch.ones((di,), dtype=dtype, device=device)},
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) written out: torch's
    ``F.softplus`` switches to ``x`` above its threshold and differs."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d in f32.  x: [B, L, C]; w: [W, C].  TF32 is
    off for it: cuDNN would otherwise round the f32 operands."""
    width, ch = w.shape
    xt = F.pad(x.to(torch.float32).transpose(1, 2), (width - 1, 0))
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        out = F.conv1d(xt, w.to(torch.float32).t()[:, None, :], groups=ch)
    return out.transpose(1, 2) + b.to(torch.float32)


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor, d_skip: torch.Tensor,
                 chunk: int) -> torch.Tensor:
    """Chunked SSD scan.  xh: [B, L, H, P]; dt: [B, L, H] f32; a: [H]
    (negative); bmat/cmat: [B, L, N].  Returns y: [B, L, H, P] f32."""
    b, l0, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, l0)
    pad = (-l0) % q
    if pad:
        # Padded dt = 0 gives dtx = 0: states and real outputs unchanged.
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    nc = (l0 + pad) // q
    log_a = a[None, None, :] * dt                      # [B, L, H] f32, <= 0
    dtx = (xh.to(torch.float32) * dt[..., None]).to(xh.dtype)
    tri = torch.tril(torch.ones((q, q), dtype=torch.float32,
                                device=xh.device))
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=xh.device)
    ys: List[torch.Tensor] = []
    for c in range(nc):
        sl = slice(c * q, (c + 1) * q)
        la_c = log_a[:, sl]
        dtx_c = dtx[:, sl].to(torch.float32)
        b_c = bmat[:, sl].to(torch.float32)
        c_c = cmat[:, sl].to(torch.float32)
        cum = torch.cumsum(la_c, dim=1)                # [B, Q, H]
        total = cum[:, -1]                             # [B, H]
        scores = torch.einsum("bin,bjn->bij", c_c, b_c)
        decay = torch.exp(torch.clamp(cum[:, :, None] - cum[:, None, :],
                                      -60.0, 0.0))
        att = scores[..., None] * decay * tri[None, :, :, None]   # [B,Q,Q,H]
        y_intra = torch.einsum("bijh,bjhp->bihp", att, dtx_c)
        y_inter = torch.einsum("bin,bhnp->bihp", c_c, state) \
            * torch.exp(cum)[..., None]
        w = torch.exp(torch.clamp(total[:, None] - cum, -60.0, 0.0))
        state = torch.exp(total)[:, :, None, None] * state \
            + torch.einsum("bjn,bjh,bjhp->bhnp", b_c, w, dtx_c)
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    y = y + d_skip[None, None, :, None] * xh.to(torch.float32)
    return y[:, :l0]


def _final_state(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bmat: torch.Tensor) -> torch.Tensor:
    """The SSD state after a whole sequence (the prefill -> decode
    handoff), ``dtx`` rounded through bf16 as :func:`_ssd_chunked` does."""
    log_a = a[None, None, :] * dt
    cum = torch.cumsum(log_a, dim=1)
    total = cum[:, -1]
    w = torch.exp(torch.clamp(total[:, None] - cum, -60.0, 0.0))
    dtx = (xh.to(torch.float32) * dt[..., None]).to(xh.dtype)
    return torch.einsum("bjn,bjh,bjhp->bhnp", bmat.to(torch.float32), w,
                        dtx.to(torch.float32))


@dataclasses.dataclass
class SSMCache:
    """Rolling conv window and SSD state, slot axis first; the protocol of
    ``layers.KVCache`` (``FIELDS``, ``tensors``, ``slot``), so the serving
    arena's slot operations take SSM rows unchanged.  Written in place."""

    conv: torch.Tensor    # [B, W-1, conv_ch] f32
    state: torch.Tensor   # [B, H, N, P] f32

    FIELDS = ("conv", "state")

    @staticmethod
    def create(batch: int, cfg, device: Optional[torch.device] = None
               ) -> "SSMCache":
        conv_ch = cfg.d_inner + 2 * cfg.ssm_state
        return SSMCache(
            torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                        dtype=torch.float32, device=device),
            torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                         cfg.ssm_headdim), dtype=torch.float32,
                        device=device))

    def tensors(self) -> List[torch.Tensor]:
        return [self.conv, self.state]

    def slot(self, slot: int) -> "SSMCache":
        """A batch-1 view of one slot; writes through it land in self."""
        sl = slice(slot, slot + 1)
        return SSMCache(self.conv[sl], self.state[sl])


def _decode_core(params: Dict[str, Any], cfg, conv_cache: torch.Tensor,
                 state: torch.Tensor, conv_in_t: torch.Tensor,
                 dtp_t: torch.Tensor, a: torch.Tensor,
                 active: Optional[torch.Tensor]):
    """One token of the decode recurrence, shared verbatim by decode and
    the verify replay so each window position equals its decode step bit
    for bit.  conv_cache [B, W-1, C] f32; state [B, H, N, P] f32;
    conv_in_t [B, 1, C] bf16; dtp_t [B, H] f32 (softplus'd dt); a [H].
    Returns (y [B, H, P] f32, new_conv, new_state), the updates masked by
    ``active`` (an inactive row's y is discarded by the caller)."""
    di, ns = cfg.d_inner, cfg.ssm_state
    h, p = cfg.ssm_heads, cfg.ssm_headdim
    window = torch.cat([conv_cache.to(conv_in_t.dtype), conv_in_t], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", window.to(torch.float32),
                            params["conv_w"].to(torch.float32)) \
        + params["conv_b"].to(torch.float32)
    conv_out = _silu(conv_out)[:, None, :].to(conv_in_t.dtype)
    new_conv = window[:, 1:].to(torch.float32)
    if active is not None:
        new_conv = torch.where(active[:, None, None], new_conv, conv_cache)
    xc, bc, cc = torch.split(conv_out, [di, ns, ns], dim=-1)
    xh = xc.reshape(-1, 1, h, p)
    # S' = exp(a dt) S + dt B x^T ; y = C.S' + D x
    la = torch.exp(a[None, :] * dtp_t)                           # [B, H]
    dtx = xh[:, 0].to(torch.float32) * dtp_t[:, :, None]
    s_new = la[:, :, None, None] * state \
        + torch.einsum("bn,bhp->bhnp", bc[:, 0].to(torch.float32), dtx)
    y = torch.einsum("bn,bhnp->bhp", cc[:, 0].to(torch.float32), s_new) \
        + params["D"][None, :, None] * xh[:, 0].to(torch.float32)
    if active is not None:
        s_new = torch.where(active[:, None, None, None], s_new, state)
    return y, new_conv, s_new


def _positionwise(verify_window: bool):
    """``layers.per_position`` in a verify window (so each window
    position computes as its decode step does), else a plain call."""
    if verify_window:
        return layers.per_position
    return lambda fn, *xs: fn(*xs)


def ssm_apply(params: Dict[str, Any], x: torch.Tensor, rt: layers.Runtime,
              cfg, name: str, *, cache: Optional[SSMCache] = None,
              seq_lengths: Optional[torch.Tensor] = None,
              active: Optional[torch.Tensor] = None,
              verify_window: bool = False):
    """Mamba2 block.  Paths: full sequence (``cache`` None); prefill into
    ``cache`` (S > 1; ``seq_lengths`` [B] marks right-padded rows: pad
    positions get dt = 0 and the conv window ends at each row's true
    length); one-token decode (S == 1, ``active`` [B] masking the cache
    update); and the speculative verify window (``verify_window``, S > 1):
    the projections run batched over the window while the decode core
    replays each position on [B, 1] slices, and the returned cache holds
    the per-step states stacked ([S, B, ...]), ``cache`` left as it was.
    Under ``rt.rec`` decode and the chunked scan record an ``ssm_core``
    span.  Returns (y, cache)."""
    b, s, _ = x.shape
    di, ns, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    pos = _positionwise(verify_window)
    zxbcdt = layers.linear(params["in_proj"], x, rt, f"{name}.in_proj")
    z, xin, bmat, cmat, dt = torch.split(zxbcdt, [di, di, ns, ns, h], dim=-1)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)          # [B, S, di+2ns]
    a = -torch.exp(params["A_log"])                         # [H], negative
    dtp = pos(lambda t: softplus(t.to(torch.float32)
                                 + params["dt_bias"][None, None, :]), dt)
    if seq_lengths is not None and s > 1:
        real = torch.arange(s, device=x.device)[None, :] \
            < seq_lengths.to(x.device)[:, None]
        dtp = torch.where(real[:, :, None], dtp, 0.0)

    new_cache = cache
    rec = rt.rec
    if cache is not None and s == 1:
        if rec is not None:
            span = rec.begin("ssm_core")
        y, new_conv, s_new = _decode_core(params, cfg, cache.conv,
                                          cache.state, conv_in, dtp[:, 0],
                                          a, active)
        if rec is not None:
            rec.end(span)
        y = y[:, None]                                      # [B, 1, H, P]
        cache.conv.copy_(new_conv)
        cache.state.copy_(s_new)
    elif cache is not None and verify_window:
        conv_c, state_c = cache.conv, cache.state
        ys, convs, states = [], [], []
        for j in range(s):
            y_t, conv_c, state_c = _decode_core(
                params, cfg, conv_c, state_c,
                conv_in[:, j:j + 1].contiguous(), dtp[:, j].contiguous(), a,
                active)
            ys.append(y_t)
            convs.append(conv_c)
            states.append(state_c)
        y = torch.stack(ys, dim=1)                          # [B, S, H, P]
        new_cache = SSMCache(torch.stack(convs), torch.stack(states))
    else:
        conv_out = _silu(_causal_conv(conv_in, params["conv_w"],
                                      params["conv_b"])).to(conv_in.dtype)
        xc, bc, cc = torch.split(conv_out, [di, ns, ns], dim=-1)
        xh = xc.reshape(b, s, h, p)
        if rec is not None:
            span = rec.begin("ssm_core")
        y = _ssd_chunked(xh, dtp, a, bc, cc, params["D"], cfg.ssm_chunk)
        if rec is not None:
            rec.end(span)
        if cache is not None:
            w = cfg.ssm_conv - 1
            if seq_lengths is not None:
                # The last w REAL inputs of each row, from a zero-left-padded
                # copy, so rows shorter than w keep a fresh cache's zeros.
                padded = torch.cat([conv_in.new_zeros((b, w,
                                                       conv_in.shape[-1])),
                                    conv_in], dim=1)
                idx = seq_lengths.to(torch.int64).to(x.device)[:, None] \
                    + torch.arange(w, device=x.device)[None, :]
                tail = padded[torch.arange(b, device=x.device)[:, None], idx]
            elif s >= w:
                tail = conv_in[:, -w:]
            else:
                tail = torch.cat([cache.conv[:, s:].to(conv_in.dtype),
                                  conv_in], dim=1)
            cache.conv.copy_(tail.to(torch.float32))
            cache.state.copy_(_final_state(xh, dtp, a, bc))

    y = y.reshape(b, s, di).to(x.dtype)
    gated = pos(lambda yy, zz: layers.rmsnorm(params["norm"], yy)
                * _silu(zz.to(torch.float32)).to(x.dtype), y, z)
    out = layers.linear(params["out_proj"], gated, rt, f"{name}.out_proj")
    return out, new_cache
