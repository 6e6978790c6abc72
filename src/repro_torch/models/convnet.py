"""MobileNetV2-style quantized conv net, the paper's own workload (port of
``repro.models.convnet``): pointwise (1x1) convs are matmuls over the
channels and route through ``layers.linear`` (the quantized backends);
depthwise convs stay higher-precision f32 conv ops, as in the reference,
whose ``lax.conv`` runs outside any Pallas kernel.

Activations are NHWC, as in the reference; the depthwise conv runs
``F.conv2d(groups=ch)`` on an NCHW view with TF's "SAME" padding (at
stride 2 the extra row and column go after, as XLA pads) and TF32 off.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class ConvNetConfig:
    num_classes: int = 10
    width: int = 16                    # stem channels
    # (expansion, out_channels, stride) per inverted-residual block
    blocks: Tuple[Tuple[int, int, int], ...] = (
        (1, 16, 1), (4, 24, 2), (4, 32, 2), (4, 64, 2))
    input_hw: int = 32
    dtype_str: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return torch.float32 if self.dtype_str == "float32" \
            else torch.bfloat16


def _dw_init(gen: torch.Generator, ch: int, dtype: torch.dtype,
             device: torch.device) -> Dict[str, torch.Tensor]:
    w = torch.randn((3, 3, ch), generator=gen, device=device,
                    dtype=torch.float32) * 0.5
    return {"w": w.to(dtype)}


def _pointwise(params: Dict[str, Any], x: torch.Tensor, rt: layers.Runtime,
               name: str) -> torch.Tensor:
    """1x1 conv == matmul over channels: the paper's MAC-array work."""
    b, h, w, c = x.shape
    y = layers.linear(params, x.reshape(b * h * w, c), rt, name)
    return y.reshape(b, h, w, -1)


def _same_pad(size: int, stride: int) -> Tuple[int, int]:
    """TF "SAME" padding of a 3-wide window: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + 3 - size, 0)
    return total // 2, total - total // 2


def _depthwise(params: Dict[str, torch.Tensor], x: torch.Tensor,
               stride: int) -> torch.Tensor:
    """3x3 depthwise conv in f32 over NHWC x; returns x's dtype."""
    ch = x.shape[-1]
    rhs = params["w"].to(torch.float32).permute(2, 0, 1)[:, None]
    top, bottom = _same_pad(x.shape[1], stride)
    left, right = _same_pad(x.shape[2], stride)
    xf = F.pad(x.to(torch.float32).permute(0, 3, 1, 2),
               (left, right, top, bottom))
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = F.conv2d(xf, rhs, stride=stride, groups=ch)
    return y.permute(0, 2, 3, 1).to(x.dtype)


class ConvNet:
    def __init__(self, cfg: ConvNetConfig):
        self.cfg = cfg

    def init(self, gen: torch.Generator, *, device=None) -> Dict[str, Any]:
        """Random weights from ``gen`` on ``device`` (default cuda), the
        reference's distributions (the draws differ; tests convert the
        reference's weights)."""
        cfg, dev = self.cfg, resolve_device(device)
        dt = cfg.dtype
        params: Dict[str, Any] = {"stem": _dw_init(gen, 3, dt, dev) | {
            "proj": layers.dense_init(gen, 3, cfg.width, dt, dev)}}
        cin = cfg.width
        blocks = []
        for t, cout, _ in cfg.blocks:
            hidden = cin * t
            blocks.append({
                "expand": layers.dense_init(gen, cin, hidden, dt, dev),
                "dw": _dw_init(gen, hidden, dt, dev),
                "project": layers.dense_init(gen, hidden, cout, dt, dev),
            })
            cin = cout
        params["blocks"] = blocks
        params["head"] = layers.dense_init(gen, cin, cfg.num_classes, dt, dev)
        return params

    def apply(self, params: Dict[str, Any], x: torch.Tensor,
              rt: layers.Runtime) -> torch.Tensor:
        """x: [B, H, W, 3] -> logits [B, num_classes]."""
        cfg = self.cfg
        h = _depthwise(params["stem"], x, 1)
        h = F.relu6(_pointwise(params["stem"]["proj"], h, rt, "stem"))
        for i, ((_, _, s), blk) in enumerate(zip(cfg.blocks,
                                                 params["blocks"])):
            inp = h
            h = F.relu6(_pointwise(blk["expand"], h, rt,
                                   f"blocks.{i}.expand"))
            h = F.relu6(_depthwise(blk["dw"], h, s))
            h = _pointwise(blk["project"], h, rt, f"blocks.{i}.project")
            if s == 1 and inp.shape == h.shape:
                h = h + inp
        pooled = torch.mean(h, dim=(1, 2))
        return layers.linear(params["head"], pooled, rt, "head")
