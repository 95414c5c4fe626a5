"""Int8 serving quantization of the head conv (port of the JAX package's
``experimental/int8_head.py``).

The flagship's 3x3 480->480 head conv at 64x64 holds most of the forward's
FLOPs.  On the H100 int8 tensor cores run at twice the bf16 rate, so
serving that one conv in int8 is the one number-format lever on it.  The
scheme is the JAX one, serving-time only (no quantization-aware training):

* weights: symmetric per-output-channel int8, scale from the max-abs;
* activations: symmetric int8 with a dynamic per-SAMPLE scale, so a
  frame's output does not depend on the batch it rode in;
* int32 accumulation, dequantized by ``s_x * s_w[o]``; the caller applies
  the frozen-BN affine in f32.

Rounding is ``torch.round`` (half to even, as ``jnp.round``).
:func:`int8_conv` computes the SAME conv as one im2col product through
``torch._int_mm`` (int8 x int8 -> int32; cuBLASLt on the card), with the
weight column-major, the layout in which cuBLASLt's int8 product is
fastest: the JAX version leaves this conv to XLA, outside any Pallas
kernel.  The im2col copy is 9x the int8 activations (4.5 GB for the head
at batch 256).
``models/layers.ConvBN`` dispatches here for a ConvBN built with
``int8_serving=True`` when ``layers.INT8_SERVING`` is set and the module is
not training.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def quantize_weights_per_channel(w: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """HWIO weights -> (int8 weights, f32 per-output-channel scale)."""
    w = w.to(torch.float32)
    amax = w.abs().amax(dim=(0, 1, 2))                        # (O,)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_q, scale


def quantize_activations(x: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """NHWC activations -> (int8, f32 per-sample scale (N, 1, 1, 1))."""
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=(1, 2, 3), keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    x_q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return x_q, scale


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int, int]:
    """XLA's 'SAME' padding: (out, pad_lo, pad_hi)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return out, total // 2, total - total // 2


def _mm_i32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exactly.  On the card
    ``_int_mm`` wants M > 16 and K, N multiples of 8: zero rows and
    columns are padded in (they add nothing) and cut off again; b goes
    in column-major.  The CPU takes the same path."""
    m, k = a.shape
    n = b.shape[1]
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    return torch._int_mm(a.contiguous(), b.t().contiguous().t())[:m, :n]


def int8_conv_acc(x_q: torch.Tensor, w_q: torch.Tensor, stride: int = 1
                  ) -> torch.Tensor:
    """SAME conv of int8 NHWC activations with int8 HWIO weights ->
    the int32 accumulator (N, OH, OW, O), as one im2col product."""
    n, h, w, cin = x_q.shape
    kh, kw, _, cout = w_q.shape
    oh, ph0, ph1 = _same_pads(h, kh, stride)
    ow, pw0, pw1 = _same_pads(w, kw, stride)
    xp = F.pad(x_q, (0, 0, pw0, pw1, ph0, ph1))
    # taps in HWIO order (dy, dx, then cin), as the weight flattens
    cols = torch.cat([xp[:, dy:dy + (oh - 1) * stride + 1:stride,
                         dx:dx + (ow - 1) * stride + 1:stride, :]
                      for dy in range(kh) for dx in range(kw)], dim=-1)
    acc = _mm_i32(cols.reshape(-1, kh * kw * cin),
                  w_q.reshape(kh * kw * cin, cout))
    return acc.reshape(n, oh, ow, cout)


def int8_conv(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor,
              stride: int = 1) -> torch.Tensor:
    """Quantized SAME conv: f32 NHWC in, f32 NHWC out (dequantized)."""
    x_q, s_x = quantize_activations(x)
    acc = int8_conv_acc(x_q, w_q, stride)
    return acc.to(torch.float32) * (s_x * s_w)


def conv_f32(x: torch.Tensor, w: torch.Tensor, stride: int = 1
             ) -> torch.Tensor:
    """The exact reference: SAME f32 conv of NHWC x with HWIO w."""
    n, h, wd, _ = x.shape
    kh, kw = w.shape[:2]
    _, ph0, ph1 = _same_pads(h, kh, stride)
    _, pw0, pw1 = _same_pads(wd, kw, stride)
    xp = F.pad(x.to(torch.float32).permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1))
    y = F.conv2d(xp, w.to(torch.float32).permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def head_error_stats(generator: torch.Generator, w: torch.Tensor,
                     batch: int = 4, hw: int = 64) -> dict:
    """Relative error of the int8 path against exact f32 on a random
    batch drawn from ``generator`` on ``w``'s device."""
    cin = w.shape[2]
    x = torch.randn((batch, hw, hw, cin), generator=generator,
                    device=w.device)
    w_q, s_w = quantize_weights_per_channel(w)
    ref = conv_f32(x, w)
    out = int8_conv(x, w_q, s_w)
    err = (out - ref).abs()
    denom = torch.clamp(ref.abs(), min=1e-6)
    return {
        'rel_err_mean': float((err / denom).mean()),
        'abs_err_p99': float(np.quantile(err.cpu().numpy(), 0.99)),
        'ref_abs_p99': float(np.quantile(ref.abs().cpu().numpy(), 0.99)),
    }
