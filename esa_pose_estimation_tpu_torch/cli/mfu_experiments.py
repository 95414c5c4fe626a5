"""Utilization experiments on one NVIDIA H100.

    python -m esa_pose_estimation_tpu_torch.cli.mfu_experiments [--chain |
        --int8 | --int8-matmul | --cluster-sweep | --repeat | --k2-case |
        --determinism | --sharded | (--ddp | --model-axis) [--coordinator
        host:port --num-processes N --process-id i]]

Port of the JAX package's ``scripts/mfu_experiments.py``.  Every mode times
on the card with CUDA events and reports its share of the card's bf16
dense tensor-core peak (989 TFLOP/s, H100 SXM) beside each time; it needs a
CUDA device.  Modes:

* default: the ``hrnet_esa`` forward (bf16) at batch 128, 256 and 512, and
  a lane-padded variant (every stage width rounded up to 128) at 256.
  Weights are random, drawn from a seeded generator; FLOPs are the
  convolutions' multiply-adds, counted from the shapes.
* ``--chain``: the branch chain of k = 4 residual blocks at 64x64x32
  (the HRNet branch-1 shape), batch 256 and 512: the hand-written kernel
  (``experimental/branch_chain.py``), its plain version, and the library
  chain of 8 cuDNN bf16 channels_last convolutions.
* ``--int8``: the head conv (3x3, 480 -> 480 at 64x64, batch 256) in bf16
  against the int8 path of ``experimental/int8_head.py``, with and without
  the activation quantization.
* ``--int8-matmul``: bf16 against int8 products at the head conv's
  contraction (the int8 one with its second operand row- and
  column-major), and the head conv's int32 accumulator as the int8 path
  computes it.
* ``--cluster-sweep``: the two cluster kernels at batch 64 and 256 with
  each cluster size R (CTAs per image) that fits: the fused CBAM kernel
  (``experimental/cbam_fuse.py``) at hrnet_esa's five site shapes, then
  the peak-decode kernel (``ops/kernels/peak_decode.py``) on
  (B, 128, 128, 30) Gaussian maps.  It is the measurement behind the CBAM
  kernel's table of R per site (``kSiteRanks``) and peak decode's default
  R, and exists to re-derive them on another card; serving never passes
  an R.  Its share of the bf16 peak is not reported (both kernels are
  bound by bytes); the rows carry the cluster's shared memory or threads
  and how many such clusters the card holds at once.  It times the device
  by CUDA-graph replay (``utils/timing.graph_ms``), so the host's cost per
  call does not count.
* ``--repeat``: determinism of the two cluster kernels.  The fused CBAM
  kernel at the five sites and the peak-decode kernel on Gaussian maps,
  at every batch serving gives them (1, 64, 256; 1, 32, 64, 256), each
  launched many times on one input: the count of launches whose output
  is not bit-equal to the first.  Nothing is timed.
* ``--determinism``: the training steps' determinism (ROADMAP.md
  section 3, fault 4).  One step each of ``hrnet_esa`` from r5 at batch
  32, the ``TinyDetector`` at the JAX round-5 recipe and ResNet-8s in both
  LINEMOD modes (:func:`training_cases`) under
  ``torch.use_deterministic_algorithms(True, warn_only=True)``, with
  ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set in this process only: the ops
  with no deterministic CUDA kernel, by the warnings on standard error
  (the backward's threads print them there), once with the
  half-pixel resize's backward as ``F.interpolate``'s and once with the
  port's (``models/layers._HalfPixelResize``).  Then, with the flag off,
  two eager runs of 4 steps of each case from one start on one set of
  draws, with cuDNN's free choice of algorithms and with its
  deterministic ones (the training path's,
  ``train/state.deterministic_cudnn``), both backwards: whether losses,
  parameters and statistics are bit-equal.
* ``--ddp``: the training programs of ``cli.train`` under
  ``DistributedDataParallel``, one process per card, started as the
  README's loop of ``cli.train`` processes is (``--coordinator host:port
  --num-processes N --process-id i``; without them one process trains
  alone, with no wrapper: the one-card reference).  Rank 0 writes a
  synthetic SPD1 shard of 512 1920x1200 frames under ``--workdir``.  At
  32 and 64 images a card, ``hrnet_esa`` from r5 (f32 masters, bf16
  compute) runs the synthetic scan (``make_scan_step``, 4 steps a graph)
  and the shard route's step on host crops (``make_train_steps(st,
  data/pipeline.step_loss)``), each replayed on one state and launched one
  by one (``StepGraph.run_eagerly``) on another from the same start and
  draws: losses, parameters, statistics and Adam's state must be
  ``torch.equal`` on every rank, and every rank's states bit-equal to rank
  0's; the scan captures a second graph, of 2 steps, after the first has
  replayed, held to its twin the same way; ms per step and images/s
  (all cards') both ways in turns; capture seconds, pool, peak memory;
  the collective calls in a capture and the device kernels of one
  replay, NCCL's among them (more than 0 of each under several
  processes); under several processes, each all-reduce size of a step,
  eager against captured.  Then, under several processes, ``cli.train``
  for 2 epochs on the synthetic route and on ``--train-shard
  --host-crop``: no eager step on the card, K1 in every rank's eval, the
  same finite epoch losses in every rank's log.  ``--device cpu --tiny``
  rehearses it under gloo.
* ``--model-axis``: the mesh's ``model`` axis in the group of the
  README's loop of processes (like ``--ddp``).  Rank 0 writes the
  ``--ddp`` shard.  On each mesh of (N, 1), (N / 2, 2) and (1, N), the
  scan and the shard route's step of ``hrnet_esa`` from r5 at 32 images
  a data slice, placed by ``parallel/mesh.shard_state`` and wrapped over
  the data group, replayed against ``StepGraph.run_eagerly`` as in
  ``--ddp`` (every rank ``torch.equal``; whole tensors bit-equal on
  every rank, split slices within each data group); ms a step, images/s,
  NCCL kernels a replay, capture seconds, peak memory of every rank.
  Then three eager f32 steps of each mesh with a model axis against its
  unsplit reference on the same global batches ((N / 2, 1) on the first
  ranks, one card for (1, N)) at the tolerances of :func:`step_differences`,
  and the gathered model serving phase 10's 128 held-out frames through
  ``make_jitted_pipeline`` (SPEED median <= 0.01).  ``--device cpu
  --tiny`` rehearses it under gloo.
* ``--sharded``: serving over the ``data`` axis of every visible card of
  one process (``pipeline.make_sharded_pipeline``).  First K1, K2 and K3
  on each card with card 0 left current, each card's output bit-equal to
  card 0's.  Then ``hrnet_esa`` from r5 in bf16 at 64 and at 1 frame a
  card, K2 off and on: each card's shard ``torch.equal`` to
  ``make_jitted_pipeline`` on that card with that slice and those
  uniforms, and whether it is bit-equal served on card 0 too; how far
  the gathered poses lie from one unsharded call on card 0 (reported:
  its network runs at the whole batch, a shard's at a slice); K1 (and
  K2) once per shard by the counters and by the profiler's kernels on
  each card.  Phase 10's 128 held-out frames served sharded
  (SPEED median <= 0.01); the host-to-device ms of 64 frames a card from
  pageable and from pinned memory; replay ms per call and images/s on 1,
  2 and all cards in turns (the batch starts on card 0, so a call
  includes its copies to the other cards).
* ``--k2-case``: two launches of the fused CBAM kernel on one input at
  batch 64, 64x64x32 with residual (R = 5 CTAs per image), the case in
  which two launches once differed (ROADMAP.md section 3, fault 2), and
  whether they are bit-equal.  It is small enough to run under
  ``compute-sanitizer --tool racecheck`` or ``--tool synccheck``.

Each mode prints one JSON line per measurement and a last line with all.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from esa_pose_estimation_tpu_torch.utils.timing import (
    BF16_TC_FLOPS,
    cuda_ms,
    graph_ms,
    paired_ms,
)

N_ITERS = 10
SEED = 0


def _require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit('mfu_experiments measures the card: no CUDA device')
    return torch.device('cuda')


def _rate(flops: float, ms: float) -> dict:
    return {'ms': ms, 'tflops': flops / (ms * 1e-3) / 1e12,
            'mfu_vs_bf16_peak': flops / (ms * 1e-3) / BF16_TC_FLOPS}


def init_random(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """He-normal conv weights drawn from ``generator`` (on the CPU); the
    BatchNorms keep their unit defaults."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                w = torch.randn(mod.weight.shape, generator=generator)
                mod.weight.copy_(w * math.sqrt(2.0 / fan_in))
                if mod.bias is not None:
                    mod.bias.zero_()
    return model


def conv_flops(model: nn.Module, x: torch.Tensor) -> float:
    """2 x the multiply-adds of every convolution of one forward of x."""
    total = 0.0

    def hook(mod, inp, out):
        nonlocal total
        total += 2.0 * out.numel() * mod.weight[0].numel()

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, nn.Conv2d)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return total


def _hrnet(cfg, dev) -> nn.Module:
    from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
    gen = torch.Generator().manual_seed(SEED)
    model = init_random(HRNet(cfg, dtype=torch.bfloat16), gen)
    return model.to(device=dev, memory_format=torch.channels_last).eval()


def time_forward(model: nn.Module, batch: int) -> dict:
    """ms per bf16 forward of a zero (batch, 128, 128, 1) input."""
    dev = next(model.parameters()).device
    x = torch.zeros((batch, 128, 128, 1), device=dev)
    flops = conv_flops(model, x[:1]) * batch

    def fwd(a):
        with torch.no_grad():
            return model(a)

    ms = cuda_ms(fwd, [(x,)], iters=N_ITERS)
    return {'ms_per_batch': ms, 'img_per_s': batch / (ms * 1e-3),
            'gflop_per_img': flops / batch / 1e9,
            'mfu': flops / (ms * 1e-3) / BF16_TC_FLOPS}


def library_chain(x: torch.Tensor, weights: torch.Tensor,
                  biases: torch.Tensor) -> torch.Tensor:
    """The chain as 2k cuDNN convolutions on channels_last NCHW x, OIHW
    weights and biases in x's dtype (the conv rounds before the bias)."""
    for i in range(weights.shape[0]):
        h = torch.relu(F.conv2d(x, weights[i, 0], biases[i, 0], padding=1))
        x = torch.relu(F.conv2d(h, weights[i, 1], biases[i, 1], padding=1)
                       + x)
    return x


def chain_experiment(batches=(256, 512), k: int = 4) -> dict:
    """The branch chain at 64x64x32: kernel, plain and library ms per call
    for each batch, with their shares of the bf16 peak, and the kernel's and
    the library's max abs difference from the plain version on the timed
    input (one more kernel launch per batch)."""
    from esa_pose_estimation_tpu_torch.experimental import branch_chain as bc
    dev = _require_cuda()
    c, hw = 32, 64
    gen = torch.Generator(device=dev).manual_seed(SEED)
    weights, biases = bc.make_test_chain(gen, k=k, c=c, device=dev)
    # the library chain's operands: OIHW, in bf16
    w_lib = weights.permute(0, 1, 5, 4, 2, 3).to(torch.bfloat16).contiguous()
    b_lib = biases.to(torch.bfloat16)
    flops_per_img = 2 * k * (hw * hw * 9 * c * c * 2)
    results = {}
    for batch in batches:
        x = (0.5 * torch.randn((batch, hw, hw, c), generator=gen,
                               device=dev)).to(torch.bfloat16)
        x_lib = x.permute(0, 3, 1, 2)            # channels_last NCHW view
        k_ms, p_ms = paired_ms(bc.branch_chain, bc.branch_chain_plain,
                               [(x, weights, biases)])
        l_ms = cuda_ms(library_chain, [(x_lib, w_lib, b_lib)])
        want = bc.branch_chain_plain(x, weights, biases).float()
        k_diff = float((bc.branch_chain(x, weights, biases).float()
                        - want).abs().max())
        lib_diff = float((library_chain(x_lib, w_lib, b_lib)
                          .permute(0, 2, 3, 1).float() - want).abs().max())
        total = flops_per_img * batch
        row = {'shape': list(x.shape), 'k': k,
               'kernel': _rate(total, k_ms), 'plain': _rate(total, p_ms),
               'library': _rate(total, l_ms),
               'kernel_max_abs_diff': k_diff,
               'library_max_abs_diff': lib_diff}
        results[f'chain_b{batch}'] = row
        print(json.dumps({f'chain_b{batch}': row}), flush=True)
    return results


def int8_experiment(batch: int = 256, hw: int = 64, c: int = 480) -> dict:
    """The head conv in bf16 (cuDNN) against the int8 path, with the
    activation quantization and without it."""
    from esa_pose_estimation_tpu_torch.experimental import int8_head as q
    dev = _require_cuda()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    w = 0.05 * torch.randn((3, 3, c, c), generator=gen, device=dev)
    x = torch.randn((batch, hw, hw, c), generator=gen, device=dev)
    w_q, s_w = q.quantize_weights_per_channel(w)
    x_bf = x.to(torch.bfloat16).permute(0, 3, 1, 2)   # channels_last NCHW
    w_bf = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()
    x_q8, _ = q.quantize_activations(x)
    flops = 2 * batch * hw * hw * 9 * c * c
    out = {}
    for name, fn, args in (
            ('bf16', lambda a, b: F.conv2d(a, b, padding=1), (x_bf, w_bf)),
            ('int8_with_quant', lambda a: q.int8_conv(a, w_q, s_w), (x,)),
            ('int8_raw', q.int8_conv_acc, (x_q8, w_q))):
        ms = min(cuda_ms(fn, [args]) for _ in range(3))
        out[name] = _rate(flops, ms)
        print(json.dumps({name: out[name]}), flush=True)
    return out


def int8_matmul_experiment() -> dict:
    """bf16 against int8 products at the head conv's contraction (K = N =
    480), and the head conv in int8 as one im2col product."""
    from esa_pose_estimation_tpu_torch.experimental import int8_head as q
    dev = _require_cuda()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    m, k, n = 65536, 480, 480
    a = torch.randn((m, k), generator=gen, device=dev)
    b = 0.05 * torch.randn((k, n), generator=gen, device=dev)
    a8 = torch.clamp(torch.round(a * 20), -127, 127).to(torch.int8)
    b8 = torch.clamp(torch.round(b * 500), -127, 127).to(torch.int8)
    flops = 2 * m * k * n
    out = {}
    for name, fn, args in (
            ('mm_bf16', torch.matmul,
             (a.to(torch.bfloat16), b.to(torch.bfloat16))),
            ('mm_s8', torch._int_mm, (a8, b8)),
            # the same product with the second operand column-major
            ('mm_s8_b_colmajor', torch._int_mm, (a8, b8.t().contiguous().t()))):
        ms = min(cuda_ms(fn, [args]) for _ in range(3))
        out[name] = _rate(flops, ms)
        print(json.dumps({name: out[name]}), flush=True)
    batch, hw, c = 256, 64, 480
    x8 = torch.randint(-127, 128, (batch, hw, hw, c), generator=gen,
                       device=dev, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (3, 3, c, c), generator=gen, device=dev,
                       dtype=torch.int8)
    ms = min(cuda_ms(q.int8_conv_acc, [(x8, w8)]) for _ in range(3))
    out['conv3x3_s8_im2col'] = _rate(2 * batch * hw * hw * 9 * c * c,
                                           ms)
    print(json.dumps({'conv3x3_s8_im2col':
                      out['conv3x3_s8_im2col']}), flush=True)
    return out


# hrnet_esa's CBAM sites: (H, W, C, residual)
CBAM_SITES = ((64, 64, 32, True), (32, 32, 64, True), (16, 16, 128, True),
              (8, 8, 256, True), (128, 128, 64, False))


def cluster_sweep(batches=(64, 256), s: int = 128, k: int = 30) -> dict:
    """K2 at each site and K1 on Gaussian (B, s, s, k) maps, at each batch,
    with every cluster size that fits."""
    from esa_pose_estimation_tpu_torch.experimental import cbam_fuse
    from esa_pose_estimation_tpu_torch.ops.kernels import peak_decode as pd
    dev = _require_cuda()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    def row(key: str, shape: dict, r: int, chosen: int, fn, bufs, cfg):
        results[key] = {**shape, 'ranks': r, 'ms': graph_ms(fn, bufs),
                        'chosen': r == chosen, **cfg}
        print(json.dumps(results[key]), flush=True)

    for b in batches:
        for h, w, c, with_res in CBAM_SITES:
            hid = c // 16
            x = torch.randn((b, h, w, c), generator=gen, device=dev
                            ).to(torch.bfloat16)
            res = (torch.randn((b, h, w, c), generator=gen, device=dev
                               ).to(torch.bfloat16) if with_res else None)
            fc1 = 0.3 * torch.randn((c, hid), generator=gen, device=dev)
            fc2 = 0.3 * torch.randn((hid, c), generator=gen, device=dev)
            spw = 0.2 * torch.randn((7, 7, 2), generator=gen, device=dev)
            chosen = cbam_fuse.cluster_config(b, h, w, c, hid)['ranks']
            # enough input copies to cycle through more than the 50 MB L2
            per_call = x.numel() * 2 * (3 if with_res else 2)
            bufs = [tuple(a.clone() if a is not None else None
                          for a in (x, fc1, fc2, spw, res))
                    for _ in range(max(1, math.ceil(160e6 / per_call)))]
            for r in (1, 2, 3, 4, 5, 6, 8, 16):
                if r > h:
                    break
                try:
                    cfg = cbam_fuse.cluster_config(b, h, w, c, hid, ranks=r)
                except RuntimeError as exc:     # does not fit: not a launch
                    print(json.dumps({'site': [b, h, w, c], 'ranks': r,
                                      'skipped': str(exc)}), flush=True)
                    continue
                row(f'cbam_b{b}_{h}x{w}x{c}_r{r}', {'site': [b, h, w, c]}, r,
                    chosen, lambda *a, r=r: cbam_fuse._launch(*a, ranks=r),
                    bufs, cfg)
            del x, res, bufs
    ax = torch.arange(s, dtype=torch.float32, device=dev)
    for b in batches:
        kp = torch.rand((b, k, 2), generator=gen, device=dev) * (s - 4) + 2
        d2 = ((ax[None, None, :, None] - kp[..., 1, None, None]) ** 2
              + (ax[None, None, None, :] - kp[..., 0, None, None]) ** 2)
        hm = torch.exp(-d2 / 8.0).permute(0, 2, 3, 1).contiguous()
        bufs = [(hm.clone(),) for _ in range(
            max(1, math.ceil(160e6 / (hm.numel() * 4))))]
        chosen = pd.cluster_config(b, s, s, k)['ranks']
        for r in (1, 2, 4, 8, 16):
            row(f'peak_b{b}_r{r}', {'maps': [b, s, s, k]}, r, chosen,
                lambda a, r=r: pd._launch(a, ranks=r), bufs,
                pd.cluster_config(b, s, s, k, ranks=r))
        del hm, bufs
    return results


def repeat_experiment(cbam_batches=(1, 64, 256),
                      peak_batches=(1, 32, 64, 256)) -> dict:
    """Launches of K2 and K1 on one input that differ from the first:
    60 launches at batch 1 and 64, 20 at 256."""
    from esa_pose_estimation_tpu_torch.experimental import cbam_fuse
    from esa_pose_estimation_tpu_torch.ops.kernels import peak_decode as pd
    dev = _require_cuda()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    def count(key: str, fn, args: tuple, n: int):
        first = fn(*args)
        differ = 0
        for _ in range(n):
            out = fn(*args)
            torch.cuda.synchronize()
            differ += not all(torch.equal(a, b) for a, b in zip(
                out if isinstance(out, tuple) else (out,),
                first if isinstance(first, tuple) else (first,)))
        results[key] = {'launches': n, 'differ': differ}
        print(json.dumps({key: results[key]}), flush=True)

    for b in cbam_batches:
        for h, w, c, _ in CBAM_SITES:
            hid = c // 16
            x, res = (torch.randn((b, h, w, c), generator=gen, device=dev
                                  ).to(torch.bfloat16) for _ in range(2))
            weights = (0.3 * torch.randn((c, hid), generator=gen, device=dev),
                       0.3 * torch.randn((hid, c), generator=gen, device=dev),
                       0.2 * torch.randn((7, 7, 2), generator=gen,
                                         device=dev))
            for r in (res, None):
                count(f'cbam_b{b}_{h}x{w}x{c}_res{int(r is not None)}',
                      cbam_fuse._launch, (x, *weights, r), 20 if b >= 256
                      else 60)
    for b in peak_batches:
        hm = torch.rand((b, 128, 128, 30), generator=gen, device=dev)
        count(f'peak_b{b}', pd._launch, (hm,), 20 if b >= 256 else 60)
    return results


def k2_case() -> dict:
    """Two K2 launches at batch 64, 64x64x32 with residual."""
    from esa_pose_estimation_tpu_torch.experimental import cbam_fuse
    dev = _require_cuda()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, h, w, c = 64, 64, 64, 32
    x, res = (torch.randn((b, h, w, c), generator=gen, device=dev
                          ).to(torch.bfloat16) for _ in range(2))
    fc1 = 0.3 * torch.randn((c, c // 16), generator=gen, device=dev)
    fc2 = 0.3 * torch.randn((c // 16, c), generator=gen, device=dev)
    spw = 0.2 * torch.randn((7, 7, 2), generator=gen, device=dev)
    outs = [cbam_fuse._launch(x, fc1, fc2, spw, res) for _ in range(2)]
    torch.cuda.synchronize()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    result = {'k2_case': {
        'shape': [b, h, w, c], 'residual': True,
        'ranks': cbam_fuse.cluster_ranks(h, w, c, b, n_sm),
        'bit_equal': torch.equal(outs[0], outs[1])}}
    print(json.dumps(result), flush=True)
    return result


def flagship_experiment() -> dict:
    """The hrnet_esa batch sweep and the lane-padded variant at 256."""
    from esa_pose_estimation_tpu_torch.utils import config as cfg_mod
    dev = _require_cuda()
    results = {}
    flagship = _hrnet(cfg_mod.hrnet_esa(), dev)
    for b in (128, 256, 512):
        results[f'flagship_b{b}'] = time_forward(flagship, b)
        print(json.dumps({f'flagship_b{b}': results[f'flagship_b{b}']}),
              flush=True)
    del flagship
    base = cfg_mod.hrnet_esa()
    pad = dataclasses.replace(
        base, stem_channels=128,
        stage1=dataclasses.replace(base.stage1, num_channels=(128,)),
        stage2=dataclasses.replace(base.stage2, num_channels=(128, 128)),
        stage3=dataclasses.replace(base.stage3,
                                   num_channels=(128, 128, 128)),
        stage4=dataclasses.replace(base.stage4,
                                   num_channels=(128, 128, 128, 256)))
    results['lane_padded_b256'] = time_forward(_hrnet(pad, dev), 256)
    print(json.dumps({'lane_padded_b256': results['lane_padded_b256']}),
          flush=True)
    return results


R5_ARTIFACT = (Path(__file__).resolve().parents[2] / 'artifacts'
               / 'esa_syn_r5.npz')


class TrainCase(NamedTuple):
    """One training program at its command's width: ``make_state()`` a
    fresh state from one start, ``inputs`` one tree of draws and data per
    step, ``loss_fn(model, inputs[j])`` the step's batch, forward and loss
    (``train/state.make_train_steps``)."""
    name: str
    make_state: Callable
    inputs: list
    loss_fn: Callable


def r5_masters(dev, dtype=torch.bfloat16) -> nn.Module:
    """The r5 weights as a training model holds them: f32 parameters of
    the bf16 hrnet_esa (or of one that computes in ``dtype``),
    channels_last."""
    from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
    from esa_pose_estimation_tpu_torch.utils import config as cfg_mod
    from esa_pose_estimation_tpu_torch.utils.artifact import (
        from_jax_variables,
        read_artifact,
    )
    variables, _ = read_artifact(str(R5_ARTIFACT))
    model = HRNet(cfg_mod.hrnet_esa(), dtype=dtype)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model.to(dev, memory_format=torch.channels_last)


def training_cases(dev, n_steps: int, hrnet_batches=(32,),
                   detector: bool = True, linemod=('heatmap', 'pvnet'),
                   seed: int = SEED) -> list[TrainCase]:
    """The port's training programs on the card, with their draws made
    from ``seed``: ``hrnet_esa`` from r5 at each of ``hrnet_batches``
    (synthetic batches, 12c's rate), the ``TinyDetector`` at the JAX
    round-5 recipe (width 32, stride 16, downscale 8, batch 16 of
    1920x1200 frames, perturbed), ResNet-8s in each ``linemod`` mode at
    the command's width (batch 16, 128 px, 9 keypoints, rendered)."""
    from esa_pose_estimation_tpu_torch.cli import train_detector as tdet
    from esa_pose_estimation_tpu_torch.cli import train_linemod as tlm
    from esa_pose_estimation_tpu_torch.data import linemod as lm_data
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.models.detector import TinyDetector
    from esa_pose_estimation_tpu_torch.train import state as tstate
    from esa_pose_estimation_tpu_torch.utils import config as cfg_mod
    from esa_pose_estimation_tpu_torch.utils.seeding import generator

    def gen(*tag):
        return generator(dev, seed, *tag)
    cases = []
    pts = synthetic.spacecraft_points(device=dev)
    cfg = cfg_mod.TrainConfig(lr_boundaries=(0, 100, 170))
    for b in hrnet_batches:
        g = gen(1, b)
        cases.append(TrainCase(
            f'hrnet_esa_b{b}',
            lambda: tstate.create_train_state(r5_masters(dev), cfg, 1000),
            [synthetic.draw_batch(g, b, device=dev) for _ in range(n_steps)],
            lambda m, d, b=b: tstate.heatmap_step_loss(
                m, synthetic.make_batch(None, b, pts, draws=d))))
    if detector:
        def det_state():
            model = TinyDetector(width=32, stride=16).to(
                device=dev, memory_format=torch.channels_last)
            model.init_weights(gen(2))
            return tdet.create_detector_state(model, 1e-3, 800)
        inputs = []
        for i in range(n_steps):
            frames, boxes = tdet.make_frame_batch(gen(3, i), 16, pts, 1200,
                                                  1920)
            inputs.append(tdet.step_inputs(frames, boxes, gen(4, i)))
        cases.append(TrainCase(
            'detector', det_state, inputs,
            lambda m, x: tdet.step_loss(m, x, 16, 8)))
    if linemod:
        verts, faces = tlm.make_icosphere()
        db = lm_data.LineModModelDB()
        db.register('cat', vertices=verts)
        kp3d = torch.as_tensor(db.get_farthest_3d('cat', 9),
                               dtype=torch.float32, device=dev)
        vt, ft = torch.as_tensor(verts, device=dev), torch.as_tensor(
            faces, device=dev)
        draws = [tlm.draw_synthetic_poses(gen(5, j), 16, dev)
                 for j in range(n_steps)]
    for mode in linemod:
        def lm_state(mode=mode):
            model = tlm.build_model(mode, 9).to(
                device=dev, memory_format=torch.channels_last)
            model.init_weights(gen(6))
            return tlm.create_state(model, 1e-3, 100)
        cases.append(TrainCase(
            f'resnet8s_{mode}', lm_state, draws,
            lambda m, d, mode=mode: tlm.synthetic_step_loss(
                m, d, mode, vt, ft, kp3d, 128)))
    return cases


def trained_equal(a, b) -> bool:
    """Whether two trained states hold bit-equal parameters, statistics
    and optimizer state."""
    from esa_pose_estimation_tpu_torch.train.state import state_tensors
    x, y = state_tensors(a), state_tensors(b)
    return len(x) == len(y) and all(torch.equal(u, v) for u, v in zip(x, y))


@contextlib.contextmanager
def _interpolate_backward():
    """The half-pixel resize with ``F.interpolate``'s own backward, as
    the port had it before its deterministic backward."""
    from esa_pose_estimation_tpu_torch.models import layers
    real = layers._HalfPixelResize

    class Plain:
        @staticmethod
        def apply(x, oh, ow):
            return F.interpolate(x, size=(oh, ow), mode='bilinear',
                                 align_corners=False)
    layers._HalfPixelResize = Plain
    try:
        yield
    finally:
        layers._HalfPixelResize = real


@contextlib.contextmanager
def _free_cudnn():
    """Training steps with cuDNN's free choice of algorithms, as the port
    trained before ``train/state.deterministic_cudnn``."""
    from esa_pose_estimation_tpu_torch.train import state as tstate
    real = tstate.deterministic_cudnn
    tstate.deterministic_cudnn = contextlib.nullcontext
    try:
        yield
    finally:
        tstate.deterministic_cudnn = real


@contextlib.contextmanager
def _stderr_lines():
    """The lines written to this process's standard error meanwhile, C++
    warnings of the backward's threads included."""
    import tempfile
    lines: list[str] = []
    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile(mode='w+') as tmp:
        os.dup2(tmp.fileno(), 2)
        try:
            yield lines
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
            tmp.seek(0)
            lines += tmp.read().splitlines()


def determinism_experiment(n_steps: int = 4) -> dict:
    """The ``--determinism`` mode (module docstring)."""
    from esa_pose_estimation_tpu_torch.train import state as tstate
    os.environ['CUBLAS_WORKSPACE_CONFIG'] = ':4096:8'
    dev = _require_cuda()
    cases = training_cases(dev, n_steps)
    results: dict = {}
    backwards = (('interpolate', _interpolate_backward),
                 ('port', contextlib.nullcontext))
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.set_warn_always(True)
    try:
        for bname, ctx in backwards:
            for case in cases:
                with ctx(), _stderr_lines() as lines:
                    tstate.run_steps(case.make_state(), case.loss_fn,
                                     case.inputs[:1])
                    torch.cuda.synchronize()
                ops = sorted({ln.split(' does not have')[0].split()[-1]
                              for ln in lines
                              if 'does not have a deterministic' in ln})
                results[f'ops_{case.name}_{bname}'] = ops
                print(json.dumps({f'ops_{case.name}_{bname}': ops}),
                      flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.set_warn_always(False)
    for cudnn_det in (False, True):
        for bname, ctx in backwards:
            for case in cases:
                with ctx(), (contextlib.nullcontext() if cudnn_det
                             else _free_cudnn()):
                    a, b = case.make_state(), case.make_state()
                    la = tstate.run_steps(a, case.loss_fn, case.inputs)
                    lb = tstate.run_steps(b, case.loss_fn, case.inputs)
                    torch.cuda.synchronize()
                row = {'losses_equal': torch.equal(la, lb),
                       'state_equal': trained_equal(a, b),
                       'first_loss_equal': bool(la[0] == lb[0]),
                       'steps': n_steps}
                key = f'pair_{case.name}_{bname}_cudnn_det_{cudnn_det}'
                results[key] = row
                print(json.dumps({key: row}), flush=True)
                del a, b
                torch.cuda.empty_cache()
    return results


# --- several processes: the training programs under DDP --------------------

DDP_BATCHES = (32, 64)          # per card: global 128 and 256 on four
DDP_SCAN_STEPS = 4              # steps in one graph of the synthetic scan
DDP_CALLS = {'scan': 3, 'shard': 5}   # calls per program; the first untimed
DDP_SHARD_RECORDS = 512


class StepRoutes:
    """Counts, while open, the calls of the training programs' graphs
    (``train/state.StepGraph``) and the eager optimizer steps on the card
    (``train/state.optimize``): a command that trains through its graph
    takes none of the latter."""

    def __enter__(self):
        from esa_pose_estimation_tpu_torch.train import state as tstate
        self.tstate, self.graph_calls, self.eager_steps = tstate, 0, 0
        self.real = real_call, real_opt = (tstate.StepGraph.__call__,
                                           tstate.optimize)

        def call(graph, inputs):
            self.graph_calls += 1
            return real_call(graph, inputs)

        def optimize(state, loss_fn):
            if next(state.model.parameters()).is_cuda:
                self.eager_steps += 1
            return real_opt(state, loss_fn)
        tstate.StepGraph.__call__, tstate.optimize = call, optimize
        return self

    def __exit__(self, *exc):
        self.tstate.StepGraph.__call__, self.tstate.optimize = self.real

    def check(self, label: str) -> str:
        if self.graph_calls == 0 or self.eager_steps:
            raise AssertionError(f'{label}: {self.graph_calls} graph calls, '
                                 f'{self.eager_steps} eager steps on the '
                                 'card')
        return (f'{self.graph_calls} graph calls, no eager step on the '
                f'card')


def replica_state(dev, tiny: bool = False, mesh=None,
                  dtype=torch.bfloat16):
    """A train state of ``hrnet_esa`` from r5 (f32 masters, computing in
    ``dtype``; ``tiny``: ``hrnet_tiny`` in f32 from a seed) at 12c's
    rate, wrapped by
    ``parallel/mesh.wrap_data_parallel`` when a group is joined; with a
    process ``mesh``, placed on it first (``parallel/mesh.shard_state``)
    and wrapped over its data group.  Every rank starts elsewhere (its own
    seed; r5 plus the rank), so the replicas agree only if rank 0's
    parameters were broadcast before the first step (over the model
    group, then over the data group)."""
    from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
    from esa_pose_estimation_tpu_torch.parallel import distributed as pdist
    from esa_pose_estimation_tpu_torch.parallel.mesh import (
        shard_state,
        wrap_data_parallel,
    )
    from esa_pose_estimation_tpu_torch.train import state as tstate
    from esa_pose_estimation_tpu_torch.utils import config as cfg_mod
    from esa_pose_estimation_tpu_torch.utils.seeding import generator
    if tiny:
        model = HRNet(cfg_mod.hrnet_tiny()).to(dev).init_weights(
            generator(dev, SEED, pdist.rank()))
    else:
        model = r5_masters(dev, dtype)
        if pdist.rank():
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(float(pdist.rank()))
    st = tstate.create_train_state(
        model, cfg_mod.TrainConfig(lr_boundaries=(0, 100, 170)), 1000)
    if mesh is not None:
        shard_state(st, mesh)
        st.train_model = wrap_data_parallel(model, mesh)
    elif torch.distributed.is_initialized():
        st.train_model = wrap_data_parallel(model)
    return st


def _sync(dev) -> None:
    if torch.device(dev).type == 'cuda':
        torch.cuda.synchronize(dev)


def _ranks(values: list[int], dev) -> list[list[int]]:
    """``values`` of every rank, in rank order (this rank's alone without
    a group)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return [list(values)]
    t = torch.tensor(values, dtype=torch.int64, device=dev)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return [o.tolist() for o in out]


def replicas_equal(st) -> bool:
    """Whether this rank's parameters, statistics and optimizer state are
    bit-equal to rank 0's (each broadcast from rank 0 and compared), and
    under a ``model`` axis (``st.mesh``) each split weight and its Adam
    moments to those of the first rank of its data group; True without a
    group."""
    import torch.distributed as dist

    from esa_pose_estimation_tpu_torch.parallel.mesh import split_convs
    from esa_pose_estimation_tpu_torch.train.state import state_tensors
    if not dist.is_initialized():
        return True
    dev = next(st.model.parameters()).device
    split = set()
    for conv in split_convs(st.model):
        split |= {id(v) for v in [conv.weight, *st.optimizer.state.get(
            conv.weight, {}).values()] if v.shape == conv.weight.shape}
    mesh = st.mesh
    same = True
    for t in state_tensors(st):
        ref = t.detach().to(dev).clone()
        if id(t) in split:
            dist.broadcast(ref, mesh.ranks[0][mesh.coordinate[1]],
                           group=mesh.data.group)
        else:
            dist.broadcast(ref, 0)
        same &= torch.equal(ref, t.detach().to(dev))
    return same


def replay_collectives(call, dev) -> dict:
    """One ``call()`` (a replay) under torch.profiler: its device kernels,
    and those of NCCL among them, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        _sync(dev)
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    nccl = sorted({n for n in names if 'nccl' in n.lower()})
    return {'kernels': len(names),
            'nccl_kernels': sum('nccl' in n.lower() for n in names),
            'nccl_names': nccl[:4]}


def collective_sweep(st, dev) -> list[dict]:
    """Each all-reduce size of a training step of ``st`` under its DDP
    wrapper (the loss, 1; each BatchNorm's statistics, 2c + 1; each of
    DDP's gradient buckets, as its logging data gives them), once eagerly
    and once captured in a CUDA graph on one input drawn from this rank's
    seed: whether the two sums are bit-equal, on every rank."""
    import torch.distributed as dist

    from esa_pose_estimation_tpu_torch.models.layers import BatchNorm
    from esa_pose_estimation_tpu_torch.parallel import distributed as pdist
    from esa_pose_estimation_tpu_torch.utils.seeding import generator
    buckets = st.train_model._get_ddp_logging_data()['bucket_sizes']
    sizes = ({1} | {2 * m.weight.numel() + 1 for m in st.model.modules()
                    if isinstance(m, BatchNorm)}
             | {int(b) // 4 for b in buckets.split(',') if b})
    rows = []
    for n in sorted(sizes):
        x = torch.randn(n, generator=generator(dev, SEED, 3, n,
                                               pdist.rank()), device=dev)
        eager, buf = x.clone(), x.clone()
        dist.all_reduce(eager)
        _sync(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            dist.all_reduce(buf)
        buf.copy_(x)
        graph.replay()
        _sync(dev)
        rows.append({'numel': n, 'equal': [
            r[0] for r in _ranks([int(torch.equal(eager, buf))], dev)]})
    return rows


@contextlib.contextmanager
def capture_collectives():
    """While open, each graph capture (``utils/graphs.capture``) runs under
    torch.profiler (host side, every thread: the backward's too); yields
    a dict that then holds the captures and the collective calls made in
    them (PyTorch's ``nccl:all_reduce`` ranges, one per all-reduce):
    those a replay launches, however NCCL carries them out."""
    from torch.profiler import ProfilerActivity, profile

    from esa_pose_estimation_tpu_torch.utils import graphs
    real, found = graphs.capture, {'captures': 0, 'collective_calls': 0}

    def observed(*args, **kwargs):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            cap = real(*args, **kwargs)
        found['captures'] += 1
        found['collective_calls'] += sum(
            e.name.startswith('nccl:') for e in prof.events())
        return cap
    graphs.capture = observed
    try:
        yield found
    finally:
        graphs.capture = real


def program_pair(route: str, batch: int, dev, shard: str,
                 tiny: bool = False, seed: int = SEED, mesh=None) -> dict:
    """One training program of ``cli.train`` under this process's group,
    from one start on two states: replayed (``route`` 'scan':
    ``make_scan_step``, ``DDP_SCAN_STEPS`` steps a graph, synthetic
    batches; 'shard': ``make_train_steps(st, data/pipeline.step_loss)``,
    a step a graph, host crops from ``shard``, this rank's records) and
    launched one by one (``StepGraph.run_eagerly``; ``run_steps`` on the
    CPU) on the same draws.  Each rank draws its own
    (``generator(dev, seed, ..., rank)``).  Then, for the scan, a second
    graph of another length, captured after the first has replayed, and
    its twin.  Returns the losses' and states' bit-equality on this rank
    and every rank's, the replicas' equality across ranks, ms per step
    both ways in turns (the first call untimed), capture seconds, pool
    and peak memory, the collective calls in the first capture
    (:func:`capture_collectives`), the largest parameter and statistic
    differences between the two states, and, for the shard route, the
    kernels of one replay (NCCL's among them: :func:`replay_collectives`)
    and, under several processes, each all-reduce size eager against
    captured (:func:`collective_sweep`).  With a process ``mesh`` the
    states are placed on it (:func:`replica_state`), the draws and
    records follow the data coordinate (the ranks of a model group take
    the same batch), the images/s count the data axis's batches, and
    there is no sweep."""
    import itertools

    from esa_pose_estimation_tpu_torch.data import pipeline as dp
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.parallel import distributed as pdist
    from esa_pose_estimation_tpu_torch.parallel.mesh import split_convs
    from esa_pose_estimation_tpu_torch.train import state as tstate
    from esa_pose_estimation_tpu_torch.utils.seeding import generator
    rank, world = pdist.rank(), pdist.world_size()
    if mesh is not None:            # the data axis's slice and count
        rank, world = mesh.coordinate[0], mesh.shape['data']
    cuda = torch.device(dev).type == 'cuda'
    crop = 32 if tiny else 128
    pts = synthetic.spacecraft_points(device=dev, n=6 if tiny else 30)
    a, b = replica_state(dev, tiny, mesh), replica_state(dev, tiny, mesh)

    def eager_program(st, loss_fn, n):
        if cuda:
            return tstate.StepGraph(st, loss_fn, n, dev).run_eagerly
        return lambda x: tstate.run_steps(st, loss_fn, x)

    if route == 'scan':
        n_inner = DDP_SCAN_STEPS
        fn = tstate.BatchFn(
            draw=lambda g: synthetic.draw_batch(g, batch, crop, device=dev),
            make=lambda d: synthetic.make_batch(None, batch, pts,
                                                crop_size=crop, draws=d))

        def loss_fn(m, d):
            return tstate.heatmap_step_loss(m, fn.make(d))
        ga, gb = (generator(dev, seed, 1, batch, rank) for _ in range(2))
        twin = eager_program(a, loss_fn, n_inner)
        scan = tstate.make_scan_step(b, fn, n_inner)

        def run_a(i):
            return twin([fn.draw(ga) for _ in range(n_inner)])

        def run_b(i):
            return scan(gb)
        graph = scan
    else:
        from esa_pose_estimation_tpu_torch.data.native_loader import (
            NativeBatchLoader,
        )
        n_inner = 1

        def loss_fn(m, x):
            return dp.step_loss(m, x, crop)
        with NativeBatchLoader(shard, batch, shuffle=False, crop_size=crop,
                               process_id=rank, process_count=world,
                               device=dev) as loader:
            host = list(itertools.islice(iter(loader), 2))
        batches = [{k: v.to(dev) for k, v in h.items()
                    if isinstance(v, torch.Tensor)} for h in host]
        g = generator(dev, seed, 2, batch, rank)
        calls = [[dp.step_inputs(batches[i % 2], g, crop)]
                 for i in range(DDP_CALLS[route])]
        twin = eager_program(a, loss_fn, n_inner)
        graph = tstate.make_train_steps(b, loss_fn, n_inner)

        def run_a(i):
            return twin(calls[i])

        def run_b(i):
            return graph(calls[i])

    def timed(call):
        _sync(dev)
        t0 = time.perf_counter()
        out = call()
        _sync(dev)
        return out, (time.perf_counter() - t0) * 1e3 / n_inner
    losses_equal = True
    eager_ms, replay_ms = [], []
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(DDP_CALLS[route]):
        if i % 2:
            (lb, tb), (la, ta) = timed(lambda: run_b(i)), timed(
                lambda: run_a(i))
        elif i:
            (la, ta), (lb, tb) = timed(lambda: run_a(i)), timed(
                lambda: run_b(i))
        else:               # the capture, its collectives counted
            la, ta = timed(lambda: run_a(i))
            with capture_collectives() as captured:
                lb, tb = timed(lambda: run_b(i))
        losses_equal &= torch.equal(la, lb)
        if i:
            eager_ms.append(ta)
            replay_ms.append(tb)
    row = {'route': route, 'batch_per_card': batch,
           'processes': pdist.world_size(), 'data_shards': world,
           'steps': DDP_CALLS[route] * n_inner, 'steps_per_graph': n_inner,
           'first_loss': float(lb[0]), 'finite': bool(torch.isfinite(
               lb).all()), 'capture': captured}
    if cuda:
        cap = graph.capture
        row.update(capture_s=cap.seconds, pool_gib=cap.pool_bytes / 2**30,
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    state_equal = trained_equal(a, b)
    with torch.no_grad():
        row['param_max_abs'] = max(float((x - y).abs().max()) for x, y in
                                   zip(a.model.parameters(),
                                       b.model.parameters()))
        row['stat_max_abs'] = max(float((x - y).abs().max()) for x, y in
                                  zip(a.model.buffers(), b.model.buffers()))
    second = True
    if route == 'scan':
        # a second graph, of another length, after the first replayed
        twin2 = eager_program(a, loss_fn, 2)
        scan2 = tstate.make_scan_step(b, fn, 2)
        second = (torch.equal(twin2([fn.draw(ga) for _ in range(2)]),
                              scan2(gb)) and trained_equal(a, b))
    e_ms = sum(eager_ms) / len(eager_ms)
    g_ms = sum(replay_ms) / len(replay_ms)
    row.update(eager_ms=e_ms, replay_ms=g_ms,
               eager_img_s=batch * world / e_ms * 1e3,
               replay_img_s=batch * world / g_ms * 1e3,
               eager_runs=eager_ms, replay_runs=replay_ms)
    if cuda and route == 'shard':
        row['replay'] = replay_collectives(lambda: run_b(0), dev)
        if world > 1 and mesh is None:
            row['all_reduce_sizes'] = collective_sweep(b, dev)
    flags = [int(losses_equal), int(state_equal), int(second),
             int(replicas_equal(a)), int(replicas_equal(b))]
    ranks = _ranks(flags, dev)
    row['split_convs'] = len(split_convs(b.model))
    row.update(losses_equal=losses_equal, state_equal=state_equal,
               second_graph_equal=second, ranks=ranks,
               all_equal=all(all(r) for r in ranks))
    return row


def ddp_commands(dev, shard: str, root: str, tiny: bool = False) -> list:
    """``cli.train`` in this process's group for 2 epochs at 32 images a
    card (``tiny``: 2, ``hrnet_tiny`` at 32 px): the synthetic route (6
    steps an epoch at ``--log-every 4``: a graph of 4 and one of the
    tail's 2) and ``--train-shard --host-crop``, an eval at the second
    epoch.  Per route: each rank's graph calls and eager steps on the
    card (:class:`StepRoutes`), K1 launches in its eval, and whether every
    rank's log holds the same epoch losses, finite."""
    from esa_pose_estimation_tpu_torch.cli import train
    from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
        peak_decode,
    )
    from esa_pose_estimation_tpu_torch.parallel import distributed as pdist
    rank, world = pdist.rank(), pdist.world_size()
    per = 2 if tiny else 32
    common = ['--epochs', '2', '--batch-size', str(per * world),
              '--eval-every', '2', '--no-panels', '--device',
              torch.device(dev).type]
    if tiny:
        common += ['--tiny', '--crop-size', '32']
    if world > 1:
        common += ['--num-processes', str(world), '--process-id', str(rank)]
    rows = []
    for route, extra in (
            ('synthetic', ['--synthetic-size', str(6 * per * world),
                           '--log-every', '4']),
            ('shard_host_crop', ['--train-shard', shard, '--host-crop',
                                 '--log-every', '1'])):
        wd = os.path.join(root, route)
        t0 = time.perf_counter()
        peak_decode.launches = 0
        with StepRoutes() as routes:
            train.main(['--workdir', wd, *common, *extra])
        _sync(dev)
        counts = _ranks([routes.graph_calls, routes.eager_steps,
                         peak_decode.launches], dev)
        pdist.barrier()
        logs = [open(os.path.join(wd, *([f'proc{r}'] if r else []),
                                  'log_esa.txt')).read().splitlines()
                for r in range(world)]
        losses = [float(ln.split('\t')[2]) for ln in logs[0][1:]]
        rows.append({
            'route': route, 'processes': world, 'batch_per_card': per,
            'seconds': time.perf_counter() - t0,
            'graph_calls': [c[0] for c in counts],
            'eager_steps': [c[1] for c in counts],
            'k1_launches': [c[2] for c in counts],
            'epoch_losses': losses,
            'logs_equal': all(lg == logs[0] for lg in logs),
            'finite': len(losses) == 2 and all(map(math.isfinite, losses))})
    return rows


def ddp_experiment(dev, root: str, tiny: bool = False,
                   batches=DDP_BATCHES) -> dict:
    """The ``--ddp`` mode (module docstring) in this process's group, or
    alone without one.  Rank 0 prints each row; every rank raises if a
    check failed."""
    from esa_pose_estimation_tpu_torch.data import shards
    from esa_pose_estimation_tpu_torch.parallel import distributed as pdist
    rank, world = pdist.rank(), pdist.world_size()
    shard = os.path.join(root, 'train.spd')
    if rank == 0:
        os.makedirs(root, exist_ok=True)
        shards.write_synthetic_shard(
            shard, 64 if tiny else DDP_SHARD_RECORDS,
            **({'height': 240, 'width': 384, 'n_kp': 6} if tiny else {}),
            device=dev)
    pdist.barrier()
    results: dict = {'processes': world}
    failed = []

    def report(key, row):
        results[key] = row
        if rank == 0:
            print(json.dumps({key: row}), flush=True)
    for batch in batches:
        for route in ('scan', 'shard'):
            row = program_pair(route, batch, dev, shard, tiny)
            report(f'{route}_b{batch}', row)
            cuda = torch.device(dev).type == 'cuda'
            if cuda:                   # the program's states and graphs
                torch.cuda.empty_cache()
            # under several processes on the card, every capture holds
            # collectives and a replay launches NCCL's kernels
            if not (row['all_equal'] and row['finite'] and (
                    not cuda or world == 1 or (
                        row['capture']['collective_calls'] > 0
                        and row.get('replay', {'nccl_kernels': 1})[
                            'nccl_kernels'] > 0))):
                failed.append(f'{route}_b{batch}')
    for row in (ddp_commands(dev, shard, os.path.join(root, 'runs'), tiny)
                if world > 1 else []):
        report(f'cli_train_{row["route"]}', row)
        cuda = torch.device(dev).type == 'cuda'
        if not (row['logs_equal'] and row['finite'] and (not cuda or (
                all(row['graph_calls']) and not any(row['eager_steps'])
                and all(row['k1_launches'])))):
            failed.append(f'cli_train_{row["route"]}')
    pdist.barrier()
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    if failed:
        raise AssertionError(f'--ddp: {failed} failed (rows above)')
    return results

# --model-axis: the meshes of four processes, and the tolerances of split
# steps against unsplit ones on the same global batches, both computing in
# f32 (TF32 off): in bf16 the two round differently, and at r5's optimum,
# where many gradients are noise, Adam moves those elements lr either way
# (the CPU rehearsal of 23a: the first bf16 loss 6.5e-3 apart, the third
# 0.12).  The first step's (from equal parameters) are chip_smoke 12a's
# card-against-CPU f32 tolerances; the later ones tests/test_torch_train's
# three-step loss tolerance, ten times its gradient norm's, and Adam's
# bound, 2 lr a step: an element near zero gradient may move lr either way.
MODEL_AXIS_PER_SHARD = 32
MODEL_AXIS_STEPS = 3
FIRST_LOSS_RTOL, FIRST_NORM_RTOL, FIRST_STAT_TOL = 1e-5, 1e-4, 1e-5
STEP_LOSS_RTOL, STEP_NORM_RTOL, STEP_STAT_TOL = 1e-4, 1e-3, 1e-4
STEP_PARAM_LRS = 2


def model_axis_meshes(world: int) -> list[tuple[int, int]]:
    """(world, 1), (world / 2, 2) and (1, world), the ones that exist."""
    return list(dict.fromkeys((world // m, m) for m in (1, 2, world)
                              if world % m == 0))


def step_batches(dev, d: int, per: int, tiny: bool, seed: int) -> list:
    """Data slice ``d`` of :data:`MODEL_AXIS_STEPS` synthetic batches,
    drawn by data coordinate, so every mesh of the same data extent sees
    the same global batches."""
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.utils.seeding import generator
    pts = synthetic.spacecraft_points(device=dev, n=6 if tiny else 30)
    return [synthetic.make_batch(generator(dev, seed, 7, step, d), per, pts,
                                 crop_size=32 if tiny else 128)
            for step in range(MODEL_AXIS_STEPS)]


def state_differences(got: nn.Module, want: nn.Module, lr: float,
                      stat_tol: float) -> tuple[float, float]:
    """The largest parameter difference between two models in lr units,
    and the running statistics' largest difference beyond ``stat_tol``
    relative (``allclose`` at rtol = atol = ``stat_tol`` holds when it is
    at most ``stat_tol``)."""
    sd_g, sd_w = got.state_dict(), want.state_dict()
    params = stats = 0.0
    for k, w in sd_w.items():
        diff = (sd_g[k].float() - w.float()).abs()
        if 'running' in k:
            stats = max(stats, float((diff - stat_tol * w.abs()).max()))
        else:
            params = max(params, float(diff.max()) / lr)
    return params, stats


def step_differences(first, whole, want_first, want, metrics_got,
                     metrics_want) -> dict:
    """How far split steps lie from unsplit ones: the loss's and the
    norm's relative differences at each step, the parameters (in lr) and
    statistics after the first step (``first``, ``want_first``) and after
    the last (``whole``, ``want``), and whether all are within the
    tolerances above."""
    lr = whole.schedule(0)
    loss = [abs(a['loss'] / b['loss'] - 1.0)
            for a, b in zip(metrics_got, metrics_want)]
    norm = [abs(a['grad_norm'] / b['grad_norm'] - 1.0)
            for a, b in zip(metrics_got, metrics_want)]
    p1, s1 = state_differences(first, want_first, lr, FIRST_STAT_TOL)
    p3, s3 = state_differences(whole.model, want.model, lr, STEP_STAT_TOL)
    steps = len(metrics_got)
    return {'loss_rel': loss, 'grad_norm_rel': norm,
            'first_param_lrs': p1, 'first_stat_excess': s1,
            'param_lrs': p3, 'stat_excess': s3,
            'within': (loss[0] <= FIRST_LOSS_RTOL
                       and norm[0] <= FIRST_NORM_RTOL
                       and max(loss) <= STEP_LOSS_RTOL
                       and max(norm) <= STEP_NORM_RTOL
                       and p1 <= STEP_PARAM_LRS and s1 <= FIRST_STAT_TOL
                       and p3 <= STEP_PARAM_LRS * steps
                       and s3 <= STEP_STAT_TOL)}


def split_steps(st, batches):
    """``train_step`` on each of ``batches``: the metrics as floats, the
    whole model after the first step and the whole state after the last
    (``parallel/mesh.gather_state``, a copy of an unsplit state).  Every
    rank of a model group calls it."""
    from esa_pose_estimation_tpu_torch.parallel.mesh import gather_state
    from esa_pose_estimation_tpu_torch.train import state as tstate
    metrics, first = [], None
    for b in batches:
        metrics.append({k: float(v) for k, v in tstate.train_step(
            st, b).items()})
        if first is None:
            first = gather_state(st).model
    return metrics, first, gather_state(st)


def reference_pair(shape: tuple[int, int], dev, tiny: bool = False,
                   per: int = MODEL_AXIS_PER_SHARD, seed: int = SEED
                   ) -> dict | None:
    """:data:`MODEL_AXIS_STEPS` eager ``train_step`` calls, computing in
    f32, on a mesh of ``shape`` over every rank and on its unsplit
    reference, (n_data, 1) on the first n_data ranks (one card for
    (1, n)), from r5 on the same global batches: the split states
    gathered (``gather_state``, every rank) and held to the reference's
    on rank 0 (:func:`step_differences`).  Returns rank 0's row, with the
    gathered state under 'gathered' (None elsewhere)."""
    from esa_pose_estimation_tpu_torch.parallel import distributed as pdist
    from esa_pose_estimation_tpu_torch.parallel import mesh as mesh_mod
    n_data, n_model = shape
    mesh = mesh_mod.make_process_mesh(n_data, n_model)
    ref_mesh = mesh_mod.make_process_mesh(n_data, 1,
                                          ranks=list(range(n_data)))

    def train(m):
        return split_steps(replica_state(dev, tiny, m, torch.float32),
                           step_batches(dev, m.coordinate[0], per, tiny,
                                        seed))
    got, first, whole = train(mesh)
    ref = train(ref_mesh) if ref_mesh is not None else None
    _sync(dev)
    pdist.barrier()
    if pdist.rank():
        return None
    row = {'mesh': list(shape), 'reference': [n_data, 1],
           'steps': MODEL_AXIS_STEPS, 'batch_per_shard': per,
           'losses': [x['loss'] for x in got],
           'reference_losses': [x['loss'] for x in ref[0]],
           'grad_norms': [x['grad_norm'] for x in got],
           'reference_grad_norms': [x['grad_norm'] for x in ref[0]]}
    row.update(step_differences(first, whole, ref[1], ref[2], got, ref[0]))
    row['gathered'] = whole
    return row


def held_out_median(model, pts) -> dict:
    """Phase 10's 128 held-out frames (:func:`held_out_speed`'s) served by
    ``pipeline.make_jitted_pipeline`` in 4 batches of 32: the SPEED
    median."""
    import statistics

    from esa_pose_estimation_tpu_torch import pipeline
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.eval.speed_score import (
        speed_score_from_matrices,
    )
    dev = next(model.parameters()).device
    fn = pipeline.make_jitted_pipeline(model, pts, **SHARDED_KW)
    gen = torch.Generator(device=dev).manual_seed(991)
    scores = []
    for i in range(4):
        s = synthetic.make_sample(torch.Generator(device=dev).manual_seed(
            991 * 100_003 + i), pts, 32)
        out = fn(s.image, s.bbox, gen)
        scores += speed_score_from_matrices(out.R, out.trans, s.quat,
                                            s.trans).speed.cpu().tolist()
    return {'frames': len(scores), 'median': statistics.median(scores),
            'mean': statistics.fmean(scores), 'worst': max(scores)}


def serving_form(state_dict, dev) -> nn.Module:
    """A trained ``hrnet_esa`` state dict as serving holds it: the bf16
    model in eval mode, its parameters stored in bf16
    (``store_in_compute_dtype``)."""
    from esa_pose_estimation_tpu_torch.models.layers import (
        store_in_compute_dtype,
    )
    model = r5_masters(dev)
    model.load_state_dict(state_dict)
    return store_in_compute_dtype(model).eval()


def model_axis_experiment(dev, root: str, tiny: bool = False) -> dict:
    """The ``--model-axis`` mode (module docstring) in this process's
    group.  Rank 0 prints each row; every rank raises if a check
    failed."""
    from esa_pose_estimation_tpu_torch.data import shards, synthetic
    from esa_pose_estimation_tpu_torch.parallel import distributed as pdist
    from esa_pose_estimation_tpu_torch.parallel import mesh as mesh_mod
    rank, world = pdist.rank(), pdist.world_size()
    cuda = torch.device(dev).type == 'cuda'
    per = 2 if tiny else MODEL_AXIS_PER_SHARD
    shard = os.path.join(root, 'train.spd')
    if rank == 0:
        os.makedirs(root, exist_ok=True)
        shards.write_synthetic_shard(
            shard, 64 if tiny else DDP_SHARD_RECORDS,
            **({'height': 240, 'width': 384, 'n_kp': 6} if tiny else {}),
            device=dev)
    pdist.barrier()
    results: dict = {'processes': world}
    failed = []

    def report(key, row):
        results[key] = row
        if rank == 0:
            print(json.dumps({key: row}), flush=True)
    for shape in model_axis_meshes(world):
        mesh = mesh_mod.make_process_mesh(*shape)
        tag = f'{shape[0]}x{shape[1]}'
        for route in ('scan', 'shard'):
            row = program_pair(route, per, dev, shard, tiny, mesh=mesh)
            if cuda:
                row['peak_gib_by_rank'] = [r[0] / 1024 for r in _ranks(
                    [int(row['peak_gib'] * 1024)], dev)]
                torch.cuda.empty_cache()
            report(f'{route}_{tag}', row)
            nccl = row.get('replay', {'nccl_kernels': 1})['nccl_kernels']
            if not (row['all_equal'] and row['finite'] and (
                    not cuda or (row['capture']['collective_calls'] > 0
                                 and nccl > 0))):
                failed.append(f'{route}_{tag}')
    pts = synthetic.spacecraft_points(device=dev, n=6 if tiny else 30)
    for shape in model_axis_meshes(world):
        if shape[1] == 1:
            continue
        row = reference_pair(shape, dev, tiny, per)
        ok = [True]
        if row is not None:
            whole = row.pop('gathered')
            if not tiny:
                row['held_out'] = held_out_median(serving_form(
                    whole.model.state_dict(), dev), pts)
                row['within'] &= row['held_out']['median'] <= 0.01
            ok = [row['within']]
            report(f'reference_{shape[0]}x{shape[1]}', row)
            del whole
        if cuda:
            torch.cuda.empty_cache()
        if not _ranks([int(ok[0])], dev)[0][0]:
            failed.append(f'reference_{shape[0]}x{shape[1]}')
    pdist.barrier()
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    if failed:
        raise AssertionError(f'--model-axis: {failed} failed (rows above)')
    return results



# --sharded: one serving batch over the data axis of this process's cards,
# at cli.eval_synthetic's solver settings
SHARDED_KW = dict(min_keypoints=0, n_hypotheses=64)
SHARDED_PER_CARD = (64, 1)
SHARDED_ITERS = 10
K1_NAME, K2_NAME = 'peak_decode_kernel', 'cbam_cluster_kernel'


def sync_all(mesh) -> None:
    for dev in dict.fromkeys(mesh.devices):
        torch.cuda.synchronize(dev)


def pose_differences(a, b) -> list[str]:
    """The fields of two PoseOutputs that are not torch.equal, each with
    its largest difference and where it lies (``b`` moved to ``a``'s card
    first)."""
    out = []
    for name, x, y in zip(a._fields, a, b):
        y = y.to(x.device)
        if not torch.equal(x, y):
            d = (x.float() - y.float()).abs()
            out.append(f'{name} max {float(d.max()):.3g} at '
                       f'{d.flatten().argmax().item()}')
    return out


def device_kernels(call, mesh) -> dict[int, tuple[int, int]]:
    """K1's and K2's device kernels of one ``call()`` on each card, by
    torch.profiler: {card index: (K1, K2)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync_all(mesh)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        sync_all(mesh)
    out: dict[int, list[int]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n = out.setdefault(e.device_index, [0, 0])
            n[0] += K1_NAME in e.name
            n[1] += K2_NAME in e.name
    return {k: tuple(v) for k, v in sorted(out.items())}


def _angles(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Rotation angle between two batches of rotation matrices, in f64
    from their Frobenius distance, 2 sqrt(2) sin(angle / 2): exact near
    0, where the trace's arccos of f32 matrices has a floor of ~1e-3
    rad (it read 9.8e-4 for two equal rotations)."""
    d = torch.linalg.matrix_norm(Ra.double() - Rb.double())
    return 2.0 * torch.arcsin(torch.clamp(d / 8.0 ** 0.5, max=1.0))


def sharded_serving_check(model, pts, mesh, frames, boxes, seed: int,
                          pose_tol: float | None = None) -> dict:
    """``pipeline.make_sharded_pipeline(model, pts, mesh)`` on one batch
    (``frames``, ``boxes`` on ``model``'s card), FUSED_CBAM as it is set.
    Raises unless: each shard is torch.equal to ``make_jitted_pipeline``
    of a replica on that shard's card, run on that slice and that slice of
    the global draw; one call launches K1 (and K2 29 times) once per
    shard, by the counters and by the profiler's device kernels on each
    card; with ``pose_tol``, the gathered poses lie within ``pose_tol``
    rad and ``pose_tol`` relative translation of one unsharded call on
    ``model``'s card.  That call's network runs at the whole batch, a
    shard's at a slice, and the bf16 heatmaps can differ by a rounding
    step with the batch (cuDNN's choice of algorithms): at 256 against 64
    a frame moved 2.0e-3 rad on four H100s.  Also says whether each shard
    is bit-equal to its slice served on ``model``'s card."""
    from esa_pose_estimation_tpu_torch import pipeline
    from esa_pose_estimation_tpu_torch.experimental.cbam_fuse import (
        fused_cbam,
    )
    from esa_pose_estimation_tpu_torch.models import layers
    from esa_pose_estimation_tpu_torch.ops import pnp
    from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
        peak_decode,
    )
    from esa_pose_estimation_tpu_torch.parallel import mesh as mesh_mod
    home = frames.device
    sharded = pipeline.make_sharded_pipeline(model, pts, mesh, **SHARDED_KW)

    def gen():
        return torch.Generator(device=mesh.devices[0]).manual_seed(seed)
    t0 = time.perf_counter()
    sharded(frames, boxes, gen())             # warm-up and capture
    sync_all(mesh)
    first_s = time.perf_counter() - t0
    out = sharded(frames, boxes, gen())
    sync_all(mesh)
    uniforms = pnp.draw_ransac_uniforms(
        gen(), frames.shape[:1], pts.shape[-2],
        SHARDED_KW['n_hypotheses'], mesh.devices[0])
    at_home = pipeline.make_jitted_pipeline(model, pts, **SHARDED_KW)
    refs = {home: at_home}
    on_home = []
    for k, (sl, dev) in enumerate(zip(
            mesh_mod.batch_sharding(mesh, frames.shape[0]), mesh.devices)):
        if dev not in refs:
            replica = mesh_mod.replicate(model, mesh_mod.Mesh((dev,)))[0]
            refs[dev] = pipeline.make_jitted_pipeline(replica, pts.to(dev),
                                                      **SHARDED_KW)
        want = refs[dev](frames[sl].to(dev), boxes[sl].to(dev),
                         ransac_uniforms=uniforms[sl].to(dev))
        bad = pose_differences(out.shards[k], want)
        if bad:
            raise AssertionError(f'sharded serving: shard {k} on {dev} is '
                                 f'not its card\'s make_jitted_pipeline: '
                                 f'{bad}')
        mine = at_home(frames[sl], boxes[sl],
                       ransac_uniforms=uniforms[sl].to(home))
        on_home.append(not pose_differences(mine, out.shards[k]))
    sync_all(mesh)
    whole = at_home(frames, boxes, gen())
    got = out.gather(home)
    angles = _angles(got.R, whole.R)
    rels = ((got.trans - whole.trans).norm(dim=-1)
            / whole.trans.norm(dim=-1))
    ang, rel = float(angles.max()), float(rels.max())
    if pose_tol is not None and not (ang <= pose_tol and rel <= pose_tol):
        raise AssertionError(f'sharded serving: gathered poses {ang} rad, '
                             f'{rel} relative from one unsharded call')
    fused = layers.FUSED_CBAM
    want_k = (len(mesh.devices), 29 * len(mesh.devices) if fused else 0)
    peak_decode.launches = fused_cbam.launches = 0
    sharded(frames, boxes, gen())
    sync_all(mesh)
    counted = (peak_decode.launches, fused_cbam.launches)
    per_card = device_kernels(lambda: sharded(frames, boxes, gen()), mesh)
    want_dev: dict[int, tuple[int, int]] = {}
    for dev in mesh.devices:
        k1, k2 = want_dev.get(dev.index, (0, 0))
        want_dev[dev.index] = (k1 + 1, k2 + (29 if fused else 0))
    if counted != want_k or per_card != want_dev:
        raise AssertionError(f'sharded serving: launches {counted} (want '
                             f'{want_k}), device kernels {per_card} (want '
                             f'{want_dev})')
    return {'shards': len(mesh.devices),
            'devices': [str(d) for d in mesh.devices],
            'batch': frames.shape[0], 'fused_cbam': fused,
            'shards_equal_their_card': True,
            'shards_equal_on_home_card': on_home,
            'max_angle_vs_unsharded': ang, 'max_rel_t_vs_unsharded': rel,
            'median_angle_vs_unsharded': float(angles.median()),
            'frames_over_1e-3_vs_unsharded': int(
                ((angles > 1e-3) | (rels > 1e-3)).sum()),
            'launches': counted, 'device_kernels': per_card,
            'first_call_s': first_s, 'sharded': sharded, 'out': out}


def h2d_ms(frames: torch.Tensor, mesh) -> dict:
    """Host-to-device copy of ``frames`` (on the host) sharded over the
    mesh (``mesh.shard_batch``): each card's copy by events on its stream,
    and the host's wall time until every copy is done."""
    from esa_pose_estimation_tpu_torch.parallel import mesh as mesh_mod
    cards = list(dict.fromkeys(mesh.devices))
    sync_all(mesh)
    ev = {d: (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for d in cards}
    for d in cards:
        ev[d][0].record(torch.cuda.current_stream(d))
    t0 = time.perf_counter()
    shards = mesh_mod.shard_batch(frames, mesh)
    enqueue = time.perf_counter() - t0
    for d in cards:
        ev[d][1].record(torch.cuda.current_stream(d))
    sync_all(mesh)
    wall = time.perf_counter() - t0
    del shards
    return {'pinned': frames.is_pinned(),
            'card_ms': [ev[d][0].elapsed_time(ev[d][1]) for d in cards],
            'host_enqueue_ms': enqueue * 1e3, 'wall_ms': wall * 1e3,
            'mbytes_per_card': frames.numel() * frames.element_size()
            / len(mesh.devices) / 1e6}


def sharded_rates(model, pts, n_cards: tuple[int, ...], per_card: int,
                  seed: int) -> list[dict]:
    """Replay ms per call and images/s (all cards') of make_sharded_pipeline
    over the first n cards for each n in ``n_cards``, in turns (n_cards,
    then reversed); the global batch (``per_card`` x n frames) starts on
    card 0, so a call includes its peer copies to the other cards."""
    from esa_pose_estimation_tpu_torch import pipeline
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.parallel import mesh as mesh_mod
    dev0 = next(model.parameters()).device
    g = torch.Generator(device=dev0).manual_seed(seed)
    s = synthetic.make_sample(g, pts, per_card * max(n_cards))
    runs = {}
    for n in n_cards:
        mesh = mesh_mod.make_mesh(devices=[torch.device('cuda', i)
                                           for i in range(n)])
        fn = pipeline.make_sharded_pipeline(model, pts, mesh, **SHARDED_KW)
        b = per_card * n
        fn(s.image[:b], s.bbox[:b], g)          # capture
        runs[n] = (mesh, fn, b)
    times: dict[int, list[float]] = {n: [] for n in n_cards}
    for n in tuple(n_cards) + tuple(reversed(n_cards)):
        mesh, fn, b = runs[n]
        fn(s.image[:b], s.bbox[:b], g)
        sync_all(mesh)
        t0 = time.perf_counter()
        for _ in range(SHARDED_ITERS):
            fn(s.image[:b], s.bbox[:b], g)
        sync_all(mesh)
        times[n].append((time.perf_counter() - t0) / SHARDED_ITERS * 1e3)
    return [{'cards': n, 'per_card': per_card, 'batch': runs[n][2],
             'ms': times[n],
             'images_per_s': [runs[n][2] / (t * 1e-3) for t in times[n]]}
            for n in n_cards]


def held_out_speed(model, pts, mesh) -> dict:
    """Phase 10's 128 held-out frames (cli.eval_synthetic's generators,
    4 batches of 32) served sharded as one batch: the SPEED median."""
    import statistics

    from esa_pose_estimation_tpu_torch import pipeline
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.eval.speed_score import (
        speed_score_from_matrices,
    )
    dev0 = next(model.parameters()).device
    samples = [synthetic.make_sample(torch.Generator(device=dev0).manual_seed(
        991 * 100_003 + i), pts, 32) for i in range(4)]
    cat = {k: torch.cat([getattr(x, k) for x in samples])
           for k in ('image', 'bbox', 'quat', 'trans')}
    fn = pipeline.make_sharded_pipeline(model, pts, mesh, **SHARDED_KW)
    out = fn(cat['image'], cat['bbox'], torch.Generator(
        device=dev0).manual_seed(991)).gather(dev0)
    sc = speed_score_from_matrices(out.R, out.trans, cat['quat'],
                                   cat['trans']).speed.cpu().tolist()
    return {'frames': len(sc), 'median': statistics.median(sc),
            'mean': statistics.fmean(sc), 'worst': max(sc)}


def kernels_on_every_card() -> list[dict]:
    """K1, K2 and K3 launched on each visible card from this process,
    whose current device stays card 0 (the wrappers make the input's card
    current; the ``.cu`` files keep their launch state per card): each
    card's output must be bit-equal to card 0's on the same input.  K1 on
    (64, 128, 128, 30) f32 maps, K2 on hrnet_esa's 64x64x32 site at batch
    64 with residual, K3 (bf16) on (8, 64, 64, 32) with k = 4."""
    from esa_pose_estimation_tpu_torch.experimental.branch_chain import (
        branch_chain,
        make_test_chain,
    )
    from esa_pose_estimation_tpu_torch.experimental.cbam_fuse import (
        fused_cbam,
    )
    from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
        peak_decode,
    )
    g = torch.Generator().manual_seed(SEED)
    hm = torch.rand((64, 128, 128, 30), generator=g)
    x2 = torch.randn((64, 64, 64, 32), generator=g).to(torch.bfloat16)
    res = torch.randn((64, 64, 64, 32), generator=g).to(torch.bfloat16)
    fc1, fc2 = (0.3 * torch.randn((32, 2), generator=g),
                0.3 * torch.randn((2, 32), generator=g))
    spw = 0.2 * torch.randn((7, 7, 2), generator=g)
    x3 = torch.randn((8, 64, 64, 32), generator=g).to(torch.bfloat16)
    w3, b3 = make_test_chain(g)
    calls = {
        'k1': lambda d: peak_decode(hm.to(d)),
        'k2': lambda d: fused_cbam(x2.to(d), fc1.to(d), fc2.to(d),
                                   spw.to(d), res.to(d)),
        'k3': lambda d: branch_chain(x3.to(d), w3.to(d), b3.to(d)),
    }
    rows = []
    for name, call in calls.items():
        first = None
        for i in range(torch.cuda.device_count()):
            dev = torch.device('cuda', i)
            out = call(dev)
            out = tuple(out) if isinstance(out, tuple) else (out,)
            torch.cuda.synchronize(dev)
            if torch.cuda.current_device() != 0:
                raise AssertionError(f'{name} left cuda:'
                                     f'{torch.cuda.current_device()} current')
            if first is None:
                first = [t.cpu() for t in out]
            equal = all(torch.equal(a.cpu(), b)
                        for a, b in zip(out, first))
            rows.append({'kernel': name, 'card': i, 'equal_to_card_0':
                         equal})
            if not equal:
                raise AssertionError(f'{name} on cuda:{i} differs from '
                                     'cuda:0')
    return rows


def sharded_experiment() -> dict:
    """``--sharded``: hrnet_esa from r5 in bf16 (the serving form) over
    every visible card of this process."""
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.models import layers
    from esa_pose_estimation_tpu_torch.parallel import mesh as mesh_mod
    from esa_pose_estimation_tpu_torch.utils.artifact import (
        load_hrnet_artifact,
    )
    _require_cuda()
    dev0 = torch.device('cuda', 0)
    model = load_hrnet_artifact(str(R5_ARTIFACT), dtype=torch.bfloat16,
                                device=dev0)
    pts = synthetic.spacecraft_points(device=dev0)
    mesh = mesh_mod.make_mesh()
    n = len(mesh.devices)
    results: dict = {'cards': n}

    def emit(key, rec):
        if isinstance(rec, dict):
            rec = {k: v for k, v in rec.items()
                   if k not in ('sharded', 'out')}
        results[key] = rec
        print(json.dumps({key: rec}), flush=True)
    import subprocess
    emit('nvidia_smi', subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines())
    emit('kernels_on_every_card', kernels_on_every_card())
    for per_card in SHARDED_PER_CARD:
        s = synthetic.make_sample(torch.Generator(device=dev0).manual_seed(
            SEED + per_card), pts, per_card * n)
        for fused in (False, True):
            layers.FUSED_CBAM = fused
            try:
                emit(f'check_{per_card}_a_card_k2_{int(fused)}',
                     sharded_serving_check(model, pts, mesh, s.image, s.bbox,
                                           SEED + 1))
            finally:
                layers.FUSED_CBAM = False
            torch.cuda.empty_cache()
    emit('held_out', held_out_speed(model, pts, mesh))
    if not results['held_out']['median'] <= 0.01:
        raise AssertionError(f'--sharded: held-out SPEED median '
                             f'{results["held_out"]["median"]} > 0.01')
    s = synthetic.make_sample(torch.Generator(device=dev0).manual_seed(
        SEED + 7), pts, SHARDED_PER_CARD[0] * n, render=False)
    host = s.image.cpu()
    emit('h2d_pageable', h2d_ms(host, mesh))
    emit('h2d_pinned', h2d_ms(host.pin_memory(), mesh))
    del s, host
    counts = tuple(sorted({c for c in (1, 2, n) if c <= n}))
    for per_card in SHARDED_PER_CARD:
        for rec in sharded_rates(model, pts, counts, per_card, SEED + 9):
            emit(f'rate_{rec["cards"]}_cards_{per_card}_a_card', rec)
    return results



def ddp_main(args) -> dict:
    """``--ddp``: join the group the arguments name (none for one
    process), run :func:`ddp_experiment`, leave the group."""
    from esa_pose_estimation_tpu_torch.parallel import distributed as pdist
    from esa_pose_estimation_tpu_torch.utils.artifact import target_device
    dev = target_device(args.device, 'mfu_experiments --ddp')
    joined = pdist.initialize(args.coordinator, args.num_processes,
                              args.process_id, device=dev)
    try:
        if dev.type == 'cuda':
            dev = torch.device('cuda', torch.cuda.current_device())
        results = ddp_experiment(dev, args.workdir, args.tiny,
                                 (2,) if args.tiny else DDP_BATCHES)
        results['device'] = (torch.cuda.get_device_name(dev)
                             if dev.type == 'cuda' else 'cpu')
        if pdist.is_primary():
            print(json.dumps(results))
        return results
    finally:
        if joined:
            pdist.shutdown()


def model_axis_main(args) -> dict:
    """``--model-axis``: join the group the arguments name, run
    :func:`model_axis_experiment`, leave the group."""
    from esa_pose_estimation_tpu_torch.parallel import distributed as pdist
    from esa_pose_estimation_tpu_torch.utils.artifact import target_device
    dev = target_device(args.device, 'mfu_experiments --model-axis')
    joined = pdist.initialize(args.coordinator, args.num_processes,
                              args.process_id, device=dev)
    try:
        if dev.type == 'cuda':
            dev = torch.device('cuda', torch.cuda.current_device())
        results = model_axis_experiment(dev, args.workdir, args.tiny)
        results['device'] = (torch.cuda.get_device_name(dev)
                             if dev.type == 'cuda' else 'cpu')
        if pdist.is_primary():
            print(json.dumps(results))
        return results
    finally:
        if joined:
            pdist.shutdown()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument('--chain', action='store_true')
    mode.add_argument('--int8', action='store_true')
    mode.add_argument('--int8-matmul', action='store_true')
    mode.add_argument('--cluster-sweep', action='store_true')
    mode.add_argument('--repeat', action='store_true')
    mode.add_argument('--k2-case', action='store_true')
    mode.add_argument('--determinism', action='store_true')
    mode.add_argument('--ddp', action='store_true')
    mode.add_argument('--sharded', action='store_true')
    mode.add_argument('--model-axis', action='store_true')
    ddp = ap.add_argument_group('--ddp and --model-axis', 'several '
                                'processes, one per card (--ddp: none, one '
                                'card alone)')
    ddp.add_argument('--coordinator', default=None)
    ddp.add_argument('--num-processes', type=int, default=None)
    ddp.add_argument('--process-id', type=int, default=None)
    ddp.add_argument('--workdir', default='build/ddp',
                     help="the shard and cli.train's runs (removed after)")
    ddp.add_argument('--device', default='cuda',
                     help="'cpu' rehearses the mode under gloo")
    ddp.add_argument('--tiny', action='store_true',
                     help='hrnet_tiny at 32 px and batch 2 a process')
    args = ap.parse_args(argv)
    if args.ddp:
        return ddp_main(args)
    if args.model_axis:
        return model_axis_main(args)
    _require_cuda()
    if args.chain:
        results = chain_experiment()
    elif args.int8:
        results = int8_experiment()
    elif args.int8_matmul:
        results = int8_matmul_experiment()
    elif args.cluster_sweep:
        results = cluster_sweep()
    elif args.repeat:
        results = repeat_experiment()
    elif args.k2_case:
        results = k2_case()
    elif args.determinism:
        results = determinism_experiment()
    elif args.sharded:
        results = sharded_experiment()
    else:
        results = flagship_experiment()
    results['device'] = torch.cuda.get_device_name(0)
    print(json.dumps(results))
    return results


if __name__ == '__main__':
    main()
