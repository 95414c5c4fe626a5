#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``esa_pose_estimation_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, drives the
serving path (``pipeline.infer_poses``) at full width on the shipped r5
artifact through the kernels, checks the poses against the synthetic
ground truth, and times the path.  Phases:

  1. device      the card's name and power limit (nvidia-smi)
  2. build       nvcc of every kernel source, in parallel
  3. K1          peak decode vs its plain version on (B, 128, 128, 30)
                 Gaussian, plateau and all-zero maps at every batch the
                 main path serves (1, 32, 64, 256), noise at 64, and an
                 odd shape; timed at batch 64 and 256; the same checks
                 and times at the LINEMOD eval's (16, 128, 128, 9) and
                 (16, 128, 128, 32)
  4. K2          fused CBAM vs its plain version, the five hrnet_esa map
                 shapes at batch 1, 64 and 256, with and without
                 residual, and three ragged shapes; two launches must be
                 equal; timed per site and per forward at 64 and 256
  5. serving     64 synthetic frames -> infer_poses, SPEED score (median
                 must be <= 0.01), launch counts, no operation that makes
                 the host wait for the card; again with FUSED_CBAM
                 (heatmaps within 0.05, median <= 0.01)
  6. throughput  images/s of infer_poses at batch 1 and 256, K2 off and on
  7. profile     one batch-256 call under torch.profiler, FUSED_CBAM off
                 then on: time per stage, kernel time, the device's idle
                 share, the hrnet stage both ways, K2 kernels per forward
  8. K3          branch chain vs its plain version: bf16 (tensor-core
                 kernel) at (256, 64, 64, 32) k=4, two ragged shapes, zero
                 input, and two exact-tap cases that must be bit-equal;
                 f32 (FMA kernel) at (4, 16, 16, 32) k=3 and zero input;
                 then its main path, cli.mfu_experiments.chain_experiment()
                 at batch 256 and 512, timed beside the cuDNN chain
  9. levers      the 64 frames of phase 5 again with MERGED_FUSE, then
                 NHWC_DECODE, then INT8_SERVING on: change of heatmaps
                 and poses, SPEED median; the lever's stage (forward or
                 decode) timed on and off
 10. eval        cli.eval_synthetic on 128 held-out frames, plain (median
                 must be <= 0.01) and with --int8
 11. two-stage   (a) 64 frames through pipeline.detect_and_infer with a
                 planted detector (the targets of the true boxes): boxes
                 within 64 px, no full-frame fallback, SPEED median <=
                 0.01, K1 launches; (b) a seeded TinyDetector on the card
                 against the CPU (maps rtol/atol 1e-3, boxes 1 px), one
                 call with no host wait, then
                 detect_and_infer timed at batch 1 and 256 beside the
                 detect stage, one batch-256 call profiled, and the
                 frames' host-to-device copy; (c) the 64 frames as a PNG +
                 pickle split: cli.submit (64 finite rows of 8 fields in
                 filename order) and cli.evaluate (speed <= 0.02, no
                 non-finite frame) on the r5 artifact
 12. train       (e) the r5 weights as f32 masters and as the loader's
                 stored bf16 serve phase 5's frames with equal heatmaps;
                 (a) one f32 train step of hrnet_tiny, card against CPU
                 (loss rtol 1e-5, grad_norm 1e-4, running statistics 1e-5,
                 parameters within lr); (b) hrnet_esa from r5, bf16 over
                 f32 masters: steps/s, images/s, peak memory and share of
                 the bf16 peak at batch 32 and 256, ms per step with and
                 without fault 4's repair in turns, one batch-256 step
                 profiled (kernels, idle share, forward / backward /
                 optimizer); (c) 60 steps from r5 at batch 32 with
                 --augment-photo at lr 1e-5, every loss finite, then the
                 in-train evaluate on phase 10's 128 held-out frames
                 (median <= 0.01) with K1's launches; (d) cli.train --tiny
                 on the card, cli.eval_synthetic --checkpoint best_rotate
                 and the artifact export on its run
 13. detector    cli.train_detector at the JAX round-5 recipe (width 32,
                 stride 16, downscale 8, 16 epochs of 50 steps at batch
                 16, --augment): every loss finite, clean and perturbed
                 det@0.5 >= 0.95, seconds per epoch and ms per step; then
                 cli.eval_synthetic --detector-workdir on the 128 held-out
                 frames (median <= 0.01, no full-frame fallback, K1
                 launches) and detect_and_infer at batch 256 with the
                 trained and with seeded weights, in turns
 14. shards      the native loader built from native/src/shard_loader.cpp;
                 raw (512) and PNG (256) SPD1 shards of 1920x1200 frames;
                 their batches against the device route on the same
                 frames (equal from frames, 0.05 grey levels from host
                 crops, pinned); hrnet_esa from r5 trained from them at
                 batch 32 and 256, frames and host crop: images/s beside
                 12b's, the host's wait on the loader, host-to-device ms,
                 peak memory, finite losses; cli.train --train-shard
                 --host-crop with K1 in its in-train eval
 15. group       three f32 hrnet_tiny steps in a one-rank NCCL group
                 (wrap_data_parallel, the group-aware BatchNorm) against
                 the same steps with no group, at 12a's tolerances; the
                 group is destroyed after; (b) in a one-rank NCCL group
                 made for graphs, hrnet_esa from r5 at batch 32 under DDP:
                 the synthetic scan (4 steps a graph) and the shard
                 route's step on host crops, each replayed and launched
                 one by one from one start, torch.equal in losses,
                 parameters, statistics and Adam; collective calls in
                 each capture, NCCL kernels in one replay; a second scan
                 graph of 2 steps; eager and replay ms per step, capture
                 seconds, pool and peak memory
 16. linemod     the LINEMOD/PVNet family at crop 128, 9 keypoints, batch
                 16: (a) ideal targets of rendered poses through heatmaps
                 -> K1 -> RANSAC-EPnP and through the vertex field ->
                 voting -> distribution -> uncertainty PnP score 1.0 on
                 2D projection and ADD; (b) the rasterizer on the card
                 against the CPU (masks equal off triangle edges, depth
                 1e-5 relative); (c) cli.train_linemod in both modes, 2
                 epochs of 50 steps, 4 eval batches: finite, falling
                 losses, ms per step, images/s, peak memory, K1 launches
                 in the heatmap eval; (d) the data2/ layout written here,
                 one epoch with --augment and the occlusion eval in both
                 modes; (e) ransac_voting timed at (16, 128, 128), 128
                 hypotheses, K = 32 and 9 (keypoints within 0.01 px,
                 launches, idle share)
 17. rehearsal   cli.dress_rehearsal at full width (1920x1200 JPEGs, 30
                 keypoints, hrnet_esa, crop 128), 64/32/16 frames, 2
                 epochs at batch 32, --host-crop --augment-geom
                 --eval-every 1, panels where matplotlib is present (4
                 PNGs per eval): finite losses, best_rotate, finite
                 scores, a CSV of 48 rows of 8 fields in filename order,
                 K1 in the in-train evals and in cli.evaluate, seconds per
                 stage; then cli.evaluate of r5 on the exported test
                 JPEGs (mean SPEED <= 0.02)
 18. reference   r5 exported under the reference's state_dict names,
     checkpoint  torch.save'd in the reference's wrapper, loaded and
                 imported into a fresh hrnet_esa: phase 5's 64 frames
                 served with FUSED_CBAM off (K1) and on (K2, K1),
                 heatmaps, keypoints and poses torch.equal to r5
 19. tooling     (a) rasterize_color card vs CPU (masks and colour equal
                 off triangle edges, depth 1e-5 relative); (b)
                 render_driver's fallback renders 16 frames on the card,
                 db_builder makes the real, render and fuse DBs, and
                 cli.train_linemod --pkl-dir trains an epoch of at least
                 20 steps at batch 16 in heatmap mode from them (finite
                 loss, K1 in its eval); (c) pose_nms, transforms.crop,
                 vgg16_bn and the instance augmentations card vs CPU at
                 the CPU tests' tolerances; (d) profiling.Timer spans at
                 least the CUDA-event time; device_probe's count
 20. graphs      the compiled programs as CUDA graphs: (a) phase 5's
                 frames through pipeline.make_jitted_pipeline, every
                 output torch.equal to eager infer_poses, FUSED_CBAM off
                 and on, SPEED median <= 0.01; (b) K1 and K2 device
                 kernels in one replay by the profiler (1 and 0, 1 and
                 29); (c) 20 replays of the FUSED_CBAM graph bit-equal;
                 (d) eager and replay in turns at batch 1 and 256: ms per
                 call, images/s, capture seconds, pool bytes, no host
                 wait around a replay; (e) the graphed EvalCache.infer
                 torch.equal to eager on phase 10's frames; (f)
                 make_scan_step from r5, 8 steps at batch 32 and 256:
                 two eager runs on the same draws torch.equal (fault 4),
                 the graph torch.equal to the same steps launched one by
                 one with capturable Adam, and within the stated
                 tolerance of train_step's (Adam in f64 on the host); ms
                 per step both ways, peak memory; (g) cli.train on the
                 synthetic route through the scan.  Phases 10, 11c,
                 12c-d, 13, 14 and 17 run their commands, and so the
                 graphs, as users do; 13, 14, 16c and 17 count their
                 graph calls and fail on an eager step on the card
 21. step graphs the compiled training programs: (a) fault 4, two eager
                 runs of the detector and of ResNet-8s in both modes
                 torch.equal; (b) fault 5, a serving graph and a training
                 graph raise once their model's storage is replaced; (c)
                 each training graph at its command's width (shard at 32
                 from host crops and at 256 from frames, pickle at 32,
                 the detector, LINEMOD's rendered scan of 16 steps and
                 its real step in both modes) torch.equal to its steps
                 launched one by one, eager and replay ms per step in
                 turns, capture seconds, pool bytes, peak memory; (d)
                 cli.train --train-pkl through its graph, K1 launches in
                 its in-train eval
 22. sharded     serving and the eval step over the data axis of this
                 process's cards (pipeline.make_sharded_pipeline,
                 train/state.make_sharded_eval_step): a mesh of every
                 visible card and, on a one-card machine, cuda:0 listed
                 twice; phase 5's frames with K2 off and on: (a) each
                 shard torch.equal to make_jitted_pipeline on its card,
                 slice and uniforms, the gathered poses within 1e-3 rad
                 and 1e-3 relative translation of one unsharded call, K1
                 (and K2) once per shard by the counters and the
                 profiler's devices, no host wait inside a call, the
                 frames' host-to-device ms from pinned memory; (b) the
                 sharded eval step: heatmaps torch.equal to eval_step per
                 shard, the loss the same on every card and within 1e-6
                 relative of eval_step's
 23. model axis  (a) four processes on this card in a gloo group (NCCL
                 refuses two ranks on one card) at the (2, 2) mesh:
                 hrnet_esa from r5 at full width through shard_state (28
                 convs split) under DDP over the data group, 2 images a
                 data slice, 3 eager steps in bf16 (finite; whole
                 tensors bit-equal on the four ranks and split slices in
                 each data group) and in f32, held to the same 3 steps of
                 one process on the 4 images (loss 1e-5 relative at the
                 first step, 1e-4 after; grad_norm 1e-4, then 1e-3;
                 statistics 1e-5, then 1e-4; parameters within 2 lr a
                 step); (b) while they run, a one-rank NCCL group:
                 the (1, 1) mesh through shard_state and the captured scan
                 torch.equal to phase 15b's program; (c) the gathered
                 (2, 2) model serves phase 5's frames, FUSED_CBAM off and
                 on: K1 once and K2 0 or 29 times by the counters and the
                 profiler, SPEED median <= 0.01

Kernel and plain times (``ms``, ``plain_ms``) are means of eager calls
between CUDA events, host cost included, as in earlier PRs; K1 and K2 are
also timed with the same calls replayed from a CUDA graph
(``utils/timing.graph_ms``: device time), printed beside them and kept as
``graph_ms`` and ``plain_graph_ms``.  Any failed check raises, so the
exit code is non-zero and the final line is not printed.  The line before
the last is a JSON record of each kernel (launches on its main path: the
serving call for K1 and K2, the branch-chain experiment for K3; for K1
also its launches in one detect_and_infer call, in phase 12c's
in-train evaluate, in phase 13's two-stage eval and in phase 14's
shard-fed in-train evaluate, in phase 16's LINEMOD evals, in phase 17's
rehearsal (in-train evals and cli.evaluate) and in phase 19b's
cli.train_linemod from built DBs; for K1 and K2 in phase 18's imported
reference checkpoint and, by the profiler, in one replay of phase 20's
serving graph; in phase 21d's cli.train --train-pkl; for K1 and K2 in one
call of phase 22's sharded pipeline; for K1 and K2 in one FUSED_CBAM call
of phase 23c's gathered model; a replay adds what
its capture recorded to the counts, ``utils/graphs.py``; error
against its plain version, times, bound); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import itertools
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
F32_OPS_PER_S = 67e12              # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 tensor cores, dense
ROOT = Path(__file__).resolve().parent
ARTIFACT = str(ROOT / 'artifacts' / 'esa_syn_r5.npz')
SEED = 20261016
DEVICE = 'cuda'
WORK = ''       # main's scratch directory: phase 14's shards, for 15b and 21
CARD = ''       # the card's name and power limit, as nvidia-smi gives them


def log(msg: str) -> None:
    print(msg, flush=True)


def copies_for(nbytes: int) -> int:
    return max(1, math.ceil(160e6 / max(nbytes, 1)))


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S
          ) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError('chip_smoke.py needs a CUDA device; none found')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    log(line)                       # name, power limit: as nvidia-smi says
    global CARD
    CARD = line
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'device {torch.cuda.get_device_name(0)} '
        f'count {torch.cuda.device_count()}')
    return line


def import_port() -> None:
    """Import the port from the checkout this script sits in, and refuse
    any other copy (an installed one, or none: the script alone fails)."""
    sys.path.insert(0, str(ROOT))
    import esa_pose_estimation_tpu_torch as port
    where = Path(port.__file__).resolve().parent.parent
    if where != ROOT:
        raise RuntimeError(f'the port was imported from {where}, not from '
                           f'the checkout {ROOT}')


def phase_build() -> None:
    from esa_pose_estimation_tpu_torch import _build
    secs = _build.build_all()
    log(f'build: {secs:.1f} s (nvcc, {len(list(_build.CSRC.glob("*.cu")))} '
        f'sources in parallel)')


def gaussian_maps(gen: torch.Generator, b: int, s: int, k: int
                  ) -> torch.Tensor:
    """(B, S, S, K) channels-last Gaussian heatmaps, sigma 2."""
    dev = DEVICE
    kp = torch.rand((b, k, 2), generator=gen, device=dev) * (s - 4) + 2
    ax = torch.arange(s, dtype=torch.float32, device=dev)
    dx = (ax[None, None, :] - kp[..., 0:1]) ** 2            # (B, K, S)
    dy = (ax[None, None, :] - kp[..., 1:2]) ** 2
    hm = torch.exp(-(dy[..., :, None] + dx[..., None, :]) / 8.0)
    return hm.permute(0, 2, 3, 1).contiguous()              # (B, S, S, K)


def plateau_maps(gen: torch.Generator, b: int, s: int, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, S, K) noise below 0.5 with the maximum 0.9 at two pixels of
    every map, S/2 rows apart (so in two different bands wherever the
    kernel splits an image in two or more); returns the maps and the first
    pixel's row-major index (B, K)."""
    hm = 0.5 * torch.rand((b, s, s, k), generator=gen, device=DEVICE)
    ya = torch.randint(0, s // 2, (b, k), generator=gen, device=DEVICE)
    xa = torch.randint(0, s, (b, k), generator=gen, device=DEVICE)
    xb = torch.randint(0, s, (b, k), generator=gen, device=DEVICE)
    bi = torch.arange(b, device=DEVICE)[:, None].expand(b, k)
    ki = torch.arange(k, device=DEVICE)[None, :].expand(b, k)
    hm[bi, ya, xa, ki] = 0.9
    hm[bi, ya + s // 2, xb, ki] = 0.9
    return hm, (ya * s + xa).to(torch.int32)


# the batches the main path gives K1: 1 and 256 (phases 6 and 11b), 32
# (the eval, evaluate and submit commands' batch, phases 10 and 11c), 64
# (phases 5, 9 and 11a); K1 and K2 choose their cluster size from the
# batch, so each is checked
K1_BATCHES = (1, 32, 64, 256)
# the keypoint counts of the LINEMOD heatmap eval at batch 16: the
# command's default 9, and the 32 of QUALITY.md's run
K1_LINEMOD_K = (9, 32)


def check_k1(label: str, hm: torch.Tensor, first: torch.Tensor | None
             ) -> float:
    """K1 against its plain version on (B, S, S, K) maps: integer peaks and
    maxvals equal (and the peaks equal to ``first`` where given), coords
    within 1e-4; returns the coords' max abs err."""
    from esa_pose_estimation_tpu_torch.ops import peak
    from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
        peak_decode,
    )
    s = hm.shape[2]
    c_k, m_k, p_k = peak_decode(hm, return_peaks=True)
    torch.cuda.synchronize()
    c_p, m_p = peak.decode_heatmaps(hm.permute(0, 3, 1, 2))
    ipk, _ = peak.argmax_peaks(hm.permute(0, 3, 1, 2))
    p_p = (ipk[..., 1] * s + ipk[..., 0]).to(torch.int32)
    if not torch.equal(p_k, p_p):
        raise AssertionError(f'K1 {label}: integer peaks differ')
    if first is not None and not torch.equal(p_k, first):
        raise AssertionError(f'K1 {label}: not the first maximum')
    if not torch.equal(m_k, m_p):
        raise AssertionError(f'K1 {label}: maxvals differ')
    err = float((c_k - c_p).abs().max())
    if not err <= 1e-4:
        raise AssertionError(f'K1 {label}: coords differ by {err}')
    log(f'K1 {label} {tuple(hm.shape)}: integer peaks and maxvals equal, '
        f'coords max abs err {err:.3g} (tolerance 1e-4)')
    return err


def phase_k1() -> dict:
    """K1 against its plain version at every batch the main path gives it:
    Gaussian, plateau (equal maxima in two bands: the first row-major one
    must win) and all-zero maps (the peak is index 0), and noise at batch
    64; timed at batch 64 and 256, by eager calls (the ``ms`` of earlier
    PRs) and by CUDA-graph replay (device time)."""
    from esa_pose_estimation_tpu_torch.ops import peak
    from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
        cluster_config,
        launch_shape,
        peak_decode,
    )
    from esa_pose_estimation_tpu_torch.utils.timing import paired_ms
    s, k = 128, 30
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    max_err = 0.0
    rec = {}
    for batch in K1_BATCHES:
        cfg = cluster_config(batch, s, s, k)
        if launch_shape(batch, s, s, k, n_sm)[::2] != (cfg['ranks'], cfg['vec']):
            raise AssertionError(f'K1: launch_shape differs from the kernel '
                                 f'{cfg}')
        log(f'K1 launch at batch {batch}: {cfg["ranks"]} CTAs per image (one '
            f'cluster) of {cfg["threads"]} threads, {4 * cfg["vec"]}-byte '
            f'loads, {cfg["max_active_clusters"]} clusters at once')
        plateau, first = plateau_maps(gen, batch, s, k)
        cases = {'gaussian': (gaussian_maps(gen, batch, s, k), None),
                 'plateau': (plateau, first),
                 'all-zero': (torch.zeros((batch, s, s, k), device=DEVICE),
                              torch.zeros((batch, k), dtype=torch.int32,
                                          device=DEVICE))}
        if batch == 64:
            cases['noise'] = (torch.rand((batch, s, s, k), generator=gen,
                                         device=DEVICE), None)
        for name, (hm, want) in cases.items():
            max_err = max(max_err, check_k1(name, hm, want))
        hm = cases['gaussian'][0]
        del cases, plateau, first
        if batch in (64, 256):
            bufs = [(hm.clone(),) for _ in range(copies_for(hm.numel() * 4))]

            def plain(x):
                return peak.decode_heatmaps(x.permute(0, 3, 1, 2))
            ms, plain_ms = paired_ms(peak_decode, plain, bufs)
            g_ms, g_plain_ms = paired_ms(peak_decode, plain, bufs, graph=True)
            nbytes = hm.numel() * 4 + batch * k * 3 * 4
            b_ms, b_by = bound(nbytes, 2.0 * hm.numel())
            log(f'K1 time ({batch},128,128,30): eager calls kernel {ms:.4f} '
                f'ms, plain {plain_ms:.4f} ms; graph replay kernel '
                f'{g_ms:.4f} ms, plain {g_plain_ms:.4f} ms; bound '
                f'{b_ms:.4f} ms ({b_by})')
            if batch == 64:
                rec = {'ms': ms, 'plain_ms': plain_ms, 'graph_ms': g_ms,
                       'plain_graph_ms': g_plain_ms, 'bound_ms': b_ms,
                       'bound_by': b_by}
            del bufs
        del hm
    # the LINEMOD heatmap eval's maps (phase 16): batch 16, K = 9 (the
    # command's default: 4-wide loads of 288 threads) and K = 32
    for k_lm in K1_LINEMOD_K:
        shape = (16, s, s, k_lm)
        cfg = cluster_config(*shape)
        if launch_shape(*shape, n_sm)[::2] != (cfg['ranks'], cfg['vec']):
            raise AssertionError(f'K1 {shape}: launch_shape differs from '
                                 f'the kernel {cfg}')
        plateau, first = plateau_maps(gen, 16, s, k_lm)
        cases = {'gaussian': (gaussian_maps(gen, 16, s, k_lm), None),
                 'plateau': (plateau, first),
                 'all-zero': (torch.zeros(shape, device=DEVICE),
                              torch.zeros((16, k_lm), dtype=torch.int32,
                                          device=DEVICE))}
        for name, (hm, want) in cases.items():
            max_err = max(max_err, check_k1(f'linemod {name}', hm, want))
        hm = cases['gaussian'][0]
        bufs = [(hm.clone(),) for _ in range(copies_for(hm.numel() * 4))]

        def plain(x):
            return peak.decode_heatmaps(x.permute(0, 3, 1, 2))
        ms, plain_ms = paired_ms(peak_decode, plain, bufs)
        g_ms, g_plain_ms = paired_ms(peak_decode, plain, bufs, graph=True)
        b_ms, b_by = bound(hm.numel() * 4 + 16 * k_lm * 3 * 4,
                           2.0 * hm.numel())
        log(f'K1 time {shape} (LINEMOD eval): {cfg["ranks"]} CTAs per '
            f'image of {cfg["threads"]} threads, {4 * cfg["vec"]}-byte '
            f'loads; eager calls kernel {ms:.4f} ms, plain {plain_ms:.4f} '
            f'ms; graph replay kernel {g_ms:.4f} ms, plain {g_plain_ms:.4f} '
            f'ms; bound {b_ms:.4f} ms ({b_by})')
        del cases, bufs, hm, plateau, first
    # W * K odd: the kernel's 4-byte-load instance; 16 CTAs per image in
    # bands of 3 rows, the last three empty
    odd = torch.rand((3, 37, 29, 7), generator=gen, device=DEVICE)
    c_k, m_k, p_k = peak_decode(odd, return_peaks=True)
    torch.cuda.synchronize()
    c_p, m_p, p_p = peak_decode(odd.cpu(), return_peaks=True)
    err = float((c_k.cpu() - c_p).abs().max())
    if not (torch.equal(p_k.cpu(), p_p) and torch.equal(m_k.cpu(), m_p)
            and err <= 1e-4):
        raise AssertionError(f'K1 odd {tuple(odd.shape)}: differs from the '
                             f'plain version (coords {err})')
    max_err = max(max_err, err)
    log(f'K1 odd {tuple(odd.shape)} (4-byte loads): integer peaks and '
        f'maxvals equal, coords max abs err {err:.3g} (tolerance 1e-4)')
    return {'name': 'peak_decode', 'route': 'cuda',
            'source': 'esa_pose_estimation_tpu_torch/csrc/peak_decode.cu',
            'replaces': 'esa_pose_estimation_tpu/ops/pallas/peak_decode.py:75',
            'max_abs_err': max_err, 'library_ms': None, **rec}


# hrnet_esa's CBAM sites in one forward: (H, W, C, residual, count)
CBAM_SITES = ((64, 64, 32, True, 10), (32, 32, 64, True, 8),
              (16, 16, 128, True, 6), (8, 8, 256, True, 4),
              (128, 128, 64, False, 1))


def cbam_inputs(gen: torch.Generator, b: int, h: int, w: int, c: int):
    """x, residual (bf16 NHWC) and the site's f32 weights."""
    hid = c // 16
    x = torch.randn((b, h, w, c), generator=gen, device=DEVICE
                    ).to(torch.bfloat16)
    res = torch.randn((b, h, w, c), generator=gen, device=DEVICE
                      ).to(torch.bfloat16)
    fc1 = 0.3 * torch.randn((c, hid), generator=gen, device=DEVICE)
    fc2 = 0.3 * torch.randn((hid, c), generator=gen, device=DEVICE)
    spw = 0.2 * torch.randn((7, 7, 2), generator=gen, device=DEVICE)
    return x, res, fc1, fc2, spw


def check_cbam(label: str, x, fc1, fc2, spw, r) -> float:
    """The kernel against its plain version, and two launches on the same
    input equal to the bit; returns the max abs err."""
    from esa_pose_estimation_tpu_torch.experimental.cbam_fuse import (
        cbam_plain,
        fused_cbam,
    )
    got = fused_cbam(x, fc1, fc2, spw, r)
    again = fused_cbam(x, fc1, fc2, spw, r)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        # say where, and which launch a third one sides with, then fail
        third = fused_cbam(x, fc1, fc2, spw, r)
        torch.cuda.synchronize()
        where = (got != again).nonzero()
        raise AssertionError(
            f'K2 {label}: two launches differ at {where.shape[0]} values '
            f'(images {sorted(set(where[:, 0].tolist()))[:8]}, rows '
            f'{sorted(set(where[:, 1].tolist()))[:16]}), max diff '
            f'{float((got.float() - again.float()).abs().max())}, non-finite '
            f'values {int((~torch.isfinite(got)).sum())} and '
            f'{int((~torch.isfinite(again)).sum())}; a third '
            f'launch equals the first {torch.equal(third, got)}, the second '
            f'{torch.equal(third, again)}')
    got = got.float()
    want = cbam_plain(x, fc1, fc2, spw, r).float()
    # both round an f32 result to bf16; sums taken in another order can
    # land on either side of a rounding boundary: one bf16 step
    # (<= 2^-7 |want|), plus f32 noise near zero
    excess = ((got - want).abs() - (2.0 ** -7 * want.abs() + 1e-4)).max()
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or float(excess) > 0:
        raise AssertionError(f'K2 {label}: max abs err {err}')
    log(f'K2 {label}: max abs err {err:.4g} (tolerance 2^-7|plain| + 1e-4), '
        f'two launches equal')
    return err


# the batches the main path gives K2 with FUSED_CBAM on: 64 (phase 5), 1
# and 256 (phases 6 and 7); it is timed at 64 and 256
K2_BATCHES = (1, 64, 256)


def phase_k2() -> dict:
    """K2 against its plain version at the five hrnet_esa site shapes, at
    every batch the main path gives it, with and without residual, and on
    ragged shapes; two launches on one input must be equal.  Timed per
    site and per forward at batch 64 and 256, by eager calls (the ``ms``
    of earlier PRs) and by CUDA-graph replay (device time); the kernels
    line takes batch 64."""
    from esa_pose_estimation_tpu_torch.experimental.cbam_fuse import (
        cbam_plain,
        cluster_config,
        fused_cbam,
    )
    from esa_pose_estimation_tpu_torch.utils.timing import paired_ms
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    max_err = 0.0
    for (b, h, w, c), with_res in (((3, 20, 36, 64), True),
                                   ((1, 8, 8, 256), True),
                                   ((2, 128, 128, 64), False)):
        x, res, fc1, fc2, spw = cbam_inputs(gen, b, h, w, c)
        max_err = max(max_err, check_cbam(
            f'ragged {b}x{h}x{w}x{c} residual={with_res}', x, fc1, fc2, spw,
            res if with_res else None))
    rec = {}
    for b in K2_BATCHES:
        tot = {'ms': 0.0, 'plain_ms': 0.0, 'graph_ms': 0.0,
               'plain_graph_ms': 0.0, 'bytes': 0.0, 'ops': 0.0}
        for h, w, c, serving_res, count in CBAM_SITES:
            hid = c // 16
            x, res, fc1, fc2, spw = cbam_inputs(gen, b, h, w, c)
            cfg = cluster_config(b, h, w, c, hid)
            log(f'K2 launch {b}x{h}x{w}x{c}: {cfg["ranks"]} CTAs per image, '
                f'{cfg["smem_bytes"]} B shared memory each, '
                f'{cfg["max_active_clusters"]} clusters at once')
            for r in (res, None):
                max_err = max(max_err, check_cbam(
                    f'{b}x{h}x{w}x{c} residual={r is not None}', x, fc1,
                    fc2, spw, r))
            if b == 1:
                continue
            r = res if serving_res else None
            args = (x, fc1, fc2, spw, r)
            bufs = [tuple(a.clone() if a is not None else None for a in args)
                    for _ in range(copies_for(
                        x.numel() * 2 * (3 if r is not None else 2)))]
            ms, plain_ms = paired_ms(fused_cbam, cbam_plain, bufs)
            g_ms, g_plain_ms = paired_ms(fused_cbam, cbam_plain, bufs,
                                         graph=True)
            del bufs
            n = x.numel()
            nbytes = n * 2 * (3 if r is not None else 2) + (2 * c * hid + 98) * 4
            ops = n * (8 if r is not None else 6) + b * h * w * 200 + b * 4 * c * hid
            b_ms, b_by = bound(nbytes, ops)
            log(f'K2 time {b}x{h}x{w}x{c} residual={r is not None} (x{count} '
                f'per forward): eager calls kernel {ms:.4f} ms, plain '
                f'{plain_ms:.4f} ms; graph replay kernel {g_ms:.4f} ms, '
                f'plain {g_plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by})')
            for key, v in (('ms', ms), ('plain_ms', plain_ms),
                           ('graph_ms', g_ms), ('plain_graph_ms', g_plain_ms),
                           ('bytes', nbytes), ('ops', ops)):
                tot[key] += count * v
            del x, res, args
        if b == 1:
            continue
        b_ms, b_by = bound(tot['bytes'], tot['ops'])
        log(f'K2 time per forward (29 sites, batch {b}): eager calls kernel '
            f'{tot["ms"]:.3f} ms, plain {tot["plain_ms"]:.3f} ms; graph '
            f'replay kernel {tot["graph_ms"]:.3f} ms, plain '
            f'{tot["plain_graph_ms"]:.3f} ms; bound {b_ms:.3f} ms ({b_by})')
        if b == 64:
            rec = {k: tot[k] for k in ('ms', 'plain_ms', 'graph_ms',
                                       'plain_graph_ms')}
            rec.update(bound_ms=b_ms, bound_by=b_by)
    torch.cuda.empty_cache()
    return {'name': 'fused_cbam', 'route': 'cuda',
            'source': 'esa_pose_estimation_tpu_torch/csrc/cbam_fuse.cu',
            'replaces': 'esa_pose_estimation_tpu/experimental/cbam_fuse.py:92',
            'max_abs_err': max_err, 'library_ms': None, **rec}


def _angles(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    c = ((Ra * Rb).sum((-2, -1)) - 1.0) / 2.0
    return torch.arccos(torch.clamp(c, -1.0, 1.0))


# the held-out evaluation's solver settings (cli/eval_synthetic)
SERVE_KW = dict(min_keypoints=0, n_hypotheses=64)


def serve(model, s, pts):
    """infer_poses on the frames of sample ``s``, RANSAC drawn from a fixed
    seed, so two runs differ only by what a flag changes."""
    from esa_pose_estimation_tpu_torch import pipeline
    return pipeline.infer_poses(
        model, s.image, s.bbox, pts,
        torch.Generator(device=DEVICE).manual_seed(SEED + 3), **SERVE_KW)


def sync_sites(call) -> dict[str, int]:
    """The synchronizing CUDA operations of one ``call()``, each of which
    makes the host wait for the card, counted by the source line that ran
    them (torch's sync debug mode)."""
    import collections
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return dict(collections.Counter(
        f'{Path(w.filename).name}:{w.lineno}' for w in caught
        if 'synchronizing CUDA operation' in str(w.message)))


def check_no_host_wait(label: str, call) -> None:
    """A serving call must not make the host wait for the card: a copy of
    a host constant inside it did (ROADMAP fault 1)."""
    sites = sync_sites(call)
    log(f'{label}: {sum(sites.values())} synchronizing operations in one '
        f'call {sites}')
    if sites:
        raise AssertionError(f'{label}: the host waits for the card at '
                             f'{sites}')


def phase_serving(model, pts):
    """Returns the K1 and K2 launches, the 64 frames and the plain run's
    output (phase 9 serves the same frames)."""
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.eval.speed_score import (
        speed_score_from_matrices,
    )
    from esa_pose_estimation_tpu_torch.experimental.cbam_fuse import (
        fused_cbam,
    )
    from esa_pose_estimation_tpu_torch.models import layers
    from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
        peak_decode,
    )
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    s = synthetic.make_sample(gen, pts, 64)

    def run(fused: bool):
        layers.FUSED_CBAM = fused
        try:
            peak_decode.launches = 0
            fused_cbam.launches = 0
            out = serve(model, s, pts)
            torch.cuda.synchronize()
            return out, peak_decode.launches, fused_cbam.launches
        finally:
            layers.FUSED_CBAM = False

    out, k1, k2 = run(False)
    if k1 != 1 or k2 != 0:
        raise AssertionError(f'serving: K1 launches {k1}, K2 {k2} '
                             '(expected 1 and 0)')
    if not (bool(torch.isfinite(out.R).all())
            and bool(torch.isfinite(out.trans).all())):
        raise AssertionError('serving: non-finite pose')
    sc = speed_score_from_matrices(out.R, out.trans, s.quat, s.trans).speed
    sc = sc.cpu().tolist()
    med, mean, worst = statistics.median(sc), statistics.fmean(sc), max(sc)
    log(f'serving: {len(sc)} frames, K1 launches {k1}, SPEED median {med:.5f} mean '
        f'{mean:.5f} worst {worst:.5f} (median limit 0.01)')
    if not med <= 0.01:
        raise AssertionError(f'serving: SPEED median {med} > 0.01')
    check_no_host_wait('serving', lambda: serve(model, s, pts))

    out2, k1b, k2b = run(True)
    if k1b != 1 or k2b != 29:
        raise AssertionError(f'serving with FUSED_CBAM: K1 launches {k1b}, '
                             f'K2 {k2b} (expected 1 and 29)')
    if not bool(torch.isfinite(out2.R).all()):
        raise AssertionError('serving with FUSED_CBAM: non-finite pose')
    ang = _angles(out.R, out2.R)
    dt = ((out.trans - out2.trans).norm(dim=-1)
          / out.trans.norm(dim=-1))
    med2 = statistics.median(speed_score_from_matrices(
        out2.R, out2.trans, s.quat, s.trans).speed.cpu().tolist())
    hm_diff = float((out.heatmaps - out2.heatmaps).abs().max())
    log(f'serving FUSED_CBAM: K1 launches {k1b}, K2 launches {k2b} (29 per '
        f'forward); heatmaps moved max {hm_diff:.4g} (rtol/atol 0.05); poses '
        f'moved median {float(ang.median()):.3g} rad / max '
        f'{float(ang.max()):.3g} rad, translation rel max '
        f'{float(dt.max()):.3g}; SPEED median {med2:.5f} (limit 0.01)')
    # K2 computes the CBAM composite's function, so the heatmaps may move
    # by bf16 rounding only, as for the exact levers of phase 9
    if not torch.allclose(out2.heatmaps, out.heatmaps, rtol=0.05, atol=0.05):
        raise AssertionError(f'serving with FUSED_CBAM: heatmaps moved '
                             f'{hm_diff}')
    if not med2 <= 0.01:
        raise AssertionError(f'serving with FUSED_CBAM: SPEED median {med2} '
                             '> 0.01')
    return k1, k2b, s, out


def phase_throughput(model, pts) -> None:
    from esa_pose_estimation_tpu_torch import pipeline
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.models import layers
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    s = synthetic.make_sample(gen, pts, 256, render=False)
    # the frames of one rendered sample batch of 16, tiled to 256 (render
    # time is set-up, not serving)
    frames16 = synthetic.render_frame(s.keypoints_2d[:16])
    frames = frames16.repeat(16, 1, 1)
    boxes = s.bbox[:16].repeat(16, 1)
    rgen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    for fused in (False, True):
        layers.FUSED_CBAM = fused
        try:
            for batch, iters in ((1, 10), (256, 5)):
                f, bx = frames[:batch].contiguous(), boxes[:batch].contiguous()
                for _ in range(2):
                    pipeline.infer_poses(model, f, bx, pts, rgen)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(iters):
                    pipeline.infer_poses(model, f, bx, pts, rgen)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                log(f'throughput: batch {batch} FUSED_CBAM={fused}: '
                    f'{batch * iters / dt:.1f} img/s '
                    f'({dt / iters * 1e3:.1f} ms per call)')
        finally:
            layers.FUSED_CBAM = False
    phase_profile(model, pts, frames, boxes, rgen)


STAGES = ('detect', 'crop', 'hrnet', 'decode', 'ransac_epnp', 'refine')


K1_KERNEL = 'peak_decode_kernel'
K2_KERNEL = 'cbam_cluster_kernel'


def phase_profile(model, pts, frames, boxes, rgen) -> None:
    """One batch-256 ``infer_poses`` under torch.profiler with FUSED_CBAM
    off, then one with it on: per stage (the pipeline's record_function
    ranges) its host time, the span of its device work and the kernel time
    inside that span; for the call, kernel time over wall time; with K2
    on, its device kernels per forward (at most 30).  The profiler's own
    host cost slows the call, so the idle share here is an upper bound."""
    from esa_pose_estimation_tpu_torch import pipeline
    from esa_pose_estimation_tpu_torch.models import layers
    hrnet = {}
    for fused in (False, True):
        layers.FUSED_CBAM = fused
        try:
            stages = profile_call(
                lambda: pipeline.infer_poses(model, frames, boxes, pts, rgen),
                f'profile FUSED_CBAM={fused}', top=8 if not fused else 3)
            hrnet[fused] = None if stages is None else stages['hrnet']
        finally:
            layers.FUSED_CBAM = False
    # the K2-per-forward check must not pass unmeasured
    if hrnet[True] is None:
        raise AssertionError('profile: no hrnet kernels recorded with '
                             'FUSED_CBAM on, so K2 per forward is unmeasured')
    k2 = hrnet[True]['k2']
    off = ('not measured' if hrnet[False] is None else
           f'{hrnet[False]["kernel_ms"]:.2f} ms of kernels in '
           f'{hrnet[False]["kernels"]} launches')
    log(f'profile hrnet stage at batch 256: FUSED_CBAM off {off}; on '
        f'{hrnet[True]["kernel_ms"]:.2f} ms in {hrnet[True]["kernels"]} '
        f'launches, {k2} of them K2 (one forward)')
    if not 0 < k2 <= 30:
        raise AssertionError(f'profile: {k2} K2 device kernels per forward '
                             '(expected 1 to 30)')


def profile_call(call, tag: str, top: int) -> dict | None:
    """Profile one ``call()`` (after one unprofiled warm-up call); log its
    stages (the pipeline's record_function ranges that ran) and ``top``
    kernels.  Returns ``{stage: {'host_ms', 'span_ms', 'kernel_ms',
    'kernels', 'k2'}}``, or None when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev if e.name not in STAGES]
    if not kernels:
        log(f'{tag}: the profiler recorded no device time (not measured)')
        return None
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    log(f'{tag} batch 256: wall {wall_ms:.1f} ms under the profiler, '
        f'{len(kernels)} kernels, {busy_ms:.1f} ms of kernel time, device '
        f'idle share {1 - busy_ms / wall_ms:.3f}')
    stages = {}
    for name in STAGES:
        host = sum(e.time_range.elapsed_us() for e in events
                   if e.name == name and e.device_type == DeviceType.CPU)
        if host == 0:
            continue                 # a stage this call does not have
        spans = [e.time_range for e in dev if e.name == name]
        lo = min((r.start for r in spans), default=0.0)
        hi = max((r.end for r in spans), default=0.0)
        inside = [e for e in kernels if lo <= e.time_range.start < hi]
        k_ms = sum(e.time_range.elapsed_us() for e in inside) / 1e3
        log(f'{tag} stage {name}: host {host / 1e3:.2f} ms, device span '
            f'{(hi - lo) / 1e3:.2f} ms, kernels {k_ms:.2f} ms in '
            f'{len(inside)} launches')
        stages[name] = {'host_ms': host / 1e3, 'span_ms': (hi - lo) / 1e3,
                        'kernel_ms': k_ms, 'kernels': len(inside),
                        'k2': sum(K2_KERNEL in e.name for e in inside)}
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:top]
    for name, times in ranked:
        log(f'{tag} kernel {sum(times) / 1e3:8.2f} ms {len(times):5d}x '
            f'{name[:90]}')
    return stages


def exact_tap_chain(gen: torch.Generator, k: int, tap: tuple[int, int]
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chain weights nonzero only at one tap (ky, kx): in every conv a
    channel permutation times 0.5; random biases.  Each conv output is then
    a single product, so the tensor-core kernel must equal the plain
    version to the bit: a fault of layout, tap offset or channel packing
    shows as a mismatch, not as noise."""
    w = torch.zeros((k, 2, 3, 3, 32, 32), device=DEVICE)
    cout = torch.arange(32, device=DEVICE)
    for i in range(k):
        for j in range(2):
            perm = torch.randperm(32, generator=gen, device=DEVICE)
            w[i, j, tap[0], tap[1], perm, cout] = 0.5
    return w, 0.1 * torch.randn((k, 2, 32), generator=gen, device=DEVICE)


def sm_clock_mhz_during(fn, args: tuple, seconds: float = 1.5
                        ) -> float | None:
    """Median SM clock (nvidia-smi, sampled every 100 ms) while fn(*args)
    runs back to back for about ``seconds``; None if nvidia-smi gave no
    reading."""
    smi = subprocess.Popen(
        ['nvidia-smi', '--query-gpu=clocks.sm', '--format=csv,noheader,nounits',
         '-lms', '100'], stdout=subprocess.PIPE, text=True)
    try:
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            for _ in range(10):
                fn(*args)
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    mhz = [float(v) for v in out.split() if v.isdigit()][1:]  # skip idle
    return statistics.median(mhz) if mhz else None


def phase_k3() -> dict:
    """K3 against its plain version: bf16 through the tensor-core kernel
    (JAX's tolerances; two exact-tap cases to the bit), f32 through the
    FMA kernel; then its main path, the branch-chain experiment at batch
    256 and 512, timed beside the cuDNN chain."""
    from esa_pose_estimation_tpu_torch.cli import mfu_experiments
    from esa_pose_estimation_tpu_torch.experimental import branch_chain as bc
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, shape, k, dtype, rtol, atol, weights): rtol/atol are JAX's
    # (tests/test_branch_chain.py); weights 'random', 'zero input' (random
    # weights on x = 0) or an exact tap (ky, kx), which must be bit-equal
    cases = (('bf16', (256, 64, 64, 32), 4, bf16, 0.05, 0.05, 'random'),
             ('bf16 ragged', (3, 40, 72, 32), 2, bf16, 0.05, 0.05, 'random'),
             ('bf16 ragged', (1, 8, 8, 32), 1, bf16, 0.05, 0.05, 'random'),
             ('bf16 zero input', (2, 8, 8, 32), 2, bf16, 0.05, 0.05,
              'zero input'),
             ('bf16 centre tap', (3, 40, 72, 32), 2, bf16, 0, 0, (1, 1)),
             ('bf16 tap (0, 2)', (3, 40, 72, 32), 2, bf16, 0, 0, (0, 2)),
             ('f32', (4, 16, 16, 32), 3, f32, 1e-4, 1e-5, 'random'),
             ('f32 zero input', (2, 8, 8, 32), 2, f32, 1e-5, 1e-6,
              'zero input'))
    max_err = 0.0
    for label, shape, k, dt, rtol, atol, kind in cases:
        if isinstance(kind, tuple):
            w, b = exact_tap_chain(gen, k, kind)
        else:
            w, b = bc.make_test_chain(gen, k=k, device=DEVICE)
        x = (torch.zeros(shape, device=DEVICE, dtype=dt)
             if kind == 'zero input' else
             (0.5 * torch.randn(shape, generator=gen, device=DEVICE)).to(dt))
        got = bc.branch_chain(x, w, b)
        torch.cuda.synchronize()
        want = bc.branch_chain_plain(x, w, b)
        err = float((got.float() - want.float()).abs().max())
        ok = (torch.equal(got, want) if isinstance(kind, tuple) else
              bool(torch.isfinite(got).all())
              and torch.allclose(got.float(), want.float(), rtol=rtol,
                                 atol=atol))
        if not ok:
            bad = (got.float() - want.float()).abs() > atol + rtol * \
                want.float().abs()
            raise AssertionError(
                f'K3 {label} {shape} k={k}: max abs err {err}, '
                f'{int(bad.sum())} of {bad.numel()} values off, first at '
                f'{bad.nonzero()[:4].tolist()}')
        if kind == 'zero input' and float(want.abs().max()) == 0.0:
            raise AssertionError('K3 zero input: the chain did not fire')
        max_err = max(max_err, err)
        tol = ('equal to the bit' if isinstance(kind, tuple)
               else f'rtol {rtol}, atol {atol}')
        log(f'K3 {label} {shape} k={k}: max abs err {err:.4g} ({tol})')
    # the main path; its times at batch 256 go into the kernels line.  It
    # checks the kernel once per batch against the plain version on the
    # timed input; those launches are not the path's
    bc.branch_chain.launches = 0
    rows = mfu_experiments.chain_experiment(batches=(256, 512))
    launches = bc.branch_chain.launches - len(rows)
    if launches <= 0:
        raise AssertionError('K3: chain_experiment launched no kernel')
    rec = None
    for row in rows.values():
        bsz, h, wd, c = row['shape']
        k = row['k']
        # max abs err <= 0.05 is within JAX's rtol/atol 0.05 (NaN fails)
        err = row['kernel_max_abs_diff']
        if not err <= 0.05:
            raise AssertionError(f'K3 chain_experiment {tuple(row["shape"])} '
                                 f'k={k}: max abs err {err} > 0.05')
        max_err = max(max_err, err)
        log(f'K3 chain_experiment {tuple(row["shape"])} bf16 k={k}: max abs '
            f'err {err:.4g} (<= 0.05)')
        nbytes = 2 * bsz * h * wd * c * 2 + k * 2 * 9 * c * c * 2 + k * 2 * c * 4
        ops = 2.0 * k * (h * wd * 9 * c * c * 2) * bsz
        b_ms, b_by = bound(nbytes, ops, BF16_OPS_PER_S)
        ms = row['kernel']['ms']
        log(f'K3 time {tuple(row["shape"])} bf16 k={k}: kernel {ms:.4f} ms, '
            f'plain {row["plain"]["ms"]:.4f} ms, cuDNN chain '
            f'{row["library"]["ms"]:.4f} ms, bound {b_ms:.4f} ms ({b_by}, '
            f'bf16 tensor cores); kernel {row["kernel"]["tflops"]:.1f} '
            f'TFLOP/s, {100 * row["kernel"]["mfu_vs_bf16_peak"]:.1f}% of the '
            f'bf16 peak; cuDNN chain {row["library"]["tflops"]:.1f} TFLOP/s')
        if rec is None:
            rec = {'ms': ms, 'plain_ms': row['plain']['ms'],
                   'bound_ms': b_ms, 'bound_by': b_by,
                   'library_ms': row['library']['ms']}
    # what bounds the kernel: cycles per wgmma on each SM, at the clock the
    # card ran during a second of back-to-back calls at batch 256
    w, b = bc.make_test_chain(gen, k=4, device=DEVICE)
    x = (0.5 * torch.randn((256, 64, 64, 32), generator=gen, device=DEVICE)
         ).to(torch.bfloat16)
    mhz = sm_clock_mhz_during(bc.branch_chain, (x, w, b))
    tiles = 256 * -(-64 // bc._TILE_H) * -(-64 // bc._TILE_W)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    # the busiest SM's count: 4 launches of ceil(tiles / n_sm) tiles, each
    # 20 M tiles of 9 taps x 2 K steps.  The time also holds the weight
    # loads and the gaps between launches, so the cycles are an upper
    # estimate of one wgmma's
    per_sm = 4 * -(-tiles // n_sm) * (bc._H_MTILES + bc._O_MTILES) * 9 * 2
    cycles = ('not measured' if mhz is None else
              f'{rec["ms"] * 1e-3 * mhz * 1e6 / per_sm:.1f}')
    log(f'K3 at batch 256: SM clock {mhz} MHz, {per_sm} wgmma m64n32k16 on '
        f'the busiest SM, at most {cycles} cycles each (16 at the '
        f'tensor-core peak; 24 if bound by its 3 KB of shared-memory reads '
        f'at 128 B per cycle)')
    log(f'K3 main path chain_experiment(batch 256, 512): {launches} '
        f'launches; phase {time.perf_counter() - t0:.1f} s')
    return {'name': 'branch_chain', 'route': 'cuda',
            'source': 'esa_pose_estimation_tpu_torch/csrc/branch_chain.cu',
            'replaces':
                'esa_pose_estimation_tpu/experimental/branch_chain.py:108',
            'launches': launches, 'max_abs_err': max_err, **rec}


def _with_flag(owner, flag: str, value: bool, fn, *args):
    setattr(owner, flag, value)
    try:
        with torch.no_grad():
            return fn(*args)
    finally:
        setattr(owner, flag, False)


def phase_levers(model, pts, s, base) -> None:
    """The frames of phase 5 with each experimental lever on in turn.
    MERGED_FUSE and NHWC_DECODE are exact rewrites: the heatmaps may move
    by bf16 rounding only (rtol/atol 0.05) and the median stays <= 0.01.
    INT8_SERVING is reported; a non-finite pose fails.  Each lever's stage
    (the forward of the frames' crops, or the decode) is timed on and off
    in turns."""
    from esa_pose_estimation_tpu_torch.eval.speed_score import (
        speed_score_from_matrices,
    )
    from esa_pose_estimation_tpu_torch.models import hrnet, layers
    from esa_pose_estimation_tpu_torch.ops import crop, peak
    from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
        peak_decode,
    )
    from esa_pose_estimation_tpu_torch.utils.timing import paired_ms
    t0 = time.perf_counter()
    crops, _, _ = crop.crop_resize(s.image, s.bbox, 128,
                                   img_w=s.image.shape[2],
                                   img_h=s.image.shape[1])
    x = crop.normalize(crops)[..., None]
    for flag, owner, exact, stage, arg in (
            ('MERGED_FUSE', hrnet, True, model, x),
            ('NHWC_DECODE', peak, True, peak.decode_heatmaps_auto_nhwc,
             base.heatmaps),
            ('INT8_SERVING', layers, False, model, x)):
        peak_decode.launches = 0
        t1 = time.perf_counter()
        out = _with_flag(owner, flag, True, serve, model, s, pts)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        launches = peak_decode.launches
        if not (bool(torch.isfinite(out.R).all())
                and bool(torch.isfinite(out.trans).all())):
            raise AssertionError(f'{flag}: non-finite pose')
        hm_diff = float((out.heatmaps - base.heatmaps).abs().max())
        ang = _angles(base.R, out.R)
        dt = ((base.trans - out.trans).norm(dim=-1)
              / base.trans.norm(dim=-1))
        med = statistics.median(speed_score_from_matrices(
            out.R, out.trans, s.quat, s.trans).speed.cpu().tolist())
        on_ms, off_ms = paired_ms(
            lambda a: _with_flag(owner, flag, True, stage, a),
            lambda a: _with_flag(owner, flag, False, stage, a), [(arg,)])
        what = 'decode' if stage is not model else 'forward'
        log(f'lever {flag}: heatmaps moved max {hm_diff:.4g}; poses moved '
            f'median {float(ang.median()):.3g} rad / max '
            f'{float(ang.max()):.3g} rad, translation rel max '
            f'{float(dt.max()):.3g}; SPEED median {med:.5f}; K1 launches '
            f'{launches}; {secs:.2f} s for {s.quat.shape[0]} frames; batch '
            f'{s.quat.shape[0]} {what} {on_ms:.3f} ms on, {off_ms:.3f} ms off')
        if exact:
            if not torch.allclose(out.heatmaps, base.heatmaps, rtol=0.05,
                                  atol=0.05):
                raise AssertionError(f'{flag}: heatmaps moved {hm_diff}')
            if not med <= 0.01:
                raise AssertionError(f'{flag}: SPEED median {med} > 0.01')
    log(f'levers: phase {time.perf_counter() - t0:.1f} s')


def phase_eval() -> None:
    """The held-out evaluation on the r5 artifact, 128 frames, plain and
    with --int8; the plain median must be <= 0.01."""
    from esa_pose_estimation_tpu_torch.cli import eval_synthetic
    t0 = time.perf_counter()
    plain = eval_synthetic.main(['--artifact', ARTIFACT])
    int8 = eval_synthetic.main(['--artifact', ARTIFACT, '--int8'])
    log(f'eval plain: {json.dumps(plain)}')
    log(f'eval int8: {json.dumps(int8)}')
    if plain['median'] is None or not plain['median'] <= 0.01:
        raise AssertionError(f'eval: median {plain["median"]} > 0.01')
    log(f'eval: phase {time.perf_counter() - t0:.1f} s')


class PlantedDetector(torch.nn.Module):
    """What a perfect detector would output: the detection targets of the
    frames' true boxes (pooled by ``downscale``) on the grid that four
    stride-2 convs give (19x30 for 300x480), the heatmap as logits."""

    def __init__(self, boxes: torch.Tensor, downscale: int = 4):
        super().__init__()
        self.boxes, self.downscale = boxes, downscale

    def forward(self, x: torch.Tensor) -> dict:
        from esa_pose_estimation_tpu_torch.models.detector import (
            detection_targets,
        )
        hs, ws = x.shape[1:3]
        for _ in range(4):
            hs, ws = (hs + 1) // 2, (ws + 1) // 2
        t = detection_targets(self.boxes / self.downscale, (hs, ws), 16)
        h = t['heatmap']
        logit = torch.log(torch.clamp(h, min=1e-6)
                          / torch.clamp(1 - h, min=1e-6))
        return {'heatmap': logit, 'offset': t['offset'], 'size': t['size']}


def phase_planted(model, pts):
    """11a: 64 frames through ``detect_and_infer`` with the planted
    detector and the r5 net; returns K1's launches in that call and the
    frames (sample) for the commands of 11c."""
    from esa_pose_estimation_tpu_torch import pipeline
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.eval.speed_score import (
        speed_score_from_matrices,
    )
    from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
        peak_decode,
    )
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    s = synthetic.make_sample(gen, pts, 64)
    det = PlantedDetector(s.bbox)
    boxes, scores = pipeline.detect_frames(det, s.image)
    err = float((boxes - s.bbox).abs().max())
    fallback = int((scores <= 0.05).sum())
    log(f'two-stage planted: boxes within {err:.4g} px of the truth (limit '
        f'64), {fallback} full-frame fallbacks (limit 0), lowest score '
        f'{float(scores.min()):.6f}')
    if not err <= 64 or fallback:
        raise AssertionError(f'two-stage planted: box error {err}, '
                             f'{fallback} fallbacks')
    peak_decode.launches = 0
    out = pipeline.detect_and_infer(
        det, model, s.image, pts,
        torch.Generator(device=DEVICE).manual_seed(SEED + 3), **SERVE_KW)
    torch.cuda.synchronize()
    launches = peak_decode.launches
    if launches < 1:
        raise AssertionError('two-stage planted: detect_and_infer launched '
                             'no K1 kernel')
    sc = speed_score_from_matrices(out.R, out.trans, s.quat,
                                   s.trans).speed.cpu().tolist()
    med = statistics.median(sc)
    log(f'two-stage planted: detect_and_infer on {len(sc)} frames, K1 '
        f'launches {launches}, SPEED median {med:.5f} mean '
        f'{statistics.fmean(sc):.5f} worst {max(sc):.5f} (median limit 0.01)')
    if not med <= 0.01:
        raise AssertionError(f'two-stage planted: SPEED median {med} > 0.01')
    return launches, s


# the seeded detector's maps on the card against the CPU: f32 both (the
# port keeps TF32 off), convolutions summed in other orders
DET_RTOL, DET_ATOL, DET_BOX_PX = 1e-3, 1e-3, 1.0
# (batch, timed calls) of the two-stage timing
TWO_STAGE_RUNS = ((1, 5), (256, 3))


def phase_seeded(model, pts) -> None:
    """11b: a seeded TinyDetector (width 32, stride 16, downscale 4) on
    the card against the same weights on the CPU; then detect_and_infer
    timed at batch 1 and 256 beside the detect stage alone, one batch-256
    call profiled, and the host-to-device copy of the uint8 frames."""
    import copy

    from esa_pose_estimation_tpu_torch import pipeline
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.models.detector import (
        TinyDetector,
        decode_detections,
    )
    det_cpu = TinyDetector(width=32, stride=16).init_weights(
        torch.Generator().manual_seed(SEED + 9)).eval()
    det = copy.deepcopy(det_cpu).to(DEVICE, memory_format=torch.channels_last)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    s = synthetic.make_sample(gen, pts, 16)
    # sensor-like noise, so that no two cells of the maps tie exactly
    noisy = torch.clamp(s.image + 8.0 * torch.rand(s.image.shape,
                                                   generator=gen,
                                                   device=DEVICE), 0, 255)
    top = max(b for b, _ in TWO_STAGE_RUNS)
    frames = noisy.to(torch.uint8).repeat(-(-top // 16), 1, 1)[:top]
    f4 = frames[:4]
    with torch.no_grad():
        x = pipeline.downsample_frames(f4, 4)[..., None]
        got = det(x)
        want = det_cpu(x.cpu())
    worst = 0.0
    for k in ('heatmap', 'offset', 'size'):
        g, w = got[k].cpu(), want[k]
        worst = max(worst, float((g - w).abs().max()))
        if not torch.allclose(g, w, rtol=DET_RTOL, atol=DET_ATOL):
            raise AssertionError(f'seeded detector {k}: card and CPU differ '
                                 f'by {float((g - w).abs().max())}')
    b_card, s_card = pipeline.detect_frames(det, f4)
    b_cpu, s_cpu = pipeline.detect_frames(det_cpu, f4.cpu())
    box_err = float((b_card.cpu() - b_cpu).abs().max())
    valid_same = torch.equal(s_card.cpu() > 0.05, s_cpu > 0.05)
    # seeded weights may leave every score under detect_frames' 0.05 (a
    # full-frame fallback); the decode's top 8 boxes at threshold 0 are
    # compared too, scaled to full-frame pixels
    top_card = decode_detections(got, 16, score_threshold=0.0,
                                 max_outputs=8)
    top_cpu = decode_detections(want, 16, score_threshold=0.0,
                                max_outputs=8)
    top_err = 4.0 * float((top_card[0].cpu() - top_cpu[0]).abs().max())
    top_same = torch.equal(top_card[2].cpu(), top_cpu[2])
    log(f'seeded detector on 4 frames (maps {tuple(got["heatmap"].shape)}): '
        f'maps max abs diff card vs CPU {worst:.3g} (rtol {DET_RTOL}, atol '
        f'{DET_ATOL}); detect_frames boxes max diff {box_err:.4g} px, valid '
        f'flags equal {valid_same}, scores {s_card.cpu().tolist()}; top-8 '
        f'boxes at threshold 0 max diff {top_err:.4g} px, valid flags equal '
        f'{top_same} (limit {DET_BOX_PX} px)')
    if not (box_err <= DET_BOX_PX and top_err <= DET_BOX_PX and valid_same
            and top_same):
        raise AssertionError(f'seeded detector: boxes differ by {box_err} '
                             f'and {top_err} px, valid flags equal '
                             f'{valid_same} and {top_same}')

    rgen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    check_no_host_wait('two-stage', lambda: pipeline.detect_and_infer(
        det, model, frames[:16], pts, rgen))
    for batch, iters in TWO_STAGE_RUNS:
        f = frames[:batch].contiguous()
        pipeline.detect_and_infer(det, model, f, pts, rgen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            pipeline.detect_and_infer(det, model, f, pts, rgen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        t1 = time.perf_counter()
        for _ in range(iters):
            pipeline.detect_frames(det, f)
        torch.cuda.synchronize()
        d_ms = (time.perf_counter() - t1) / iters * 1e3
        log(f'two-stage throughput: batch {batch}: {batch * iters / dt:.1f} '
            f'img/s ({dt / iters * 1e3:.1f} ms per detect_and_infer call; '
            f'detect_frames alone {d_ms:.2f} ms per call)')
    profile_call(lambda: pipeline.detect_and_infer(det, model, frames, pts,
                                                   rgen),
                 'profile two-stage', top=6)

    host = frames.cpu()
    pinned = host.pin_memory()
    for label, src in (('pageable', host), ('pinned', pinned)):
        src.to(DEVICE, non_blocking=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            src.to(DEVICE, non_blocking=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        log(f'host to device, {top} uint8 frames ({host.numel() / 1e6:.0f} '
            f'MB) from {label} memory: {ms:.1f} ms, '
            f'{host.numel() / ms / 1e6:.1f} GB/s (not in the device stages)')
    del host, pinned, frames
    torch.cuda.empty_cache()


def phase_commands(s, pts) -> None:
    """11c: the frames of 11a as a labelled PNG + pickle split in a
    temporary directory; cli.submit and cli.evaluate on the r5 artifact."""
    import csv

    from esa_pose_estimation_tpu_torch.cli import evaluate, submit
    t0 = time.perf_counter()
    n = s.image.shape[0]
    with tempfile.TemporaryDirectory() as root:
        write_split(s, pts, root)
        t_write = time.perf_counter() - t0
        common = ['--artifact', ARTIFACT, '--test-pkl', f'{root}/split.pkl',
                  '--image-root', root, '--workdir', root]
        t1 = time.perf_counter()
        path = submit.main(common + ['--suffix', 'smoke'])
        t_submit = time.perf_counter() - t1
        with open(path) as f:
            rows = list(csv.reader(f))
        names = [r[0] for r in rows]
        values = [float(v) for r in rows for v in r[1:]]
        if not (len(rows) == n and all(len(r) == 8 for r in rows)
                and names == sorted(names)
                and all(math.isfinite(v) for v in values)):
            raise AssertionError(f'submit: {len(rows)} rows, not {n} finite '
                                 'rows of 8 fields in filename order')
        t1 = time.perf_counter()
        res = evaluate.main(common)
        t_eval = time.perf_counter() - t1
    log(f'commands: submit wrote {n} rows of 8 finite fields in filename '
        f'order ({t_submit:.1f} s); evaluate {json.dumps(res)} ({t_eval:.1f} s; '
        f'limits speed 0.02, nonfinite 0); split written in {t_write:.1f} s')
    if not (res['speed'] <= 0.02 and res['nonfinite'] == 0):
        raise AssertionError(f'evaluate: {res}')


# phase 12 (a): one f32 train step of hrnet_tiny, card against CPU
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_STAT_TOL = 1e-5, 1e-4, 1e-5
# (batch, warm-up steps, timed steps) of the full-width throughput
TRAIN_RUNS = ((32, 2, 8), (256, 2, 4))
FINETUNE_STEPS, FINETUNE_BATCH = 60, 32
# the held-out frames of cli.eval_synthetic (its --seed, its batch)
EVAL_SEED, EVAL_BATCH, EVAL_FRAMES = 991, 32, 128
TRAIN_PHASES = ('forward', 'backward', 'optimizer')


def train_serving_form(s, pts) -> None:
    """12e: the r5 weights as f32 masters and in the loader's stored-bf16
    serving form serve phase 5's frames with the same heatmaps."""
    from esa_pose_estimation_tpu_torch.cli.mfu_experiments import r5_masters
    from esa_pose_estimation_tpu_torch.utils.artifact import (
        load_hrnet_artifact,
    )
    masters = r5_masters(DEVICE).eval()
    serving = load_hrnet_artifact(ARTIFACT, dtype=torch.bfloat16,
                                  device=DEVICE)
    if masters.stem_conv1.weight.dtype != torch.float32:
        raise AssertionError('train: the masters are not f32')
    a, b = serve(masters, s, pts), serve(serving, s, pts)
    diff = float((a.heatmaps.float() - b.heatmaps.float()).abs().max())
    if torch.equal(a.heatmaps, b.heatmaps):
        log(f'train serving form: r5 as f32 masters and as stored bf16 give '
            f'equal heatmaps on {s.image.shape[0]} frames (torch.equal)')
        return
    log(f'train serving form: heatmaps differ by {diff:.4g} (limit 1e-2): '
        'the two models feed cuDNN the same bf16 operands, so a difference '
        'is a change of algorithm between the calls')
    if not diff <= 1e-2:
        raise AssertionError(f'train serving form: heatmaps moved {diff}')


def train_card_vs_cpu() -> None:
    """12a: one f32 train step of hrnet_tiny from the same weights and
    batch on the card and on the CPU (TF32 off)."""
    import copy

    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
    from esa_pose_estimation_tpu_torch.train import state as tstate
    from esa_pose_estimation_tpu_torch.utils import config
    cfg = config.TrainConfig(batch_size=8, crop_size=64)
    lr = cfg.lr_values[0]
    cpu = HRNet(config.hrnet_tiny()).init_weights(
        torch.Generator().manual_seed(SEED + 20))
    card = copy.deepcopy(cpu).to(DEVICE, memory_format=torch.channels_last)
    gen = torch.Generator().manual_seed(SEED + 21)
    batch = synthetic.make_batch(gen, 8, synthetic.spacecraft_points(n=6),
                                 crop_size=64)
    # standard-normal images: on the synthetic crops' flat ground a
    # channel's mean is tens of times its spread, and the fast variance
    # mean(x^2) - mean(x)^2 would multiply the two sums' rounding by
    # mean^2/var
    batch = {'image': torch.randn(batch['image'].shape, generator=gen),
             'heatmaps': batch['heatmaps'], 'weights': batch['weights']}
    m_cpu = tstate.train_step(tstate.create_train_state(cpu, cfg), batch)
    m_card = tstate.train_step(tstate.create_train_state(card, cfg),
                               {k: v.to(DEVICE) for k, v in batch.items()})
    loss_rel = abs(float(m_card['loss']) / float(m_cpu['loss']) - 1.0)
    gn_rel = abs(float(m_card['grad_norm']) / float(m_cpu['grad_norm'])
                 - 1.0)
    sd_cpu, sd_card = cpu.state_dict(), card.state_dict()
    stat_err = param_err = 0.0
    stats_ok = True
    for k, v in sd_cpu.items():
        w = sd_card[k].cpu()
        err = float((w - v).abs().max())
        if k.endswith(('running_mean', 'running_var')):
            stat_err = max(stat_err, err)
            stats_ok &= torch.allclose(w, v, rtol=TRAIN_STAT_TOL,
                                       atol=TRAIN_STAT_TOL)
        else:
            param_err = max(param_err, err)
    log(f'train card vs CPU (hrnet_tiny f32, batch 8 at 64x64): loss '
        f'{float(m_card["loss"]):.7g} rel diff {loss_rel:.3g} (limit '
        f'{TRAIN_LOSS_RTOL}); grad_norm rel diff {gn_rel:.3g} (limit '
        f'{TRAIN_GNORM_RTOL}); running statistics max diff {stat_err:.3g} '
        f'(rtol/atol {TRAIN_STAT_TOL}); parameters max diff {param_err:.3g} '
        f'(limit lr {lr})')
    if not (loss_rel <= TRAIN_LOSS_RTOL and gn_rel <= TRAIN_GNORM_RTOL
            and stats_ok and param_err <= lr):
        raise AssertionError('train: card and CPU steps disagree')


def conv_flops_per_image(model) -> float:
    """The forward's convolution FLOPs per image, from the shapes of one
    batch-1 forward (2 per multiply-add)."""
    from esa_pose_estimation_tpu_torch.models.layers import Conv
    total = [0]

    def hook(mod, inp, out):
        total[0] += 2 * out.numel() * mod.weight[0].numel()
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, Conv)]
    was_training = model.training
    model.eval()
    with torch.no_grad():
        model(torch.zeros((1, 128, 128, 1), device=DEVICE))
    model.train(was_training)
    for h in handles:
        h.remove()
    return float(total[0])


def phased_step(st, batch) -> None:
    """``train.state.train_step``'s operations, with a synchronize closing
    each phase inside its range: the profile's CPU ranges then bound each
    phase's kernels."""
    from torch.profiler import record_function

    from esa_pose_estimation_tpu_torch.train import state as tstate
    from esa_pose_estimation_tpu_torch.train.loss import (
        weighted_heatmap_loss,
    )
    model, opt = st.model, st.optimizer
    model.train()
    with record_function('forward'), tstate.deterministic_cudnn():
        loss = weighted_heatmap_loss(model(batch['image']),
                                     batch['heatmaps'], batch['weights'])
        torch.cuda.synchronize()
    with record_function('backward'), tstate.deterministic_cudnn():
        opt.zero_grad(set_to_none=True)
        loss.backward()
        tstate.global_norm([p.grad for p in model.parameters()
                            if p.grad is not None])
        torch.cuda.synchronize()
    with record_function('optimizer'):
        for group in opt.param_groups:
            group['lr'] = st.schedule(st.step)
        opt.step()
        st.step += 1
        torch.cuda.synchronize()


def profile_train(st, batch) -> None:
    """One batch-256 train_step under torch.profiler: kernels, kernel time,
    the device's idle share; then one phased step for the time and
    launches of forward, backward and optimizer."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from esa_pose_estimation_tpu_torch.train import state as tstate
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tstate.train_step(st, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log('profile train: the profiler recorded no device time (not '
            'measured)')
        return
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    log(f'profile train step batch 256: wall {wall_ms:.1f} ms under the '
        f'profiler, {len(kernels)} kernels, {busy:.1f} ms of kernel time, '
        f'device idle share {1 - busy / wall_ms:.3f}')
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    for name, times in sorted(by_name.items(),
                              key=lambda kv: -sum(kv[1]))[:6]:
        log(f'profile train kernel {sum(times) / 1e3:8.2f} ms '
            f'{len(times):5d}x {name[:90]}')
    with profile(activities=acts) as prof:
        phased_step(st, batch)
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in TRAIN_PHASES]
    for name in TRAIN_PHASES:
        rngs = [e.time_range for e in events
                if e.name == name and e.device_type == DeviceType.CPU]
        if not rngs:
            log(f'profile train phase {name}: no range recorded (not '
                'measured)')
            continue
        lo, hi = min(r.start for r in rngs), max(r.end for r in rngs)
        inside = [e for e in kernels if lo <= e.time_range.start < hi]
        ms = sum(e.time_range.elapsed_us() for e in inside) / 1e3
        log(f'profile train phase {name}: host {(hi - lo) / 1e3:.2f} ms '
            f'(synchronized), kernels {ms:.2f} ms in {len(inside)} '
            'launches')


def repair_cost(st, batches, iters: int) -> dict[str, float]:
    """12b: ms per eager step with each half of fault 4's repair on and
    off: the half-pixel resize's own backward or ``F.interpolate``'s
    (which adds with atomics), cuDNN's deterministic algorithms or its
    free choice; each of the four run twice, in the order ABCD DCBA.
    Returns the mean of each, keyed 'resize/cudnn' with 'port' or
    'interpolate' and 'det' or 'free'."""
    import contextlib

    from esa_pose_estimation_tpu_torch.cli.mfu_experiments import (
        _free_cudnn,
        _interpolate_backward,
    )
    from esa_pose_estimation_tpu_torch.train import state as tstate

    def run(port: bool, det: bool) -> float:
        with (contextlib.nullcontext() if port
              else _interpolate_backward()), (
                contextlib.nullcontext() if det else _free_cudnn()):
            tstate.train_step(st, batches[0])    # cuDNN's choice, untimed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(iters):
                tstate.train_step(st, batches[i % 2])
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3
    order = [(p, d) for p in (True, False) for d in (True, False)]
    runs: dict[tuple, list[float]] = {k: [] for k in order}
    for key in order + order[::-1]:
        runs[key].append(run(*key))
    return {f'{"port" if p else "interpolate"}/{"det" if d else "free"}':
            statistics.mean(v) for (p, d), v in runs.items()}


def train_throughput(pts) -> dict[int, float]:
    """12b: full width from r5 (bf16 compute, f32 masters): steps/s,
    images/s, peak memory and share of the bf16 peak at batch 32 and 256,
    then the profile of a batch-256 step.  Returns images/s by batch."""
    from esa_pose_estimation_tpu_torch.cli.mfu_experiments import r5_masters
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.train import state as tstate
    from esa_pose_estimation_tpu_torch.utils import config
    model = r5_masters(DEVICE)
    fwd = conv_flops_per_image(model)
    log(f'train: hrnet_esa forward {fwd / 1e9:.2f} GFLOP of convolutions '
        f'per image, a step about 3x: {3 * fwd / 1e9:.1f} GFLOP per image')
    st = tstate.create_train_state(model, config.TrainConfig())
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 22)
    rates = {}
    for batch, warm, iters in TRAIN_RUNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batches = [synthetic.make_batch(gen, batch, pts) for _ in range(2)]
        torch.cuda.synchronize()
        make_ms = (time.perf_counter() - t0) / 2 * 1e3
        torch.cuda.reset_peak_memory_stats()
        for i in range(warm):
            tstate.train_step(st, batches[i % 2])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            m = tstate.train_step(st, batches[i % 2])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not math.isfinite(float(m['loss'])):
            raise AssertionError(f'train: loss {float(m["loss"])} at batch '
                                 f'{batch}')
        share = 3 * fwd * batch / dt / BF16_OPS_PER_S
        rates[batch] = batch / dt
        log(f'train throughput: batch {batch}: {1 / dt:.2f} steps/s, '
            f'{batch / dt:.1f} img/s ({dt * 1e3:.1f} ms per step), peak '
            f'memory {peak:.2f} GiB, {100 * share:.2f}% of the bf16 peak; '
            f'make_batch {make_ms:.1f} ms (not in the step)')
        cost = repair_cost(st, batches, max(2, iters // 2))
        log(f'train fault 4 repair at batch {batch}: ms per eager step '
            f'with the resize\'s backward (port: tent products; '
            f'interpolate: F.interpolate\'s atomics) and cuDNN '
            f'(det: deterministic algorithms; free: its choice) '
            f'{json.dumps({k: round(v, 1) for k, v in cost.items()})}; '
            f'the repair is port/det; {max(2, iters // 2)} steps a run, '
            f'each twice in the order ABCD DCBA')
        if batch == TRAIN_RUNS[0][0]:
            sites = sync_sites(lambda: tstate.train_step(st, batches[0]))
            log(f'train step batch {batch}: {sum(sites.values())} '
                f'synchronizing operations {sites}')
        if batch == TRAIN_RUNS[-1][0]:
            profile_train(st, batches[0])
        del batches
    del st, model
    torch.cuda.empty_cache()
    return rates


def held_out_batches(pts) -> list[dict]:
    """The 128 frames of phase 10 (cli.eval_synthetic's generators) as
    frame-carrying batches."""
    from esa_pose_estimation_tpu_torch.data import synthetic
    out = []
    for i in range(-(-EVAL_FRAMES // EVAL_BATCH)):
        g = torch.Generator(device=DEVICE).manual_seed(
            EVAL_SEED * 100_003 + i)
        s = synthetic.make_sample(g, pts, EVAL_BATCH)
        out.append({'frame': s.image, 'bbox': s.bbox, 'quat': s.quat,
                    'trans': s.trans, 'keypoints_2d': s.keypoints_2d})
    return out


def evaluate_with_medians(model, cache, pts) -> tuple[dict, float, int]:
    """cli.evaluate.evaluate on the cache; returns its result, the median
    of its per-frame SPEED scores (finite frames) and K1's launches in
    the call."""
    from esa_pose_estimation_tpu_torch.cli import evaluate as evaluate_mod
    from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
        peak_decode,
    )
    real = evaluate_mod.speed_score_from_matrices
    frames = []

    def recording(*args):
        sc = real(*args)
        frames.append(sc.score_t + sc.score_r)
        return sc
    evaluate_mod.speed_score_from_matrices = recording
    try:
        model.eval()
        peak_decode.launches = 0
        res = evaluate_mod.evaluate(
            model, cache, pts, torch.Generator(device=DEVICE).manual_seed(
                SEED + 24))
        torch.cuda.synchronize()
        launches = peak_decode.launches
    finally:
        evaluate_mod.speed_score_from_matrices = real
    sc = torch.cat(frames).cpu()
    sc = sc[torch.isfinite(sc)]
    med = float(sc.median()) if sc.numel() else math.inf
    return res, med, launches


def train_finetune(pts) -> int:
    """12c: a short fine-tune from r5 with --augment-photo at the
    schedule's second rate, then the in-train evaluate on the 128 held-out
    frames of phase 10, before and after.  Returns K1's launches in the
    evaluation after."""
    from esa_pose_estimation_tpu_torch.cli.mfu_experiments import r5_masters
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.eval.eval_cache import EvalCache
    from esa_pose_estimation_tpu_torch.experimental.branch_chain import (
        branch_chain,
    )
    from esa_pose_estimation_tpu_torch.experimental.cbam_fuse import (
        fused_cbam,
    )
    from esa_pose_estimation_tpu_torch.train import state as tstate
    from esa_pose_estimation_tpu_torch.utils import config
    model = r5_masters(DEVICE)
    t0 = time.perf_counter()
    cache = EvalCache(model, held_out_batches(pts), pts)
    before, med0, _ = evaluate_with_medians(model, cache, pts)
    # a boundary at epoch 0 applies the schedule's second value from the
    # first step: lr_values[1] = 1e-5
    cfg = config.TrainConfig(lr_boundaries=(0, 100, 170))
    st = tstate.create_train_state(model, cfg, FINETUNE_STEPS)
    lr = st.schedule(0)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
    fused_cbam.launches = branch_chain.launches = 0
    t1 = time.perf_counter()
    losses = torch.stack([
        tstate.train_step(st, synthetic.make_batch(
            gen, FINETUNE_BATCH, pts, augment_photo=True))['loss']
        for _ in range(FINETUNE_STEPS)]).cpu()
    t_train = time.perf_counter() - t1
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f'train fine-tune: non-finite loss {losses}')
    if fused_cbam.launches or branch_chain.launches:
        raise AssertionError('train fine-tune: K2 or K3 launched in train '
                             'mode')
    after, med, launches = evaluate_with_medians(model, cache, pts)
    n_batches = len(cache.batches)
    log(f'train fine-tune: {FINETUNE_STEPS} steps at batch '
        f'{FINETUNE_BATCH}, lr {lr:g}, --augment-photo, {t_train:.1f} s '
        f'with batch building; loss first {float(losses[0]):.5f} last '
        f'{float(losses[-1]):.5f}, all finite')
    log(f'train fine-tune eval on {cache.n_frames} held-out frames: before '
        f'median {med0:.5f} speed {before["speed"]:.5f}; after median '
        f'{med:.5f} (limit 0.01) speed {after["speed"]:.5f} score_t '
        f'{after["score_t"]:.5f} score_r {after["score_r"]:.5f} pix_err '
        f'{after["pix_err"]:.3f} nonfinite {after["nonfinite"]}; K1 '
        f'launches {launches} in {n_batches} batches; '
        f'{time.perf_counter() - t0:.1f} s')
    if not med <= 0.01:
        raise AssertionError(f'train fine-tune: held-out median {med}')
    if launches < n_batches:
        raise AssertionError(f'train fine-tune: K1 launched {launches} times '
                             f'in {n_batches} eval batches')
    del st, model, cache
    torch.cuda.empty_cache()
    return launches


def train_commands() -> None:
    """12d: cli.train --tiny on the card, then cli.eval_synthetic and the
    artifact export on its checkpoint."""
    import tempfile

    from esa_pose_estimation_tpu_torch.cli import eval_synthetic, train
    from esa_pose_estimation_tpu_torch.utils import artifact
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        wd = f'{root}/run'
        train.main(['--workdir', wd, '--tiny', '--epochs', '2',
                    '--synthetic-size', '64', '--batch-size', '16',
                    '--eval-every', '1', *panel_args()])
        t_train = time.perf_counter() - t0
        ckpts = set(Path(wd, 'net_esa').iterdir())
        names = {p.name for p in ckpts}
        with open(f'{wd}/events.jsonl') as f:
            events = [json.loads(line)['event'] for line in f]
        rows = Path(wd, 'log_esa.txt').read_text().strip().split('\n')
        if not ({'last', 'best_tran', 'best_rotate'} <= names
                and 'eval' in events and len(rows) == 3):
            raise AssertionError(f'cli.train: checkpoints {sorted(names)}, '
                                 f'events {events}, log rows {len(rows)}')
        rec = eval_synthetic.main(['--workdir', wd, '--checkpoint',
                                   'best_rotate', '--tiny', '--frames', '16',
                                   '--batch-size', '16'])
        if rec['frames'] + rec['nonfinite_frames'] != 16:
            raise AssertionError(f'eval_synthetic on the checkpoint: {rec}')
        npz = f'{root}/tiny.npz'
        artifact.main(['--workdir', wd, '--out', npz, '--tiny'])
        served = artifact.load_hrnet_artifact(npz, device=DEVICE)
        with torch.no_grad():
            hm = served(torch.zeros((1, 128, 128, 1), device=DEVICE))
        if hm.shape != (1, 128, 128, 6) or not bool(torch.isfinite(hm).all()):
            raise AssertionError(f'exported artifact: heatmaps {hm.shape}')
    log(f'train commands: cli.train --tiny 2 epochs in {t_train:.1f} s wrote '
        f'{sorted(names)}, log rows {rows[1:]}, events {events}; '
        f'eval_synthetic --checkpoint best_rotate {json.dumps(rec)}; '
        f'export loaded by load_hrnet_artifact; '
        f'{time.perf_counter() - t0:.1f} s')


def phase_train(s, pts) -> tuple[int, dict[int, float]]:
    """12: training.  Returns K1's launches in the fine-tune's in-train
    evaluation and 12b's images/s by batch."""
    t0 = time.perf_counter()
    train_serving_form(s, pts)
    train_card_vs_cpu()
    rates = train_throughput(pts)
    launches = train_finetune(pts)
    train_commands()
    log(f'train: phase {time.perf_counter() - t0:.1f} s')
    return launches, rates


# phase 13: the JAX round-5 recipe of runs/det_robust_r5 (QUALITY.md)
DETECTOR_RECIPE = ('--downscale', '8', '--epochs', '16', '--steps-per-epoch',
                   '50', '--batch-size', '16', '--augment')
# the JAX package's round-5 detector on a TPU v5e (QUALITY.md): quality
# figures of the reference, printed beside the port's, not speed targets
JAX_R5_IOU, JAX_R5_PERTURBED_IOU = 0.812, 0.807
DETECT_RATE_MIN = 0.95          # the JAX round-4 gate (QUALITY.md)


def two_stage_rate(det, model, frames, pts, downscale: int, iters: int = 3
                   ) -> float:
    """Images/s of detect_and_infer on ``frames`` (after a warm-up)."""
    from esa_pose_estimation_tpu_torch import pipeline
    rgen = torch.Generator(device=DEVICE).manual_seed(SEED + 31)

    def call():
        return pipeline.detect_and_infer(det, model, frames, pts, rgen,
                                         detector_downscale=downscale)
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    torch.cuda.synchronize()
    return frames.shape[0] * iters / (time.perf_counter() - t0)


def phase_detector(model, pts) -> int:
    """13: cli.train_detector at the JAX round-5 recipe on the card (no
    fallback: the run, its checkpoint and its gates must all hold), then
    cli.eval_synthetic --detector-workdir on the 128 held-out frames, and
    detect_and_infer at batch 256 with the trained weights and with seeded
    ones, in turns.  Returns K1's launches in that eval."""
    import tempfile

    from esa_pose_estimation_tpu_torch.cli import eval_synthetic
    from esa_pose_estimation_tpu_torch.cli import train_detector
    from esa_pose_estimation_tpu_torch.cli.mfu_experiments import StepRoutes
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.models.detector import TinyDetector
    from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
        peak_decode,
    )
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        wd = f'{root}/det'
        with StepRoutes() as routes:
            res = train_detector.main(['--workdir', wd, *DETECTOR_RECIPE])
        t_train = time.perf_counter() - t0
        with open(f'{wd}/events.jsonl') as f:
            epochs = [json.loads(line) for line in f]
        steps = int(DETECTOR_RECIPE[DETECTOR_RECIPE.index(
            '--steps-per-epoch') + 1])
        train_s = [e['train_seconds'] for e in epochs]
        epoch_s = statistics.median([e['seconds'] for e in epochs])
        losses = [e['loss'] for e in epochs]
        log(f'detector training ({" ".join(DETECTOR_RECIPE)}; width 32, '
            f'stride 16, f32, TF32 off): {len(epochs)} epochs in '
            f'{t_train:.1f} s; seconds per epoch {epoch_s:.2f} '
            f'(median; training alone {statistics.median(train_s):.2f}), '
            f'{1e3 * statistics.median(train_s) / steps:.1f} ms per step '
            f'with the frames rendered and perturbed on the card; loss '
            f'first {losses[0]:.4f} last {losses[-1]:.4f}; '
            f'{routes.check("13 cli.train_detector")}')
        log(f'detector held-out (last epoch, {4 * 16} frames): clean mean '
            f'IoU {res["mean_iou"]:.4f} det@0.5 {res["detect_rate_50"]:.4f} '
            f'det@0.75 {res["detect_rate_75"]:.4f}; perturbed mean IoU '
            f'{res["perturbed_mean_iou"]:.4f} det@0.5 '
            f'{res["perturbed_detect_rate_50"]:.4f} det@0.75 '
            f'{res["perturbed_detect_rate_75"]:.4f} (the JAX package on a '
            f'TPU v5e, a quality figure: IoU {JAX_R5_IOU} clean, '
            f'{JAX_R5_PERTURBED_IOU} perturbed)')
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f'detector training: losses {losses}')
        if not (res['detect_rate_50'] >= DETECT_RATE_MIN
                and res['perturbed_detect_rate_50'] >= DETECT_RATE_MIN):
            raise AssertionError(f'detector training: det@0.5 '
                                 f'{res["detect_rate_50"]} clean, '
                                 f'{res["perturbed_detect_rate_50"]} '
                                 f'perturbed (limit {DETECT_RATE_MIN})')
        peak_decode.launches = 0
        rec = eval_synthetic.main(['--artifact', ARTIFACT,
                                   '--detector-workdir', wd])
        torch.cuda.synchronize()
        launches = peak_decode.launches
        log(f'two-stage eval (trained detector, box x1.1): '
            f'{json.dumps(rec)}; K1 launches {launches}')
        if rec['median'] is None or not rec['median'] <= 0.01 \
                or rec['detector_fallback_frames']:
            raise AssertionError(f'two-stage eval: median {rec["median"]} '
                                 f'(limit 0.01), '
                                 f'{rec["detector_fallback_frames"]} '
                                 'full-frame fallbacks (limit 0)')
        if launches < 1:
            raise AssertionError('two-stage eval: K1 never launched')
        trained, ds = eval_synthetic.load_trained_detector(wd, None, DEVICE)
    seeded = TinyDetector(width=32, stride=16).to(
        DEVICE, memory_format=torch.channels_last).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED + 9)).eval()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 30)
    frames = torch.clamp(synthetic.make_sample(gen, pts, 256).image, 0,
                         255).to(torch.uint8)
    rates = {'seeded': [], 'trained': []}
    for name in ('seeded', 'trained', 'trained', 'seeded'):
        rates[name].append(two_stage_rate(
            trained if name == 'trained' else seeded, model, frames, pts,
            ds))
    log(f'two-stage throughput batch 256 at downscale {ds}: trained '
        f'detector {", ".join(f"{r:.1f}" for r in rates["trained"])} img/s, '
        f'seeded detector {", ".join(f"{r:.1f}" for r in rates["seeded"])} '
        f'img/s (in turns: seeded, trained, trained, seeded)')
    del frames, trained, seeded
    torch.cuda.empty_cache()
    log(f'detector: phase {time.perf_counter() - t0:.1f} s')
    return launches


# phase 14: the shards (records, frames per write batch) and the runs
# (shard, batch, host crop, timed steps)
SHARD_RAW_RECORDS, SHARD_PNG_RECORDS, SHARD_WRITE_BATCH = 512, 256, 16
SHARD_RUNS = (('raw', 32, False, 8), ('raw', 32, True, 8),
              ('raw', 256, False, 3), ('raw', 256, True, 3),
              ('png', 32, False, 6), ('png', 32, True, 6))
# host crop against the device crop, in grey levels (the JAX test's)
HOST_CROP_ATOL = 0.05


def shard_steps(st, path, batch, host_crop, steps):
    """``steps`` train steps (after two untimed ones) from the shard through
    the native loader, pinned host tensors and ``build_shard_batch``:
    images/s, the host's mean wait on the loader per step, the
    host-to-device copy of one batch (synchronized), peak memory and the
    losses."""
    from esa_pose_estimation_tpu_torch.data import pipeline as dp
    from esa_pose_estimation_tpu_torch.data.native_loader import (
        NativeBatchLoader,
    )
    from esa_pose_estimation_tpu_torch.train import state as tstate
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 40)
    loader = NativeBatchLoader(path, batch, n_threads=4, shuffle=True,
                               seed=SEED, crop_size=128 if host_crop
                               else None, device=DEVICE)
    waits, losses = [], []

    def batches():
        while True:                      # epochs, reshuffled
            it = iter(loader)
            while True:
                t = time.perf_counter()
                b = next(it, None)
                waits.append(time.perf_counter() - t)
                if b is None:
                    break
                yield b
    stream = dp.prefetch_to_device(batches(), DEVICE, size=2)
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps + 2):
        if i == 2:
            torch.cuda.synchronize()
            t0, n_wait = time.perf_counter(), len(waits)
        b = dp.build_shard_batch(next(stream), gen, train=True)
        losses.append(tstate.train_step(st, b)['loss'])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    wait_ms = 1e3 * sum(waits[n_wait:]) / steps
    peak = torch.cuda.max_memory_allocated() / 2**30
    host = next(iter(loader))
    nbytes = sum(v.numel() * v.element_size() for v in host.values()
                 if isinstance(v, torch.Tensor))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for v in host.values():
        if isinstance(v, torch.Tensor):
            v.to(DEVICE, non_blocking=True)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t1) * 1e3
    loader.close()
    return {'img_s': batch / dt, 'ms_step': dt * 1e3, 'wait_ms': wait_ms,
            'h2d_ms': h2d_ms, 'h2d_mb': nbytes / 1e6, 'peak_gib': peak,
            'losses': torch.stack(losses).cpu().tolist()}


def check_shard_batches(path, pts) -> None:
    """The shard's first 16 records as the loader gives them (frames, then
    host crops) against the device route on the frames the writer
    rendered: ``build_batch`` on the same uint8 frames, on the card."""
    from esa_pose_estimation_tpu_torch.data import pipeline as dp
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.data.native_loader import (
        NativeBatchLoader,
    )
    from esa_pose_estimation_tpu_torch.utils.seeding import generator
    n = SHARD_WRITE_BATCH
    s = synthetic.make_sample(generator(DEVICE, SEED, 0), pts, n)
    frames = torch.clamp(s.image, 0, 255).to(torch.uint8)
    draws = dp.draw_build(torch.Generator(device=DEVICE).manual_seed(SEED),
                          n, 128, device=DEVICE)
    want = dp.build_batch(frames, s.bbox, s.keypoints_2d, crop_size=128,
                          draws=draws)
    out = {}
    for crop in (None, 128):
        with NativeBatchLoader(path, n, shuffle=False, crop_size=crop,
                               device=DEVICE) as loader:
            host = next(iter(loader))
        pinned = all(v.is_pinned() for v in host.values()
                     if isinstance(v, torch.Tensor))
        b = {k: (v.to(DEVICE, non_blocking=True)
                 if isinstance(v, torch.Tensor) else v)
             for k, v in host.items()}
        out[crop] = (dp.build_shard_batch(b, crop_size=128, draws=draws),
                     pinned)
    got, pinned_f = out[None]
    exact = all(torch.equal(got[k], want[k]) for k in want)
    got_c, pinned_c = out[128]
    # images are normalized: a grey level is 1 / (255 * 0.229)
    img_err = float((got_c['image'] - want['image']).abs().max()) \
        * 255 * 0.229
    tgt_err = max(float((got_c[k] - want[k]).abs().max())
                  for k in ('heatmaps', 'weights', 'keypoints_crop'))
    log(f'shard batches vs the device route on the same {n} frames: from '
        f'frames equal {exact}; from host crops images within '
        f'{img_err:.4g} grey levels (limit {HOST_CROP_ATOL}), targets '
        f'within {tgt_err:.3g}; loader tensors pinned {pinned_f and pinned_c}')
    if not (exact and img_err <= HOST_CROP_ATOL and tgt_err <= 1e-4
            and pinned_f and pinned_c):
        raise AssertionError('shard batches differ from the device route')


def phase_shards(pts, synthetic_rates: dict[int, float]) -> int:
    """14: the native loader built from native/src/shard_loader.cpp at
    first use; synthetic SPD1 shards of full 1920x1200 frames, raw and
    PNG; their batches against the device route; hrnet_esa from r5 trained
    from them at batch 32 and 256 with and without the host crop, beside
    phase 12b's synthetic route; then cli.train --train-shard --host-crop
    on the card (K1 in its in-train eval).  Returns K1's launches there."""
    import tempfile

    from esa_pose_estimation_tpu_torch.cli import train
    from esa_pose_estimation_tpu_torch.cli.mfu_experiments import StepRoutes
    from esa_pose_estimation_tpu_torch.cli.mfu_experiments import r5_masters
    from esa_pose_estimation_tpu_torch.data import native_loader, shards
    from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
        peak_decode,
    )
    from esa_pose_estimation_tpu_torch.train import state as tstate
    from esa_pose_estimation_tpu_torch.utils import config
    t0 = time.perf_counter()
    lib = native_loader.build_library()
    link = ' '.join(native_loader.libpng_args())
    log(f'shard loader: built {lib.name} from '
        f'{native_loader.SOURCE.relative_to(ROOT)} in '
        f'{time.perf_counter() - t0:.1f} s ({link})')
    with tempfile.TemporaryDirectory() as root:
        paths = {}
        for kind, n in (('raw', SHARD_RAW_RECORDS),
                        ('png', SHARD_PNG_RECORDS)):
            # the shards stay in WORK for phase 21
            t1 = time.perf_counter()
            paths[kind] = f'{WORK}/{kind}.spd'
            shards.write_synthetic_shard(paths[kind], n,
                                         compressed=kind == 'png',
                                         batch=SHARD_WRITE_BATCH, seed=SEED,
                                         device=DEVICE)
            log(f'shard {kind}: {n} records of 1920x1200, '
                f'{Path(paths[kind]).stat().st_size / 1e6:.0f} MB, written '
                f'in {time.perf_counter() - t1:.1f} s')
        check_shard_batches(paths['raw'], pts)
        model = r5_masters(DEVICE)
        st = tstate.create_train_state(model, config.TrainConfig())
        for kind, batch, host_crop, steps in SHARD_RUNS:
            r = shard_steps(st, paths[kind], batch, host_crop, steps)
            if not all(math.isfinite(v) for v in r['losses']):
                raise AssertionError(f'shard {kind} batch {batch}: losses '
                                     f'{r["losses"]}')
            ref = synthetic_rates.get(batch)
            log(f'shard train {kind} batch {batch} '
                f'{"host crop" if host_crop else "frames"}: '
                f'{r["img_s"]:.1f} img/s ({r["ms_step"]:.1f} ms per step; '
                f'synthetic route of 12b in this run '
                f'{"not measured" if ref is None else f"{ref:.1f}"} img/s); '
                f'host waits on the loader {r["wait_ms"]:.2f} ms per step; '
                f'host to device {r["h2d_ms"]:.2f} ms for '
                f'{r["h2d_mb"]:.1f} MB a batch (pinned, alone); peak memory '
                f'{r["peak_gib"]:.2f} GiB; losses all finite')
        del st, model
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        wd = f'{root}/run'
        peak_decode.launches = 0
        with StepRoutes() as routes:
            res = train.main(['--workdir', wd, '--train-shard',
                              paths['raw'], '--host-crop', '--epochs', '1',
                              '--batch-size', '32', '--eval-every', '1',
                              *panel_args()])
        torch.cuda.synchronize()
        launches = peak_decode.launches
        with open(f'{wd}/events.jsonl') as f:
            loss = [e for e in map(json.loads, f)
                    if e['event'] == 'epoch'][0]['loss']
        log(f'cli.train --train-shard raw --host-crop (hrnet_esa from its '
            f'initialisation, 1 epoch of {SHARD_RAW_RECORDS // 32} steps, '
            f'eval on the shard\'s first 128 frames): epoch loss {loss:.5f}, '
            f'eval {json.dumps(res)}; K1 launches {launches}; '
            f'{routes.check("14 cli.train --train-shard")}; '
            f'{time.perf_counter() - t2:.1f} s')
        if launches < 4 or not math.isfinite(loss):
            raise AssertionError(f'cli.train from the shard: loss {loss}, '
                                 f'K1 launches {launches}')
    log(f'shards: phase {time.perf_counter() - t0:.1f} s')
    return launches


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def phase_group() -> None:
    """15: a one-rank NCCL group: three f32 train steps of hrnet_tiny
    through wrap_data_parallel and the group-aware BatchNorm against the
    same three steps with no group, at phase 12a's tolerances; the group
    is then destroyed."""
    import copy

    import torch.distributed as dist

    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
    from esa_pose_estimation_tpu_torch.parallel.mesh import (
        wrap_data_parallel,
    )
    from esa_pose_estimation_tpu_torch.train import state as tstate
    from esa_pose_estimation_tpu_torch.utils import config
    t0 = time.perf_counter()
    cfg = config.TrainConfig(batch_size=8, crop_size=64)
    lr = cfg.lr_values[0]
    plain = HRNet(config.hrnet_tiny()).to(
        DEVICE, memory_format=torch.channels_last).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED + 50))
    grouped = copy.deepcopy(plain)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 51)
    b = synthetic.make_batch(gen, 8, synthetic.spacecraft_points(
        device=DEVICE, n=6), crop_size=64)
    batch = {'image': torch.randn(b['image'].shape, generator=gen,
                                  device=DEVICE),
             'heatmaps': b['heatmaps'], 'weights': b['weights']}
    st = tstate.create_train_state(plain, cfg)
    want = [tstate.train_step(st, batch) for _ in range(3)]
    dist.init_process_group('nccl', init_method=f'tcp://localhost:'
                            f'{free_port()}', world_size=1, rank=0)
    try:
        st = tstate.create_train_state(grouped, cfg)
        st.train_model = wrap_data_parallel(grouped)
        got = [tstate.train_step(st, batch) for _ in range(3)]
        torch.cuda.synchronize()
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    loss_rel = max(abs(float(g['loss']) / float(w['loss']) - 1.0)
                   for g, w in zip(got, want))
    gn_rel = max(abs(float(g['grad_norm']) / float(w['grad_norm']) - 1.0)
                 for g, w in zip(got, want))
    stat_err = param_err = 0.0
    stats_ok = True
    sd_p, sd_g = plain.state_dict(), grouped.state_dict()
    for k, v in sd_p.items():
        err = float((sd_g[k] - v).abs().max())
        if k.endswith(('running_mean', 'running_var')):
            stat_err = max(stat_err, err)
            stats_ok &= torch.allclose(sd_g[k], v, rtol=TRAIN_STAT_TOL,
                                       atol=TRAIN_STAT_TOL)
        else:
            param_err = max(param_err, err)
    log(f'one-rank {backend} group (hrnet_tiny f32, batch 8 at 64x64, 3 '
        f'steps through DistributedDataParallel) against no group: loss '
        f'rel diff {loss_rel:.3g} (limit {TRAIN_LOSS_RTOL}), grad_norm rel '
        f'diff {gn_rel:.3g} (limit {TRAIN_GNORM_RTOL}), running statistics '
        f'max diff {stat_err:.3g} (rtol/atol {TRAIN_STAT_TOL}), parameters '
        f'max diff {param_err:.3g} (limit 3 lr = {3 * lr:g}); group '
        f'destroyed: {not dist.is_initialized()}; '
        f'{time.perf_counter() - t0:.1f} s')
    if not (loss_rel <= TRAIN_LOSS_RTOL and gn_rel <= TRAIN_GNORM_RTOL
            and stats_ok and param_err <= 3 * lr
            and not dist.is_initialized()):
        raise AssertionError('one-rank group: the steps disagree with the '
                             'steps without a group')


GROUP_BATCH = 32          # 15b: hrnet_esa's batch, the TrainConfig default


def phase_group_graphs() -> None:
    """15b: the training programs as CUDA graphs under
    DistributedDataParallel in a one-rank NCCL group, made as
    ``parallel/distributed.initialize`` makes a group (NCCL's asynchronous
    error handling off) and wrapped as ``cli.train`` wraps the model (on a
    side stream): ``hrnet_esa`` from r5 at batch 32, the synthetic scan
    (``make_scan_step``, 4 steps a graph) and the shard route's step on
    host crops of phase 14's raw shard (``make_train_steps(st,
    data/pipeline.step_loss)``), each replayed and launched one by one
    (``StepGraph.run_eagerly``) from one start on the same draws
    (``cli/mfu_experiments.program_pair``): losses, parameters, running
    statistics and Adam's state torch.equal; the collective calls inside
    each capture, by the profiler (more than 0), and the device kernels of
    one replay of the step graph, NCCL's among them (none in one rank:
    NCCL sums one rank's tensor in place without a kernel; four cards
    launch them, ``mfu_experiments --ddp``); the scan's second graph, of
    2 steps, captured after the first replayed and torch.equal to its
    twin; eager and replay ms per step, capture seconds, pool and peak
    memory.  The group is destroyed after."""
    import torch.distributed as dist

    from esa_pose_estimation_tpu_torch.cli import mfu_experiments as mfu
    from esa_pose_estimation_tpu_torch.parallel.distributed import (
        prepare_nccl_for_graphs,
    )
    t0 = time.perf_counter()
    prepare_nccl_for_graphs()
    dist.init_process_group('nccl', init_method=f'tcp://localhost:'
                            f'{free_port()}', world_size=1, rank=0)
    try:
        dev = torch.device('cuda', torch.cuda.current_device())
        rows = [mfu.program_pair(route, GROUP_BATCH, dev, f'{WORK}/raw.spd',
                                 seed=SEED) for route in ('scan', 'shard')]
    finally:
        dist.destroy_process_group()
    for row in rows:
        rep = row.get('replay')
        log(f'group 15b {row["route"]} (hrnet_esa from r5, batch '
            f'{GROUP_BATCH}, {row["steps"]} steps, {row["steps_per_graph"]}'
            f' a graph, one-rank NCCL group, DDP): against the same steps '
            f'launched one by one, losses equal {row["losses_equal"]}, '
            f'parameters, statistics and Adam equal {row["state_equal"]}'
            + (f', the second graph (2 steps, captured after the first '
               f'replayed) equal {row["second_graph_equal"]}'
               if row['route'] == 'scan' else '')
            + f'; {row["capture"]["collective_calls"]} collective calls '
            f'in the capture'
            + (f'; one replay: {rep["kernels"]} kernels, '
               f'{rep["nccl_kernels"]} of NCCL' if rep else '')
            + f'; eager {row["eager_ms"]:.1f} ms per step, replay '
            f'{row["replay_ms"]:.1f} (runs '
            f'{[round(v, 1) for v in row["eager_runs"]]}, '
            f'{[round(v, 1) for v in row["replay_runs"]]}); capture '
            f'{row["capture_s"]:.2f} s, pool +{row["pool_gib"]:.2f} GiB, '
            f'peak {row["peak_gib"]:.2f} GiB; {CARD}')
    log(f'group 15b: destroyed {not dist.is_initialized()}; '
        f'{time.perf_counter() - t0:.1f} s')
    # one rank: NCCL carries a sum out in place with no kernel, so the
    # collectives show as calls inside the capture, not in the replay
    for row in rows:
        if not (row['all_equal'] and row['finite']
                and row['capture']['collective_calls'] > 0):
            raise AssertionError(f'group 15b {row["route"]}: {row}')
    if dist.is_initialized():
        raise AssertionError('group 15b: the group was not destroyed')


# phase 16: the LINEMOD/PVNet family at the command's full width
LM_SIZE, LM_KP, LM_BATCH = 128, 9, 16
LM_CLI = ('--epochs', '2', '--steps-per-epoch', '50', '--batch-size', '16',
          '--eval-batches', '4')
# a differing mask pixel must lie on a triangle edge: an edge function
# within this many px^2 of zero (f32 products of up to ~1e4 px^2 round at
# ~1e-3 px^2, with or without a fused multiply-add)
EDGE_PX2 = 1e-2
VOTING_RUNS = (32, 9)           # keypoints: bench.py's voting mode, the CLI


def linemod_object():
    """The command's synthetic object on the card: (db, vertices, faces,
    the 9 FPS keypoints)."""
    from esa_pose_estimation_tpu_torch.cli import train_linemod as tl
    from esa_pose_estimation_tpu_torch.data.linemod import LineModModelDB
    verts, faces = tl.make_icosphere()
    db = LineModModelDB()
    db.register('cat', vertices=verts)
    kp3d = torch.as_tensor(db.get_farthest_3d('cat', LM_KP),
                           dtype=torch.float32, device=DEVICE)
    return (db, torch.as_tensor(verts, device=DEVICE),
            torch.as_tensor(faces, device=DEVICE), kp3d)


def linemod_ideal(db, pts, faces, kp3d) -> None:
    """16a: tests/test_train_linemod.py's well-posed harness at full size:
    ideal targets of 16 rendered poses through heatmaps -> K1 ->
    RANSAC-EPnP and through the vertex field -> voting -> distribution ->
    uncertainty PnP must score 1.0 on 2D projection and ADD."""
    from esa_pose_estimation_tpu_torch.cli import train_linemod as tl
    from esa_pose_estimation_tpu_torch.eval import evaluator
    from esa_pose_estimation_tpu_torch.ops import heatmap, peak, pnp
    from esa_pose_estimation_tpu_torch.ops import vertex, voting
    from esa_pose_estimation_tpu_torch.utils.seeding import generator
    b = tl.synthetic_linemod_batch(generator(DEVICE, SEED, 16), LM_BATCH,
                                   pts, faces, kp3d, LM_SIZE)
    p3 = kp3d.expand((LM_BATCH,) + kp3d.shape)
    hm, _ = heatmap.render_targets(b['keypoints_2d'], LM_SIZE, LM_SIZE, 2.0)
    coords, _ = peak.decode_heatmaps_auto_nhwc(
        hm.permute(0, 2, 3, 1).contiguous())
    res = pnp.ransac_epnp(p3, coords, b['K'], generator(DEVICE, SEED, 3))
    field = vertex.vertex_field(b['mask'], b['keypoints_2d'])
    vres = voting.ransac_voting(b['mask'], field, generator(DEVICE, SEED, 4))
    mean, cov = voting.estimate_voting_distribution_with_mean(
        b['mask'], field, vres.keypoints, generator(DEVICE, SEED, 6))
    R, t = pnp.uncertainty_pnp(p3, mean, cov, b['K'],
                               generator(DEVICE, SEED, 5))
    out = {}
    for route, (Rp, tp) in (('heatmap', (res.R, res.t)), ('pvnet', (R, t))):
        acc = evaluator.pose_accuracy(pts, db.get_diameter('cat'), b['K'],
                                      Rp, tp, b['R'], b['t'])
        out[route] = {k: float(v) for k, v in acc.items()}
        if not (out[route]['projection_2d'] == 1.0
                and out[route]['add'] == 1.0):
            raise AssertionError(f'linemod ideal targets, {route}: {out}')
    kp_err = float((vres.keypoints - b['keypoints_2d']).abs().max())
    log(f'linemod 16a ideal targets (16 poses at 128 px, 9 keypoints): '
        f'{json.dumps(out)}; voting keypoints max abs err {kp_err:.4f} px')


def edge_distance(verts, faces, R, t, K, h: int, w: int) -> torch.Tensor:
    """(H, W) f64 on the CPU: per pixel, the smallest |edge function| over
    the triangles whose other two edge tests pass: near zero on an edge."""
    from esa_pose_estimation_tpu_torch.core.camera import project_points
    f64 = torch.float64
    uv = project_points(verts.cpu().to(f64), R.cpu().to(f64),
                        t.cpu().to(f64), K.cpu().to(f64))
    tri = uv[faces.cpu().long()]                             # (F, 3, 2)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=f64),
                            torch.arange(w, dtype=f64), indexing='ij')
    px, py = xs.reshape(1, -1), ys.reshape(1, -1)

    def edge(p, q):
        return ((q[:, 0, None] - p[:, 0, None]) * (py - p[:, 1, None])
                - (q[:, 1, None] - p[:, 1, None]) * (px - p[:, 0, None]))
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    area = ((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
            - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))
    sgn = torch.where(area >= 0, 1.0, -1.0).to(f64)[:, None]
    ws = [edge(b, c) * sgn, edge(c, a) * sgn, edge(a, b) * sgn]
    best = torch.full((h * w,), math.inf, dtype=f64)
    for i in range(3):
        o = [ws[j] for j in range(3) if j != i]
        near = (o[0] >= -EDGE_PX2) & (o[1] >= -EDGE_PX2)
        cand = torch.where(near, ws[i].abs(), math.inf).amin(dim=0)
        best = torch.minimum(best, cand)
    return best.reshape(h, w)


def linemod_render(pts, faces) -> None:
    """16b: the batched rasterizer on the card against the CPU for 8 poses
    of the icosphere: masks equal except on triangle-edge pixels, depth
    within 1e-5 relative where both cover."""
    from esa_pose_estimation_tpu_torch.cli import train_linemod as tl
    from esa_pose_estimation_tpu_torch.core.camera import quat_to_rotmat
    from esa_pose_estimation_tpu_torch.utils import render
    from esa_pose_estimation_tpu_torch.utils.seeding import generator
    d = tl.draw_synthetic_poses(generator(DEVICE, SEED, 17), 8, DEVICE)
    R = quat_to_rotmat(d['quat'])
    t = torch.zeros((8, 3), device=DEVICE)
    t[:, 2] = d['tz']
    K = tl.synthetic_k(LM_SIZE, DEVICE)
    mc, dc = render.rasterize(pts, faces, R, t, K, LM_SIZE, LM_SIZE)
    mh, dh = render.rasterize(pts.cpu(), faces.cpu(), R.cpu(), t.cpu(),
                              K.cpu(), LM_SIZE, LM_SIZE)
    mc, dc = mc.cpu(), dc.cpu()
    differ = mc != mh
    for i in torch.nonzero(differ.flatten(1).any(1)).flatten().tolist():
        dist = edge_distance(pts, faces, R[i], t[i], K, LM_SIZE, LM_SIZE)
        if not bool((dist[differ[i]] < EDGE_PX2).all()):
            raise AssertionError(f'render pose {i}: a mask pixel off the '
                                 f'triangle edges differs card vs CPU')
    both = mc & mh
    rel = float(((dc[both] - dh[both]).abs() / dh[both]).max())
    if not rel <= 1e-5:
        raise AssertionError(f'render: depth differs by {rel} relative')
    log(f'linemod 16b render card vs CPU, 8 poses at 128 px: '
        f'{int(differ.sum())} of {int((mc | mh).sum())} covered pixels '
        f'differ (all within {EDGE_PX2} px^2 of a triangle edge), depth '
        f'max rel err {rel:.3g} (tolerance 1e-5)')


def linemod_commands(root: str) -> int:
    """16c: cli.train_linemod in both modes at the command's defaults for
    2 epochs of 50 steps at batch 16 with 4 eval batches: finite losses,
    the second epoch below the first; ms per step, images/s, peak memory,
    K1's launches in the heatmap eval.  Returns those launches."""
    from esa_pose_estimation_tpu_torch.cli import train_linemod
    from esa_pose_estimation_tpu_torch.cli.mfu_experiments import StepRoutes
    from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
        peak_decode,
    )
    launches = 0
    for mode in ('heatmap', 'pvnet'):
        wd = f'{root}/{mode}'
        torch.cuda.reset_peak_memory_stats()
        peak_decode.launches = 0
        t0 = time.perf_counter()
        with StepRoutes() as routes:
            res = train_linemod.main(['--workdir', wd, '--mode', mode,
                                      *LM_CLI])
        secs = time.perf_counter() - t0
        n_k1 = peak_decode.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        rows = Path(wd, 'log_cat.txt').read_text().strip().split('\n')[1:]
        losses = [float(r.split('\t')[2]) for r in rows]
        with open(f'{wd}/events.jsonl') as f:
            epochs = [e for e in map(json.loads, f) if e['event'] == 'epoch']
        if not (len(losses) == 2 and all(map(math.isfinite, losses))
                and losses[1] < losses[0]):
            raise AssertionError(f'cli.train_linemod {mode}: losses {losses}')
        if (n_k1 == 0) == (mode == 'heatmap'):
            raise AssertionError(f'cli.train_linemod {mode}: {n_k1} K1 '
                                 f'launches in its eval')
        step_ms = epochs[1]['train_seconds'] / epochs[1]['steps'] * 1e3
        log(f'linemod 16c cli.train_linemod --mode {mode} '
            f'{" ".join(LM_CLI)}: losses {losses}, triple {json.dumps(res)}, '
            f'epoch 2 {step_ms:.2f} ms/step ({LM_BATCH * 1e3 / step_ms:.0f} '
            f'images/s; epoch 1 {epochs[0]["train_seconds"]:.2f} s with the '
            f'warm-up, capture), peak memory {peak:.2f} GiB, K1 launches in '
            f'the eval {n_k1}, {routes.check("16c " + mode)}, command '
            f'{secs:.1f} s')
        if mode == 'heatmap':
            launches = n_k1
    return launches


def linemod_step_profile(pts, faces, kp3d) -> None:
    """16c: one heatmap-mode step of the command's loop under the
    profiler, the render of its batch and the optimizer step apart:
    launches, kernel ms, wall ms."""
    from esa_pose_estimation_tpu_torch.cli import train_linemod as tl
    from esa_pose_estimation_tpu_torch.train import state as tstate
    from esa_pose_estimation_tpu_torch.utils.seeding import generator
    model = tl.build_model('heatmap', LM_KP).to(
        device=DEVICE, memory_format=torch.channels_last)
    model.init_weights(generator(DEVICE, 0))
    st = tl.create_state(model, 1e-3, 100)
    gen = generator(DEVICE, SEED, 19)
    box = {}

    def render():
        box['b'] = tl.synthetic_linemod_batch(gen, LM_BATCH, pts, faces,
                                              kp3d, LM_SIZE)

    def step():
        b = box['b']
        tstate.optimize(st, lambda m: tl.linemod_loss(
            m, tl.synthetic_inputs(b), 'heatmap', b['keypoints_2d'],
            b['mask']))
    for name, call in (('render', render), ('step', step)):
        n, busy, wall = kernel_profile(call)
        log(f'linemod 16c profile, {name} of one heatmap step at batch 16: '
            f'{n} kernel launches, {busy:.2f} ms of kernel time in '
            f'{wall:.2f} ms of wall under the profiler'
            + (f', idle share {1 - busy / wall:.3f}' if n else
               ' (no device time recorded: not measured)'))


def write_data2(root: str) -> tuple[str, str]:
    """A tiny data2/ layout of 640x480 frames (tests/test_linemod_real.py's
    fixture at the reference's frame size): 4 real (train 0, 2; test 1, 3),
    2 render, 2 fuse, 2 occlusion records with their PNGs."""
    import os
    import pickle

    import numpy as np
    from PIL import Image

    from esa_pose_estimation_tpu_torch.data.linemod import FUSE_CLS_ORDER
    rng = np.random.default_rng(SEED)
    img_root, pkl = f'{root}/LINEMOD', f'{root}/data2'

    def record(i, prefix):
        x1, y1 = rng.uniform(150, 350, 2)
        return {'rgb_pth': f'{prefix}/{i}.jpg.png',
                'dpt_pth': f'{prefix}_mask/{i}.png',
                'bbox': np.array([x1, y1, x1 + rng.uniform(60, 150),
                                  y1 + rng.uniform(60, 120)], np.float32),
                'sift': rng.uniform(200, 400, (LM_KP, 2)).astype(np.float32),
                'sift_3d': rng.normal(scale=0.05, size=(LM_KP, 3)).astype(
                    np.float32),
                'K': np.array([[572.4, 0, 325.3], [0, 573.6, 242.0],
                               [0, 0, 1]], np.float32),
                'RT': np.hstack([np.eye(3), [[0.], [0.], [0.6]]]).astype(
                    np.float32)}
    real = [record(i, 'real') for i in range(4)]
    render = [record(i, 'render') for i in range(2)]
    fuse = [record(i, 'fuse') for i in range(2)]
    for r in fuse:
        r['rgb_pth'] = f'fuse/f{r["rgb_pth"].split("/")[1]}'
    occ = [record(i, 'occ') for i in range(2)]
    for des in real + render + fuse + occ:
        for path in (des['rgb_pth'], des['dpt_pth']):
            os.makedirs(os.path.dirname(f'{img_root}/{path}'), exist_ok=True)
        Image.fromarray((rng.random((480, 640, 3)) * 255).astype(np.uint8)
                        ).save(f'{img_root}/{des["rgb_pth"]}')
        x1, y1, x2, y2 = des['bbox'].astype(int)
        if os.path.basename(des['rgb_pth']).startswith('f'):
            m = np.zeros((480, 640), np.uint8)
            m[y1:y2, x1:x2] = FUSE_CLS_ORDER.index('cat') + 1
        else:
            m = np.zeros((480, 640, 3), np.uint8)
            m[y1:y2, x1:x2] = 255
        Image.fromarray(m).save(f'{img_root}/{des["dpt_pth"]}')
    os.makedirs(f'{pkl}/occ', exist_ok=True)
    for name, obj in (('cat_real', real), ('cat_render', render),
                      ('cat_fuse', fuse), ('occ/cat_real', occ),
                      ('cat_train', [(f'x/{i}.jpg',) for i in (0, 2)]),
                      ('cat_test', [(f'x/{i}.jpg',) for i in (1, 3)])):
        with open(f'{pkl}/{name}.pkl', 'wb') as f:
            pickle.dump(obj, f)
    return pkl, img_root


def linemod_real(root: str) -> None:
    """16d: cli.train_linemod on a data2/ layout written here, one epoch
    with --augment in both modes and the occlusion eval: finite losses,
    one occ_result.txt row of three finite numbers."""
    from esa_pose_estimation_tpu_torch.cli import train_linemod
    t0 = time.perf_counter()
    pkl, img_root = write_data2(root)
    for mode in ('heatmap', 'pvnet'):
        wd = f'{root}/real_{mode}'
        res = train_linemod.main([
            '--workdir', wd, '--mode', mode, '--epochs', '1',
            '--batch-size', '2', '--pkl-dir', pkl, '--image-root', img_root,
            '--augment', '--occ-pkl-dir', pkl, '--occ-image-root',
            img_root])
        rows = Path(wd, 'log_cat.txt').read_text().strip().split('\n')[1:]
        occ = Path(wd, 'occ_result.txt').read_text().strip().split('\n')
        vals = [float(v) for v in occ[0].split('\t')[1:]]
        loss = float(rows[0].split('\t')[2])
        if not (len(rows) == 1 and math.isfinite(loss) and len(occ) == 1
                and len(vals) == 3 and all(map(math.isfinite, vals))):
            raise AssertionError(f'cli.train_linemod real {mode}: log {rows}'
                                 f', occ {occ}')
        test = {k: v for k, v in res.items() if not k.startswith('occ')}
        log(f'linemod 16d real layout --mode {mode} --augment: loss '
            f'{loss:.4f}, test triple {json.dumps(test)}, occ_result.txt '
            f'{occ[0]!r}')
    log(f'linemod 16d: {time.perf_counter() - t0:.1f} s')


def kernel_profile(call) -> tuple[int, float, float]:
    """(kernel launches, kernel ms, wall ms) of one ``call()`` under
    torch.profiler, after one warm-up call; (0, 0, wall) when the profiler
    saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return len(kernels), busy, wall_ms


def linemod_voting() -> None:
    """16e: ransac_voting on exact fields of 16 images at 128 px, 128
    hypotheses, K = 32 (bench.py's voting operating point) and K = 9:
    keypoints within 0.01 px; ms per image, launches of one call and the
    device's idle share under torch.profiler."""
    from esa_pose_estimation_tpu_torch.ops import vertex, voting
    from esa_pose_estimation_tpu_torch.utils.seeding import generator
    from esa_pose_estimation_tpu_torch.utils.timing import cuda_ms
    s, b = LM_SIZE, LM_BATCH
    for k in VOTING_RUNS:
        gen = generator(DEVICE, SEED, 18, k)
        mask = torch.zeros((b, s, s), device=DEVICE)
        mask[:, 24:104, 32:96] = 1.0
        kps = 16 + (s - 32) * torch.rand((b, k, 2), generator=gen,
                                         device=DEVICE)
        field = vertex.vertex_field(mask, kps)

        def call():
            return voting.ransac_voting(mask, field, gen, n_hypotheses=128)

        def spread():                  # the pvnet eval's second pass
            return voting.estimate_voting_distribution_with_mean(
                mask, field, kps, gen)
        err = float((call().keypoints - kps).abs().max())
        if not err <= 0.01:
            raise AssertionError(f'voting K={k}: keypoints off by {err} px')
        ms = cuda_ms(call, [()], iters=10)
        n, busy, wall = kernel_profile(call)
        idle = (f'{1 - busy / wall:.3f}' if n else 'not measured')
        steady = (f'{max(0.0, 1 - busy / ms):.3f}' if n else 'not measured')
        log(f'linemod 16e ransac_voting (16, 128, 128), K={k}, 128 '
            f'hypotheses, exact field: keypoints max abs err {err:.2e} px '
            f'(tolerance 0.01); {ms:.3f} ms per call = {ms / b:.4f} ms per '
            f'image; {n} kernel launches per call, {busy:.3f} ms of kernel '
            f'time in {wall:.3f} ms under the profiler, device idle share '
            f'{idle} under it, {steady} of back-to-back calls')
        ms2 = cuda_ms(spread, [()], iters=3, warmup=1)
        n2, busy2, _ = kernel_profile(spread)
        log(f'linemod 16e estimate_voting_distribution_with_mean, K={k}, '
            f'1024 hypotheses: {ms2:.3f} ms per call = {ms2 / b:.4f} ms per '
            f'image, {n2} kernel launches, {busy2:.3f} ms of kernel time')


def phase_linemod() -> int:
    """16: the LINEMOD/PVNet family.  Returns K1's launches in one
    heatmap-mode eval of cli.train_linemod (16c)."""
    import tempfile
    t0 = time.perf_counter()
    db, pts, faces, kp3d = linemod_object()
    linemod_ideal(db, pts, faces, kp3d)
    linemod_render(pts, faces)
    with tempfile.TemporaryDirectory() as root:
        launches = linemod_commands(root)
        linemod_step_profile(pts, faces, kp3d)
        linemod_real(root)
    linemod_voting()
    log(f'linemod: phase {time.perf_counter() - t0:.1f} s')
    return launches


def panel_args() -> list[str]:
    """``--no-panels`` where matplotlib is absent: a probe of the host's
    plotting library, which draws the eval panels; no device path
    depends on it."""
    import importlib.util
    if importlib.util.find_spec('matplotlib') is not None:
        return []
    log('matplotlib is absent: the in-train evals run with --no-panels')
    return ['--no-panels']


# cli.train's seconds in this phase on the eager per-step shard route that
# preceded its graph: that tree's phase 17 alone in a fresh process, two
# runs in turns with this tree's (14.7 and 14.7 s the same way), on an H100
# 80GB HBM3 at 700 W
EAGER_REHEARSAL_TRAIN_S = '16.7 and 13.4'
REHEARSAL = ('--n-train', '64', '--n-test', '32', '--n-real-test', '16',
             '--epochs', '2', '--batch-size', '32', '--eval-every', '1')


class StageLaunches:
    """Counts K1's launches in each call of the wrapped commands' ``main``:
    the count is set to 0 just before a call and read just after."""

    def __init__(self, **modules):
        self.modules = modules
        self.counts: dict[str, list[int]] = {k: [] for k in modules}

    def __enter__(self):
        from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
            peak_decode,
        )
        self.saved = {}
        for name, mod in self.modules.items():
            inner = self.saved[name] = mod.main

            def wrapped(argv=None, _inner=inner, _name=name):
                peak_decode.launches = 0
                out = _inner(argv)
                torch.cuda.synchronize()
                self.counts[_name].append(peak_decode.launches)
                return out
            mod.main = wrapped
        return self

    def __exit__(self, *exc):
        for name, mod in self.modules.items():
            mod.main = self.saved[name]


def phase_rehearsal() -> tuple[int, int]:
    """17: cli.dress_rehearsal at full width (1920x1200 frames, 30
    keypoints, hrnet_esa, crop 128), depth cut to 64/32/16 frames and 2
    epochs at batch 32 with --host-crop --augment-geom --eval-every 1 and
    panels; then cli.evaluate of the r5 artifact on the exported test
    JPEGs (mean SPEED <= 0.02).  Returns K1's launches in the in-train
    evals and in cli.evaluate."""
    import csv
    import os
    import pickle
    import tempfile

    from esa_pose_estimation_tpu_torch.cli import dress_rehearsal
    from esa_pose_estimation_tpu_torch.cli import evaluate as eval_cli
    from esa_pose_estimation_tpu_torch.cli import train as train_cli
    from esa_pose_estimation_tpu_torch.cli.mfu_experiments import StepRoutes
    t0 = time.perf_counter()
    no_panels = panel_args()
    with tempfile.TemporaryDirectory() as root:
        wd = f'{root}/run'
        with StageLaunches(train=train_cli, evaluate=eval_cli) as stages, \
                StepRoutes() as routes:
            out = dress_rehearsal.main(['--root', root, '--workdir', wd,
                                        *REHEARSAL, *no_panels])
        k1_train, k1_eval = stages.counts['train'][0], \
            stages.counts['evaluate'][0]
        rows = Path(wd, 'log_esa.txt').read_text().strip().split('\n')[1:]
        losses = [float(r.split('\t')[2]) for r in rows]
        if not (len(losses) == 2 and all(map(math.isfinite, losses))):
            raise AssertionError(f'rehearsal: losses {losses}')
        if not Path(wd, 'net_esa', 'best_rotate').exists():
            raise AssertionError('rehearsal: no best_rotate checkpoint')
        if not no_panels:
            n_png = [len(os.listdir(f'{wd}/panels/epoch{e:03d}'))
                     for e in (1, 2)]
            if n_png != [4, 4]:
                raise AssertionError(f'rehearsal: panels per eval {n_png}')
        scores = [out[k] for k in ('eval_score_t', 'eval_score_r',
                                   'eval_speed')]
        if not all(map(math.isfinite, scores)):
            raise AssertionError(f'rehearsal: evaluate scores {scores}')
        with open(out['csv_path']) as f:
            csv_rows = list(csv.reader(f))
        names = []
        for split in ('test', 'real_test'):
            with open(f'{root}/{split}.pkl', 'rb') as f:
                names += [d['rgb_pth'] for d in pickle.load(f)]
        if not (len(csv_rows) == 48 and all(len(r) == 8 for r in csv_rows)
                and [r[0] for r in csv_rows] == names):
            raise AssertionError(f'rehearsal: CSV {len(csv_rows)} rows')
        if k1_train <= 0 or k1_eval <= 0:
            raise AssertionError(f'rehearsal: K1 launches {k1_train} in the '
                                 f'in-train evals, {k1_eval} in evaluate')
        log(f'rehearsal 17 cli.dress_rehearsal {" ".join(REHEARSAL)} '
            f'(1920x1200, hrnet_esa, --host-crop --augment-geom, '
            f'{"no panels" if no_panels else "4 panels per eval"}): seconds '
            f'per stage {json.dumps(out["timing"])}, losses {losses}, '
            f'evaluate score_t {out["eval_score_t"]} score_r '
            f'{out["eval_score_r"]} speed {out["eval_speed"]}, CSV '
            f'{len(csv_rows)} rows of 8 fields in filename order; K1 '
            f'launches {k1_train} in the in-train evals, {k1_eval} in '
            f'cli.evaluate; cli.train through the shard route\'s graph: '
            f'{routes.check("17 cli.train")}, {out["timing"]["train_s"]} s '
            f'(the eager per-step route, phase 17 alone in a fresh process: '
            f'{EAGER_REHEARSAL_TRAIN_S} s)')
        r5 = eval_cli.main(['--artifact', ARTIFACT, '--workdir', f'{root}/r5',
                            '--test-pkl', f'{root}/test.pkl', '--image-root',
                            f'{root}/images/test', '--batch-size', '32'])
        log(f'rehearsal 17 cli.evaluate --artifact r5 on the 32 exported '
            f'test JPEGs: speed {r5["speed"]:.5f} (score_t '
            f'{r5["score_t"]:.5f}, score_r {r5["score_r"]:.5f}, nonfinite '
            f'{r5["nonfinite"]}; limit 0.02)')
        if not r5['speed'] <= 0.02:
            raise AssertionError(f'rehearsal: r5 on the JPEGs {r5["speed"]}'
                                 ' > 0.02')
    log(f'rehearsal: phase {time.perf_counter() - t0:.1f} s')
    return k1_train, k1_eval


def phase_reference_checkpoint(model, s, pts) -> tuple[int, int]:
    """18: the r5 weights exported under the reference's names, saved as
    the reference saves them (the 'net' wrapper, 'module.' prefixes),
    loaded and imported into a fresh hrnet_esa on the card, then phase 5's
    64 frames served with FUSED_CBAM off (K1) and on (K2 and K1): heatmaps
    and poses torch.equal to serving r5 directly.  Returns K1's and K2's
    launches in the imported model's FUSED_CBAM run."""
    import tempfile

    from esa_pose_estimation_tpu_torch.experimental.cbam_fuse import (
        fused_cbam,
    )
    from esa_pose_estimation_tpu_torch.models import layers
    from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
    from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
        peak_decode,
    )
    from esa_pose_estimation_tpu_torch.utils import config as cfg_mod
    from esa_pose_estimation_tpu_torch.utils import torch_import
    t0 = time.perf_counter()
    sd = torch_import.export_reference_hrnet(model)
    with tempfile.TemporaryDirectory() as root:
        path = f'{root}/seg_hrnet3.pth'
        torch.save({'net': {'module.' + k: v for k, v in sd.items()},
                    'epoch': 0}, path)
        loaded = torch_import.load_torch_checkpoint(path)
    imported = HRNet(cfg_mod.hrnet_esa(), dtype=torch.bfloat16)
    torch_import.import_reference_hrnet(imported, loaded)
    imported = layers.store_in_compute_dtype(imported.to(
        device=DEVICE, memory_format=torch.channels_last)).eval()
    launches = (0, 0)
    for fused in (False, True):
        layers.FUSED_CBAM = fused
        try:
            want = serve(model, s, pts)
            peak_decode.launches = fused_cbam.launches = 0
            got = serve(imported, s, pts)
            torch.cuda.synchronize()
            launches = (peak_decode.launches, fused_cbam.launches)
        finally:
            layers.FUSED_CBAM = False
        for field in ('heatmaps', 'keypoints_2d', 'R', 'trans', 'quat'):
            if not torch.equal(getattr(got, field), getattr(want, field)):
                raise AssertionError(f'reference checkpoint, FUSED_CBAM '
                                     f'{fused}: {field} differs from r5')
        if launches != ((1, 29) if fused else (1, 0)):
            raise AssertionError(f'reference checkpoint, FUSED_CBAM {fused}:'
                                 f' K1/K2 launches {launches}')
        log(f'reference checkpoint 18, FUSED_CBAM {fused}: {len(sd)} torch '
            f'keys through torch.save/load_torch_checkpoint/'
            f'import_reference_hrnet; 64 frames: heatmaps, keypoints and '
            f'poses torch.equal to r5; K1 launches {launches[0]}, K2 '
            f'{launches[1]}')
    log(f'reference checkpoint: phase {time.perf_counter() - t0:.1f} s')
    return launches


def tooling_render(pts, faces) -> None:
    """19a: rasterize_color on the card against the CPU, 8 poses of the
    icosphere at 128 px with vertex colours: masks equal off triangle
    edges, depth 1e-5 relative, colour 1e-5 off edge pixels."""
    from esa_pose_estimation_tpu_torch.cli import train_linemod as tl
    from esa_pose_estimation_tpu_torch.core.camera import quat_to_rotmat
    from esa_pose_estimation_tpu_torch.utils import render
    from esa_pose_estimation_tpu_torch.utils.seeding import generator
    d = tl.draw_synthetic_poses(generator(DEVICE, SEED, 21), 8, DEVICE)
    R = quat_to_rotmat(d['quat'])
    t = torch.zeros((8, 3), device=DEVICE)
    t[:, 2] = d['tz']
    K = tl.synthetic_k(LM_SIZE, DEVICE)
    vc = torch.rand(pts.shape, generator=generator(DEVICE, SEED, 22),
                    device=DEVICE)
    light = (0.3, -0.2, 1.0)
    cc, dc, mc = (a.cpu() for a in render.rasterize_color(
        pts, faces, R, t, K, LM_SIZE, LM_SIZE, vc, light_dir=light))
    ch, dh, mh = render.rasterize_color(
        pts.cpu(), faces.cpu(), R.cpu(), t.cpu(), K.cpu(), LM_SIZE, LM_SIZE,
        vc.cpu(), light_dir=light)
    bad = (mc != mh) | ((cc - ch).abs().amax(-1) > 1e-5)
    for i in torch.nonzero(bad.flatten(1).any(1)).flatten().tolist():
        dist = edge_distance(pts, faces, R[i], t[i], K, LM_SIZE, LM_SIZE)
        if not bool((dist[bad[i]] < EDGE_PX2).all()):
            raise AssertionError(f'rasterize_color pose {i}: a pixel off the '
                                 f'triangle edges differs card vs CPU')
    both = mc & mh
    rel = float(((dc[both] - dh[both]).abs() / dh[both]).max())
    if not rel <= 1e-5:
        raise AssertionError(f'rasterize_color: depth differs by {rel}')
    log(f'tooling 19a rasterize_color card vs CPU, 8 poses at 128 px: '
        f'{int(bad.sum())} of {int((mc | mh).sum())} covered pixels differ '
        f'(all within {EDGE_PX2} px^2 of a triangle edge), depth max rel '
        f'err {rel:.3g}')


def write_linemod_layout(root: str, job, verts) -> None:
    """The fallback's renders as the LINEMOD layouts db_builder reads: per
    frame ``renders/cat/{k}.jpg`` and ``{k}_RT.pkl``, and the real layout
    ``cat/JPEGImages``, ``cat/mask``, ``cat/data/rot|tra`` (cm)."""
    import os
    import pickle

    import numpy as np
    from PIL import Image

    from esa_pose_estimation_tpu_torch.utils import render_driver as rd
    poses = np.load(job.poses_path)
    for sub in ('JPEGImages', 'mask', 'data'):
        os.makedirs(f'{root}/cat/{sub}', exist_ok=True)
    for k, pose in enumerate(poses):
        RT = np.concatenate([rd.euler_to_rotmat(pose[:3]),
                             pose[3:6, None].astype(np.float32)], 1)
        img = Image.open(f'{job.output_dir}/{k}.png').convert('RGB')
        img.save(f'{job.output_dir}/{k}.jpg')
        img.save(f'{root}/cat/JPEGImages/{k:06d}.jpg')
        Image.open(f'{job.output_dir}/{k}_depth.png').save(
            f'{root}/cat/mask/{k:04d}.png')
        with open(f'{job.output_dir}/{k}_RT.pkl', 'wb') as f:
            pickle.dump({'RT': RT}, f)
        with open(f'{root}/cat/data/rot{k}.rot', 'w') as f:
            f.write('3 3\n' + '\n'.join(' '.join(f'{v:.9f}' for v in row)
                                        for row in RT[:, :3]))
        with open(f'{root}/cat/data/tra{k}.tra', 'w') as f:
            f.write('1 3\n' + ' '.join(f'{v:.9f}' for v in RT[:, 3] * 100))


LM_DB_FRAMES, LM_DB_FUSE = 16, 304


def tooling_linemod_dbs(root: str) -> int:
    """19b: render_driver's fallback writes 16 frames on the card;
    db_builder makes the real, render and fuse DBs (304 composites) and
    the split; cli.train_linemod --pkl-dir trains one epoch at batch 16
    in heatmap mode from them: finite loss, K1 in its eval.  Returns K1's
    launches in the command."""
    import numpy as np

    from esa_pose_estimation_tpu_torch.cli import train_linemod as tl
    from esa_pose_estimation_tpu_torch.data import db_builder as dbb
    from esa_pose_estimation_tpu_torch.data.linemod import LineModModelDB
    from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
        peak_decode,
    )
    from esa_pose_estimation_tpu_torch.utils import render_driver as rd
    t0 = time.perf_counter()
    verts, faces = tl.make_icosphere()
    np.savez(f'{root}/cat.npz', vertices=verts, faces=faces)
    job = rd.ExternalRenderer(
        class_type='cat', obj_path=f'{root}/cat.npz',
        output_dir=f'{root}/renders/cat', poses_path=f'{root}/poses/cat.npy',
        bg_imgs_path=f'{root}/bg.npy', n_poses=LM_DB_FRAMES, seed=SEED % 997,
        min_dist=0.5, max_dist=0.9, device=DEVICE)
    n = job.run()
    t_render = time.perf_counter() - t0
    if n != LM_DB_FRAMES:
        raise AssertionError(f'render_driver fallback: {n} frames')
    write_linemod_layout(root, job, verts)
    db = LineModModelDB()
    db.register('cat', vertices=verts)
    real = dbb.build_real_db(root, 'cat', db, n_kp=LM_KP)
    render = dbb.build_render_db(root, 'cat', db, n_kp=LM_KP)
    dbb.compose_fuse_set(root, {'cat': 'renders/cat'}, LM_DB_FUSE,
                         seed=SEED % 991)
    fuse = dbb.build_fuse_db(root, 'cat', db, n_kp=LM_KP)
    train, test = dbb.build_split_pkls(real, root, 'cat')
    t_db = time.perf_counter() - t0 - t_render
    n_train = len(train) + len(render) + len(fuse)
    peak_decode.launches = 0
    t1 = time.perf_counter()
    wd = f'{root}/run'
    res = tl.main(['--workdir', wd, '--mode', 'heatmap', '--epochs', '1',
                   '--batch-size', '16', '--num-keypoints', str(LM_KP),
                   '--pkl-dir', root, '--image-root', root,
                   '--device', DEVICE])
    torch.cuda.synchronize()
    launches = peak_decode.launches
    rows = Path(wd, 'log_cat.txt').read_text().strip().split('\n')[1:]
    loss = float(rows[0].split('\t')[2])
    with open(f'{wd}/events.jsonl') as f:
        steps = [e for e in map(json.loads, f)
                 if e['event'] == 'epoch'][0]['steps']
    if not (math.isfinite(loss) and launches > 0 and steps >= 20):
        raise AssertionError(f'linemod DBs: loss {loss}, {steps} steps, K1 '
                             f'launches {launches}')
    log(f'tooling 19b render_driver fallback on the card: {n} frames of '
        f'640x480 in {t_render:.1f} s; db_builder: {len(real)} real, '
        f'{len(render)} render, {len(fuse)} fuse records ({LM_DB_FUSE} '
        f'composites), split {len(train)}/{len(test)}, {t_db:.1f} s; '
        f'cli.train_linemod --pkl-dir heatmap 1 epoch at batch 16: '
        f'{steps} steps over {n_train} records, loss {loss:.5f}, test '
        f'triple {json.dumps(res)}, K1 launches {launches}, '
        f'{time.perf_counter() - t1:.1f} s')
    return launches


def _card_vs_cpu(label: str, fn, args, atol: float) -> float:
    """``fn`` on the card and on the CPU on the same inputs: every output
    within ``atol``.  Returns the largest difference."""
    from torch.utils._pytree import tree_leaves, tree_map
    got = tree_leaves(fn(*tree_map(
        lambda a: a.to(DEVICE) if isinstance(a, torch.Tensor) else a,
        args)))
    want = tree_leaves(fn(*args))
    err = 0.0
    for g, w in zip(got, want):
        g = g.cpu()
        if g.dtype == torch.bool or not g.is_floating_point():
            if not torch.equal(g, w):
                raise AssertionError(f'{label}: card differs from the CPU')
            continue
        err = max(err, float((g - w).abs().max()))
    if not err <= atol:
        raise AssertionError(f'{label}: card vs CPU {err} > {atol}')
    return err


def tooling_ops() -> None:
    """19c: pose_nms, transforms.crop, vgg16_bn features and the instance
    augmentations on the card against the CPU, at the CPU tests'
    tolerances (tests/test_torch_tools.py), except the resample of
    crop_resize_instance_v1 (7.8e-3: see there)."""
    from esa_pose_estimation_tpu_torch.data import augment
    from esa_pose_estimation_tpu_torch.models import vgg
    from esa_pose_estimation_tpu_torch.ops import pose_nms, transforms
    g = torch.Generator().manual_seed(SEED)
    centers = torch.rand((3, 1, 17, 2), generator=g) * 350 + 50
    poses = (centers + torch.randn((3, 5, 17, 2), generator=g) * 1.5
             ).reshape(15, 17, 2)
    poses = torch.cat([poses, torch.rand((5, 17, 2), generator=g) * 500])
    scores = torch.rand((20, 17), generator=g) * 0.95 + 0.05
    ref = pose_nms.ref_dists_from_bboxes(torch.cat([poses.amin(1),
                                                    poses.amax(1)], -1))
    errs = {'pose_nms': _card_vs_cpu('pose_nms', pose_nms.pose_nms,
                                     (poses, scores, ref), 1e-4)}
    # the CPU test's sizes: its tolerance assumes sample positions below
    # 100 px, where f32 rounds them to 1e-5 px (noise images change by up
    # to 255 levels a pixel)
    imgs = torch.rand((8, 60, 80), generator=g) * 255
    c = torch.rand((8, 2), generator=g) * torch.tensor([20.0, 15.0]) + 30
    errs['transforms.crop'] = _card_vs_cpu(
        'transforms.crop', lambda a, b: transforms.crop(a, b, 0.3, (48, 40),
                                                        20.0),
        (imgs, c), 1e-2)
    net = vgg.VGGFeatures('vgg16', batch_norm=True).init_weights(
        torch.Generator().manual_seed(1)).eval()
    x = torch.randn((4, 3, 64, 64), generator=g)
    with torch.no_grad():
        want = net(x)
        got = net.to(DEVICE)(x.to(DEVICE))
    errs['vgg16_bn'] = max(float((a.cpu() - b).abs().max())
                           for a, b in zip(got, want))
    if not all(torch.allclose(a.cpu(), b, atol=1e-4, rtol=1e-4)
               for a, b in zip(got, want)):
        raise AssertionError(f'vgg16_bn: card vs CPU {errs["vgg16_bn"]}')
    images = torch.rand((16, 128, 128, 3), generator=g) * 255
    masks = torch.zeros((16, 128, 128))
    for i in range(15):
        y0, x0 = (int(v) for v in torch.randint(4, 60, (2,), generator=g))
        masks[i, y0:y0 + 40, x0:x0 + 50] = 1.0
    kp = torch.rand((16, LM_KP, 2), generator=g) * 128
    d1 = augment.draw_crop_resize_v1(g, masks, 96, 96)
    ranges = augment.instance_window_range(masks, 96, 112)
    d2 = augment.draw_window_begins(g, ranges)
    blur = augment.draw_blur(g, 16)
    # the card contracts a sample coordinate's (y + 0.5) * r - 0.5 into an
    # FMA and the CPU does not: 2 ulps of a 128 px coordinate times noise
    # gradients of up to 255 levels a pixel
    resample_atol = 2 * torch.finfo(torch.float32).eps * 128 * 255
    errs['crop_resize_instance_v1'] = _card_vs_cpu(
        'crop_resize_instance_v1',
        lambda *a: augment.crop_resize_instance_v1(*a, 96, 96),
        (images, masks, kp, d1), resample_atol)
    errs['crop_or_padding_to_fixed_size_instance'] = _card_vs_cpu(
        'crop_or_padding_to_fixed_size_instance',
        lambda *a: augment.crop_or_padding_to_fixed_size_instance(
            *a, 96, 112), (images, masks, kp, d2['hbeg'], d2['wbeg']), 1e-4)
    errs['crop_or_padding'] = _card_vs_cpu(
        'crop_or_padding', lambda *a: augment.crop_or_padding(*a, 1.25, 0.75),
        (images, masks, kp), 1e-4)
    errs['instance_window_range'] = _card_vs_cpu(
        'instance_window_range',
        lambda m: augment.instance_window_range(m, 96, 112), (masks,), 0.0)
    errs['random_blur'] = _card_vs_cpu(
        'random_blur', augment.random_blur, (images[..., 0], blur), 1e-3)
    log(f'tooling 19c card vs CPU, max abs err: '
        f'{json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()})}')


def tooling_timer_probe() -> None:
    """19d: a profiling.Timer span of a VGG16Convs forward at batch 32
    lasts at least the CUDA-event time of the same call (events recorded
    inside the span); device_probe reports the card count within its
    deadline."""
    from esa_pose_estimation_tpu_torch.models import vgg
    from esa_pose_estimation_tpu_torch.obs import profiling
    from esa_pose_estimation_tpu_torch.utils import device_probe
    net = vgg.VGG16Convs().init_weights(
        torch.Generator(device=DEVICE).manual_seed(0)).to(DEVICE).eval()
    x = torch.randn((32, 3, 224, 224), device=DEVICE)
    timer = profiling.Timer()
    rows = []
    with torch.no_grad():
        net(x)
        for _ in range(3):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with timer.span() as s:
                start.record()
                s.result = net(x)
                end.record()
            rows.append((timer.times[-1] * 1e3, start.elapsed_time(end)))
    if not all(span >= ev for span, ev in rows):
        raise AssertionError(f'profiling.Timer: spans shorter than the '
                             f'CUDA-event times {rows}')
    t0 = time.monotonic()
    n = device_probe.cuda_device_count(timeout_s=120.0)
    secs = time.monotonic() - t0
    if n != torch.cuda.device_count():
        raise AssertionError(f'device_probe: {n} devices, torch sees '
                             f'{torch.cuda.device_count()}')
    log(f'tooling 19d profiling.Timer span vs CUDA events (ms) of a '
        f'VGG16Convs forward at batch 32, 224 px: '
        f'{[(round(a, 3), round(b, 3)) for a, b in rows]}; '
        f'device_probe.cuda_device_count -> {n} in {secs:.1f} s '
        f'(deadline 120 s)')


def phase_tooling() -> int:
    """19: the tooling on the card.  Returns K1's launches in 19b's
    cli.train_linemod."""
    import tempfile
    t0 = time.perf_counter()
    _, pts, faces, _ = linemod_object()
    tooling_render(pts, faces)
    with tempfile.TemporaryDirectory() as root:
        launches = tooling_linemod_dbs(root)
    tooling_ops()
    tooling_timer_probe()
    log(f'tooling: phase {time.perf_counter() - t0:.1f} s')
    return launches


GRAPH_REPEATS = 20           # 20c: replays of the FUSED_CBAM graph
GRAPH_TIMING = ((1, 10), (256, 5))   # 20d: (batch, calls per run)
SCAN_STEPS = 8                       # 20f: steps in one graph
# 20f: one bf16 rounding step, 2^-8: hrnet_esa computes in bf16, and a
# last-bit difference of an f32 master can move a bf16 operand by this much
BF16_REL = 2.0 ** -8


def _unequal(a, b) -> list[str]:
    """The fields of two PoseOutputs that are not torch.equal, each with
    its largest difference."""
    from esa_pose_estimation_tpu_torch.cli.mfu_experiments import (
        pose_differences,
    )
    return pose_differences(a, b)


def replay_kernels(call) -> tuple[int, int, int]:
    """(K1, K2, all) device kernels of one ``call()`` under torch.profiler,
    by name; -1 each when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA and e.name not in STAGES]
    if not names:
        return -1, -1, -1
    return (sum(K1_KERNEL in n for n in names),
            sum(K2_KERNEL in n for n in names), len(names))


def graphs_serving(model, pts, s) -> tuple[int, int]:
    """20a-c: phase 5's frames and seed through make_jitted_pipeline and
    through eager infer_poses, FUSED_CBAM off and on; the device kernels
    of one replay; 20 replays of the FUSED_CBAM graph.  Returns K1's and
    K2's device kernels in one FUSED_CBAM replay."""
    from esa_pose_estimation_tpu_torch import pipeline
    from esa_pose_estimation_tpu_torch.eval.speed_score import (
        speed_score_from_matrices,
    )
    from esa_pose_estimation_tpu_torch.models import layers
    from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
        peak_decode,
    )
    from esa_pose_estimation_tpu_torch.experimental.cbam_fuse import (
        fused_cbam,
    )
    jitted = pipeline.make_jitted_pipeline(model, pts, **SERVE_KW)

    def graph_call():
        return jitted(s.image, s.bbox, torch.Generator(
            device=DEVICE).manual_seed(SEED + 3))
    per_replay = {}
    for fused in (False, True):
        layers.FUSED_CBAM = fused
        try:
            eager = serve(model, s, pts)
            t0 = time.perf_counter()
            first = graph_call()              # warm-up, capture, replay
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t0
            out = graph_call()
            torch.cuda.synchronize()
            bad = _unequal(eager, first) + _unequal(eager, out)
            if bad:
                raise AssertionError(f'graphs FUSED_CBAM={fused}: replay '
                                     f'differs from eager: {bad}')
            med = statistics.median(speed_score_from_matrices(
                out.R, out.trans, s.quat, s.trans).speed.cpu().tolist())
            if not med <= 0.01:
                raise AssertionError(f'graphs FUSED_CBAM={fused}: SPEED '
                                     f'median {med}')
            peak_decode.launches = fused_cbam.launches = 0
            k1, k2, n = replay_kernels(graph_call)
            counted = (peak_decode.launches, fused_cbam.launches)
            want = (1, 29 if fused else 0)
            log(f'graphs 20a FUSED_CBAM={fused}: {s.image.shape[0]} frames, '
                f'every output of two replays torch.equal to eager '
                f'infer_poses; SPEED median {med:.5f} (limit 0.01); first '
                f'call (warm-up, capture, replay) {t_first:.2f} s')
            log(f'graphs 20b FUSED_CBAM={fused}: one replay holds {n} device '
                f'kernels, K1 {k1}, K2 {k2} (profiler; expected {want}); '
                f'the counters added {counted}')
            if (k1, k2) != want or counted != want:
                raise AssertionError(f'graphs 20b: kernels in one replay '
                                     f'{(k1, k2)}, counted {counted}, '
                                     f'expected {want}')
            per_replay[fused] = (k1, k2)
            if fused:
                outs = [graph_call() for _ in range(GRAPH_REPEATS)]
                torch.cuda.synchronize()
                diff = [(i, _unequal(outs[0], o))
                        for i, o in enumerate(outs[1:], 1)
                        if _unequal(outs[0], o)]
                log(f'graphs 20c fault 2: {GRAPH_REPEATS} replays of the '
                    f'FUSED_CBAM graph at batch {s.image.shape[0]} '
                    f'({29 * GRAPH_REPEATS} K2 launches back to back): '
                    f'{len(diff)} differ from the first {diff}')
                if diff:
                    raise AssertionError(f'graphs 20c: replays differ {diff}')
        finally:
            layers.FUSED_CBAM = False
    for st in jitted.graphs.stats():
        log(f'graphs capture at batch {s.image.shape[0]}: {st["seconds"]:.2f} '
            f's, pool +{st["pool_bytes"] / 2**20:.0f} MiB, launches per '
            f'replay {st["launches"]}')
    return per_replay[True]


def graphs_timing(model, pts) -> None:
    """20d: eager and replay in turns (eager, graph, graph, eager) at
    batch 1 and 256, given box, K2 off: ms per call, images/s, capture
    seconds and pool bytes, and no host wait around a replay."""
    from esa_pose_estimation_tpu_torch import pipeline
    from esa_pose_estimation_tpu_torch.data import synthetic
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    s = synthetic.make_sample(gen, pts, 256, render=False)
    frames = synthetic.render_frame(s.keypoints_2d[:16]).repeat(16, 1, 1)
    boxes = s.bbox[:16].repeat(16, 1)
    rgen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    eager = pipeline.make_pipeline(model, pts)
    jitted = pipeline.make_jitted_pipeline(model, pts)
    for batch, iters in GRAPH_TIMING:
        f, bx = frames[:batch].contiguous(), boxes[:batch].contiguous()
        eager(f, bx, rgen)
        jitted(f, bx, rgen)
        torch.cuda.synchronize()

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(f, bx, rgen)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / iters * 1e3
        e1, g1, g2, e2 = (timed(eager), timed(jitted), timed(jitted),
                          timed(eager))
        e_ms, g_ms = (e1 + e2) / 2, (g1 + g2) / 2
        st = jitted.graphs.stats()[-1]
        log(f'graphs 20d batch {batch}: eager {e_ms:.2f} ms per call '
            f'({batch / e_ms * 1e3:.1f} img/s; runs {e1:.2f}, {e2:.2f}), '
            f'graph replay {g_ms:.2f} ms ({batch / g_ms * 1e3:.1f} img/s; '
            f'runs {g1:.2f}, {g2:.2f}); capture {st["seconds"]:.2f} s, pool '
            f'+{st["pool_bytes"] / 2**20:.0f} MiB')
        check_no_host_wait(f'graphs 20d replay at batch {batch}',
                           lambda: jitted(f, bx, rgen))
        if batch == 1:
            storage_check_cost(jitted, g_ms)


def storage_check_cost(jitted, replay_ms: float) -> None:
    """20d (fault 5): the host time of the storage check that precedes
    every replay (``utils/graphs.check_pointers``), at batch 1 serving."""
    from esa_pose_estimation_tpu_torch.utils import graphs
    cap = next(iter(jitted.graphs.entries.values()))[0]
    n = 1000
    t0 = time.perf_counter()
    for _ in range(n):
        graphs.check_pointers(cap.pointers,
                              graphs.storage_pointers(cap.reads()))
    us = (time.perf_counter() - t0) / n * 1e6
    log(f'graphs 20d fault 5: the storage check before a batch-1 serving '
        f'replay reads {len(cap.pointers)} pointers in {us:.1f} us of host '
        f'time ({100 * us / (replay_ms * 1e3):.2f}% of the '
        f'{replay_ms:.2f} ms replay)')


def graphs_eval(pts) -> None:
    """20e: the graphed EvalCache.infer against eager
    infer_poses_from_crops on phase 10's 128 frames, every output
    torch.equal."""
    from esa_pose_estimation_tpu_torch import pipeline
    from esa_pose_estimation_tpu_torch.cli.mfu_experiments import r5_masters
    from esa_pose_estimation_tpu_torch.eval.eval_cache import EvalCache
    model = r5_masters(DEVICE).eval()
    cache = EvalCache(model, held_out_batches(pts), pts)
    for i, b in enumerate(cache.batches):
        got = cache.infer(model, b, torch.Generator(
            device=DEVICE).manual_seed(SEED + 30 + i))
        want = pipeline.infer_poses_from_crops(
            model, b['crop'], b['rate'], b['origin'], pts,
            torch.Generator(device=DEVICE).manual_seed(SEED + 30 + i),
            **cache.infer_kw)
        bad = _unequal(want, got)
        if bad:
            raise AssertionError(f'graphs 20e batch {i}: {bad}')
    log(f'graphs 20e: EvalCache.infer on {cache.n_frames} held-out frames '
        f'in {len(cache.batches)} batches torch.equal to eager '
        f'infer_poses_from_crops ({len(cache.graphs.entries)} graph)')
    del cache, model
    torch.cuda.empty_cache()


def _train_diff(a, b, start: list[torch.Tensor]) -> dict:
    """How far two trained copies of one model are apart: the largest
    parameter difference; the update of ``a`` (its parameters less
    ``start``) against that of ``b``, as the norm of their difference
    over the norm of b's; the largest running-statistic difference
    relative to 1 + |b|."""
    with torch.no_grad():
        da = torch.cat([(p - q).flatten()
                        for p, q in zip(a.parameters(), start)])
        db = torch.cat([(p - q).flatten()
                        for p, q in zip(b.parameters(), start)])
        stats = max(float(((x - y).abs() / (1 + y.abs())).max())
                    for x, y in zip(a.buffers(), b.buffers()))
        return {'params': float((da - db).abs().max()),
                'update': float((da - db).norm() / db.norm()),
                'stats': stats}


def graphs_scan(pts) -> None:
    """20f: from r5, make_scan_step's graph of SCAN_STEPS steps at batch 32
    and 256 against eager steps on the same draws.  Fault 4 is closed
    (ROADMAP.md section 3): two eager runs of train_step are torch.equal
    in losses, parameters and running statistics, and the graph is
    torch.equal to the same steps launched one by one with its optimizer
    arithmetic (``StepGraph.run_eagerly``: capturable Adam, a tensor
    rate).  Against train_step the Adam arithmetic differs (capturable
    Adam takes its bias correction in f32 on the card, train_step's in f64
    on the host), so there the stated tolerance holds: the first loss
    torch.equal; parameters within 2 lr a step; running statistics within
    a tenth of how far training moved them; losses within 2^-7 relative
    (two bf16 rounding steps).  Then ms per step, eager and graph in turns
    (the second eager run, two replays, an eager run after the graph is
    freed: at batch 256 its pool and an eager step do not fit together),
    and the scan's peak memory."""
    from esa_pose_estimation_tpu_torch.cli.mfu_experiments import (
        trained_equal,
    )
    from esa_pose_estimation_tpu_torch.cli.mfu_experiments import r5_masters
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.train import state as tstate
    from esa_pose_estimation_tpu_torch.utils import config
    cfg = config.TrainConfig(lr_boundaries=(0, 100, 170))   # 12c's rate
    for batch in (32, 256):
        fn = tstate.BatchFn(
            draw=lambda g, b=batch: synthetic.draw_batch(g, b, device=DEVICE),
            make=lambda d, b=batch: synthetic.make_batch(None, b, pts,
                                                         draws=d))
        e1, e2, e3, sc = (tstate.create_train_state(r5_masters(DEVICE), cfg,
                                                    1000) for _ in range(4))
        start = [p.detach().clone() for p in e1.model.parameters()]
        buffers = [b.detach().clone() for b in e1.model.buffers()]
        lr = e1.schedule(0)
        g1, g2, g3, gs = (torch.Generator(device=DEVICE).manual_seed(
            SEED + 40) for _ in range(4))

        def eager_steps(st, g):
            return torch.stack([
                tstate.train_step(st, fn.make(fn.draw(g)))['loss']
                for _ in range(SCAN_STEPS)])

        def timed(call):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) / SCAN_STEPS * 1e3
        want, _ = timed(lambda: eager_steps(e1, g1))
        again, e_first = timed(lambda: eager_steps(e2, g2))
        twin = tstate.StepGraph(e3, lambda m, d: tstate.heatmap_step_loss(
            m, fn.make(d)), SCAN_STEPS, torch.device(DEVICE))
        same = twin.run_eagerly([fn.draw(g3) for _ in range(SCAN_STEPS)])
        del twin
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        scan = tstate.make_scan_step(sc, fn, SCAN_STEPS)
        got, first_ms = timed(lambda: scan(gs))
        peak = torch.cuda.max_memory_allocated() / 2**30
        pair = torch.equal(want, again) and trained_equal(e1, e2)
        graph = torch.equal(got, same) and trained_equal(sc, e3)
        diff = _train_diff(sc.model, e1.model, start)
        moved = max(float(((x - y).abs() / (1 + y.abs())).max())
                    for x, y in zip(e1.model.buffers(), buffers))
        rel = float(((got - want).abs() / want.abs()).max())
        log(f'graphs 20f batch {batch}: {SCAN_STEPS} steps at lr {lr:g}; '
            f'fault 4: two eager runs of train_step torch.equal in losses, '
            f'parameters and statistics {pair}; the graph against the same '
            f'steps launched one by one (capturable Adam) torch.equal '
            f'{graph}; against train_step (Adam in f64 on the host): first '
            f'loss equal {bool(got[0] == want[0])}, losses rel {rel:.3g} '
            f'(limit {2 * BF16_REL:.3g}), update rel {diff["update"]:.3g}, '
            f'parameters max {diff["params"]:.3g} (limit '
            f'{2 * lr * SCAN_STEPS:.3g}), running statistics '
            f'{diff["stats"]:.3g} (moved {moved:.3g}); steps {e1.step}, '
            f'{sc.step}')
        if not (pair and graph and bool(got[0] == want[0])
                and rel <= 2 * BF16_REL
                and diff['params'] <= 2 * lr * SCAN_STEPS
                and diff['stats'] <= 0.1 * moved and sc.step == e1.step):
            raise AssertionError(f'graphs 20f batch {batch}: pair {pair}, '
                                 f'graph {graph}, {diff}, losses rel {rel}')
        del e2, e3
        runs = [e_first, timed(lambda: scan(gs))[1],
                timed(lambda: scan(gs))[1]]
        cap_s, cap_bytes = scan.capture.seconds, scan.capture.pool_bytes
        del scan                         # the graph and its pool with it
        torch.cuda.empty_cache()
        runs.append(timed(lambda: eager_steps(e1, g1))[1])
        e_ms, g_ms = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
        log(f'graphs 20f batch {batch}: eager {e_ms:.1f} ms per step '
            f'({batch / e_ms * 1e3:.1f} img/s), graph {g_ms:.1f} ms per step '
            f'({batch / g_ms * 1e3:.1f} img/s), draws and batch making '
            f'included; runs {[round(r, 1) for r in runs]}; first scan call '
            f'(warm-up, capture, replay) {first_ms * SCAN_STEPS / 1e3:.2f} s, '
            f'capture {cap_s:.2f} s, pool +{cap_bytes / 2**30:.2f} GiB, peak '
            f'memory of the scan {peak:.2f} GiB')
        del e1, sc
        torch.cuda.empty_cache()


def graphs_command() -> None:
    """20g: cli.train on the synthetic route at full width, 8 steps at
    batch 32 in two chunks of 4: the scan's graph is captured once and
    replayed twice; finite losses; K1 in its in-train eval."""
    import tempfile

    from esa_pose_estimation_tpu_torch.cli import train
    from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
        peak_decode,
    )
    from esa_pose_estimation_tpu_torch.train import state as tstate
    real = tstate.make_scan_step
    calls: list[int] = []

    def counting(*args, **kwargs):
        fn = real(*args, **kwargs)

        def run(g):
            calls.append(args[2])
            return fn(g)
        return run
    tstate.make_scan_step = counting
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as root:
            peak_decode.launches = 0
            train.main(['--workdir', f'{root}/run', '--epochs', '1',
                        '--synthetic-size', '256', '--batch-size', '32',
                        '--log-every', '4', '--eval-every', '1',
                        *panel_args()])
            torch.cuda.synchronize()
            k1 = peak_decode.launches
            rows = Path(root, 'run', 'log_esa.txt').read_text().split('\n')
    finally:
        tstate.make_scan_step = real
    loss = float(rows[1].split('\t')[2])
    log(f'graphs 20g cli.train (hrnet_esa, 8 steps at batch 32, '
        f'--log-every 4): scan calls {calls}, epoch loss {loss:.5f}, K1 '
        f'launches {k1} in the in-train eval; '
        f'{time.perf_counter() - t0:.1f} s')
    if calls != [4, 4] or not math.isfinite(loss) or k1 < 4:
        raise AssertionError(f'graphs 20g: scan calls {calls}, loss {loss}, '
                             f'K1 {k1}')


def phase_graphs(model, pts, s) -> tuple[int, int]:
    """20: the compiled programs as CUDA graphs.  Returns K1's and K2's
    device kernels in one FUSED_CBAM replay of the serving graph."""
    t0 = time.perf_counter()
    replay = graphs_serving(model, pts, s)
    graphs_timing(model, pts)
    graphs_eval(pts)
    graphs_scan(pts)
    graphs_command()
    log(f'graphs: phase {time.perf_counter() - t0:.1f} s')
    return replay


# phase 21: steps of each per-step program, steps of the LINEMOD epoch
# graph (the command captures --steps-per-epoch, 50)
STEP_PROGRAM_STEPS = 4
LM_SCAN_STEPS = 16


def determinism_pairs() -> None:
    """21a (fault 4): two eager runs of 4 steps from one start on one set
    of draws, the detector at the JAX round-5 recipe and ResNet-8s in both
    LINEMOD modes (hrnet_esa's pairs are 20f's): losses, parameters and
    running statistics torch.equal.  Each pair starts with cuDNN's
    determinism flag off, as serving leaves it: the training path turns it
    on for its steps (``train/state.deterministic_cudnn``) and off again,
    which is checked after each pair."""
    from esa_pose_estimation_tpu_torch.cli import mfu_experiments as mfu
    from esa_pose_estimation_tpu_torch.train import state as tstate
    for case in mfu.training_cases(torch.device(DEVICE), 4,
                                   hrnet_batches=(), seed=SEED):
        torch.backends.cudnn.deterministic = False
        a, b = case.make_state(), case.make_state()
        la = tstate.run_steps(a, case.loss_fn, case.inputs)
        lb = tstate.run_steps(b, case.loss_fn, case.inputs)
        equal = torch.equal(la, lb) and mfu.trained_equal(a, b)
        log(f'step graphs 21a fault 4 {case.name}: two eager runs of '
            f'{len(case.inputs)} steps bit-equal {equal} from cuDNN\'s '
            f'flag off, the flag after them '
            f'{torch.backends.cudnn.deterministic} (losses '
            f'{[round(v, 6) for v in la.tolist()]})')
        if not equal:
            raise AssertionError(f'21a {case.name}: two eager runs differ')
        if torch.backends.cudnn.deterministic:
            raise AssertionError(f'21a {case.name}: the training steps '
                                 'left cuDNN\'s determinism flag on')
        del a, b, case
    torch.cuda.empty_cache()


def storage_check() -> None:
    """21b (fault 5): a serving graph and a training graph raise at their
    next call once their model's storage is replaced
    (``load_state_dict(..., assign=True)``; the serving form's cast)."""
    from esa_pose_estimation_tpu_torch import pipeline
    from esa_pose_estimation_tpu_torch.cli.mfu_experiments import r5_masters
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.models import layers
    from esa_pose_estimation_tpu_torch.train import state as tstate
    from esa_pose_estimation_tpu_torch.utils import config
    pts = synthetic.spacecraft_points(device=DEVICE)
    s = synthetic.make_sample(torch.Generator(device=DEVICE).manual_seed(
        SEED + 50), pts, 1)
    raised = []
    for replace in ('assign', 'compute_dtype'):
        model = r5_masters(DEVICE).eval()
        jitted = pipeline.make_jitted_pipeline(model, pts)
        jitted(s.image, s.bbox)
        if replace == 'assign':
            model.load_state_dict({k: v.clone() for k, v in
                                   model.state_dict().items()}, assign=True)
        else:
            layers.store_in_compute_dtype(model)
        try:
            jitted(s.image, s.bbox)
        except RuntimeError as e:
            raised.append(f'serving/{replace}: {str(e)[:60]}...')
        del jitted, model
    st = tstate.create_train_state(r5_masters(DEVICE), config.TrainConfig())
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 51)
    fn = tstate.BatchFn(
        draw=lambda gen: synthetic.draw_batch(gen, 8, device=DEVICE),
        make=lambda d: synthetic.make_batch(None, 8, pts, draws=d))
    scan = tstate.make_scan_step(st, fn, 1)
    scan(g)
    st.model.load_state_dict({k: v.clone() for k, v in
                              st.model.state_dict().items()}, assign=True)
    try:
        scan(g)
    except RuntimeError as e:
        raised.append(f'training/assign: {str(e)[:60]}...')
    log(f'step graphs 21b fault 5: {len(raised)} of 3 calls after the '
        f'storage was replaced raised: {raised}')
    if len(raised) != 3:
        raise AssertionError(f'21b: only {raised} raised')
    del scan, st
    torch.cuda.empty_cache()


def write_split(s, pts, root: str) -> str:
    """The frames of ``s`` as PNGs under ``root`` and their labels as a
    pickle split (the reference's layout); returns the split's path."""
    import pickle

    import numpy as np
    from PIL import Image

    from esa_pose_estimation_tpu_torch.core import camera
    frames = s.image.to(torch.uint8).cpu().numpy()
    n = frames.shape[0]
    R = camera.quat_to_rotmat(s.quat).cpu().numpy()
    arrays = {k: getattr(s, k).cpu().numpy()
              for k in ('bbox', 'keypoints_2d', 'quat', 'trans')}
    recs = []
    for i in range(n):
        name = f'img{(i * 37) % n:06d}.png'     # not in file order
        Image.fromarray(frames[i]).save(f'{root}/{name}', compress_level=1)
        recs.append({'rgb_pth': name, 'bbox': arrays['bbox'][i],
                     'sift': arrays['keypoints_2d'][i],
                     'sift3d': pts.cpu().numpy(),
                     'K': camera.SPEED_K.astype('float32'),
                     'RT': np.concatenate([R[i], arrays['trans'][i][:, None]],
                                          1),
                     'qua': arrays['quat'][i]})
    with open(f'{root}/split.pkl', 'wb') as f:
        pickle.dump(recs, f)
    return f'{root}/split.pkl'


def real_linemod_batches(n: int) -> list[dict]:
    """``n`` real-layout LINEMOD batches of 16 made on the card from a seed:
    480x640 RGB frames of noise, a disc as the object's mask, its box and
    9 keypoints inside it."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 61)
    yy = torch.arange(480, device=DEVICE)[:, None]
    xx = torch.arange(640, device=DEVICE)[None, :]
    out = []
    for _ in range(n):
        c = 200 + 240 * torch.rand((16, 2), generator=g, device=DEVICE)
        c[:, 1] -= 40
        r = 40 + 30 * torch.rand((16,), generator=g, device=DEVICE)
        mask = (((xx - c[:, 0, None, None]) ** 2
                 + (yy - c[:, 1, None, None]) ** 2)
                < r[:, None, None] ** 2).to(torch.float32)
        out.append({
            'frame': torch.floor(255 * torch.rand(
                (16, 480, 640, 3), generator=g, device=DEVICE)),
            'bbox': torch.stack([c[:, 0] - r, c[:, 1] - r, c[:, 0] + r,
                                 c[:, 1] + r], -1),
            'keypoints_2d': c[:, None] + r[:, None, None] * (torch.rand(
                (16, 9, 2), generator=g, device=DEVICE) - 0.5),
            'mask': mask})
    return out


def step_programs(shard_path: str, split_path: str) -> list:
    """21c: the compiled training programs of this slice at their
    commands' width, each as (name, make_state, per-call inputs, loss_fn,
    steps per call, batch): the shard route at 32 from host crops and at
    256 from raw frames, the pickle route at 32, the detector at the JAX
    round-5 recipe, LINEMOD's epoch scan and real step in both modes."""
    from esa_pose_estimation_tpu_torch.cli import mfu_experiments as mfu
    from esa_pose_estimation_tpu_torch.cli import train_linemod as tlm
    from esa_pose_estimation_tpu_torch.data import pipeline as dp
    from esa_pose_estimation_tpu_torch.data import speed as speed_data
    from esa_pose_estimation_tpu_torch.data.native_loader import (
        NativeBatchLoader,
    )
    from esa_pose_estimation_tpu_torch.train import state as tstate
    from esa_pose_estimation_tpu_torch.utils import config
    n = STEP_PROGRAM_STEPS
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 62)

    def hrnet_state():
        return tstate.create_train_state(mfu.r5_masters(DEVICE),
                                         config.TrainConfig())

    def shard_inputs(batch, crop):
        with NativeBatchLoader(shard_path, batch, shuffle=False,
                               crop_size=crop, device=DEVICE) as loader:
            host = list(itertools.islice(iter(loader), 2))
        batches = [{k: v.to(DEVICE) for k, v in b.items()
                    if isinstance(v, torch.Tensor)} for b in host]
        return [[dp.step_inputs(batches[i % 2], g)] for i in range(n)]

    def data_loss(m, x):
        return dp.step_loss(m, x)
    records = speed_data.records_from_pickle(split_path,
                                             str(Path(split_path).parent))
    pkl = [{k: torch.as_tensor(b[k]).to(DEVICE) for k in dp.STEP_KEYS
            if k in b}
           for b in speed_data.BatchLoader(records, 32, shuffle=False)]
    out = [('shard_b32_host_crop', hrnet_state, shard_inputs(32, 128),
            data_loss, 1, 32),
           ('shard_b256_frames', hrnet_state, shard_inputs(256, None),
            data_loss, 1, 256),
           ('pickle_b32', hrnet_state,
            [[dp.step_inputs(pkl[i % len(pkl)], g)] for i in range(n)],
            data_loss, 1, 32)]
    det, = mfu.training_cases(torch.device(DEVICE), n, hrnet_batches=(),
                              linemod=(), seed=SEED + 1)
    out.append(('detector', det.make_state, [[x] for x in det.inputs],
                det.loss_fn, 1, 16))
    lm = mfu.training_cases(torch.device(DEVICE), LM_SCAN_STEPS,
                            hrnet_batches=(), detector=False, seed=SEED + 2)
    for case in lm:
        out.append((f'linemod_scan_{case.name.split("_")[-1]}',
                    case.make_state, [case.inputs], case.loss_fn,
                    LM_SCAN_STEPS, 16))
    real = real_linemod_batches(2)
    for case in lm:
        mode = case.name.split('_')[-1]
        out.append((f'linemod_real_{mode}', case.make_state,
                    [[tlm.real_step_inputs(real[i % 2], 128, True, g,
                                           DEVICE)] for i in range(n)],
                    lambda m, x, mode=mode: tlm.real_step_loss(m, x, mode,
                                                                128),
                    1, 16))
    return out


def check_program(name, make_state, calls, loss_fn, n_inner, batch) -> None:
    """21c for one program: its graph against the same steps launched one
    by one with the same optimizer arithmetic (capturable Adam, a tensor
    rate: ``StepGraph.run_eagerly``), every loss and the state after the
    last torch.equal; ms per step of the eager route (``run_steps``: the
    per-step loop as it ran before) and of the replays, in turns (eager,
    graph, graph, eager; the graph freed before the last: at batch 256 its
    pool and an eager step do not fit together); capture seconds, pool
    bytes, peak memory."""
    from esa_pose_estimation_tpu_torch.cli import mfu_experiments as mfu
    from esa_pose_estimation_tpu_torch.train import state as tstate
    steps = n_inner * len(calls)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = torch.cat([fn(x) for x in calls])
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / steps * 1e3
    a = make_state()
    twin = tstate.StepGraph(a, loss_fn, n_inner, torch.device(DEVICE))
    want, _ = timed(twin.run_eagerly)
    del twin
    e = make_state()
    _, e1 = timed(lambda x: tstate.run_steps(e, loss_fn, x))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b = make_state()
    graph = tstate.make_train_steps(b, loss_fn, n_inner)
    got, first = timed(graph)
    peak = torch.cuda.max_memory_allocated() / 2**30
    equal = (bool(got[0] == want[0]), torch.equal(got, want),
             mfu.trained_equal(a, b))
    del a
    g1, g2 = timed(graph)[1], timed(graph)[1]
    cap_s, cap_gib = graph.capture.seconds, graph.capture.pool_bytes / 2**30
    del graph, b                         # the graph and its pool with them
    torch.cuda.empty_cache()
    e2 = timed(lambda x: tstate.run_steps(e, loss_fn, x))[1]
    del e
    torch.cuda.empty_cache()
    e_ms, g_ms = (e1 + e2) / 2, (g1 + g2) / 2
    log(f'step graphs 21c {name}: {steps} steps of batch {batch}, '
        f'{n_inner} per graph call; against the same steps launched one by '
        f'one (capturable Adam): first loss equal {equal[0]}, losses equal '
        f'{equal[1]}, parameters and statistics equal {equal[2]}; eager '
        f'{e_ms:.1f} ms per step ({batch / e_ms * 1e3:.1f} img/s; runs '
        f'{e1:.1f}, {e2:.1f}), replay {g_ms:.1f} ms per step '
        f'({batch / g_ms * 1e3:.1f} img/s; runs {g1:.1f}, {g2:.1f}); first '
        f'call (warm-up, capture, replay) {first * steps / 1e3:.2f} s, '
        f'capture {cap_s:.2f} s, pool +{cap_gib:.2f} GiB, peak memory '
        f'{peak:.2f} GiB')
    if not all(equal):
        raise AssertionError(f'21c {name}: graph against eager {equal}')


def pickle_command(split_path: str) -> int:
    """21d: cli.train --train-pkl on phase 11c's 64 frames, one epoch of 2
    steps at batch 32 through the pickle route's graph, its in-train eval
    on the same split: finite loss, no eager step on the card, K1
    launches.  Returns them."""
    import tempfile

    from esa_pose_estimation_tpu_torch.cli import train
    from esa_pose_estimation_tpu_torch.cli.mfu_experiments import StepRoutes
    from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
        peak_decode,
    )
    root = str(Path(split_path).parent)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as wd, StepRoutes() as routes:
        peak_decode.launches = 0
        res = train.main(['--workdir', wd, '--train-pkl', split_path,
                          '--test-pkl', split_path, '--image-root', root,
                          '--epochs', '1', '--batch-size', '32',
                          '--eval-every', '1', *panel_args()])
        torch.cuda.synchronize()
        launches = peak_decode.launches
        rows = Path(wd, 'log_esa.txt').read_text().split('\n')
    loss = float(rows[1].split('\t')[2])
    log(f'step graphs 21d cli.train --train-pkl (hrnet_esa, 64 PNG frames, '
        f'2 steps at batch 32): epoch loss {loss:.5f}, eval speed '
        f'{res["speed"]:.5f}; {routes.check("21d")}; K1 launches {launches}'
        f' in the in-train eval; {time.perf_counter() - t0:.1f} s')
    if not math.isfinite(loss) or launches < 2:
        raise AssertionError(f'21d: loss {loss}, K1 {launches}')
    return launches


def phase_step_graphs(s, pts) -> int:
    """21: faults 4 and 5, then the compiled training programs as CUDA
    graphs (21c) and the pickle route's command (21d).  Returns K1's
    launches in that command's in-train eval."""
    import tempfile
    t0 = time.perf_counter()
    determinism_pairs()
    storage_check()
    with tempfile.TemporaryDirectory() as root:
        split = write_split(s, pts, root)
        for program in step_programs(f'{WORK}/raw.spd', split):
            check_program(*program)
            del program
        launches = pickle_command(split)
    log(f'step graphs: phase {time.perf_counter() - t0:.1f} s')
    return launches


def sharded_eval(model, pts, mesh) -> None:
    """22b: train/state.make_sharded_eval_step on a batch of 32 crops with
    targets: each shard's heatmaps torch.equal to eval_step on that card
    and slice; every card's loss the same and within 1e-6 relative of
    eval_step's loss on those heatmaps (weighted_heatmap_loss of the
    shards' eval_step outputs, joined), and within 1e-4 of eval_step on
    the whole batch, whose bf16 network runs at twice a shard's batch
    (cuDNN may pick other algorithms: 1.8e-6 apart on an H100)."""
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.parallel import mesh as mesh_mod
    from esa_pose_estimation_tpu_torch.train import state as tstate
    from esa_pose_estimation_tpu_torch.train.loss import (
        weighted_heatmap_loss,
    )
    b = synthetic.make_batch(torch.Generator(device=DEVICE).manual_seed(
        SEED + 60), 32, pts)
    batch = {k: b[k] for k in ('image', 'heatmaps', 'weights')}
    replicas = mesh_mod.replicate(model, mesh)
    step = tstate.make_sharded_eval_step(mesh)
    step(replicas, batch)                              # capture
    heatmaps, losses = step(replicas, batch)
    for dev in dict.fromkeys(mesh.devices):
        torch.cuda.synchronize(dev)
    outs = []
    for k, (sl, dev) in enumerate(zip(mesh_mod.batch_sharding(mesh, 32),
                                      mesh.devices)):
        want, _ = tstate.eval_step(tstate.TrainState(replicas[k]),
                                   {n: v[sl].to(dev) for n, v in
                                    batch.items()})
        if not torch.equal(heatmaps.shards[k], want):
            raise AssertionError(f'22b: shard {k} heatmaps differ from '
                                 'eval_step')
        outs.append(want.to(DEVICE))
    joined = float(weighted_heatmap_loss(torch.cat(outs), batch['heatmaps'],
                                         batch['weights']))
    _, whole = tstate.eval_step(tstate.TrainState(model), batch)
    rel = max(abs(float(v) - joined) / abs(joined) for v in losses)
    rel_whole = max(abs(float(v) - float(whole)) / abs(float(whole))
                    for v in losses)
    same = all(torch.equal(v.to(losses[0].device), losses[0])
               for v in losses)
    log(f'sharded 22b eval step over {len(mesh.devices)} shards: heatmaps '
        f'torch.equal to eval_step per shard; loss {float(losses[0]):.8f} '
        f'on every card {same}, {rel:.3g} relative from eval_step\'s on '
        f'the same heatmaps (limit 1e-6), {rel_whole:.3g} from eval_step '
        f'on the whole batch, {float(whole):.8f} (limit 1e-4)')
    if not same or rel > 1e-6 or rel_whole > 1e-4:
        raise AssertionError(f'22b: losses {losses} against {joined} and '
                             f'{whole}')


def phase_sharded(model, pts, s) -> tuple[int, int]:
    """22: serving and the eval step over the data axis of one process's
    cards (every visible card; on a one-card machine also cuda:0 listed
    twice), hrnet_esa from r5 in bf16 on phase 5's 64 frames, K2 off and
    on: each shard torch.equal to its card's make_jitted_pipeline on that
    slice and those uniforms, the gathered poses within 1e-3 rad and 1e-3
    relative translation of one unsharded call, K1 (and K2) once per
    shard by the counters and by the profiler's devices, no host wait
    inside a call; host-to-device ms of the frames from pinned memory;
    22b the sharded eval step.  Returns K1's and K2's launches in one
    FUSED_CBAM call on the last mesh."""
    from esa_pose_estimation_tpu_torch.cli import mfu_experiments as mfu
    from esa_pose_estimation_tpu_torch.models import layers
    from esa_pose_estimation_tpu_torch.parallel import mesh as mesh_mod
    t0 = time.perf_counter()
    meshes = [mesh_mod.make_mesh()]
    if torch.cuda.device_count() == 1:
        meshes.append(mesh_mod.make_mesh(devices=[DEVICE] * 2))
    launches = (0, 0)
    for mesh in meshes:
        for fused in (False, True):
            layers.FUSED_CBAM = fused
            try:
                rec = mfu.sharded_serving_check(model, pts, mesh, s.image,
                                                s.bbox, SEED + 3,
                                                pose_tol=1e-3)
                gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
                check_no_host_wait(
                    f'sharded {len(mesh.devices)} FUSED_CBAM={fused}',
                    lambda: rec['sharded'](s.image, s.bbox, gen))
            finally:
                layers.FUSED_CBAM = False
            launches = rec['launches']
            log(f'sharded 22a {rec["devices"]} FUSED_CBAM={fused}: '
                f'{rec["batch"]} frames, every shard torch.equal to its '
                f'card\'s make_jitted_pipeline; bit-equal on cuda:0 too '
                f'{rec["shards_equal_on_home_card"]}; gathered poses '
                f'{rec["max_angle_vs_unsharded"]:.3g} rad, '
                f'{rec["max_rel_t_vs_unsharded"]:.3g} relative from one '
                f'unsharded call (limits 1e-3); launches (K1, K2) '
                f'{rec["launches"]}, device kernels by card '
                f'{rec["device_kernels"]}; first call (warm-up, capture, '
                f'replay) {rec["first_call_s"]:.2f} s')
            del rec
        torch.cuda.empty_cache()
    mesh = meshes[-1]
    h2d = mfu.h2d_ms(s.image.cpu().pin_memory(), mesh)
    log(f'sharded 22a host-to-device of the 64 frames from pinned memory '
        f'over {mesh.devices}: {h2d["mbytes_per_card"]:.0f} MB a shard, '
        f'{[round(v, 2) for v in h2d["card_ms"]]} ms by card, host '
        f'{h2d["wall_ms"]:.2f} ms ({CARD})')
    sharded_eval(model, pts, mesh)
    torch.cuda.empty_cache()
    log(f'sharded: phase {time.perf_counter() - t0:.1f} s')
    return launches


# phase 23: the model axis on one card
MODEL_AXIS_PER_SHARD = 2      # 23a: images per data slice at (2, 2)


def model_axis_rank(rank: int, port: int, out: str) -> None:
    """23a, one of four processes on cuda:0 in a gloo group (NCCL refuses
    two ranks on one card), at the (2, 2) mesh: hrnet_esa from r5 placed
    on it (``parallel/mesh.shard_state``; each rank from r5 plus its
    rank) and wrapped over its data group, three eager train steps on its
    data slice, in bf16 (the slice's precision: whether the replicas are
    bit-equal, whole tensors across the four and split slices across
    each data group; the gathered model for 23c) and in f32 (held to one
    process by the caller).  Rank 0 saves both to ``out``."""
    import torch.distributed as dist
    import_port()
    from esa_pose_estimation_tpu_torch.cli import mfu_experiments as mfu
    from esa_pose_estimation_tpu_torch.parallel import mesh as mesh_mod
    torch.cuda.set_device(0)
    dev = torch.device('cuda', 0)
    dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                            world_size=4, rank=rank)
    try:
        mesh = mesh_mod.make_mesh(2, 2)
        batches = mfu.step_batches(dev, mesh.coordinate[0],
                                   MODEL_AXIS_PER_SHARD, False, SEED)
        st = mfu.replica_state(dev, mesh=mesh)
        bf16, _, bf16_whole = mfu.split_steps(st, batches)
        flags = mfu._ranks([int(mfu.replicas_equal(st))], dev)
        split = len(mesh_mod.split_convs(st.model))
        del st
        f32, first, whole = mfu.split_steps(
            mfu.replica_state(dev, mesh=mesh, dtype=torch.float32), batches)
        torch.cuda.synchronize()
        if rank == 0:
            torch.save({'bf16': bf16, 'f32': f32, 'split': split,
                        'replicas': [f[0] for f in flags],
                        'backend': dist.get_backend(),
                        'bf16_model': bf16_whole.model.state_dict(),
                        'f32_first': first.state_dict(),
                        'f32_model': whole.model.state_dict()}, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def model_axis_gloo(dev, meanwhile):
    """23a: four gloo processes at (2, 2) on this card, their f32 steps
    against the same three steps in this process on the whole batch (4
    images), at ``cli/mfu_experiments``' tolerances (step_differences);
    their bf16 steps finite and their replicas bit-equal.  This process
    runs ``meanwhile()`` while they finish.  Returns the gathered
    bf16-trained model's state dict."""
    import os

    from esa_pose_estimation_tpu_torch.cli import mfu_experiments as mfu
    out, port = f'{WORK}/model_axis.pt', free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, '-c', f'import chip_smoke; chip_smoke.'
         f'model_axis_rank({r}, {port}, {out!r})'], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    try:
        slices = [mfu.step_batches(dev, d, MODEL_AXIS_PER_SHARD, False, SEED)
                  for d in (0, 1)]
        batches = [{k: torch.cat([b[k] for b in pair])
                    for k in ('image', 'heatmaps', 'weights')}
                   for pair in zip(*slices)]
        want, want_first, ref = mfu.split_steps(
            mfu.replica_state(dev, dtype=torch.float32), batches)
        meanwhile()
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode:
            raise AssertionError(f'23a: rank {r} exited {p.returncode}: '
                                 f'{text[-3000:]}')
    got = torch.load(out, map_location=dev, weights_only=True)

    def f32_model(key):
        m = mfu.r5_masters(dev, torch.float32)
        m.load_state_dict(got[key])
        return m
    whole = type(ref)(f32_model('f32_model'), None, ref.schedule)
    diff = mfu.step_differences(f32_model('f32_first'), whole, want_first,
                                ref, got['f32'], want)
    finite = all(math.isfinite(m[k]) for m in got['bf16'] for k in m)
    log(f'model axis 23a: four {got["backend"]} processes on one card at '
        f'(2, 2), hrnet_esa from r5 at {MODEL_AXIS_PER_SHARD} images a data '
        f'slice, {got["split"]} convs split, 3 eager steps; bf16: losses '
        f'{[round(m["loss"], 6) for m in got["bf16"]]}, finite {finite}, '
        f'replicas bit-equal by rank {got["replicas"]}; f32 against one '
        f'process on the 4 images: loss '
        f'{[f"{v:.3g}" for v in diff["loss_rel"]]} relative (first '
        f'{mfu.FIRST_LOSS_RTOL}, then '
        f'{mfu.STEP_LOSS_RTOL}), grad_norm '
        f'{[f"{v:.3g}" for v in diff["grad_norm_rel"]]} (first '
        f'{mfu.FIRST_NORM_RTOL}, then {mfu.STEP_NORM_RTOL}); after the '
        f'first step parameters {diff["first_param_lrs"]:.3g} lr, '
        f'statistics {diff["first_stat_excess"]:.3g} beyond '
        f'{mfu.FIRST_STAT_TOL} relative (limits {mfu.STEP_PARAM_LRS}, '
        f'{mfu.FIRST_STAT_TOL}); after the third {diff["param_lrs"]:.3g} '
        f'lr, {diff["stat_excess"]:.3g} beyond {mfu.STEP_STAT_TOL} (limits '
        f'{mfu.STEP_PARAM_LRS * 3}, {mfu.STEP_STAT_TOL})')
    if not (diff['within'] and finite and all(got['replicas'])
            and got['split'] == 28):
        raise AssertionError(f'23a: {diff}, finite {finite}, replicas '
                             f'{got["replicas"]}, {got["split"]} split')
    return got['bf16_model']


def model_axis_one_rank(dev) -> None:
    """23b: in a one-rank NCCL group made for graphs, the (1, 1) mesh
    through shard_state (nothing split) and the synthetic scan as a CUDA
    graph (4 steps a graph, batch 32, two calls) against phase 15b's
    program, the same scan of a state wrapped with no mesh, from one start
    on the same draws: losses and states torch.equal."""
    import torch.distributed as dist

    from esa_pose_estimation_tpu_torch.cli import mfu_experiments as mfu
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.parallel import mesh as mesh_mod
    from esa_pose_estimation_tpu_torch.parallel.distributed import (
        prepare_nccl_for_graphs,
    )
    from esa_pose_estimation_tpu_torch.train import state as tstate
    from esa_pose_estimation_tpu_torch.utils.seeding import generator
    prepare_nccl_for_graphs()
    dist.init_process_group('nccl', init_method=f'tcp://localhost:'
                            f'{free_port()}', world_size=1, rank=0)
    try:
        mesh = mesh_mod.make_process_mesh(1, 1)
        plain, placed = mfu.replica_state(dev), mfu.replica_state(dev,
                                                                  mesh=mesh)
        pts = synthetic.spacecraft_points(device=dev)
        fn = tstate.BatchFn(
            draw=lambda g: synthetic.draw_batch(g, GROUP_BATCH, 128,
                                                device=dev),
            make=lambda d: synthetic.make_batch(None, GROUP_BATCH, pts,
                                                crop_size=128, draws=d))
        losses = []
        for st in (plain, placed):
            scan = tstate.make_scan_step(st, fn, mfu.DDP_SCAN_STEPS)
            gen = generator(dev, SEED, 1, GROUP_BATCH, 0)
            losses.append(torch.cat([scan(gen) for _ in range(2)]))
            captured = scan.capture is not None
            del scan
        torch.cuda.synchronize()
        equal = (torch.equal(*losses) and mfu.trained_equal(plain, placed))
        split = len(mesh_mod.split_convs(placed.model))
    finally:
        dist.destroy_process_group()
    log(f'model axis 23b: (1, 1) mesh in a one-rank NCCL group, {split} '
        f'convs split, the scan captured {captured}: 8 steps at batch '
        f'{GROUP_BATCH} torch.equal to phase 15b\'s program (no mesh) in '
        f'losses, parameters, statistics and Adam: {equal}')
    if not (equal and split == 0 and captured):
        raise AssertionError('23b: the (1, 1) mesh changed the program')
    torch.cuda.empty_cache()


def model_axis_serving(sd, pts, s) -> tuple[int, int]:
    """23c: the gathered (2, 2) model in the serving form serves phase 5's
    frames, FUSED_CBAM off and on: K1 once and K2 0 or 29 times, by the
    counters and by the profiler's kernels; SPEED median <= 0.01.
    Returns the FUSED_CBAM run's launches."""
    from esa_pose_estimation_tpu_torch.cli import mfu_experiments as mfu
    from esa_pose_estimation_tpu_torch.eval.speed_score import (
        speed_score_from_matrices,
    )
    from esa_pose_estimation_tpu_torch.experimental.cbam_fuse import (
        fused_cbam,
    )
    from esa_pose_estimation_tpu_torch.models import layers
    from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
        peak_decode,
    )
    model = mfu.serving_form(sd, DEVICE)
    launches = (0, 0)
    for fused in (False, True):
        layers.FUSED_CBAM = fused
        try:
            peak_decode.launches = fused_cbam.launches = 0
            out = serve(model, s, pts)
            torch.cuda.synchronize()
            launches = (peak_decode.launches, fused_cbam.launches)
            k1, k2, _ = replay_kernels(lambda: serve(model, s, pts))
        finally:
            layers.FUSED_CBAM = False
        med = statistics.median(speed_score_from_matrices(
            out.R, out.trans, s.quat, s.trans).speed.cpu().tolist())
        want = (1, 29 if fused else 0)
        log(f'model axis 23c: the gathered (2, 2) model serves phase 5\'s '
            f'{s.image.shape[0]} frames, FUSED_CBAM={fused}: K1, K2 '
            f'launches {launches}, device kernels {(k1, k2)} (want {want});'
            f' SPEED median {med:.5f} (limit 0.01)')
        if launches != want or (k1, k2) != want or not med <= 0.01:
            raise AssertionError(f'23c FUSED_CBAM={fused}: launches '
                                 f'{launches}, kernels {(k1, k2)}, median '
                                 f'{med}')
    return launches


def phase_model_axis(pts, s) -> tuple[int, int]:
    """23: the model axis on one card: 23a four gloo processes at (2, 2)
    against one process; 23b, while they run, the (1, 1) mesh against
    phase 15b's program; 23c the gathered model served through K1 and K2.
    Returns K1's and K2's launches in 23c's FUSED_CBAM call."""
    t0 = time.perf_counter()
    dev = torch.device('cuda', torch.cuda.current_device())
    sd = model_axis_gloo(dev, lambda: model_axis_one_rank(dev))
    torch.cuda.empty_cache()
    launches = model_axis_serving(sd, pts, s)
    log(f'model axis: phase {time.perf_counter() - t0:.1f} s')
    return launches


def main() -> None:
    global WORK
    WORK = tempfile.mkdtemp(prefix='chip_smoke_')
    try:
        run()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


def run() -> None:
    t_start = time.perf_counter()
    phase_device()
    import_port()
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.utils.artifact import (
        load_hrnet_artifact,
    )
    phase_build()
    k1 = phase_k1()
    k2 = phase_k2()
    model = load_hrnet_artifact(ARTIFACT, dtype=torch.bfloat16, device=DEVICE)
    pts = synthetic.spacecraft_points(device=DEVICE)
    k1['launches'], k2['launches'], frames, base = phase_serving(model, pts)
    phase_throughput(model, pts)
    k3 = phase_k3()
    phase_levers(model, pts, frames, base)
    phase_eval()
    t11 = time.perf_counter()
    k1['launches_two_stage'], planted = phase_planted(model, pts)
    phase_seeded(model, pts)
    phase_commands(planted, pts)
    log(f'two-stage and commands: phase {time.perf_counter() - t11:.1f} s')
    k1['launches_train_eval'], rates = phase_train(frames, pts)
    k1['launches_two_stage_eval'] = phase_detector(model, pts)
    k1['launches_shard_train_eval'] = phase_shards(pts, rates)
    phase_group()
    phase_group_graphs()
    k1['launches_linemod_eval'] = phase_linemod()
    (k1['launches_rehearsal_train_eval'],
     k1['launches_rehearsal_evaluate']) = phase_rehearsal()
    (k1['launches_imported_checkpoint'],
     k2['launches_imported_checkpoint']) = phase_reference_checkpoint(
        model, frames, pts)
    k1['launches_linemod_db_eval'] = phase_tooling()
    (k1['launches_graph_replay'],
     k2['launches_graph_replay']) = phase_graphs(model, pts, frames)
    k1['launches_pickle_train_eval'] = phase_step_graphs(planted, pts)
    (k1['launches_sharded_serving'],
     k2['launches_sharded_serving']) = phase_sharded(model, pts, frames)
    (k1['launches_model_axis_serving'],
     k2['launches_model_axis_serving']) = phase_model_axis(pts, frames)
    log(f'total: {time.perf_counter() - t_start:.1f} s')
    # graph_ms / plain_graph_ms (K1 and K2): the same calls replayed from a
    # CUDA graph, beside ms / plain_ms by eager calls as in earlier PRs;
    # launches_two_stage (K1): its launches in one detect_and_infer call;
    # launches_train_eval (K1): its launches in the in-train evaluate of
    # phase 12c (four batches of 32 held-out frames); launches_two_stage_eval
    # (K1): in cli.eval_synthetic --detector-workdir of phase 13 (128
    # frames); launches_shard_train_eval (K1): in the in-train evaluate of
    # cli.train --train-shard in phase 14 (four batches of 32 frames);
    # launches_linemod_eval (K1): in the heatmap-mode evals of
    # cli.train_linemod in phase 16c (two epochs of four batches of 16);
    # launches_rehearsal_train_eval / launches_rehearsal_evaluate (K1): in
    # the in-train evals and in cli.evaluate of phase 17's
    # cli.dress_rehearsal; launches_imported_checkpoint (K1 and K2): in one
    # FUSED_CBAM serving call of phase 18's imported reference checkpoint;
    # launches_linemod_db_eval (K1): in phase 19b's cli.train_linemod from
    # the DBs db_builder made; launches_graph_replay (K1 and K2): device
    # kernels in one replay of phase 20's FUSED_CBAM serving graph, by the
    # profiler; launches_pickle_train_eval (K1): in the in-train evaluate of
    # phase 21d's cli.train --train-pkl (two batches of 32 frames);
    # launches_sharded_serving (K1 and K2): in one FUSED_CBAM call of phase
    # 22's sharded pipeline over its last mesh (one per shard; 29 K2 each);
    # launches_model_axis_serving (K1 and K2): in one FUSED_CBAM serving
    # call of phase 23c's gathered (2, 2) model
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
            'graph_ms', 'plain_graph_ms', 'launches_two_stage',
            'launches_train_eval', 'launches_two_stage_eval',
            'launches_shard_train_eval', 'launches_linemod_eval',
            'launches_rehearsal_train_eval', 'launches_rehearsal_evaluate',
            'launches_imported_checkpoint', 'launches_linemod_db_eval',
            'launches_graph_replay', 'launches_pickle_train_eval',
            'launches_sharded_serving', 'launches_model_axis_serving')
    print(json.dumps({'kernels': [{k: rec[k] for k in keys if k in rec}
                                  for rec in (k1, k2, k3)]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
