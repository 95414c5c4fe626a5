"""LINEMOD training command: the reference ``main2.py`` path (port of the
JAX package's ``cli/train_linemod.py``).

    python -m esa_pose_estimation_tpu_torch.cli.train_linemod \\
        --workdir runs/cat --mode pvnet [--epochs 10] \\
        [--pkl-dir data2 --image-root LINEMOD/ [--augment] \\
         [--occ-pkl-dir data2 --occ-image-root OCC/]] [--device cpu]

Two model modes, the reference's two LINEMOD formulations:

* ``--mode heatmap``: ResNet18-8s regressing K keypoint heatmaps (the
  data_load3.py / main2.py path), decoded by the peak-decode kernel
  (``ops/peak.decode_heatmaps_auto_nhwc``) and solved by RANSAC-EPnP;
* ``--mode pvnet``: ResNet8s-2o regressing segmentation + vertex fields
  (the lib/ PVNet path), evaluated through RANSAC voting, the voting
  distribution around the winners and uncertainty PnP.

Every epoch reports the LINEMOD triple (2D projection / ADD / 5cm5deg,
evaluation.py:526-532).  Two data sources:

* default: a lumpy icosphere rendered on the device with depth shading
  (``utils/render.rasterize``, a whole batch per call), one batch per
  step;
* ``--pkl-dir DIR --image-root ROOT``: the reference's data2/ pickle
  layout (data_load3.py:89-121): real-train + render[:10000] + fuse
  records, the LINEMOD crop rule on the device, ImageNet normalization,
  with ``--augment`` the PVNet instance augmentations
  (linemod_dataset.py:256-293), eval on the {cls}_test.pkl split and, with
  ``--occ-pkl-dir``, the OCCLUSION_LINEMOD eval appended to
  ``<workdir>/occ_result.txt``.

Adam with a cosine decay to lr/100 over the run; ``last`` and metric-gated
``best_add`` checkpoints under ``net_<cls>/`` (a run resumes from
``last``), ``log_<cls>.txt`` and ``events.jsonl``.  The rendered source
trains an epoch as one program of ``--steps-per-epoch`` steps, the real
source a step per batch (``train/state.make_train_steps``: on the card a
CUDA graph replay).  The per-step losses stay on the device and are read
once per epoch.  Runs on the card
(``--device cuda``, the default; without one it raises) or on the CPU with
``--device cpu``.  The random streams are torch's, seeded from ``--seed``:
the batches are not the JAX run's.
"""

from __future__ import annotations

import argparse
import os
import time
from functools import lru_cache

import numpy as np
import torch

from esa_pose_estimation_tpu_torch.core import camera
from esa_pose_estimation_tpu_torch.data import augment as aug
from esa_pose_estimation_tpu_torch.data import linemod as linemod_data
from esa_pose_estimation_tpu_torch.eval import evaluator
from esa_pose_estimation_tpu_torch.models.resnet8s import (
    ResNet8s2o,
    pvnet_loss,
    resnet18_8s,
)
from esa_pose_estimation_tpu_torch.obs import JsonlLogger, TsvLogger
from esa_pose_estimation_tpu_torch.ops import crop as crop_ops
from esa_pose_estimation_tpu_torch.ops import heatmap as heatmap_ops
from esa_pose_estimation_tpu_torch.ops import peak as peak_ops
from esa_pose_estimation_tpu_torch.ops import pnp as pnp_mod
from esa_pose_estimation_tpu_torch.ops import vertex as vertex_ops
from esa_pose_estimation_tpu_torch.ops import voting as voting_ops
from esa_pose_estimation_tpu_torch.train import state as state_mod
from esa_pose_estimation_tpu_torch.train.checkpoint import (
    LAST,
    CheckpointManager,
)
from esa_pose_estimation_tpu_torch.train.loss import weighted_heatmap_loss
from esa_pose_estimation_tpu_torch.utils import render
from esa_pose_estimation_tpu_torch.utils.artifact import target_device
from esa_pose_estimation_tpu_torch.utils.seeding import generator

BEST = 'best_add'
METRICS = ('projection_2d', 'add', 'cm_degree_5')


@lru_cache(maxsize=8)
def synthetic_k(size: int, device=None) -> torch.Tensor:
    """LINEMOD_K scaled from 640 px to a ``size`` crop, K[2, 2] = 1, made
    once per (size, device), as ``core/camera.speed_k``: a captured step
    that renders with it copies nothing from the host.  Shared: do not
    write to it."""
    K = camera.linemod_k(device=device) * (size / 640.0)
    K[2, 2] = 1.0
    return K


def draw_synthetic_poses(generator: torch.Generator | None, batch: int,
                         device=None) -> dict:
    """The pose draws of :func:`synthetic_linemod_batch`: a standard-normal
    quaternion (normalized at use) and a depth uniform in [0.35, 0.55]."""
    return {'quat': torch.randn((batch, 4), generator=generator,
                                device=device),
            'tz': 0.35 + 0.2 * torch.rand((batch,), generator=generator,
                                          device=device)}


def synthetic_linemod_batch(generator: torch.Generator | None,
                            batch_size: int, model_pts: torch.Tensor,
                            faces: torch.Tensor, kp3d: torch.Tensor,
                            size: int = 128, draws: dict | None = None
                            ) -> dict[str, torch.Tensor]:
    """Rendered LINEMOD-like batch: pose -> depth-shaded render -> targets,
    on ``model_pts``' device; ``draws`` (:func:`draw_synthetic_poses`)
    replaces the generator's.

    The network input is the depth-shaded surface (``image``), not the
    silhouette: the silhouette of a near-convex object is almost pose
    invariant; shading restores the 3D appearance cue real photos carry.
    ``mask`` stays binary for the segmentation / vertex-field targets.
    """
    dev = model_pts.device
    if draws is None:
        draws = draw_synthetic_poses(generator, batch_size, dev)
    K = synthetic_k(size, dev)
    R = camera.quat_to_rotmat(draws['quat'])
    t = torch.zeros((batch_size, 3), device=dev)
    t[:, 2] = draws['tz']
    mask, depth = render.rasterize(model_pts, faces, R, t, K, size, size)
    maskf = mask.to(torch.float32)
    zc = t[:, 2, None, None]
    finite = torch.where(torch.isfinite(depth), depth, zc)
    shade = torch.clamp(1.0 - (finite - (zc - 0.2)) / 0.4, 0.0, 1.0)
    return {'image': shade * maskf, 'mask': maskf,
            'keypoints_2d': camera.project_points(kp3d, R, t, K),
            'R': R, 't': t, 'K': K}


def make_icosphere(radius: float = 0.06, subdiv: int = 2
                   ) -> tuple[np.ndarray, np.ndarray]:
    """A small lumpy triangulated sphere (the synthetic LINEMOD object):
    (vertices (V, 3) f32, faces (F, 3) int32)."""
    t = (1 + 5 ** 0.5) / 2
    verts = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                      [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                      [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                     float)
    faces = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10],
                      [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
                      [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                      [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5],
                      [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                     np.int32)
    for _ in range(subdiv):
        new_faces = []
        verts = verts.tolist()
        cache = {}

        def mid(a, b):
            kk = (min(a, b), max(a, b))
            if kk not in cache:
                m = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2
                verts.append(m.tolist())
                cache[kk] = len(verts) - 1
            return cache[kk]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        faces = np.asarray(new_faces, np.int32)
        verts = np.asarray(verts, float)
    verts = np.asarray(verts, float)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True) * radius
    # angular bumps break the ellipsoid's rotation symmetry, so that every
    # pose is visually distinct
    az = np.arctan2(verts[:, 1], verts[:, 0])
    el = np.arcsin(np.clip(verts[:, 2] / radius, -1, 1))
    bump = (1.0 + 0.35 * np.sin(3 * az) * np.cos(el)
            + 0.25 * np.sin(2 * el + 0.7) * np.cos(az + 0.3))
    verts *= bump[:, None]
    verts[:, 2] *= 0.75
    verts[:, 0] *= 1.15
    return verts.astype(np.float32), faces


def build_model(mode: str, num_keypoints: int) -> torch.nn.Module:
    """The driver's networks at their full width: ResNet18-8s (heatmap)
    or ResNet8s-2o at depth 18 (pvnet)."""
    if mode == 'heatmap':
        return resnet18_8s(ver_dim=num_keypoints)
    return ResNet8s2o(ver_dim=2 * num_keypoints, seg_dim=2, depth=18,
                      fc_dim=128, s8_dim=64, s4_dim=32, s2_dim=32,
                      raw_dim=32)


def create_state(model: torch.nn.Module, lr: float,
                 total_steps: int) -> state_mod.TrainState:
    """Adam (optax's defaults) with a cosine decay to lr/100 over the run
    (the reference steps lr/10 at fixed epochs, main.py:223-234; the
    smooth schedule converges the slower vertex-field head)."""
    schedule = state_mod.cosine_schedule(lr, max(total_steps, 1), 0.01)
    opt = torch.optim.Adam(model.parameters(), lr=schedule(0),
                           betas=(0.9, 0.999), eps=1e-8)
    return state_mod.TrainState(model, opt, schedule)


def linemod_loss(model: torch.nn.Module, img: torch.Tensor, mode: str,
                 kp2d: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The forward and the mode's loss: the weighted HeatmapWing on
    sigma-2 heatmap targets, or :func:`models.resnet8s.pvnet_loss` on the
    vertex field of ``mask``."""
    out = model(img)
    if mode == 'heatmap':
        size = img.shape[1]
        hm, wm = heatmap_ops.render_targets(kp2d, size, size, 2.0)
        return weighted_heatmap_loss(out, hm.permute(0, 2, 3, 1),
                                     wm.permute(0, 2, 3, 1))
    seg, vert = out
    return pvnet_loss(seg, vert, mask, vertex_ops.vertex_field(mask, kp2d))


def synthetic_inputs(batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """The shaded image as a 3-channel (B, S, S, 3) input."""
    return batch['image'][..., None].expand(-1, -1, -1, 3)


def synthetic_step_loss(model: torch.nn.Module, draws: dict, mode: str,
                        model_pts: torch.Tensor, faces: torch.Tensor,
                        kp3d: torch.Tensor, size: int) -> torch.Tensor:
    """The rendered step as ``train/state.make_train_steps`` holds it (the
    JAX ``scan_epoch``'s body): the batch rendered from its pose draws,
    the forward and :func:`linemod_loss`."""
    batch = synthetic_linemod_batch(None, draws['tz'].shape[0], model_pts,
                                    faces, kp3d, size, draws=draws)
    return linemod_loss(model, synthetic_inputs(batch), mode,
                        batch['keypoints_2d'], batch['mask'])


def draw_real_augment(generator: torch.Generator | None, batch: int,
                      size: int, device=None) -> dict:
    """The draws of the real-data augmentation chain, in its order."""
    return {'occlusion': aug.draw_occlusion(generator, batch, size, size,
                                            device=device),
            'occlude': torch.rand((batch,), generator=generator,
                                  device=device) < 0.5,
            'rotate': aug.draw_rotate(generator, batch, 30.0, device),
            'crop': aug.draw_crop_resize_v2(generator, batch, device),
            'flip': aug.draw_flip(generator, batch, device),
            'noise': aug.draw_add_noise(generator, batch, size, size,
                                        device)}


def real_batch(frames: torch.Tensor, bboxes: torch.Tensor,
               kp2d: torch.Tensor, masks: torch.Tensor, size: int,
               augment: bool = False,
               generator: torch.Generator | None = None,
               draws: dict | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A real-layout batch on the device: the LINEMOD crop (x1.1 rule) of
    frames (B, H, W, 3), masks and keypoints; with ``augment`` the PVNet
    chain (linemod_dataset.py:256-293): occlusion mask-out (p 0.5),
    instance rotation, crop_resize_instance_v2 scale and window jitter,
    horizontal flip (p 0.5), gaussian noise or motion blur; then ImageNet
    normalization.  ``draws`` (:func:`draw_real_augment`) replaces the
    generator's.  Returns (input, mask crop, keypoints in the crop)."""
    origin, crop_sizes, csize = crop_ops.adjust_bbox_linemod(
        bboxes, img_w=frames.shape[2], img_h=frames.shape[1], min_size=size)
    crops = crop_ops.crop_resize_stretch(frames, origin, crop_sizes, size)
    rate = size / csize.to(torch.float32)
    kp = (kp2d - origin[:, None, :].to(torch.float32)) * rate[:, None, None]
    mcrop = (crop_ops.crop_resize_stretch(masks, origin, crop_sizes, size)
             > 0.5).to(torch.float32)
    if augment:
        if draws is None:
            draws = draw_real_augment(generator, frames.shape[0], size,
                                      frames.device)
        occluded = aug.random_occlusion(mcrop, draws['occlusion'])
        mcrop = torch.where(draws['occlude'][:, None, None], occluded, mcrop)
        crops, mcrop, kp = aug.random_rotate(crops, mcrop, kp,
                                             draws['rotate'])
        crops, mcrop, kp = aug.random_crop_resize_v2(crops, mcrop, kp,
                                                     draws['crop'], size,
                                                     size)
        crops, mcrop, kp = aug.random_flip(crops, mcrop, kp, draws['flip'])
        crops = aug.random_add_noise(crops, draws['noise'])
    return crop_ops.normalize_rgb(crops), mcrop, kp


def real_step_inputs(batch: dict, size: int, augment: bool,
                     generator: torch.Generator | None, device) -> dict:
    """One real step's inputs: a loader batch's frames, boxes, keypoints
    and masks on the device and, with ``augment``, the draws of
    :func:`draw_real_augment`, drawn here, before the step."""
    inputs = {k: torch.as_tensor(batch[k], device=device)
              for k in ('frame', 'bbox', 'keypoints_2d', 'mask')}
    if augment:
        inputs['augment'] = draw_real_augment(
            generator, inputs['frame'].shape[0], size, device)
    return inputs


def real_step_loss(model: torch.nn.Module, inputs: dict, mode: str,
                   size: int) -> torch.Tensor:
    """The real step as ``train/state.make_train_steps`` holds it (the JAX
    ``make_real_step``): :func:`real_batch` on :func:`real_step_inputs`,
    the forward and :func:`linemod_loss`."""
    img, mcrop, kp = real_batch(inputs['frame'], inputs['bbox'],
                                inputs['keypoints_2d'], inputs['mask'], size,
                                'augment' in inputs,
                                draws=inputs.get('augment'))
    return linemod_loss(model, img, mode, kp, mcrop)


@torch.no_grad()
def predict_poses(model: torch.nn.Module, img: torch.Tensor, mode: str,
                  kp3d: torch.Tensor, K: torch.Tensor, gen_seed: tuple,
                  rate: torch.Tensor | None = None,
                  origin: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode forward -> keypoints -> pose, batched: heatmap mode
    decodes with the peak-decode kernel and solves RANSAC-EPnP; pvnet mode
    runs RANSAC voting, the 0.99 distribution around the winners
    (evaluation.py:471-508) and uncertainty PnP.  ``rate``/``origin`` map
    crop keypoints back to the frame (covariances by 1/rate^2).
    ``gen_seed`` seeds the RANSAC streams."""
    dev = img.device
    model.eval()
    out = model(img)
    if mode == 'heatmap':
        coords, _ = peak_ops.decode_heatmaps_auto_nhwc(out)
        if rate is not None:
            coords = coords / rate[:, None, None] \
                + origin[:, None, :].to(torch.float32)
        res = pnp_mod.ransac_epnp(kp3d, coords, K,
                                  generator(dev, *gen_seed, 3))
        return res.R, res.t
    seg, vert = out
    seg_mask = (torch.argmax(seg, dim=-1) == 1).to(torch.float32)
    b, h, w, _ = vert.shape
    field = vert.reshape(b, h, w, kp3d.shape[-2], 2)
    vres = voting_ops.ransac_voting(seg_mask, field,
                                    generator(dev, *gen_seed, 4))
    kp_mean, kp_cov = voting_ops.estimate_voting_distribution_with_mean(
        seg_mask, field, vres.keypoints, generator(dev, *gen_seed, 6))
    if rate is not None:
        kp_mean = kp_mean / rate[:, None, None] \
            + origin[:, None, :].to(torch.float32)
        kp_cov = kp_cov / rate[:, None, None, None] ** 2
    return pnp_mod.uncertainty_pnp(kp3d, kp_mean, kp_cov, K,
                                   generator(dev, *gen_seed, 5))


def evaluate_real(model, loader, db, cls: str, mode: str, size: int,
                  seed: tuple, device) -> dict[str, float]:
    """Real-split eval (result_show.py val loop, batched): crop ->
    forward -> keypoints -> uncrop -> PnP -> the LINEMOD triple."""
    meters = {k: evaluator.AverageMeter() for k in METRICS}
    model_pts = torch.as_tensor(db.get_ply_model(cls), dtype=torch.float32,
                                device=device)
    for bi, batch in enumerate(loader):
        frames = torch.as_tensor(batch['frame'], device=device)
        bboxes = torch.as_tensor(batch['bbox'], device=device)
        origin, crop_sizes, csize = crop_ops.adjust_bbox_linemod(
            bboxes, img_w=frames.shape[2], img_h=frames.shape[1],
            min_size=size)
        img = crop_ops.normalize_rgb(crop_ops.crop_resize_stretch(
            frames, origin, crop_sizes, size))
        Kc = torch.as_tensor(batch['K'], device=device)
        R, t = predict_poses(
            model, img, mode, torch.as_tensor(batch['keypoints_3d'],
                                              device=device),
            Kc, seed + (bi,), size / csize.to(torch.float32), origin)
        acc = evaluator.pose_accuracy(
            model_pts, db.get_diameter(cls), Kc, R, t,
            torch.as_tensor(batch['R'], device=device),
            torch.as_tensor(batch['t'], device=device),
            symmetric=db.is_symmetric(cls))
        n = frames.shape[0]
        for k in meters:
            meters[k].update(float(acc[k]), n=n)
    return {k: m.avg for k, m in meters.items()}


def _print_triple(r: dict, prefix: str = '') -> None:
    print(f"  {prefix}2D-proj {r['projection_2d']:.3f}  ADD {r['add']:.3f}  "
          f"5cm5deg {r['cm_degree_5']:.3f}")


def train(args) -> dict:
    dev = target_device(args.device, 'cli.train_linemod')
    os.makedirs(args.workdir, exist_ok=True)
    db = linemod_data.LineModModelDB()
    use_real = args.pkl_dir is not None
    size = args.crop_size
    if use_real:
        train_records = linemod_data.load_mixed_train_records(
            args.pkl_dir, args.cls, use_fuse=args.use_fuse,
            use_render=args.use_render)
        test_records = linemod_data.load_real_split(args.pkl_dir, args.cls,
                                                    'test')
        args.num_keypoints = int(np.asarray(
            train_records[0]['sift']).reshape(-1, 2).shape[0])
        if args.ply:
            db.register(args.cls, ply_path=args.ply)
        else:
            # no mesh: the record's 3D keypoint cloud stands in as the ADD
            # model (coarser than the PLY, the same metric)
            db.register(args.cls, vertices=np.asarray(
                train_records[0]['sift_3d'], np.float32).reshape(-1, 3))
    else:
        verts, faces = make_icosphere()
        db.register(args.cls, vertices=verts)
        kp3d = torch.as_tensor(db.get_farthest_3d(args.cls,
                                                  args.num_keypoints),
                               dtype=torch.float32, device=dev)
        model_pts = torch.as_tensor(verts, device=dev)
        faces_t = torch.as_tensor(faces, device=dev)

    model = build_model(args.mode, args.num_keypoints).to(
        device=dev, memory_format=torch.channels_last)
    model.init_weights(generator(dev, 0))
    state = create_state(model, args.lr, args.epochs * args.steps_per_epoch)

    logger = TsvLogger(os.path.join(args.workdir, f'log_{args.cls}.txt'),
                       resume=True)       # a restart appends
    logger.set_names(['Epoch', 'LR', 'Train Loss'])
    events = JsonlLogger(os.path.join(args.workdir, 'events.jsonl'))
    ckpt = CheckpointManager(os.path.join(args.workdir, f'net_{args.cls}'))
    state, begin_epoch = ckpt.restore(LAST, state)
    if begin_epoch:
        print(f'resumed from epoch {begin_epoch}')
    # the best ADD so far survives a resume, so a restart cannot replace
    # best_add with worse weights at its first eval
    best = ckpt.load_best()
    result: dict = {}

    def save(epoch, result):
        ckpt.save(LAST, state, epoch)
        if result['add'] > best.get(BEST, -1.0):
            best[BEST] = result['add']       # the sidecar first
            ckpt.store_best(best)
            ckpt.save(BEST, state, epoch)

    # the JAX package's compiled steps: the real step per batch
    # (make_real_step), the rendered epoch as one program of
    # --steps-per-epoch steps (scan_epoch), render inside; on the card one
    # CUDA graph replay per step or per epoch
    if use_real:
        step = state_mod.make_train_steps(
            state, lambda m, x: real_step_loss(m, x, args.mode, size))
    else:
        scan_epoch = state_mod.make_train_steps(
            state, lambda m, d: synthetic_step_loss(
                m, d, args.mode, model_pts, faces_t, kp3d, size),
            args.steps_per_epoch)
    try:
        for epoch in range(begin_epoch, args.epochs):
            t0 = time.perf_counter()
            if use_real:
                loader = linemod_data.LinemodBatchLoader(
                    train_records, args.image_root, args.cls,
                    args.batch_size, shuffle=True, seed=args.seed + epoch,
                    frame_hw=(args.frame_h, args.frame_w))
                losses = torch.cat([step([real_step_inputs(
                    batch, size, args.augment,
                    generator(dev, args.seed, 1, epoch, bi), dev)])
                    for bi, batch in enumerate(loader)])
            else:
                losses = scan_epoch([draw_synthetic_poses(
                    generator(dev, args.seed, 1, epoch, j), args.batch_size,
                    dev) for j in range(args.steps_per_epoch)])
            loss_avg = float(losses.mean())                # waits for the card
            train_s = time.perf_counter() - t0
            logger.append([epoch + 1, args.lr, loss_avg])
            print(f'{args.cls} epoch {epoch + 1}: loss {loss_avg:.5f}')

            if use_real:
                eval_loader = linemod_data.LinemodBatchLoader(
                    test_records, args.image_root, args.cls,
                    min(args.batch_size, len(test_records)), shuffle=False,
                    drop_last=False, frame_hw=(args.frame_h, args.frame_w))
                result = evaluate_real(model, eval_loader, db, args.cls,
                                       args.mode, size,
                                       (args.seed, 555, epoch), dev)
            else:
                # the LINEMOD triple over --eval-batches held-out batches
                # (granularity 1/(eval_batches * batch_size))
                accs = []
                for j in range(args.eval_batches):
                    eb = synthetic_linemod_batch(
                        generator(dev, args.seed, 999_999, j),
                        args.batch_size, model_pts, faces_t, kp3d, size)
                    p3 = kp3d.expand((args.batch_size,) + kp3d.shape)
                    R, t = predict_poses(model, synthetic_inputs(eb),
                                         args.mode, p3, eb['K'], (0,))
                    acc = evaluator.pose_accuracy(
                        model_pts, db.get_diameter(args.cls), eb['K'], R, t,
                        eb['R'], eb['t'],
                        symmetric=db.is_symmetric(args.cls))
                    accs.append(torch.stack([acc[k] for k in METRICS]))
                means = torch.stack(accs).mean(0).tolist()
                result = dict(zip(METRICS, means))
            events.log('epoch', epoch=epoch + 1, loss=loss_avg,
                       train_seconds=train_s, steps=len(losses))
            events.log('eval', epoch=epoch + 1, **result)
            _print_triple(result)
            save(epoch, result)

        if use_real and args.occ_pkl_dir:
            # OCCLUSION_LINEMOD eval (result_show.py:95-98, 378)
            occ_records = linemod_data.load_occlusion_records(
                args.occ_pkl_dir, args.cls)
            occ_loader = linemod_data.LinemodBatchLoader(
                occ_records, args.occ_image_root or args.image_root,
                args.cls, min(args.batch_size, len(occ_records)),
                shuffle=False, drop_last=False,
                frame_hw=(args.frame_h, args.frame_w))
            occ = evaluate_real(model, occ_loader, db, args.cls, args.mode,
                                size, (args.seed, 777), dev)
            result.update({f'occ_{k}': v for k, v in occ.items()})
            events.log('occ_eval', **occ)
            with open(os.path.join(args.workdir, 'occ_result.txt'),
                      'a') as fi:
                fi.write(f"{args.cls}\t{occ['projection_2d']:.6f}\t"
                         f"{occ['add']:.6f}\t{occ['cm_degree_5']:.6f}\n")
            _print_triple(occ, 'occlusion: ')
    finally:
        logger.close()
        events.close()
    return result


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workdir', default='runs/linemod')
    ap.add_argument('--cls', default='cat')
    ap.add_argument('--mode', choices=['heatmap', 'pvnet'], default='heatmap')
    ap.add_argument('--epochs', type=int, default=10)
    ap.add_argument('--steps-per-epoch', type=int, default=50)
    ap.add_argument('--batch-size', type=int, default=16)
    ap.add_argument('--crop-size', type=int, default=128)
    ap.add_argument('--num-keypoints', type=int, default=9)
    ap.add_argument('--lr', type=float, default=1e-3)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--pkl-dir', default=None,
                    help='directory of {cls}_{real,train,test,fuse,render}'
                         '.pkl (data_load3.py:89-121 layout)')
    ap.add_argument('--image-root', default='',
                    help='root for rgb_pth/dpt_pth record paths')
    ap.add_argument('--ply', default=None,
                    help='object mesh for ADD metrics (else the record '
                         'sift_3d cloud is used)')
    ap.add_argument('--augment', action='store_true',
                    help='real-data path: the PVNet training augmentation '
                         'chain (occlusion mask-out, instance rotation, '
                         'crop_resize_instance_v2 scale/window jitter, flip, '
                         'add_noise) on the device per batch '
                         '(linemod_dataset.py:256-293 parity)')
    ap.add_argument('--no-fuse', dest='use_fuse', action='store_false')
    ap.add_argument('--no-render', dest='use_render', action='store_false')
    ap.add_argument('--frame-h', type=int, default=480)
    ap.add_argument('--frame-w', type=int, default=640)
    ap.add_argument('--occ-pkl-dir', default=None,
                    help='pkl dir containing occ/{cls}_real.pkl '
                         '(OCCLUSION_LINEMOD eval, result_show.py:95-98)')
    ap.add_argument('--occ-image-root', default=None)
    ap.add_argument('--eval-batches', type=int, default=1,
                    help='synthetic mode: held-out eval batches per epoch '
                         '(metric granularity 1/(N*batch_size))')
    ap.add_argument('--device', default='cuda',
                    help="where to run: 'cuda' (default; without a card it "
                         "raises) or 'cpu'")
    return ap


def main(argv=None) -> dict:
    return train(_parser().parse_args(argv))


if __name__ == '__main__':
    main()
