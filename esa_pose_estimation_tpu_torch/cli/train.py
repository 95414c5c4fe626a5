"""Keypoint training command: the reference ``main.py:237-424`` as a command
(port of the JAX package's ``cli/train.py``).

    python -m esa_pose_estimation_tpu_torch.cli.train --workdir runs/esa \\
        [--train-pkl data/train.pkl --test-pkl data/test.pkl \\
         --image-root /data/speed/images/train/ | \\
         --train-shard data/train.spd [--loader-threads 4] [--host-crop]] \\
        [--epochs 100] [--batch-size 32] [--synthetic-size 2048] \\
        [--augment-geom] [--augment-photo] [--tiny] [--device cpu] \\
        [--coordinator host:port --num-processes N --process-id i]

HRNet-W32+CBAM (``--tiny``: ``hrnet_tiny``) in bf16 over f32 master
weights, Adam with the stepped schedule, the weighted HeatmapWing loss, a
periodic SPEED-score eval (``cli/evaluate.evaluate`` over an
``EvalCache`` built once), rolling ``last`` + ``best_tran``/``best_rotate``
checkpoints (``train/checkpoint.py``), TSV/JSONL logs, optional
TensorBoard scalars and TCP telemetry.  A run resumes from ``last``.

Data: ``--train-shard`` streams an SPD1 shard (``data/shards.py``)
through the C++ loader (``data/native_loader.py``, built at first use) in
page-locked host tensors, the production input route; ``--host-crop``
crops on the loader's threads and ships 128x128 crops in place of
1920x1200 frames.  ``--train-pkl``/``--image-root`` read the SPEED pickle
layout (data_load4.py:90-101) through ``data/speed.BatchLoader``.  Both
keep two batches' copies to the card in flight, and train a step per
batch through ``train/state.make_train_steps`` (the batch build and the
step, ``data/pipeline.step_loss``: on the card one CUDA graph replay per
step).  Without either, the synthetic dataset (``data/synthetic.make_batch``)
is generated on the device, ``--log-every`` steps at a time by
``train/state.make_scan_step`` (on the card one CUDA graph replay per
chunk, and a second graph for an epoch's shorter tail).  Both hold for any
number of processes.  ``--test-pkl`` gives the held-out eval split of
either route; a shard run without it evaluates on the shard's first four
batches.

Several processes, one per card: ``--coordinator host:port
--num-processes N --process-id i`` (or ``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``) join one NCCL group (gloo with ``--device
cpu``).  ``--batch-size`` is the global batch and must divide over the
processes; each process streams its own slice of the records at its
share of the batch, DistributedDataParallel averages the gradients, the
BatchNorm statistics are taken over the global batch
(``models/layers.BatchNorm``), and the loss each step reports is the
global batch's (the mean over the processes), so every process logs the
same losses, as the JAX package does.  Each graph holds its steps'
collectives.  Process i > 0 writes its logs and checkpoints under
``<workdir>/proc{i}``: the primary's are the run's.

Each held-out eval draws the first four frames of its first batch as
PNG panels under ``<workdir>/panels/epoch<NNN>/`` (``obs/visual.py``,
which needs matplotlib); ``--no-panels`` skips them.

Runs on the card (``--device cuda``, the default; without one it raises)
or on the CPU with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time

import torch

from esa_pose_estimation_tpu_torch.cli.evaluate import evaluate
from esa_pose_estimation_tpu_torch.data import pipeline as data_pipeline
from esa_pose_estimation_tpu_torch.data import speed as speed_data
from esa_pose_estimation_tpu_torch.data import synthetic
from esa_pose_estimation_tpu_torch.eval.eval_cache import EvalCache
from esa_pose_estimation_tpu_torch.eval.evaluator import AverageMeter
from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
from esa_pose_estimation_tpu_torch.obs import (
    JsonlLogger,
    TbWriter,
    TcpPusher,
    TsvLogger,
)
from esa_pose_estimation_tpu_torch.parallel import distributed as dist
from esa_pose_estimation_tpu_torch.parallel.mesh import wrap_data_parallel
from esa_pose_estimation_tpu_torch.train import checkpoint as checkpoint_mod
from esa_pose_estimation_tpu_torch.train import state as state_mod
from esa_pose_estimation_tpu_torch.train.checkpoint import CheckpointManager
from esa_pose_estimation_tpu_torch.utils import config as cfg_mod
from esa_pose_estimation_tpu_torch.utils.artifact import target_device
from esa_pose_estimation_tpu_torch.utils.seeding import generator

CLASS_NAME = 'esa'


def lr_boundaries(epochs: int, explicit: str | None) -> tuple[int, ...]:
    """``--lr-boundaries``, or the reference's 80/100/170 (main.py:298-299),
    which assume a ~100-epoch run, scaled to shorter runs so that the 10x
    decays still happen."""
    if explicit:
        return tuple(int(b) for b in explicit.split(','))
    base = cfg_mod.TrainConfig.lr_boundaries
    if epochs >= base[1]:
        return base
    return tuple(max(1, round(b * epochs / 100)) for b in base)


def _synthetic_eval_batches(device, batch_size, points_3d, crop_size):
    """The fixed held-out frames of the synthetic route: four
    frame-carrying batches from fixed seeds, made one at a time (each
    batch's frames are freed once the cache has cropped them)."""
    for j in range(4):
        yield synthetic.make_batch(generator(device, 1234, 9000 + j),
                                   batch_size, points_3d,
                                   crop_size=crop_size, with_frames=True)


def _shard_eval_batches(args, dev):
    """The held-out frames of a shard run without ``--test-pkl``: the
    shard's first four batches, in order."""
    from esa_pose_estimation_tpu_torch.data.native_loader import (
        NativeBatchLoader,
    )
    with NativeBatchLoader(args.train_shard, args.batch_size,
                           n_threads=args.loader_threads, shuffle=False,
                           device=dev) as loader:
        yield from itertools.islice(iter(loader), 4)


def _check_batch(args) -> None:
    n = dist.requested_processes(args.num_processes)
    if args.batch_size % n:
        raise ValueError(f'--batch-size {args.batch_size} (global) must '
                         f'divide over {n} processes')


def train(args) -> dict:
    dev = target_device(args.device, 'cli.train')
    _check_batch(args)
    dist.initialize(args.coordinator, args.num_processes, args.process_id,
                    device=dev)
    if dev.type == 'cuda':
        dev = torch.device('cuda', torch.cuda.current_device())
    n_proc, rank = dist.world_size(), dist.rank()
    proc_batch = args.batch_size // n_proc
    cfg = cfg_mod.TrainConfig(
        batch_size=args.batch_size, crop_size=args.crop_size,
        num_epochs=args.epochs,
        lr_boundaries=lr_boundaries(args.epochs, args.lr_boundaries),
        **({'eval_every': args.eval_every} if args.eval_every else {}),
        **({'eval_after': args.eval_after}
           if args.eval_after is not None else {}))
    # the primary's logs and checkpoints are the run's
    workdir = (os.path.join(args.workdir, f'proc{rank}') if rank
               else args.workdir)
    os.makedirs(workdir, exist_ok=True)

    model_cfg = cfg_mod.hrnet_tiny() if args.tiny else cfg_mod.hrnet_esa()
    dtype = (torch.bfloat16 if cfg.compute_dtype == 'bfloat16'
             else torch.float32)
    model = HRNet(model_cfg, dtype=dtype).to(
        device=dev, memory_format=torch.channels_last)
    model.init_weights(generator(dev, cfg.seed))
    norm_mean = (args.norm_mean if args.norm_mean is not None
                 else 0.5 if args.mixed else 0.449)

    # data ------------------------------------------------------------------
    use_shard = args.train_shard is not None
    use_real = args.train_pkl is not None
    test_records = None
    if use_shard:
        from esa_pose_estimation_tpu_torch.data.native_loader import (
            NativeBatchLoader,
        )
        shard_loader = NativeBatchLoader(
            args.train_shard, proc_batch, n_threads=args.loader_threads,
            shuffle=args.shuffle, seed=cfg.seed,
            crop_size=cfg.crop_size if args.host_crop else None,
            process_id=rank, process_count=n_proc, device=dev)
        if shard_loader.meta.n_kp != model_cfg.num_keypoints:
            shard_loader.close()
            raise ValueError(
                f'the shard has {shard_loader.meta.n_kp} keypoints but the '
                f'model outputs {model_cfg.num_keypoints}')
        points_3d = synthetic.spacecraft_points(
            device=dev, n=model_cfg.num_keypoints)
        steps_per_epoch = max(shard_loader.meta.n_records // cfg.batch_size,
                              1)
        if args.test_pkl:
            test_records = speed_data.records_from_pickle(args.test_pkl,
                                                          args.image_root)
    elif use_real:
        # --mixed: data_load5 semantics, one pickle of synthetic-train and
        # real_test records routed by filename length, normalized at 0.5
        from_pkl = (speed_data.records_from_pickle_mixed if args.mixed
                    else speed_data.records_from_pickle)
        train_records = from_pkl(args.train_pkl, args.image_root)
        steps_per_epoch = max(len(train_records) // cfg.batch_size, 1)
        test_records = (from_pkl(args.test_pkl, args.image_root)
                        if args.test_pkl else train_records[:64])
        points_3d = torch.as_tensor(train_records[0].keypoints_3d,
                                    device=dev)
        # process i trains on its slice at its share of the batch
        train_records = dist.local_slice(train_records)
    else:
        points_3d = synthetic.spacecraft_points(
            device=dev, n=model_cfg.num_keypoints)
        steps_per_epoch = max(args.synthetic_size // cfg.batch_size, 1)

    # state, logs, checkpoints ------------------------------------------------
    st = state_mod.create_train_state(model, cfg, steps_per_epoch)
    ckpt = CheckpointManager(os.path.join(workdir, f'net_{CLASS_NAME}'))
    st, begin_epoch = ckpt.restore(checkpoint_mod.LAST, st)
    if n_proc > 1:
        st.train_model = wrap_data_parallel(model)
    logger = TsvLogger(os.path.join(workdir, f'log_{CLASS_NAME}.txt'),
                       resume=True)
    logger.set_names(['Epoch', 'LR', 'Train Loss'])
    events = JsonlLogger(os.path.join(workdir, 'events.jsonl'))
    tb = TbWriter(os.path.join(workdir, 'tb')) if args.tb else None
    tcp = TcpPusher(host=args.tcp_host)
    tcp.create_socket(classname=CLASS_NAME)

    # the synthetic route runs make_scan_step, one per chunk length (the
    # JAX scan_cache); the shard and pickle routes a step program of one
    # step (the JAX make_sharded_train_step with build_batch), on the card
    # one CUDA graph replay per call, for any number of processes
    scan = not (use_shard or use_real)
    scans: dict[int, object] = {}
    if scan:
        batch_fn = state_mod.BatchFn(
            draw=lambda g: synthetic.draw_batch(
                g, proc_batch, cfg.crop_size, args.augment_geom,
                args.augment_photo, device=dev),
            make=lambda d: synthetic.make_batch(
                None, proc_batch, points_3d, crop_size=cfg.crop_size,
                augment_geom=args.augment_geom,
                augment_photo=args.augment_photo, draws=d))
    else:
        def step_loss(model, x):
            return data_pipeline.step_loss(
                model, x, cfg.crop_size, norm_mean, args.augment_geom,
                args.augment_photo, cfg.loss_weight_w)
        step = state_mod.make_train_steps(st, step_loss)
    print(f'training program: train/state.'
          f'{"make_scan_step" if scan else "make_train_steps"}, '
          f'{"a CUDA graph" if dev.type == "cuda" else "steps on the CPU"}'
          f' per call, {n_proc} process(es)')

    # the running minima of the best gates survive a resume (sidecar)
    best: dict[str, float] = ckpt.load_best()
    result: dict = {}
    eval_cache = None          # built at the first eval: the split is fixed
    try:
        for epoch in range(begin_epoch, cfg.num_epochs):
            t0 = time.time()
            losses = AverageMeter()
            # each process draws its own augmentations (one process: the
            # stream of a single-card run)
            gen = generator(dev, 1234, epoch, *([rank] if n_proc > 1 else []))
            if not scan:
                if use_shard:
                    src = iter(shard_loader)
                else:
                    src = iter(speed_data.BatchLoader(
                        train_records, proc_batch, shuffle=args.shuffle,
                        seed=epoch))
                batches = (data_pipeline.step_inputs(
                    b, gen, cfg.crop_size, args.augment_geom,
                    args.augment_photo)
                    for b in data_pipeline.prefetch_to_device(src, dev,
                                                              size=2))

            # per-step losses stay on the device; the host reads one per
            # print interval (the reference's cadence, main.py:396-398)
            # and the epoch mean once
            loss_hist = []
            if scan:
                # the synthetic route, as the JAX package's: log_every
                # steps (or the epoch's tail) per call of a scan, one
                # CUDA graph replay on the card
                base = 0
                while base < steps_per_epoch:
                    n = min(args.log_every, steps_per_epoch - base)
                    if n not in scans:
                        scans[n] = state_mod.make_scan_step(
                            st, batch_fn, n, cfg.loss_weight_w)
                    chunk = scans[n](gen)
                    loss_hist.append(chunk)
                    base += n
                    if base % args.log_every == 0:
                        losses.update(float(chunk[-1]))
                        print(f'{CLASS_NAME} [{epoch + 1}, {base}] '
                              f'loss : {losses.avg:.6f}')
            else:
                for i, batch in enumerate(batches):
                    loss = step([batch])
                    loss_hist.append(loss)
                    if i % args.log_every == args.log_every - 1:
                        losses.update(float(loss[0]))
                        print(f'{CLASS_NAME} [{epoch + 1}, {i + 1}] '
                              f'loss : {losses.avg:.6f}')
            losses.avg = (float(torch.cat(loss_hist).mean()) if loss_hist
                          else float('nan'))
            lr = st.schedule(st.step)
            logger.append([epoch + 1, lr, losses.avg])
            tcp.send(f'{epoch + 1}\t{lr}\t{round(losses.avg, 10)}\t',
                     type='log', classname=CLASS_NAME)
            events.log('epoch', epoch=epoch + 1, lr=lr, loss=losses.avg,
                       seconds=time.time() - t0)
            if tb:
                tb.scalars(epoch + 1, {'train/loss': losses.avg,
                                       'train/lr': lr})
            # 'last' goes before the eval: a crash in the eval must not lose
            # the epoch's training (a deterministic eval failure would
            # otherwise retrain the same epoch forever); the best aliases
            # are gated after it
            ckpt.save(checkpoint_mod.LAST, st, epoch)
            if not (epoch > cfg.eval_after
                    or epoch % cfg.eval_every == cfg.eval_every - 1):
                continue
            if eval_cache is None:
                if test_records is not None:
                    src = speed_data.BatchLoader(
                        test_records, min(cfg.batch_size, len(test_records)),
                        shuffle=False)
                elif use_shard:
                    src = _shard_eval_batches(args, dev)
                else:
                    src = _synthetic_eval_batches(dev, cfg.batch_size,
                                                  points_3d, cfg.crop_size)
                eval_cache = EvalCache(model, src, points_3d, cfg.crop_size,
                                       norm_mean=norm_mean)
                events.log('eval_cache', frames=eval_cache.n_frames,
                           **eval_cache.timing)
            model.eval()
            result = evaluate(
                model, eval_cache, points_3d, generator(dev, 1234, 777),
                cfg.crop_size, norm_mean=norm_mean,
                panel_dir=(os.path.join(workdir, 'panels',
                                        f'epoch{epoch + 1:03d}')
                           if args.eval_panels else None))
            best = ckpt.save_rolling(st, epoch, score_tran=result['score_t'],
                                     score_rotate=result['score_r'],
                                     best=best, save_last=False)
            events.log('eval', epoch=epoch + 1, **result)
            if tb:
                tb.scalars(epoch + 1, {'eval/score_t': result['score_t'],
                                       'eval/score_r': result['score_r'],
                                       'eval/speed': result['speed']})
            tcp.send('\t'.join(str(v) for v in [CLASS_NAME, epoch,
                                                 result['score_t'],
                                                 result['score_r']]),
                     type='load', classname=CLASS_NAME)
            print(f"eval epoch {epoch + 1}: speed={result['speed']:.5f} "
                  f"(t={result['score_t']:.5f}, r={result['score_r']:.5f})")
    finally:
        if use_shard:
            shard_loader.close()
        logger.close()
        events.close()
        if tb:
            tb.close()
        tcp.close()
    print('Finished Training')
    return result


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workdir', default='runs/esa')
    ap.add_argument('--train-pkl', default=None)
    ap.add_argument('--test-pkl', default=None)
    ap.add_argument('--train-shard', default=None,
                    help='SPD1 shard read through the native C++ loader '
                         '(data/shards.py layout; the 3D model points are '
                         'the synthetic spacecraft_points)')
    ap.add_argument('--loader-threads', type=int, default=4)
    ap.add_argument('--host-crop', action='store_true',
                    help='with --train-shard: crop and resize on the '
                         "loader's threads and copy 65 KB crops to the card "
                         'in place of 2.3 MB frames')
    ap.add_argument('--image-root', default='')
    ap.add_argument('--mixed', action='store_true',
                    help='data_load5 semantics: --train-pkl mixes synthetic '
                         'train + real_test records routed by filename '
                         'length; normalization mean defaults to 0.5')
    ap.add_argument('--norm-mean', type=float, default=None,
                    help='crop normalization mean (default 0.449, or 0.5 '
                         'with --mixed; data_load4.py:81/data_load5.py:83)')
    ap.add_argument('--epochs', type=int, default=100)
    ap.add_argument('--batch-size', type=int, default=32)
    ap.add_argument('--crop-size', type=int, default=128)
    ap.add_argument('--synthetic-size', type=int, default=2048)
    ap.add_argument('--tcp-host', default=None)
    ap.add_argument('--tb', action='store_true',
                    help='also write TensorBoard scalar event files to '
                         '<workdir>/tb/')
    ap.add_argument('--lr-boundaries', default=None,
                    help='comma-separated epoch boundaries of the 10x LR '
                         'drops (default: the reference 80,100,170 scaled '
                         'to --epochs)')
    ap.add_argument('--no-panels', dest='eval_panels',
                    action='store_false',
                    help='skip the PNG panels of each held-out eval')
    ap.add_argument('--tiny', action='store_true',
                    help='the tiny model topology, for smoke tests')
    ap.add_argument('--log-every', type=int, default=10,
                    help='steps between loss prints; each print reads one '
                         'loss back from the card')
    ap.add_argument('--augment-geom', action='store_true',
                    help='train-time horizontal flip + in-plane rotation in '
                         'crop space: the synthetic route transforms the '
                         'keypoints before rendering (+-180 deg), the '
                         'pickle route resamples the crop (+-25 deg)')
    ap.add_argument('--augment-photo', action='store_true',
                    help='train-time exposure gain/offset + gaussian-noise-'
                         'or-motion-blur coin on the crops '
                         '(data/augment.perturb_capture, the transform '
                         'cli/eval_synthetic --perturb probes with)')
    ap.add_argument('--eval-every', type=int, default=None,
                    help='epochs between SPEED evals before --eval-after '
                         '(default 5; every epoch after)')
    ap.add_argument('--eval-after', type=int, default=None,
                    help='epoch after which every epoch is evaluated '
                         '(default 80)')
    ap.add_argument('--no-shuffle', dest='shuffle', action='store_false',
                    help='deterministic record order')
    ap.add_argument('--max-retries', type=int, default=0,
                    help='restart and resume from the last checkpoint on '
                         'failure (the reference wraps train() in '
                         'try/except, main.py:440-443)')
    ap.add_argument('--coordinator', default=None,
                    help='several processes: host:port where process 0 '
                         'listens (or MASTER_ADDR and MASTER_PORT)')
    ap.add_argument('--num-processes', type=int, default=None,
                    help='several processes: how many (or WORLD_SIZE)')
    ap.add_argument('--process-id', type=int, default=None,
                    help="several processes: this one's index (or RANK)")
    ap.add_argument('--device', default='cuda',
                    help="where to run: 'cuda' (default; without a card it "
                         "raises) or 'cpu'")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = target_device(args.device, 'cli.train')
    _check_batch(args)
    joined = dist.initialize(args.coordinator, args.num_processes,
                             args.process_id, device=dev)
    attempt = 0
    try:
        while True:
            try:
                result = train(args)
                break
            except Exception as e:  # noqa: BLE001 — the retry boundary
                attempt += 1
                if attempt > args.max_retries:
                    raise
                print(f'train attempt {attempt} failed ({e!r}); resuming '
                      f'from the last checkpoint')
        # the primary hosts the rendezvous: no process leaves before all
        # are done
        dist.barrier()
        return result
    finally:
        if joined:
            dist.shutdown()


if __name__ == '__main__':
    main()
