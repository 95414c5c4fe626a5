"""The HRFormer cell's run on the CPU at ``hrformer_tiny`` size, and the
host-ingest cell's at ``hrnet_tiny`` size, for the harness's tests: the
cells' own files with the network, the pool and the calls cut down, the
look for a card skipped, and limits set for these sizes."""

from __future__ import annotations

from h100_bench import harness, run
from h100_bench.tests import _tiny, _tiny_vit

HRF_CELL = 'hrformer_b_offline_b64'
HOST_CELL = 'serve_offline_host_b256'
# the program in f32 here, against the f32 reference, as _tiny_vit's; no
# frame is far here (seen: 0), and _tiny_vit's far share of 0.1 fails one
# frame in the six judged (the cell's 0.18 is set for 256 bf16 frames)
HRF_LIMITS = dict(_tiny_vit.LIMITS)
TINY = dict(crop_size=64, stem_channels=16, stage1_blocks=1,
            stage1_planes=16, channels=[39, 78, 117, 156],
            heads=[1, 2, 3, 4], modules=[1, 1, 1], blocks_per_branch=1,
            mlp_ratio=2, heatmap_size=16, num_keypoints=8,
            head_final_std=0.03, compute_dtype='float32')


def hrf_context(seed: int = 2**33 + 7):
    wl = harness.workload(HRF_CELL)
    cfg = harness.config(wl['config'])
    cfg.update(TINY)
    cfg['serving'] = dict(cfg['serving'], min_keypoints=6)
    wl['traffic'].update(batch=4, pool_frames=8, check_frames=6,
                         warm_up_calls=1, ahead_calls=2)
    wl['limits'] = dict(HRF_LIMITS)
    return run.make_context(HRF_CELL, seed, 1.0, False, 'cpu', wl=wl,
                            cfg=cfg)


def host_context(weights: str, seed: int = 2**33 + 7):
    wl = harness.workload(HOST_CELL)
    cfg = harness.config(wl['config'])
    cfg.update(model='hrnet_tiny', num_keypoints=6, stem_channels=8,
               widths=[8, 16, 32, 64], blocks=[1, 1, 1, 1], weights=weights)
    wl['traffic'].update(batch=4, pool_frames=8, check_frames=6,
                         warm_up_calls=1, ahead_calls=2)
    wl['limits'] = dict(_tiny.SERVE_LIMITS)
    return run.make_context(HOST_CELL, seed, 1.0, False, 'cpu', wl=wl,
                            cfg=cfg)
