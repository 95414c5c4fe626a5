"""The ViTPose cell's run on the CPU at ``vitpose_tiny`` size, for the
harness's tests: the cell's own files with the network, the pool and the
calls cut down, the look for a card skipped, and limits set for this
size."""

from __future__ import annotations

from h100_bench import harness, run

CELL = 'vitpose_h_offline_b64'
# the program in f32 here, against the f32 reference: their orders of
# summation alone (seen: heatmap_gap ~2.5e-7, confidence_gap ~9e-8, where
# attention's scale left out reads 5.4e-4 and 1.0e-4); the decode and the
# solve of the served outputs take the same plain path on the CPU (0); the
# share of far frames keeps the cell's own limit
LIMITS = {'heatmap_gap': 1e-5, 'keypoint_gap_px': 1e-3,
          'confidence_gap': 1e-5, 'solve_rotation_gap_median_rad': 1e-5,
          'solve_translation_gap_median': 1e-5,
          'solve_far_share': harness.workload(CELL)['limits'][
              'solve_far_share']}
TINY = dict(crop_size=64, embed_dim=64, depth=2, num_heads=4, head_dim=16,
            head_channels=[32, 32], heatmap_size=16, num_keypoints=8,
            head_final_std=300.0, compute_dtype='float32')


def context(seed: int = 2**33 + 7):
    wl = harness.workload(CELL)
    cfg = harness.config(wl['config'])
    cfg.update(TINY)
    cfg['serving'] = dict(cfg['serving'], min_keypoints=6)
    wl['traffic'].update(batch=4, pool_frames=8, check_frames=6,
                         warm_up_calls=1, ahead_calls=2)
    wl['limits'] = dict(LIMITS)
    return run.make_context(CELL, seed, 1.0, False, 'cpu', wl=wl, cfg=cfg)
