"""Device ms of the program's RANSAC-EPnP (``ops/pnp.ransac_epnp``) on the
first frame of the last profiled call, its keypoints, selection and
uniforms, in a CUDA graph of the harness's own timed by CUDA events."""

import torch

from h100_bench.trace import graph_ms


def read(rec):
    live = rec.live
    if getattr(live, 'last', None) is None:
        return None
    from esa_pose_estimation_tpu_torch.core.camera import speed_k
    from esa_pose_estimation_tpu_torch.ops import pnp
    s = live.config['serving']
    kp = live.last.keypoints_2d[:1].contiguous()
    sel = live.last.selected[:1].contiguous()
    u = live.uniforms[:1].contiguous()
    p3 = live.pts.expand((1,) + live.pts.shape)
    K = speed_k(torch.float32, live.device)
    with torch.no_grad():
        return graph_ms(lambda: pnp.ransac_epnp(
            p3, kp, K, None, valid=sel, n_hypotheses=s['n_hypotheses'],
            sample_size=s['sample_size'], lm_iters=s['lm_iters'],
            uniforms=u))
