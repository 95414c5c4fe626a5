"""The work the shares divide by, from the configuration's shapes on the
benchmark's own reference network, whatever implements it, and the
published peaks of one NVIDIA H100 SXM (dense, 700 W).

* :func:`forward_flops`: ``FlopCounterMode``'s count of one forward of the
  reference network (its convolutions and products);
* :func:`train_flops`: the same of a training step, forward and backward
  through the loss (the optimizer's elementwise work is not counted);
* :func:`k1_bytes`: the peak decode's least traffic, each heatmap read
  once (f32) and the coordinates and confidences written once.

The configuration files hold the figures these give at their shapes
(``flops_forward_per_image``, ``flops_train_per_image``), which a CPU test
holds to the functions.
"""

from __future__ import annotations

import torch

PEAK_BF16_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s
PEAK_HBM_BYTES = 3.35e12        # HBM3 bytes/s


def _network(cfg: dict):
    from h100_bench.reference import serve
    return serve.build(cfg)


def _input(cfg: dict, batch: int) -> torch.Tensor:
    size = cfg['crop_size']
    return torch.zeros((batch, size, size, cfg['in_channels']))


def forward_flops(cfg: dict, batch: int = 1) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device('meta'):
        model = _network(cfg).eval()
        x = _input(cfg, batch)
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            model(x)
    return int(fc.get_total_flops())


def train_flops(cfg: dict, batch: int = 1) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    from h100_bench.reference.loss import weighted_heatmap_loss
    with torch.device('meta'):
        model = _network(cfg).train()
        x = _input(cfg, batch)
        target = torch.zeros(x.shape[:3] + (cfg['num_keypoints'],))
        with FlopCounterMode(display=False) as fc:
            weighted_heatmap_loss(model(x), target, target).backward()
    return int(fc.get_total_flops())


def k1_bytes(batch: int, size: int, keypoints: int) -> int:
    return batch * size * size * keypoints * 4 + batch * keypoints * 3 * 4
