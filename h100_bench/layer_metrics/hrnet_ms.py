"""Device ms of the served network, ``model(x)`` on the cell's batch of
normalised crops, replayed in a CUDA graph of the harness's own and timed
by CUDA events."""

import torch

from h100_bench.trace import graph_ms


def read(rec):
    live = rec.live
    if getattr(live, 'model', None) is None:
        return None
    size = rec.config['crop_size']
    g = torch.Generator(device=live.device).manual_seed(0)
    x = torch.randn((live.batch, size, size, rec.config['in_channels']),
                    generator=g, device=live.device)
    with torch.no_grad():
        return graph_ms(lambda: live.model(x))
