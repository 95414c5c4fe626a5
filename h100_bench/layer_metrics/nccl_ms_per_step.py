"""Device ms per training step of the NCCL kernels on rank 0's card in
the profiled calls (DDP's bucket all-reduces, the global-batch BatchNorm's
and the loss's)."""


def read(rec):
    ks = [k for k in rec.trace.kernels() if 'nccl' in k.name.lower()]
    if not ks or not rec.steps:
        return None
    return sum(k.end - k.start for k in ks) * 1e-3 / rec.steps
