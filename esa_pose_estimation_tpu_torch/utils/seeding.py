"""Seeded ``torch.Generator`` streams for the commands."""

from __future__ import annotations

import numpy as np
import torch


def generator(device, *entropy: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``entropy``:
    distinct tuples give independent streams (an epoch's data, the eval
    frames, the RANSAC draws), the same tuple the same stream, so a
    resumed run sees the data an unbroken one would."""
    seed = int(np.random.SeedSequence(list(entropy)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)
