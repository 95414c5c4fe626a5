"""Weights for the plain reference: the npz inference artifact read into
the reference network's ``state_dict``, with no code of the port.

The artifact is flat: ``p:<slash/path>`` a parameter leaf stored as the
uint16 bits of a bf16, ``s:<path>`` a batch-statistics leaf in f32.  Conv
``kernel`` (HWIO) becomes ``weight`` (OIHW), BatchNorm ``scale`` becomes
``weight``, ``mean``/``var`` become ``running_mean``/``running_var``; module
paths become dotted names.
"""

from __future__ import annotations

import numpy as np
import torch

_PARAM_LEAF = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias'}
_STAT_LEAF = {'mean': 'running_mean', 'var': 'running_var'}


def read_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The artifact at ``path`` as f32 CPU tensors under the reference
    network's names."""
    out: dict[str, torch.Tensor] = {}
    with np.load(path) as z:
        for key in z.files:
            if key.startswith('p:'):
                bits = z[key].view(np.uint16).astype(np.uint32) << 16
                value, leaves = bits.view(np.float32), _PARAM_LEAF
            elif key.startswith('s:'):
                value, leaves = np.asarray(z[key], np.float32), _STAT_LEAF
            else:
                continue
            *mods, leaf = key[2:].split('/')
            if leaf not in leaves:
                raise KeyError(f'unmapped leaf {key!r}')
            if leaf == 'kernel':
                value = value.transpose(3, 2, 0, 1)
            name = '.'.join(mods + [leaves[leaf]])
            if name in out:
                raise KeyError(f'two leaves map to {name!r}')
            out[name] = torch.from_numpy(np.ascontiguousarray(value))
    return out
