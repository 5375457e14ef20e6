"""Convert a parameter tree of numpy arrays into the port's tensors.

The reference package's params (a nested dict whose leaves convert with
``numpy.asarray``) have the same keys and shapes as the port's, in each of
its layouts (a uniform stack's ``blocks/...`` leaves, a hybrid pattern's
``blocks_{i}/...`` stacks or per-layer ``layer_{i:03d}/...`` subtrees), so
both sides can be fed the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import dtype_of


def params_from_numpy(tree, device, dtype) -> dict:
    """Nested dict of array-likes -> nested dict of tensors on ``device``.
    Floating leaves become ``dtype`` (rounded to nearest even, as the
    reference's casts do); integer leaves keep their type."""
    dtype = dtype_of(dtype)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind in "iub":
        return torch.from_numpy(arr.copy()).to(device)
    # numpy has no bfloat16: widen to float32 (exact) before handing over
    return torch.from_numpy(arr.astype(np.float32)).to(device=device,
                                                       dtype=dtype)
