"""Parameter trees between ``repro`` (numpy) and ``repro_torch`` (tensors).

Both packages use the same tree: nested dicts and lists with dense weights
``[d_in, d_out]``.  ``params_from_jax`` takes ``repro``'s tree as numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns tensors on
``device``: bfloat16 leaves (``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses) bitwise as ``torch.bfloat16``, every other
leaf as float32; ``params_to_jax`` returns the numpy tree ``repro`` takes
(``jax.tree.map(jnp.asarray, tree)`` on the caller's side).
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(np_tree, device="cuda"):
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, device) for k, v in np_tree.items()}
    if isinstance(np_tree, (list, tuple)):
        return [params_from_jax(v, device) for v in np_tree]
    arr = np.asarray(np_tree)
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr).view(np.uint16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(np_tree, dtype=np.float32)).to(device)


def params_to_jax(tree):
    if isinstance(tree, dict):
        return {k: params_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_jax(v) for v in tree]
    return tree.detach().cpu().numpy()
