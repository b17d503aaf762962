"""Parameter trees between ``repro`` (numpy) and ``repro_torch`` (tensors).

Both packages use the same tree: nested dicts and lists with dense weights
``[d_in, d_out]``.  ``params_from_jax`` takes ``repro``'s tree as numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns tensors on
``device``: bfloat16 leaves (``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses) bitwise as ``torch.bfloat16``, every other
leaf as float32; ``params_to_jax`` returns the numpy tree ``repro`` takes
(``jax.tree.map(jnp.asarray, tree)`` on the caller's side).

``lm_train_state_from_jax`` / ``lm_train_state_to_jax`` carry the LM
train state of ``repro``'s ``lm_init_train_state`` (``{"params": fp32
master, "opt": {"m", "v", "step"}}``, moments fp32 or bf16) across, the
step an int32 scalar on the CPU as the port's AdamW keeps it.

GraphCast's tree differs in one place: ``repro`` stacks the processor's
layers along a leading axis for its scan (``proc``: one tree whose every
leaf is ``[n_layers, ...]``), the port keeps a list of ``n_layers`` layer
trees.  ``graphcast_params_from_jax`` / ``graphcast_params_to_jax`` map the
one to the other and every other key as above.
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
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:           # numpy has no bfloat16: JAX's own type
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def lm_train_state_from_jax(np_state, device="cuda"):
    """``repro``'s LM train state (numpy leaves) -> the port's, on
    ``device``; bf16 moments bitwise."""
    opt = np_state["opt"]
    return {"params": params_from_jax(np_state["params"], device),
            "opt": {"m": params_from_jax(opt["m"], device),
                    "v": params_from_jax(opt["v"], device),
                    "step": torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32)}}


def lm_train_state_to_jax(state):
    """The port's LM train state -> ``repro``'s tree of numpy arrays."""
    opt = state["opt"]
    return {"params": params_to_jax(state["params"]),
            "opt": {"m": params_to_jax(opt["m"]), "v": params_to_jax(opt["v"]),
                    "step": np.asarray(int(opt["step"]), dtype=np.int32)}}


def _unstack(np_tree, i):
    if isinstance(np_tree, dict):
        return {k: _unstack(v, i) for k, v in np_tree.items()}
    if isinstance(np_tree, (list, tuple)):
        return [_unstack(v, i) for v in np_tree]
    return np.asarray(np_tree)[i]


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return np.stack(trees)


def _n_stacked(np_tree):
    while isinstance(np_tree, (dict, list, tuple)):
        np_tree = next(iter(np_tree.values())) if isinstance(np_tree, dict) else np_tree[0]
    return np.asarray(np_tree).shape[0]


def graphcast_params_from_jax(np_tree, device="cuda"):
    """``repro``'s GraphCast params (numpy, ``proc`` stacked per layer) ->
    the port's tree (``proc`` a list of layers) of tensors on ``device``."""
    out = {k: v for k, v in np_tree.items() if k != "proc"}
    proc = np_tree["proc"]
    out["proc"] = [_unstack(proc, i) for i in range(_n_stacked(proc))]
    return params_from_jax(out, device)


def graphcast_params_to_jax(tree):
    """The port's GraphCast params -> ``repro``'s numpy tree, ``proc``
    stacked along a leading layer axis."""
    out = params_to_jax({k: v for k, v in tree.items() if k != "proc"})
    out["proc"] = _stack([params_to_jax(p) for p in tree["proc"]])
    return out
