"""DLRM RM2 in the torch port against the JAX reference package: data,
config, forward, the lookup against the reference's sharded lookup, one
train step, retrieval and the cell builder, at the smoke config on the CPU.

Both packages start from ``repro``'s own params (``init_dlrm`` with
``PRNGKey(0)``, carried across by ``repro_torch.convert``); inputs come from
``criteo_like`` with a seed.  Bands: the forward rtol 1e-5 / atol 1e-6, the
band the reference holds its own sharded lookup to
(``tests/test_gnn_zoo.py``); the loss rel 2e-6 and the gradients, updated
params and moments rtol 1e-3 / atol 2e-5, the reference's gradient band
(``tests/test_consistency.py``); retrieval top-k ids equal, values
rtol 1e-5.  The in-place AdamW is bitwise the same in row chunks as in
one piece, and the functional AdamW leaves its inputs as they were.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import dlrm_rm2 as ref_rm2
from repro.configs.recsys_common import RECSYS_SHAPES as REF_SHAPES
from repro.graph.datasets import criteo_like as ref_criteo_like
from repro.models import dlrm as ref_dlrm
from repro.sharding import split_tree as ref_split_tree
from repro.train import optimizer as ref_opt

from repro_torch import nn
from repro_torch.configs import get_arch
from repro_torch.configs import dlrm_rm2
from repro_torch.configs.recsys_common import RECSYS_SHAPES
from repro_torch.convert import params_from_jax
from repro_torch.graph.datasets import criteo_like
from repro_torch.kernels import build
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.models import dlrm
from repro_torch.train import optimizer
from repro_torch.train.optimizer import (
    AdamWConfig, adamw_update, adamw_update_, init_adamw)

RTOL, ATOL = 1e-5, 1e-6            # the reference's sharded-lookup band
G_RTOL, G_ATOL = 1e-3, 2e-5        # the reference's gradient band
LOSS_REL = 2e-6


def _ref_params(cfg):
    params, _ = ref_split_tree(ref_dlrm.init_dlrm(jax.random.PRNGKey(0), cfg), {})
    return params


def _both(cfg, batch, seed=0):
    """(ref params, port params, numpy (dense, sparse, labels))."""
    params = _ref_params(cfg)
    return params, params_from_jax(jax.tree.map(np.asarray, params), "cpu"), \
        ref_criteo_like(batch, cfg, seed=seed)


def _port_cfg(ref_cfg):
    return dlrm.DLRMConfig(**dataclasses.asdict(ref_cfg))


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("which", ["smoke", "rm2"])
def test_data_and_config_match_reference(which):
    ref_cfg = ref_rm2.smoke_config() if which == "smoke" else ref_rm2.config()
    cfg = dlrm_rm2.smoke_config() if which == "smoke" else dlrm_rm2.config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.n_interactions == ref_cfg.n_interactions
    assert dlrm_rm2._mlp_flops(cfg) == ref_rm2._mlp_flops(ref_cfg)
    assert np.array_equal(dlrm.field_offsets(cfg), ref_dlrm.field_offsets(ref_cfg))
    for got, want in zip(criteo_like(64, cfg, seed=3), ref_criteo_like(64, ref_cfg, seed=3)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert dlrm.DLRMConfig.rm2().vocab_sizes == ref_dlrm.DLRMConfig.rm2().vocab_sizes
    assert RECSYS_SHAPES == REF_SHAPES
    f = cfg.n_sparse + 1
    assert np.array_equal(torch.triu_indices(f, f, 1).numpy(),
                          np.stack(jnp.triu_indices(f, k=1)))


def test_params_cross_and_init_matches_reference_tree():
    cfg = ref_dlrm.DLRMConfig.smoke()
    ref_tree = ref_dlrm.init_dlrm(jax.random.PRNGKey(0), cfg)
    params = _ref_params(cfg)
    port = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    assert sorted(port) == ["bot", "tables", "top"]
    for a, b in zip(nn.tree_leaves(port), jax.tree.leaves(params)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # the port's own init: the same tree and shapes, drawn on the CPU here
    own = dlrm.init_dlrm(torch.Generator().manual_seed(0), _port_cfg(cfg), "cpu")
    ref_leaves = jax.tree.leaves(ref_tree, is_leaf=lambda x: hasattr(x, "dims"))
    assert [tuple(t.shape) for t in nn.tree_leaves(own)] == \
        [tuple(r.value.shape) for r in ref_leaves]
    assert all(t.dtype == torch.float32 for t in nn.tree_leaves(own))
    assert float(own["tables"].std()) == pytest.approx(0.01, rel=0.2)
    assert all(float(layer["b"].abs().max()) == 0.0 for layer in own["bot"] + own["top"])


def test_forward_matches_reference():
    ref_cfg = ref_dlrm.DLRMConfig.smoke()
    params, port, (dense, sparse, _) = _both(ref_cfg, 32)
    want = ref_dlrm.dlrm_forward(params, jnp.asarray(dense), jnp.asarray(sparse), ref_cfg)
    got = dlrm.dlrm_forward(port, torch.from_numpy(dense), torch.from_numpy(sparse),
                            _port_cfg(ref_cfg))
    assert got.shape == (32, 1)
    _close(got, want, RTOL, ATOL)


def test_lookup_matches_reference_row_sharded_lookup():
    """The port's one-launch lookup over [B*F, H] bags against the
    reference's ``embedding_bag_local``: unsharded, and summed over 4 row
    shards (the stacked counterpart of its psum over the model axis)."""
    ref_cfg = ref_dlrm.DLRMConfig.smoke()
    params, port, (_, sparse, _) = _both(ref_cfg, 24, seed=1)
    B, F, H = sparse.shape
    got = dlrm.lookup_local(port["tables"], torch.from_numpy(sparse), _port_cfg(ref_cfg))
    assert got.shape == (B, F, ref_cfg.embed_dim)
    got = got.reshape(B * F, -1)
    flat = jnp.asarray(sparse.reshape(-1))
    bag = jnp.repeat(jnp.arange(B * F), H)
    table = params["tables"]
    _close(got, ref_dlrm.embedding_bag_local(table, flat, bag, B * F), RTOL, ATOL)
    rows = table.shape[0] // 4
    shards = [ref_dlrm.embedding_bag_local(table[lo:lo + rows], flat, bag, B * F,
                                           row_range=(lo, lo + rows))
              for lo in range(0, table.shape[0], rows)]
    _close(got, sum(shards), RTOL, ATOL)
    torch.testing.assert_close(embedding_bag(port["tables"], torch.from_numpy(
        sparse.reshape(B * F, H))), got, rtol=0, atol=0)


def _ref_train_step(params, dense, sparse, labels, cfg):
    """dlrm_rm2.py's train step body, composed from repro's functions."""
    def loss_fn(p):
        logits = ref_dlrm.dlrm_forward(p, dense, sparse, cfg)
        logp = jax.nn.log_sigmoid(logits)
        logn = jax.nn.log_sigmoid(-logits)
        return -(labels * logp + (1 - labels) * logn).mean()

    loss, grads = jax.value_and_grad(loss_fn)(params)
    opt = ref_opt.AdamWConfig()
    new_p, new_opt, _ = ref_opt.adamw_update(grads, ref_opt.init_adamw(params, opt),
                                             params, opt)
    return loss, grads, new_p, new_opt


def test_train_step_matches_reference():
    ref_cfg = ref_dlrm.DLRMConfig.smoke()
    cfg = _port_cfg(ref_cfg)
    params, port, (dense, sparse, labels) = _both(ref_cfg, 64, seed=2)
    loss, grads, new_p, new_opt = _ref_train_step(
        params, jnp.asarray(dense), jnp.asarray(sparse), jnp.asarray(labels), ref_cfg)
    args = tuple(torch.from_numpy(a) for a in (dense, sparse, labels))
    _, port_grads = nn.value_and_grad(dlrm_rm2.bce_loss, port, *args, cfg)
    state = {"params": port, "opt": init_adamw(port, AdamWConfig())}
    state, port_loss = dlrm_rm2.make_train_step(cfg, AdamWConfig())(state, *args)
    assert abs(float(port_loss) - float(loss)) <= LOSS_REL * abs(float(loss))
    assert int(state["opt"]["step"]) == 1
    for got, want in ((port_grads, grads), (state["params"], new_p),
                      (state["opt"]["m"], new_opt["m"]), (state["opt"]["v"], new_opt["v"])):
        for a, b in zip(nn.tree_leaves(got), jax.tree.leaves(want)):
            _close(a, b, G_RTOL, G_ATOL)


@pytest.mark.parametrize("opt", [AdamWConfig(),
                                 AdamWConfig(weight_decay=0.1, clip_norm=None)],
                         ids=["clip", "decay_noclip"])
def test_inplace_adamw_chunks_bitwise_and_functional_copies(opt, monkeypatch):
    cfg = dlrm.DLRMConfig.smoke()
    rng = np.random.default_rng(4)
    params = dlrm.init_dlrm(torch.Generator().manual_seed(1), cfg, "cpu")
    clone = lambda tree: nn.tree_map(torch.clone, tree)  # noqa: E731
    state = init_adamw(params, opt)
    ip_params, ip_state = clone(params), init_adamw(params, opt)
    for step in range(2):
        grads = nn.tree_map(lambda p: torch.from_numpy(
            rng.normal(size=tuple(p.shape)).astype(np.float32)), params)
        before = clone([params, state["m"], state["v"]])
        new_params, new_state, info = adamw_update(grads, state, params, opt)
        # the functional form leaves its inputs as they were
        assert int(state["step"]) == step
        assert all(torch.equal(a, b) for a, b in zip(
            nn.tree_leaves([params, state["m"], state["v"]]), nn.tree_leaves(before)))
        params, state = new_params, new_state
        # chunks of 1000 elements: smaller than the table, larger than some
        # MLP leaves, and not a multiple of every leaf's row width (above,
        # every leaf fit in one chunk)
        with monkeypatch.context() as m:
            m.setattr(optimizer, "CHUNK_ELEMS", 1000)
            out = adamw_update_(grads, ip_state, ip_params, opt)
        assert out[0] is ip_params and out[1] is ip_state
        assert torch.equal(out[2]["grad_norm"], info["grad_norm"])
    assert int(ip_state["step"]) == int(state["step"]) == 2
    for got, want in ((ip_params, params), (ip_state["m"], state["m"]),
                      (ip_state["v"], state["v"])):
        assert all(torch.equal(a, b) for a, b in zip(nn.tree_leaves(got),
                                                     nn.tree_leaves(want)))


def test_gradient_tree_is_freed_without_cyclic_gc():
    """value_and_grad's gradients die with their last reference: at RM2 a
    table gradient kept alive until the next cyclic GC is 12.8 GB."""
    import gc
    import weakref
    cfg = dlrm.DLRMConfig.smoke()
    params = dlrm.init_dlrm(torch.Generator().manual_seed(0), cfg, "cpu")
    args = tuple(torch.from_numpy(a) for a in criteo_like(8, cfg, seed=0))
    enabled = gc.isenabled()
    gc.disable()
    try:
        _, grads = nn.value_and_grad(dlrm_rm2.bce_loss, params, *args, cfg)
        ref = weakref.ref(grads["tables"])
        del grads
        assert ref() is None
    finally:
        if enabled:
            gc.enable()


def test_retrieval_matches_reference():
    ref_cfg = ref_dlrm.DLRMConfig.smoke()
    params, port, (dense, sparse, _) = _both(ref_cfg, 1, seed=5)
    cand = np.random.default_rng(5).normal(size=(4096, ref_cfg.embed_dim)).astype(np.float32)
    want_v, want_i = ref_dlrm.retrieval_score(params, jnp.asarray(dense), jnp.asarray(sparse),
                                              jnp.asarray(cand), ref_cfg, top_k=100)
    got_v, got_i = dlrm.retrieval_score(port, torch.from_numpy(dense),
                                        torch.from_numpy(sparse), torch.from_numpy(cand),
                                        _port_cfg(ref_cfg), top_k=100)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    _close(got_v, want_v, RTOL, 0.0)


@pytest.mark.parametrize("shape_id", sorted(RECSYS_SHAPES))
def test_build_cell_every_shape_on_cpu(shape_id):
    module, family = get_arch("dlrm-rm2")
    assert module is dlrm_rm2 and family == "recsys"
    cfg = dlrm_rm2.smoke_config()
    build.reset_launch_counts()
    step, args, meta = module.build_cell(shape_id, device="cpu", seed=0, cfg=cfg)
    B = RECSYS_SHAPES[shape_id]["batch"]
    assert meta["batch"] == B and meta["kind"] == RECSYS_SHAPES[shape_id]["kind"]
    if meta["kind"] == "train":
        assert meta["model_flops"] == 6 * B * dlrm_rm2._mlp_flops(cfg)
        state, losses = args[0], []
        for _ in range(2):
            state, loss = step(*args)
            losses.append(float(loss))
        assert np.all(np.isfinite(losses)) and losses[1] < losses[0]
        assert int(state["opt"]["step"]) == 2
    elif meta["kind"] == "serve":
        logits = step(*args)
        assert logits.shape == (B, 1) and bool(torch.isfinite(logits).all())
    else:
        vals, ids = step(*args)
        assert vals.shape == ids.shape == (100,) and bool(torch.isfinite(vals).all())
        assert bool((vals[:-1] >= vals[1:]).all())
    assert all(v == 0 for v in build.launch_counts.values())   # CPU: plain version
