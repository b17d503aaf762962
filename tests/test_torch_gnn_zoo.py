"""The rest of the GNN zoo in the port (GAT, NequIP, MACE, their irreps,
the segment ops, the minibatch sampler and the graph datasets) against
``repro``'s, on the CPU, from the same numpy inputs and weights.

Sizes are the reference's smoke sizes: ``GATConfig(16, 4, 2, 3, 2)`` on
``cora_like(0, n=80, m_und=240, d=16)``, and the NequIP / MACE
``smoke_config()`` (and ``tests/test_gnn_zoo.py``'s l_max-2 variants) on
``molecules(batch=2, n_atoms=12)``.  Held:

* the segment ops within 1e-6 (empty segments ``-inf`` for the max, as
  ``jax.ops.segment_max``);
* the irreps host pieces array-equal (``clebsch_gordan``,
  ``wigner_d_from_R``, ``_rand_rotations``, ``sh_l``), ``tp_paths`` in
  the reference's order, the products, linear, gate and RBF within 1e-5;
* each model's forward within rtol 1e-4 / atol 1e-5 of the reference's,
  its parameter gradients and (NequIP, MACE) forces within rtol 1e-3 /
  atol 2e-5 of ``jax.grad``'s; GAT's output unmoved by its softmax shift;
* rotation and translation invariance of the energies and the covariance
  of the forces (``tests/test_gnn_zoo.py:165-226``);
* the overrides against the reference's loss: ``act_bf16`` within 2e-2,
  ``edge_parallel`` (one shard) within 2e-6, ``remat`` bitwise equal to
  no ``remat`` (loss and gradients);
* one AdamW step of GAT, NequIP and MACE through ``make_gnn_train_step``
  against the reference's (``tests/test_arch_smoke.py:30-93``; GraphCast's
  is ``tests/test_torch_gnn_common.py``'s);
* each arch's dry-run cell for ``full_graph_sm``, ``ogb_products``,
  ``molecule`` and ``minibatch_lg`` with the reference's shapes (the
  ``minibatch`` pads from ``SampledBlock.pad_sizes``, as the reference's);
* ``powerlaw_graph``, ``molecules``, ``batch_molecules``, the CSR (its
  radix sort over one and two 16-bit digits), the sampled blocks and
  ``block_meta`` array-equal; ``params_from_jax``
  carrying the three trees unchanged.

The reference's functions run under ``jax.jit`` (eagerly they took
16-26 s a test).
"""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_arch as ref_get_arch
from repro.configs import gnn_common as ref_G
from repro.core.graph_state import ShardedGraph as RefGraph
from repro.core.halo import HaloSpec as RefHalo
from repro.core.partition import partition_graph as ref_partition_graph
from repro.graph import datasets as ref_ds
from repro.graph import sampler as ref_sampler
from repro.graph import segment as ref_seg
from repro.launch.mesh import make_mesh as ref_make_mesh
from repro.models.gnn_zoo import gat as ref_gat
from repro.models.gnn_zoo import irreps as ref_ir
from repro.models.gnn_zoo import mace as ref_mace
from repro.models.gnn_zoo import nequip as ref_nequip
from repro.train.optimizer import AdamWConfig as RefAdamW
from repro.train.optimizer import init_adamw as ref_init_adamw

from repro_torch import nn
from repro_torch.configs import get_arch
from repro_torch.configs import gnn_common as G
from repro_torch.convert import graphcast_params_to_jax, params_from_jax, params_to_jax
from repro_torch.core.distributed import local_graph_of
from repro_torch.core.graph_state import NMPPlan
from repro_torch.core.halo import MAX, NONE, HaloSpec
from repro_torch.core.partition import partition_graph
from repro_torch.graph import datasets, sampler, segment
from repro_torch.models.gnn_zoo import gat, irreps as ir, mace, nequip
from repro_torch.train.optimizer import AdamWConfig, init_adamw

F_RTOL, F_ATOL = 1e-4, 1e-5
G_RTOL, G_ATOL = 1e-3, 2e-5
LOSS_REL, BF16_REL = 2e-6, 2e-2
LR = 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _close_trees(got, want, rtol=G_RTOL, atol=G_ATOL):
    """A port tree (tensors) against a reference tree (arrays) of one
    structure: leaf by leaf, in the flatten order both share."""
    g, w = nn.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# segment ops
# ---------------------------------------------------------------------------

def _segment_data():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(40, 3, 2)).astype(np.float32)
    ids = rng.integers(0, 9, 40).astype(np.int32)
    ids[ids == 4] = 5                       # segment 4 (and 9, 10) empty
    mask = (rng.random(40) > 0.3).astype(np.float32)
    return data, ids, mask, 11


def test_segment_ops_match_reference_with_empty_segments():
    data, ids, mask, n = _segment_data()
    got = segment.segment_max(_t(data), _t(ids), n).numpy()
    want = np.asarray(ref_seg.segment_max(jnp.asarray(data), jnp.asarray(ids), n))
    assert np.isneginf(got[[4, 9, 10]]).all() and np.isneginf(want[[4, 9, 10]]).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        segment.segment_mean(_t(data), _t(ids), n).numpy(),
        np.asarray(ref_seg.segment_mean(jnp.asarray(data), jnp.asarray(ids), n)),
        rtol=1e-6, atol=1e-7)
    for m in (None, mask):
        got = segment.segment_softmax(_t(data[:, :, 0]), _t(ids), n,
                                      None if m is None else _t(m)).numpy()
        want = ref_seg.segment_softmax(jnp.asarray(data[:, :, 0]), jnp.asarray(ids), n,
                                       None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)


def test_gather_rows_backward_is_the_segment_sum():
    data, ids, _, n = _segment_data()
    x = _t(data[:n]).requires_grad_(True)
    out = segment.gather_rows(x, _t(ids))
    np.testing.assert_array_equal(out.detach().numpy(), data[:n][ids])
    g = torch.autograd.grad(out, x, _t(data))[0]
    np.testing.assert_array_equal(g.numpy(), segment.segment_sum(_t(data), _t(ids), n).numpy())


# ---------------------------------------------------------------------------
# the irreps pieces
# ---------------------------------------------------------------------------

LS = [(l1, l2, l3) for l1 in range(3) for l2 in range(3) for l3 in range(4)]


def test_host_pieces_array_equal():
    np.testing.assert_array_equal(ir._rand_rotations(7, seed=3),
                                  ref_ir._rand_rotations(7, seed=3))
    R = ir._rand_rotations(1, seed=5)[0]
    pts = np.random.default_rng(1).normal(size=(9, 3))
    for l in range(4):
        np.testing.assert_array_equal(ir.wigner_d_from_R(l, R), ref_ir.wigner_d_from_R(l, R))
        np.testing.assert_array_equal(ir.sh_l(pts, l), ref_ir.sh_l(pts, l))
    for ls in LS:
        got, want = ir.clebsch_gordan(*ls), ref_ir.clebsch_gordan(*ls)
        assert (got is None) == (want is None), ls
        if want is not None:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("l_max", [1, 2])
def test_tp_paths_in_the_reference_order(l_max):
    hid = ir.Irreps.make([(8, l, (-1) ** l) for l in range(l_max + 1)])
    sh = ir.Irreps.make([(1, l, (-1) ** l) for l in range(l_max + 1)])
    rhid = ref_ir.Irreps.make(hid.blocks)
    rsh = ref_ir.Irreps.make(sh.blocks)
    for args, rargs in (((ir.Irreps.scalars(8), sh, hid), (ref_ir.Irreps.scalars(8), rsh, rhid)),
                        ((hid, sh, hid), (rhid, rsh, rhid)),
                        ((hid, hid, hid), (rhid, rhid, rhid))):
        got, want = ir.tp_paths(*args), ref_ir.tp_paths(*rargs)
        assert [p[:3] for p in got] == [p[:3] for p in want]
        for p, q in zip(got, want):
            np.testing.assert_array_equal(p[3].numpy(), np.asarray(q[3]))
    assert ir.cg_on(1, 1, 2, torch.device("cpu")) is ir.cg_on(1, 1, 2, torch.device("cpu"))


def test_products_linear_gate_and_rbf_match_reference():
    rng = np.random.default_rng(2)
    hid = ir.Irreps.make([(4, l, (-1) ** l) for l in range(3)])
    sh = ir.Irreps.make([(1, l, (-1) ** l) for l in range(3)])
    rhid, rsh = ref_ir.Irreps.make(hid.blocks), ref_ir.Irreps.make(sh.blocks)
    E = 10
    x1 = rng.normal(size=(E, hid.dim)).astype(np.float32)
    x2 = rng.normal(size=(E, sh.dim)).astype(np.float32)
    x3 = rng.normal(size=(E, hid.dim)).astype(np.float32)
    rad = rng.normal(size=(E, 3)).astype(np.float32)
    paths = ir.tp_paths(hid, sh, hid)
    pw = [rng.normal(size=(3, hid.blocks[i][0], hid.blocks[k][0])).astype(np.float32)
          for i, _, k, _ in paths]
    cw = [rng.normal(size=(4,)).astype(np.float32) for _ in ir.tp_paths(hid, hid, hid)]
    lw = [rng.normal(size=(4, 4)).astype(np.float32) for _ in ir._linear_pairs(hid, hid)]
    checks = [
        (ir.weighted_tensor_product({"path_w": [_t(w) for w in pw]}, _t(x1), _t(x2), _t(rad),
                                    hid, sh, hid),
         ref_ir.weighted_tensor_product({"path_w": pw}, jnp.asarray(x1), jnp.asarray(x2),
                                        jnp.asarray(rad), rhid, rsh, rhid)),
        (ir.channel_tensor_product({"ctp_w": [_t(w) for w in cw]}, _t(x1), _t(x3),
                                   hid, hid, hid),
         ref_ir.channel_tensor_product({"ctp_w": cw}, jnp.asarray(x1), jnp.asarray(x3),
                                       rhid, rhid, rhid)),
        (ir.linear_irreps({"lin_w": [_t(w) for w in lw]}, _t(x1), hid, hid),
         ref_ir.linear_irreps({"lin_w": lw}, jnp.asarray(x1), rhid, rhid)),
        (ir.gate_irreps(_t(x1), hid), ref_ir.gate_irreps(jnp.asarray(x1), rhid)),
        (ir.bessel_rbf(_t(np.abs(x1[:, 0]) * 3), 8, 5.0),
         ref_ir.bessel_rbf(jnp.asarray(np.abs(x1[:, 0]) * 3), 8, 5.0)),
    ]
    for got, want in checks:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the models against the reference
# ---------------------------------------------------------------------------

GAT_CFG = dict(in_dim=16, hidden=4, heads=2, n_classes=3, n_layers=2)


@functools.lru_cache(maxsize=None)
def _gat_setup():
    edges, feats, _ = ref_ds.cora_like(seed=0, n=80, m_und=240, d=16, n_classes=3)
    ref_pg = ref_partition_graph(80, edges, 1)
    pg = partition_graph(80, edges, 1)
    rg = RefGraph.from_arrays({k: jnp.asarray(v) for k, v in
                               ref_pg.device_arrays().items()}).rank(0)
    graph = local_graph_of(pg, None, NMPPlan(halo=HaloSpec(mode=NONE)), device="cpu")
    x = np.zeros((pg.n_pad, 16), np.float32)
    x[:80] = feats
    rcfg = ref_gat.GATConfig(**GAT_CFG)
    np_params = jax.tree.map(np.asarray, ref_gat.init_gat(jax.random.PRNGKey(0), rcfg))
    w = np.random.default_rng(4).normal(size=(pg.n_pad, 3)).astype(np.float32)
    return rg, graph, x, rcfg, np_params, w


def _mol_setup(arch, l_max=None):
    species, pos, el = ref_ds.molecules(batch=2, n_atoms=12, n_species=4, seed=1)
    sp, ps, meta = ref_ds.batch_molecules(species, pos, el, e_pad_per=48)
    mod, _ = get_arch(arch)
    ref_mod, _ = ref_get_arch(arch)
    cfg, rcfg = mod.smoke_config(), ref_mod.smoke_config()
    if l_max is not None:
        cfg, rcfg = (dataclasses.replace(c, l_max=l_max) for c in (cfg, rcfg))
    return sp, ps, meta, cfg, rcfg


REF_MODELS = {"nequip": (ref_nequip.init_nequip, ref_nequip.nequip_forward),
              "mace": (ref_mace.init_mace, ref_mace.mace_forward)}
PORT_MODELS = {"nequip": nequip.nequip_forward, "mace": mace.mace_forward}


def test_gat_forward_and_gradients_match_reference():
    rg, graph, x, rcfg, np_params, w = _gat_setup()
    halo = RefHalo(mode="none")

    def ref_loss(p, xx):
        out = ref_gat.gat_forward(p, xx, rg, halo, rcfg)
        return jnp.sum(out * w), out
    (val, out), grads = jax.jit(jax.value_and_grad(ref_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(x))
    params = params_from_jax(np_params, "cpu")
    cfg = gat.GATConfig(**GAT_CFG)
    got = gat.gat_forward(params, _t(x), graph, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=F_RTOL, atol=F_ATOL)
    loss, g = nn.value_and_grad(
        lambda p: torch.sum(gat.gat_forward(p, _t(x), graph, cfg) * _t(w)), params)
    assert _rel(loss, val) <= LOSS_REL
    _close_trees(g, grads)


def test_gat_output_does_not_move_with_its_shift():
    """The softmax shift's exchange (``combine="max"``) may give any value
    without moving the layer: d out / d shift is 0, which is why the port
    exchanges it detached."""
    _, graph, x, _, np_params, _ = _gat_setup()
    params = params_from_jax(np_params, "cpu")
    p0 = params["layers"][0]

    def shifted(by):
        return lambda t, combine="sum": t + by if combine == MAX else t
    base = gat._gat_layer(p0, _t(x), graph, None, True)
    for by in (-0.75, 2.5):
        moved = gat._gat_layer(p0, _t(x), graph, shifted(by), True)
        np.testing.assert_allclose(moved.numpy(), base.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["nequip", "mace"])
def test_equivariant_forward_gradients_and_forces_match_reference(arch):
    sp, ps, meta, cfg, rcfg = _mol_setup(arch)
    init, fwd = REF_MODELS[arch]
    np_params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), rcfg))
    mg = {k: jnp.asarray(v) for k, v in meta.items()}
    w = np.random.default_rng(5).normal(size=sp.shape).astype(np.float32)

    def ref_loss(p, pos):
        e = fwd(p, jnp.asarray(sp), pos, mg, RefHalo(mode="none"), rcfg)
        return jnp.sum(e * w), e
    (val, e_ref), (g_p, g_pos) = jax.jit(jax.value_and_grad(ref_loss, argnums=(0, 1),
                                                            has_aux=True))(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(ps))
    params = params_from_jax(np_params, "cpu")
    graph = {k: _t(v) for k, v in meta.items()}
    with torch.enable_grad():
        p = nn.tree_map(lambda t: t.requires_grad_(True), params)
        pos = _t(ps).requires_grad_(True)
        e = PORT_MODELS[arch](p, _t(sp), pos, graph, cfg)
        loss = torch.sum(e * _t(w))
        grads = torch.autograd.grad(loss, nn.tree_leaves(p) + [pos])
    np.testing.assert_allclose(e.detach().numpy(), np.asarray(e_ref), rtol=F_RTOL, atol=F_ATOL)
    assert float(np.abs(np.asarray(e_ref)).max()) > 0
    assert _rel(loss.detach(), val) <= 1e-5
    _close_trees(nn.tree_unflatten(params, grads[:-1]), g_p)
    np.testing.assert_allclose(-grads[-1].numpy(), -np.asarray(g_pos), rtol=G_RTOL, atol=G_ATOL)


@pytest.mark.parametrize("arch", ["nequip", "mace"])
def test_invariance_and_force_covariance(arch):
    """``tests/test_gnn_zoo.py:165-226`` on the port (l_max 2): energies
    invariant under a rotation and a translation (rtol 5e-4, atol 1e-5),
    forces rotating with the positions (rtol 2e-3, atol 1e-5)."""
    sp, ps, meta, cfg, _ = _mol_setup(arch, l_max=2)
    init = {"nequip": nequip.init_nequip, "mace": mace.init_mace}[arch]
    params = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    graph = {k: _t(v) for k, v in meta.items()}
    fwd = PORT_MODELS[arch]

    def energies(pos):
        return fwd(params, _t(sp), _t(pos.astype(np.float32)), graph, cfg).detach().numpy()

    def forces(pos):
        with torch.enable_grad():
            x = _t(pos.astype(np.float32)).requires_grad_(True)
            return -torch.autograd.grad(fwd(params, _t(sp), x, graph, cfg).sum(), x)[0].numpy()
    e1 = energies(ps)
    assert np.isfinite(e1).all() and np.abs(e1).max() > 0
    R = ir._rand_rotations(1, seed=5)[0].astype(np.float32)
    np.testing.assert_allclose(energies(ps @ R.T), e1, rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(energies(ps + np.float32([1.3, -0.7, 2.1])), e1,
                               rtol=5e-4, atol=1e-5)
    R = ir._rand_rotations(1, seed=9)[0].astype(np.float32)
    np.testing.assert_allclose(forces(ps @ R.T), forces(ps) @ R.T, rtol=2e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# the cells' loss under each override, against the reference's
# ---------------------------------------------------------------------------

MOLECULE = dict(kind="molecule", n_nodes=12, n_edges=48, batch=2)


@functools.lru_cache(maxsize=None)
def _mol_cell(arch):
    """The molecule data stacked [1, ...] and repro's weights (numpy)."""
    sp, ps, meta, _, rcfg = _mol_setup(arch)
    target = np.random.default_rng(6).normal(size=sp.shape).astype(np.float32)
    inputs = {"species": sp[None].astype(np.int32), "pos": ps[None], "target": target[None]}
    np_params = jax.tree.map(np.asarray, REF_MODELS[arch][0](jax.random.PRNGKey(0), rcfg))
    return inputs, {k: v[None] for k, v in meta.items()}, np_params


def _ref_cell_loss(arch, overrides, monkeypatch):
    """repro's cell loss at the smoke config (its ``config`` pointed at
    ``smoke_config`` for the test) inside its shard_map on a (1, 1) mesh."""
    ref_mod, _ = ref_get_arch(arch)
    monkeypatch.setattr(ref_mod, "config", lambda shape=None: ref_mod.smoke_config())
    inputs, meta, np_params = _mol_cell(arch)
    mesh = ref_make_mesh((1, 1), ("data", "model"))
    loss_local = ref_mod._loss_local_factory(MOLECULE, RefHalo(mode="none", axis="data"),
                                             "data", mesh, overrides=dict(overrides))
    _, specs = ref_mod._inputs_factory(MOLECULE, 1, 24, 96, "data")

    def local(p, i, m):
        return loss_local(p, i, {k: v[0] for k, v in m.items()})
    fn = jax.shard_map(local, mesh=mesh, in_specs=(P(), specs, {k: P("data") for k in meta}),
                       out_specs=P(), check_vma=False)
    return float(jax.jit(fn)(jax.tree.map(jnp.asarray, np_params),
                             {k: jnp.asarray(v) for k, v in inputs.items()},
                             {k: jnp.asarray(v) for k, v in meta.items()}))


def _port_cell(arch, overrides):
    mod, _ = get_arch(arch)
    inputs, meta, np_params = _mol_cell(arch)
    loss_local = mod._loss_local_factory(MOLECULE, HaloSpec(mode=NONE),
                                         overrides=dict(overrides), cfg=mod.smoke_config())
    graph = {k: _t(v[0]) for k, v in meta.items()}
    return loss_local, {k: _t(v) for k, v in inputs.items()}, graph, \
        params_from_jax(np_params, "cpu")


@pytest.mark.parametrize("arch", ["nequip", "mace"])
@pytest.mark.parametrize("name", ["none", "act_bf16", "edge_parallel"])
def test_cell_loss_overrides_match_reference(arch, name, monkeypatch):
    overrides = () if name == "none" else ((name, True),)
    loss_local, inputs, graph, params = _port_cell(arch, overrides)
    with torch.no_grad():
        loss = float(loss_local(params, inputs, graph))
    want = _ref_cell_loss(arch, overrides, monkeypatch)
    if name == "act_bf16":
        assert _rel(loss, want) <= BF16_REL
        base, _, _, _ = _port_cell(arch, ())
        with torch.no_grad():
            assert loss != float(base(params, inputs, graph))
    else:
        assert _rel(loss, want) <= LOSS_REL


@pytest.mark.parametrize("arch", ["nequip", "mace"])
def test_remat_is_bitwise_no_remat(arch):
    loss_local, inputs, graph, params = _port_cell(arch, ())
    remat, _, _, _ = _port_cell(arch, (("remat", True),))
    l0, g0 = G.gnn_loss_and_grads(loss_local, params, inputs, graph)
    l1, g1 = G.gnn_loss_and_grads(remat, params, inputs, graph)
    assert float(l0) == float(l1)
    for a, b in zip(nn.tree_leaves(g0), nn.tree_leaves(g1)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# one training step of each GNN arch (tests/test_arch_smoke.py:30-93)
# ---------------------------------------------------------------------------

SMOKE_N = 48
SMOKE_SHAPE = dict(kind="full", n_nodes=SMOKE_N, n_edges=140, d_feat=16, n_classes=3)


def _smoke_data(arch):
    """test_arch_smoke.py's graph, inputs and weights (numpy), drawn from
    its rng in its order."""
    edges, _, _ = ref_ds.cora_like(seed=1, n=SMOKE_N, m_und=140, d=16, n_classes=3)
    ref_pg = ref_partition_graph(SMOKE_N, edges, 1)
    n_pad, e_pad = ref_pg.n_pad, ref_pg.e_pad
    rng = np.random.default_rng(0)
    ref_mod, _ = ref_get_arch(arch)
    if arch in REF_MODELS:
        cfg = ref_mod.smoke_config()
        params = REF_MODELS[arch][0](jax.random.PRNGKey(0), cfg)
        inputs = {"species": rng.integers(0, cfg.n_species, (1, n_pad)).astype(np.int32),
                  "pos": rng.normal(size=(1, n_pad, 3)).astype(np.float32),
                  "target": rng.normal(size=(1, n_pad)).astype(np.float32)}
    else:
        sds, _ = ref_mod._inputs_factory(SMOKE_SHAPE, 1, n_pad, e_pad, "data")
        inputs = {k: (rng.integers(0, 3, s.shape).astype(np.int32) if s.dtype == jnp.int32
                      else rng.normal(size=s.shape).astype(np.float32))
                  for k, s in sds.items()}
        params = jax.tree.map(
            lambda s: jnp.asarray(rng.normal(size=s.shape) * 0.05, s.dtype)
            if jnp.issubdtype(s.dtype, jnp.floating) else jnp.zeros(s.shape, s.dtype),
            ref_mod._param_factory(SMOKE_SHAPE))
    return edges, ref_pg, inputs, jax.tree.map(np.asarray, params)


def _ref_train_step(arch, edges, ref_pg, inputs, np_params):
    ref_mod, _ = ref_get_arch(arch)
    mesh = ref_make_mesh((1, 1), ("data", "model"))
    halo = RefHalo(mode="none", axis="data")
    if arch in REF_MODELS:
        cfg, fwd = ref_mod.smoke_config(), REF_MODELS[arch][1]

        def loss_local(p, inp, m):
            e = fwd(p, inp["species"][0], inp["pos"][0], m, halo, cfg)
            return ref_G.consistent_mse_loss(e, inp["target"][0], m["node_inv_mult"],
                                             ("data",))
        specs = {"species": P("data", None), "pos": P("data", None, None),
                 "target": P("data", None)}
    else:
        loss_local = ref_mod._loss_local_factory(SMOKE_SHAPE, halo, "data", mesh)
        _, specs = ref_mod._inputs_factory(SMOKE_SHAPE, 1, ref_pg.n_pad, ref_pg.e_pad, "data")
    meta = {k: jnp.asarray(v) for k, v in ref_pg.device_arrays().items()}
    params = jax.tree.map(jnp.asarray, np_params)
    opt = RefAdamW()
    state = {"params": params, "opt": ref_init_adamw(params, opt)}
    _, wrap = ref_G.make_gnn_train_step(loss_local, mesh, specs, "data", opt)
    new_state, loss = jax.jit(wrap(meta))(state, {k: jnp.asarray(v) for k, v in inputs.items()},
                                          meta)

    def local(p, i, m):
        g = RefGraph.from_arrays({k: v[0] for k, v in m.items()})
        return jax.grad(lambda pp: loss_local(pp, i, g))(p)
    grads = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P(), specs,
                                                             ref_G.meta_specs(meta, "data")),
                                  out_specs=P(), check_vma=False))(
        params, {k: jnp.asarray(v) for k, v in inputs.items()}, meta)
    return float(loss), jax.tree.map(np.asarray, new_state["params"]), \
        jax.tree.map(np.asarray, grads)


def _flat(leaves):
    return np.concatenate([np.ravel(np.asarray(a)) for a in leaves])


@pytest.mark.parametrize("arch", ["gat-cora", "nequip", "mace"])
def test_gnn_arch_one_train_step_matches_reference(arch):
    edges, ref_pg, inputs, np_params = _smoke_data(arch)
    ref_loss, ref_new, ref_grads = _ref_train_step(arch, edges, ref_pg, inputs, np_params)
    mod, family = get_arch(arch)
    assert family == "gnn"
    pg = partition_graph(SMOKE_N, edges, 1)
    halo = HaloSpec(mode=NONE)
    graph = local_graph_of(pg, None, NMPPlan(halo=halo), device="cpu")
    params = params_from_jax(np_params, "cpu")
    cfg = mod.smoke_config() if arch in REF_MODELS else None
    loss_local = mod._loss_local_factory(SMOKE_SHAPE, halo, cfg=cfg)
    opt = AdamWConfig()
    state = {"params": params, "opt": init_adamw(params, opt)}
    state, loss = G.make_gnn_train_step(loss_local, opt)(
        state, {k: _t(v) for k, v in inputs.items()}, graph)
    assert np.isfinite(float(loss)) and _rel(loss, ref_loss) <= LOSS_REL
    new, want = _flat(jax.tree.leaves(params_to_jax(state["params"]))), \
        _flat(jax.tree.leaves(ref_new))
    g = np.abs(_flat(jax.tree.leaves(ref_grads)))
    assert g.max() > 0 and np.abs(new - _flat(jax.tree.leaves(np_params))).max() > 0
    sure = g > 1e-4
    np.testing.assert_allclose(new[sure], want[sure], rtol=0, atol=1e-6)
    np.testing.assert_allclose(new, want, rtol=0, atol=2 * LR + 1e-6)


# ---------------------------------------------------------------------------
# the dry-run cells
# ---------------------------------------------------------------------------

def _spec(p):
    return tuple({"data": G.GRAPH}.get(a, a) for a in tuple(p))


def _same_structs(got, want):
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        assert got[k].device.type == "meta"


@pytest.mark.parametrize("arch", ["gat-cora", "nequip", "mace", "graphcast"])
@pytest.mark.parametrize("shape_id", ["full_graph_sm", "ogb_products", "molecule",
                                      "minibatch_lg"])
def test_dryrun_cell_matches_reference(arch, shape_id):
    ref_mod, _ = ref_get_arch(arch)
    mod, _ = get_arch(arch)
    ref_mesh = SimpleNamespace(shape={"data": 16, "model": 16}, axis_names=("data", "model"))
    _, rargs, rin, _, rmeta = ref_mod.build_dryrun_cell(shape_id, ref_mesh)
    step, args, in_specs, out_specs, meta = mod.build_dryrun_cell(
        shape_id, {"graph": 16, "model": 16})
    assert callable(step) and out_specs == (None, None)
    assert {k: v for k, v in meta.items() if k != "graph_axis"} == \
        {k: v for k, v in rmeta.items() if k != "graph_axis"}
    for i in (1, 2):
        _same_structs(args[i], rargs[i])
        assert in_specs[i] == {k: _spec(v) for k, v in rin[i].items()}
    to_ref = graphcast_params_to_jax if arch == "graphcast" else params_to_jax
    for got, want in ((args[0]["params"], rargs[0]["params"]),
                      (args[0]["opt"]["m"], rargs[0]["opt"]["m"])):
        assert all(t.device.type == "meta" for t in nn.tree_leaves(got))
        got = to_ref(nn.tree_map(lambda t: torch.empty(t.shape), got))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert [a.shape for a in jax.tree.leaves(got)] == \
            [tuple(b.shape) for b in jax.tree.leaves(want)]


def test_minibatch_pads_equal_reference():
    shape = G.GNN_SHAPES["minibatch_lg"]
    assert G._minibatch_pads(shape) == ref_G._minibatch_pads(shape) == (10624, 10624)
    for n, f in ((64, (15, 10)), (5, (3, 2, 2)), (1, ())):
        assert sampler.SampledBlock.pad_sizes(n, f) == ref_sampler.SampledBlock.pad_sizes(n, f)


# ---------------------------------------------------------------------------
# datasets, the sampler and the weights
# ---------------------------------------------------------------------------

def test_datasets_array_equal():
    for got, want in ((datasets.powerlaw_graph(700, 6, seed=3),
                       ref_ds.powerlaw_graph(700, 6, seed=3)),):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    mol = datasets.molecules(batch=3, n_atoms=12, n_species=4, seed=2)
    rmol = ref_ds.molecules(batch=3, n_atoms=12, n_species=4, seed=2)
    for a, b in zip(mol[:2], rmol[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(mol[2], rmol[2]):
        np.testing.assert_array_equal(a, b)
    for e_pad_per in (8, 64):   # 8 cuts each molecule's edge list
        got = datasets.batch_molecules(*mol, e_pad_per=e_pad_per)
        want = ref_ds.batch_molecules(*rmol, e_pad_per=e_pad_per)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a, b)
        assert set(got[2]) == set(want[2])
        for k in want[2]:
            assert got[2][k].dtype == want[2][k].dtype
            np.testing.assert_array_equal(got[2][k], want[2][k])


def test_sampler_blocks_array_equal():
    edges = datasets.powerlaw_graph(500, 8, seed=1)
    csr = sampler.CSRGraph.from_edges(500, edges)
    rcsr = ref_sampler.CSRGraph.from_edges(500, edges)
    np.testing.assert_array_equal(csr.indptr, rcsr.indptr)
    np.testing.assert_array_equal(csr.indices, rcsr.indices)
    rng, rrng = np.random.default_rng(7), np.random.default_rng(7)
    seeds = np.random.default_rng(8).choice(500, 16, replace=False)
    for fanouts in ((5, 3), (4, 3, 2)):
        block = sampler.sample_block(csr, seeds, fanouts, rng)
        want = ref_sampler.sample_block(rcsr, seeds, fanouts, rrng)
        for f in dataclasses.fields(want):
            a, b = getattr(block, f.name), getattr(want, f.name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert float(block.edge_mask.sum()) > 0
        got_meta, want_meta = sampler.block_meta(block), ref_sampler.block_meta(want)
        assert set(got_meta) == set(want_meta)
        for k in want_meta:
            np.testing.assert_array_equal(got_meta[k], want_meta[k])


@pytest.mark.parametrize("n", [1, 7, 65536, 65537, 300_000])
def test_csr_array_equal_across_radix_digits(n):
    """The CSR's radix sort (one 16-bit digit per pass) against the
    reference's stable argsort, on ids that need one and two digits."""
    rng = np.random.default_rng(n)
    for e in (0, 1, 4000):
        edges = rng.integers(0, n, (e, 2)).astype(np.int64)
        got = sampler.CSRGraph.from_edges(n, edges)
        want = ref_sampler.CSRGraph.from_edges(n, edges)
        for a, b in ((got.indptr, want.indptr), (got.indices, want.indices)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["gat-cora", "nequip", "mace"])
def test_params_carry_over_unchanged(arch):
    """``params_from_jax`` carries the reference's trees as they are, and
    the port's ``init_*`` gives the same structure and shapes."""
    ref_mod, _ = ref_get_arch(arch)
    mod, _ = get_arch(arch)
    if arch == "gat-cora":
        ref_tree = ref_gat.init_gat(jax.random.PRNGKey(0), ref_gat.GATConfig(**GAT_CFG))
        port = gat.init_gat(torch.Generator().manual_seed(0), gat.GATConfig(**GAT_CFG), "cpu")
    else:
        ref_tree = REF_MODELS[arch][0](jax.random.PRNGKey(0), ref_mod.smoke_config())
        init = {"nequip": nequip.init_nequip, "mace": mace.init_mace}[arch]
        port = init(torch.Generator().manual_seed(0), mod.smoke_config(), "cpu")
    np_tree = jax.tree.map(np.asarray, ref_tree)
    got = params_from_jax(np_tree, "cpu")
    back = params_to_jax(got)
    assert jax.tree.structure(back) == jax.tree.structure(np_tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree)):
        np.testing.assert_array_equal(a, b)
    mine = params_to_jax(port)
    assert jax.tree.structure(mine) == jax.tree.structure(np_tree)
    assert [a.shape for a in jax.tree.leaves(mine)] == [b.shape for b in jax.tree.leaves(np_tree)]
