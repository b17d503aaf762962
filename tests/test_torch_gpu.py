"""The torch port's CUDA kernels on the card, each against its plain
PyTorch version, plus the determinism the serving contract needs.

Every test here is ``gpu``-marked and skips on a host without a CUDA card
(CUDA kernels have no CPU mode); the card is detected inside a fixture,
never at import.  The file imports only ``torch`` and ``repro_torch``, so it
runs on a GPU host without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: the fused NMP kernel sums the MLP and the aggregate in another
order than the plain version: rtol 1e-4 / atol 1e-5 (the reference's own
forward band), also on a graph built to hit its tile edges
(``tile_edge_graph``, which ``tests/test_torch_kernels.py`` holds the plain
version to ``repro`` on).  Its backward: node and edge gradients rtol 1e-3 / atol
2e-5 (the reference's gradient band); the weight gradients are sums over
every edge, so they are held to a relative L2 norm of 5e-4.  Pack and
unpack-add are pure data movement: bitwise, values and gradients; so is
the packed exchange (one pack launch for every round and rank), against
the per-round path and against the CPU's plain exchange, gradients too.  The
embedding bag sums in the plain version's order and type: bitwise.  Flash
attention runs its online softmax over key tiles where the plain version
takes one softmax: ``tests/test_kernels.py``'s ``TOL`` (fp32 rtol / atol
2e-5, bf16 2e-2), and at a long sequence, whose late rows are smaller than
that atol, each row's relative L2 error within 1e-2; Granite's smoke cells hold prefill + decode to the full
forward in fp32 at the reference's forward band.  The dst-aligned
edge-MLP kernel sums its aggregate in another order than the plain
version's sorted segment sum: e_new rtol / atol 3e-5 in fp32 and 2e-2 in
bf16 (``tests/test_kernels.py``'s bands for the op and its ``TOL``), agg
1e-4 in both (fp32), also at its tile edges (block_e against its 64-slot
tiles, Fin and H off multiples of 8, a node block of one slot and one of
padding only, every block_n it is built for).  Every kernel, and a training step through them, is
bitwise repeatable.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.gnn import GNNConfig, gnn_forward, init_gnn
from repro_torch.core.graph_state import FUSED, XLA, NMPPlan, ShardedGraph
from repro_torch.core.halo import NEIGHBOR, NONE, halo_sync_stacked
from repro_torch.core.mesh_gen import box_mesh, taylor_green_velocity
from repro_torch.core.partition import (
    gather_node_features, partition_mesh, scatter_node_outputs)
from repro_torch.core.reference import gnn_forward_stacked
from repro_torch.nn import tree_leaves
from repro_torch.train.loop import TrainConfig, train_consistent_gnn
from repro_torch.graph.segment import segment_sum
from repro_torch.configs import dlrm_rm2, granite_34b
from repro_torch.kernels import build
from repro_torch.kernels.embedding_bag import ops as eb
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models.transformer import attention as lm_attention
from repro_torch.models.transformer import model as lm
from repro_torch.kernels.halo_pack import ops as hp
from repro_torch.kernels.segment_agg import ops as sa

RTOL, ATOL = 1e-4, 1e-5
G_RTOL, G_ATOL = 1e-3, 2e-5
W_REL = 5e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _graph(elems, grid, plan, device):
    sem = box_mesh(elems, p=2)
    pg = partition_mesh(sem, grid)
    return sem, pg, ShardedGraph.build(pg, sem.coords, plan, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("hidden,layers", [(8, 2), (16, 1), (32, 5)])
def test_fused_nmp_kernel_matches_plain(cuda, hidden, layers):
    plan = NMPPlan(backend=FUSED, block_e=32)
    _, pg, g = _graph((3, 2, 2), (1, 1, 1), plan, cuda)
    g = g.rank(0)
    gen = torch.Generator().manual_seed(hidden)
    cfg = GNNConfig(hidden=hidden, n_mp_layers=1, mlp_hidden_layers=layers)
    edge = init_gnn(gen, cfg, device=cuda)["mp"][0]["edge"]
    x = torch.randn(pg.n_pad, hidden, generator=gen).to(cuda)
    e = torch.randn(pg.e_pad, hidden, generator=gen).to(cuda)
    args = (x, e, edge, g["seg_perm"], g["seg_src"], g["seg_rowptr"],
            g["edge_mask"], g["edge_inv_mult"])
    n0 = build.launch_counts.get(sa.KERNEL, 0)
    e_new, agg = sa.fused_nmp_edge_agg(*args)
    torch.cuda.synchronize()
    assert build.launch_counts[sa.KERNEL] == n0 + 1
    pe, pa = sa.fused_nmp_edge_agg_plain(*args)
    torch.testing.assert_close(e_new, pe, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(agg, pa, rtol=RTOL, atol=ATOL)
    e2, a2 = sa.fused_nmp_edge_agg(*args)                # deterministic
    assert torch.equal(e_new, e2) and torch.equal(agg, a2)


def tile_edge_graph(rng):
    """A graph whose dst-sorted slots hit every edge of the forward kernel's
    128-slot tiles.  In-degrees in node order: node 0 receives nothing,
    nodes 1..16 eight edges each (tile 0 ends exactly at node 16's last
    slot), node 17 nothing (a node of degree 0 on a tile edge), node 18 129
    (all of tile 1 and one slot of tile 2), node 19 5, node 20 nothing,
    node 21 300 (from tile 2 across tile 3 into tile 4), then 40 nodes of
    0..7 and a last node of degree 0; the slot count is not a multiple of
    128.  Edges come in random order from random sources; 11 padding edges
    point past the nodes (dst = n, mask 0: outside the layout) and about a
    tenth of the real edges are masked.  Numpy only, so the CPU tests can
    hold the plain version to ``repro`` on the same graph.

    Returns (src, dst, mask, inv_mult, n_nodes)."""
    deg = np.array([0] + [8] * 16 + [0, 129, 5, 0, 300]
                   + list(rng.integers(0, 8, 40)) + [0])
    if deg.sum() % 128 == 0:
        deg[-2] += 1
    n = deg.size
    dst = np.concatenate([np.repeat(np.arange(n), deg), np.full(11, n)])
    src = rng.integers(0, n, dst.size)
    order = rng.permutation(dst.size)
    src, dst = src[order], dst[order]
    mask = np.where(dst < n, 1.0, 0.0).astype(np.float32)
    mask[rng.random(dst.size) < 0.1] = 0.0
    counts = np.bincount(np.minimum(dst, n), minlength=n + 1)
    inv = (1.0 / counts[np.minimum(dst, n)]).astype(np.float32)
    return src.astype(np.int32), dst.astype(np.int32), mask, inv, n


def _tile_edge_case(cuda, hidden, n_hidden, has_ln, seed):
    rng = np.random.default_rng(seed)
    src, dst, mask, inv, n = tile_edge_graph(rng)
    lay = sa.compact_gather_layout(src, dst, n, 32)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    gen = torch.Generator().manual_seed(seed)
    cfg = GNNConfig(hidden=hidden, n_mp_layers=1, mlp_hidden_layers=n_hidden)
    edge = init_gnn(gen, cfg, device=cuda)["mp"][0]["edge"]
    if not has_ln:
        edge.pop("ln")
    for lp in edge["layers"]:                  # non-trivial biases
        lp["b"] = 0.1 * torch.randn(lp["b"].shape, generator=gen).to(cuda)
    x = torch.randn(n, hidden, generator=gen).to(cuda)
    e = torch.randn(dst.size, hidden, generator=gen).to(cuda)
    return (x, e, edge, T(lay["perm"]), T(lay["src"]), T(lay["rowptr"]), T(mask),
            T(inv)), np.nonzero(dst == n)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("has_ln", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("n_hidden", [0, 7])
@pytest.mark.parametrize("hidden", [8, 16, 32])
def test_fused_nmp_kernel_tile_edges(cuda, hidden, n_hidden, has_ln):
    """Nodes across 2 and 3 tiles, a tile ending at a node boundary, nodes
    of degree 0, padding edges and a ragged last tile: within the forward
    band of the plain version, e' of edges outside the layout 0, and two
    launches bitwise equal."""
    args, outside = _tile_edge_case(cuda, hidden, n_hidden, has_ln, hidden + n_hidden)
    e_new, agg = sa.fused_nmp_edge_agg(*args)
    pe, pa = sa.fused_nmp_edge_agg_plain(*args)
    torch.testing.assert_close(e_new, pe, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(agg, pa, rtol=RTOL, atol=ATOL)
    assert not e_new[torch.from_numpy(outside).to(cuda)].any()
    e2, a2 = sa.fused_nmp_edge_agg(*args)
    assert torch.equal(e_new, e2) and torch.equal(agg, a2)


@pytest.mark.gpu
def test_fused_nmp_kernel_weights_past_shared_memory(cuda):
    """More hidden layers than shared memory holds: the rest are read from
    global memory, within the same band."""
    args, _ = _tile_edge_case(cuda, 32, 48, True, 5)
    n_slots = args[3].numel()
    plan = sa.fwd_launch_plan(32, 48, n_slots)
    assert 0 < plan["smem_layers"] < 48
    assert plan["tiles"] == -(-n_slots // 128)           # the kernel's 128-slot tiles
    e_new, agg = sa.fused_nmp_edge_agg(*args)
    pe, pa = sa.fused_nmp_edge_agg_plain(*args)
    torch.testing.assert_close(e_new, pe, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(agg, pa, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_fused_nmp_fwd_plan(cuda):
    """The forward edge pass's launch as the card reports it at the serving
    mesh's width (H=32, 5 hidden layers, 4,315,696 slots)."""
    plan = sa.fwd_launch_plan(32, 5, 4_315_696)
    assert plan["smem_layers"] == 5 and plan["blocks_per_sm"] >= 1
    assert plan["tiles"] == -(-4_315_696 // 128)
    assert 1 <= plan["grid"] <= 132 * plan["blocks_per_sm"]
    assert sa.fwd_launch_plan(8, 0, 10)["grid"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_halo_kernels_bitwise_plain(cuda, seed):
    rng = np.random.default_rng(seed)
    n, w, f = 301, 72, 32
    x, a = (torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(cuda)
            for _ in range(2))
    buf = torch.from_numpy(rng.normal(size=(w, f)).astype(np.float32)).to(cuda)
    idx = np.zeros(w, np.int32)
    idx[:60] = rng.choice(np.arange(n), 60, replace=False)   # real ids unique
    idx[0] = 0                          # a real write to row 0 beside padding
    mask = np.zeros(w, np.float32)
    mask[:60] = 1.0
    wire = _wire(idx, mask, n, cuda)
    idx, mask = wire.idx, wire.mask
    assert torch.equal(hp.halo_pack(x, wire), hp.halo_pack_plain(x, idx, mask))
    assert torch.equal(hp.halo_unpack_add(a, buf, wire),
                       hp.halo_unpack_add_plain(a, buf, idx, mask))


def _wire(idx, mask, n, device):
    return hp.halo_wire(torch.from_numpy(idx).to(device),
                        torch.from_numpy(mask).to(device), n)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["w0", "all_masked", "first_last_rows",
                                  "neg_zero_seed", "odd_f"])
def test_halo_unpack_add_edges_bitwise_plain(cuda, case):
    """W = 0, a wire whose mask is all 0, recv rows 0 and N-1, a -0.0 seed
    and a width that is not a multiple of 4 (scalar path): torch.equal to
    the plain version, one counted launch each."""
    rng = np.random.default_rng(7)
    n, w, f = 97, 16, 32
    if case == "odd_f":
        f = 6
    idx = rng.choice(np.arange(1, n - 1), w, replace=False).astype(np.int32)
    mask = np.ones(w, np.float32)
    if case == "w0":
        idx, mask = idx[:0], mask[:0]
    elif case == "all_masked":
        mask[:] = 0.0
        idx[:] = 0
    elif case == "first_last_rows":
        idx[0], idx[-1] = 0, n - 1
    a = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(cuda)
    if case == "neg_zero_seed":
        a = torch.full_like(a, -0.0)
        mask[-3:] = 0.0
        idx[-3:] = 0                    # padding slots onto row 0
    buf = torch.from_numpy(rng.normal(size=(idx.shape[0], f)).astype(np.float32)).to(cuda)
    wire = _wire(idx, mask, n, cuda)
    idx, mask, inv = wire
    n0 = build.launch_counts.get(hp.UNPACK, 0)
    got = hp.halo_unpack_add(a, buf, wire)
    torch.cuda.synchronize()
    assert build.launch_counts[hp.UNPACK] == n0 + 1
    assert torch.equal(got, hp.halo_unpack_add_plain(a, buf, idx, mask))
    if case == "neg_zero_seed":       # rows no real slot lands on keep -0.0
        untouched = inv < 0
        assert torch.equal(torch.signbit(got[untouched]),
                           torch.ones_like(got[untouched], dtype=torch.bool))


@pytest.mark.gpu
def test_halo_unpack_add_without_inverse_raises(cuda):
    a = torch.zeros(8, 4, device=cuda)
    buf = torch.zeros(2, 4, device=cuda)
    idx = torch.tensor([1, 2], dtype=torch.int32, device=cuda)
    mask = torch.ones(2, device=cuda)
    with pytest.raises(ValueError, match="inv"):
        hp.halo_unpack_add(a, buf, hp.HaloWire(idx, mask))
    with pytest.raises(ValueError, match="inv"):
        hp.halo_pack(a.clone().requires_grad_(True), hp.HaloWire(idx, mask))
    with pytest.raises(TypeError, match="dtype"):
        hp.halo_unpack_add(a, buf,
                           hp.HaloWire(idx, mask, torch.zeros(8, device=cuda)))


@pytest.mark.gpu
def test_segment_sum_deterministic_on_card(cuda):
    gen = torch.Generator().manual_seed(0)
    data = torch.randn(20000, 32, generator=gen).to(cuda)
    ids = torch.randint(0, 500, (20000,), generator=gen).to(cuda)
    a = segment_sum(data, ids, 500)
    assert torch.equal(a, segment_sum(data, ids, 500))
    want = torch.zeros(500, 32, device=cuda).index_add_(0, ids, data)
    torch.testing.assert_close(a, want, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_fused_forward_one_rank_equals_four_ranks_on_card(cuda):
    cfg = GNNConfig(hidden=32, n_mp_layers=2, mlp_hidden_layers=5)
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device=cuda)
    sem = box_mesh((4, 2, 2), p=2)
    x = taylor_green_velocity(sem.coords)
    outs = []
    for grid, mode in (((1, 1, 1), NONE), ((2, 2, 1), NEIGHBOR)):
        pg = partition_mesh(sem, grid)
        plan = NMPPlan.build(pg, mode, packed=True, backend=FUSED)
        g = ShardedGraph.build(pg, sem.coords, plan, device=cuda)
        xs = torch.from_numpy(gather_node_features(pg, x)).to(cuda)
        y = gnn_forward_stacked(params, xs, g, plan, sync_fn=halo_sync_stacked)
        outs.append(scatter_node_outputs(pg, y.cpu().numpy()))
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_fused_backend_matches_plain_backend_on_card(cuda):
    cfg = GNNConfig(hidden=32, n_mp_layers=4, mlp_hidden_layers=5)
    params = init_gnn(torch.Generator().manual_seed(1), cfg, device=cuda)
    outs = []
    for backend in (XLA, FUSED):
        plan = NMPPlan(backend=backend)
        sem, pg, g = _graph((4, 2, 2), (1, 1, 1), plan, cuda)
        x = torch.from_numpy(gather_node_features(
            pg, taylor_green_velocity(sem.coords))[0]).to(cuda)
        outs.append(gnn_forward(params, x, g.rank(0), plan))
    torch.testing.assert_close(outs[1], outs[0], rtol=RTOL, atol=ATOL)


def _rel_norm(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("has_ln", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("layers", [1, 6], ids=["lp0", "lp5"])
@pytest.mark.parametrize("hidden", [8, 16, 32])
def test_fused_nmp_bwd_kernel_matches_plain(cuda, hidden, layers, has_ln):
    plan = NMPPlan(backend=FUSED, block_e=32)
    _, pg, g = _graph((3, 2, 2), (1, 1, 1), plan, cuda)
    g = g.rank(0)
    gen = torch.Generator().manual_seed(hidden + layers)
    cfg = GNNConfig(hidden=hidden, n_mp_layers=1, mlp_hidden_layers=layers - 1)
    edge = init_gnn(gen, cfg, device=cuda)["mp"][0]["edge"]
    if not has_ln:
        edge.pop("ln")
    for lp in edge["layers"]:                  # non-trivial biases
        lp["b"] = 0.1 * torch.randn(lp["b"].shape, generator=gen).to(cuda)
    x = torch.randn(pg.n_pad, hidden, generator=gen).to(cuda)
    e = torch.randn(pg.e_pad, hidden, generator=gen).to(cuda)
    g_enew = torch.randn(pg.e_pad, hidden, generator=gen).to(cuda)
    g_agg = torch.randn(pg.n_pad, hidden, generator=gen).to(cuda)
    lay = (g["seg_perm"], g["seg_src"], g["seg_rowptr"])
    rest = (g["edge_mask"], g["edge_inv_mult"], g_enew, g_agg)
    n0 = build.launch_counts.get(sa.KERNEL_BWD, 0)
    got = sa.fused_nmp_edge_agg_bwd(x, e, edge, *lay, g["seg_src_slots"],
                                    g["seg_src_rowptr"], *rest)
    torch.cuda.synchronize()
    assert build.launch_counts[sa.KERNEL_BWD] == n0 + 1
    want = sa.fused_nmp_edge_agg_bwd_plain(x, e, edge, *lay, *rest)
    torch.testing.assert_close(got[0], want[0], rtol=G_RTOL, atol=G_ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=G_RTOL, atol=G_ATOL)
    n_hidden = layers - 1
    for i, (a, b) in enumerate(zip(got[2:], want[2:])):
        if i in (2, 3) and n_hidden == 0:      # the dummy hidden stack
            assert not a.any() and not b.any()
        elif i in (4, 5) and not has_ln:       # no LayerNorm
            assert not a.any() and not b.any()
        else:
            assert _rel_norm(a, b) <= W_REL, i
    again = sa.fused_nmp_edge_agg_bwd(x, e, edge, *lay, g["seg_src_slots"],
                                      g["seg_src_rowptr"], *rest)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _ragged_layout(rng, cuda, n=300, block_e=32):
    """A graph whose dst-sorted slots hit every ragged case of the backward
    kernel's 128-slot tiles: node 5's 200 slots span two tiles, node 7's
    300 slots are all masked (a whole tile of masked rows), nodes 0..39
    receive nothing (g_x from their src side only, or none), 17 edges point
    past the nodes (outside the layout: g_e stays 0) and the slot count is
    not a multiple of 128."""
    dst = np.concatenate([np.full(200, 5), np.full(300, 7),
                          rng.integers(40, n, 611), np.full(17, n)])
    src = rng.integers(0, n, dst.size)
    order = rng.permutation(dst.size)
    src, dst = src[order], dst[order]
    lay = sa.compact_gather_layout(src, dst, n, block_e)
    assert lay["n_edges"] % 128 and lay["n_edges"] == 1111
    mask = np.where(dst == 7, 0.0, 1.0).astype(np.float32)
    mask[dst == n] = 0.0
    deg = np.bincount(np.minimum(dst, n), minlength=n + 1)[np.minimum(dst, n)]
    inv = (1.0 / deg).astype(np.float32)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    return ((T(lay["perm"]), T(lay["src"]), T(lay["rowptr"])),
            (T(lay["src_slots"]), T(lay["src_rowptr"])), T(mask), T(inv),
            np.nonzero(dst == n)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("hidden,layers", [(8, 1), (16, 3), (32, 6)])
def test_fused_nmp_bwd_kernel_ragged_tiles(cuda, hidden, layers):
    """Nodes spanning tiles, isolated nodes, an all-masked tile, edges
    outside the layout and a ragged last tile: within the gradient bands of
    the plain version and bitwise equal across two launches."""
    rng = np.random.default_rng(hidden)
    lay, src_lay, mask, inv, outside = _ragged_layout(rng, cuda)
    n, n_edges = 300, mask.shape[0]
    gen = torch.Generator().manual_seed(hidden)
    cfg = GNNConfig(hidden=hidden, n_mp_layers=1, mlp_hidden_layers=layers - 1)
    edge = init_gnn(gen, cfg, device=cuda)["mp"][0]["edge"]
    for lp in edge["layers"]:
        lp["b"] = 0.1 * torch.randn(lp["b"].shape, generator=gen).to(cuda)
    R = lambda *s: torch.randn(*s, generator=gen).to(cuda)  # noqa: E731
    x, e, g_enew, g_agg = R(n, hidden), R(n_edges, hidden), R(n_edges, hidden), R(n, hidden)
    rest = (mask, inv, g_enew, g_agg)
    got = sa.fused_nmp_edge_agg_bwd(x, e, edge, *lay, *src_lay, *rest)
    want = sa.fused_nmp_edge_agg_bwd_plain(x, e, edge, *lay, *rest)
    torch.testing.assert_close(got[0], want[0], rtol=G_RTOL, atol=G_ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=G_RTOL, atol=G_ATOL)
    assert not got[1][torch.from_numpy(outside).to(cuda)].any()
    for i, (a, b) in enumerate(zip(got[2:], want[2:])):
        if i in (2, 3) and layers == 1:
            assert not a.any() and not b.any()
        else:
            assert _rel_norm(a, b) <= W_REL, i
    again = sa.fused_nmp_edge_agg_bwd(x, e, edge, *lay, *src_lay, *rest)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_fused_nmp_bwd_plan_and_limits(cuda):
    """The edge pass's launch as the card reports it, and what the wrapper
    refuses: more hidden layers than the accumulators hold."""
    plan = sa.bwd_launch_plan(32, 5, 4_315_696)
    assert plan["smem_bytes"] == 220_672 and plan["blocks_per_sm"] >= 1
    assert 1 <= plan["grid"] <= 132 * plan["blocks_per_sm"]
    assert sa.bwd_launch_plan(8, 0, 10)["grid"] == 1
    gen = torch.Generator().manual_seed(0)
    cfg = GNNConfig(hidden=8, n_mp_layers=1, mlp_hidden_layers=6)
    edge = init_gnn(gen, cfg, device=cuda)["mp"][0]["edge"]
    rng = np.random.default_rng(0)
    lay, src_lay, mask, inv, _ = _ragged_layout(rng, cuda)
    z = lambda *s: torch.zeros(*s, device=cuda)  # noqa: E731
    with pytest.raises(ValueError, match="at most 5"):
        sa.fused_nmp_edge_agg_bwd(z(300, 8), z(1128, 8), edge, *lay, *src_lay, mask,
                                  inv, z(1128, 8), z(300, 8))


@pytest.mark.gpu
def test_halo_kernel_grads_bitwise_plain(cuda):
    rng = np.random.default_rng(3)
    n, w, f = 301, 72, 32
    idx = np.zeros(w, np.int32)
    idx[:60] = rng.choice(np.arange(n), 60, replace=False)
    mask = np.zeros(w, np.float32)
    mask[:60] = 1.0
    wire = _wire(idx, mask, n, cuda)
    idx, mask = wire.idx, wire.mask
    T = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)  # noqa: E731
    x, a, buf, g_buf, g_out = T(n, f), T(n, f), T(w, f), T(w, f), T(n, f)
    counts = dict(build.launch_counts)
    xk = x.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(hp.halo_pack(xk, wire), xk, g_buf)
    ak, bk = a.clone().requires_grad_(True), buf.clone().requires_grad_(True)
    ga, gb = torch.autograd.grad(hp.halo_unpack_add(ak, bk, wire), (ak, bk),
                                 g_out)
    # each backward launched the other op's kernel
    assert build.launch_counts[hp.PACK] == counts.get(hp.PACK, 0) + 2
    assert build.launch_counts[hp.UNPACK] == counts.get(hp.UNPACK, 0) + 2
    xp = x.clone().requires_grad_(True)
    (wx,) = torch.autograd.grad(hp.halo_pack_plain(xp, idx, mask), xp, g_buf)
    ap, bp = a.clone().requires_grad_(True), buf.clone().requires_grad_(True)
    wa, wb = torch.autograd.grad(hp.halo_unpack_add_plain(ap, bp, idx, mask),
                                 (ap, bp), g_out)
    assert torch.equal(gx, wx) and torch.equal(ga, wa) and torch.equal(gb, wb)


@pytest.mark.gpu
def test_fused_training_steps_bitwise_repeatable(cuda):
    sem = box_mesh((4, 2, 2), p=2)
    pg = partition_mesh(sem, (1, 1, 1))
    cfg = GNNConfig(hidden=32, n_mp_layers=2, mlp_hidden_layers=5)
    start = init_gnn(torch.Generator().manual_seed(2), cfg, device="cpu")
    runs = []
    for _ in range(2):
        n0 = build.launch_counts.get(sa.KERNEL_BWD, 0)
        hist = train_consistent_gnn(
            pg, sem, cfg, TrainConfig(n_steps=3, plan=NMPPlan(backend=FUSED)),
            params=start, device=cuda)
        assert build.launch_counts[sa.KERNEL_BWD] == n0 + 3 * 2
        runs.append(hist)
    assert runs[0]["losses"] == runs[1]["losses"]
    assert all(np.isfinite(runs[0]["losses"]))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(runs[0]["params"]),
                                                 tree_leaves(runs[1]["params"])))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 20, 13])
@pytest.mark.parametrize("h", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_embedding_bag_kernel_bitwise_plain(cuda, dtype, h, d):
    gen = torch.Generator().manual_seed(h * 100 + d)
    table = torch.randn(5000, d, generator=gen).to(dtype).to(cuda)
    idx = torch.randint(0, 5000, (777, h), generator=gen, dtype=torch.int32).to(cuda)
    n0 = build.launch_counts.get(eb.KERNEL, 0)
    got = eb.embedding_bag(table, idx)
    torch.cuda.synchronize()
    assert build.launch_counts[eb.KERNEL] == n0 + 1
    assert got.dtype == dtype and got.shape == (777, d)
    assert torch.equal(got, eb.embedding_bag_plain(table, idx))
    assert torch.equal(got, eb.embedding_bag(table, idx))


@pytest.mark.gpu
def test_embedding_bag_kernel_traps_on_out_of_range_ids(cuda):
    # a trap ends the CUDA context, so it runs in a process of its own
    code = ("import torch\n"
            "from repro_torch.kernels.embedding_bag import ops as eb\n"
            "t = torch.randn(100, 64, device='cuda')\n"
            "idx = torch.tensor([[3], [100]], dtype=torch.int32, device='cuda')\n"
            "eb.embedding_bag(t, idx)\n"
            "torch.cuda.synchronize()\n")
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parents[1] / "src")}
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and "Error" in r.stderr, r.stderr[-2000:]


@pytest.mark.gpu
def test_dlrm_smoke_cells_on_card(cuda):
    cfg = dlrm_rm2.smoke_config()
    for shape_id in ("serve_p99", "serve_bulk"):
        step, args, _ = dlrm_rm2.build_cell(shape_id, device=cuda, cfg=cfg)
        n0 = build.launch_counts.get(eb.KERNEL, 0)
        logits = step(*args)
        assert build.launch_counts[eb.KERNEL] == n0 + 1
        assert bool(torch.isfinite(logits).all())
    runs = []
    for _ in range(2):
        step, args, _ = dlrm_rm2.build_cell("train_batch", device=cuda, seed=3, cfg=cfg)
        n0 = build.launch_counts.get(eb.KERNEL, 0)
        losses = [float(step(*args)[1]) for _ in range(3)]
        assert build.launch_counts[eb.KERNEL] == n0 + 3
        runs.append((losses, tree_leaves(args[0])))
    assert runs[0][0] == runs[1][0] and all(np.isfinite(runs[0][0]))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # B, S, Hq, Hkv, D, causal, window, softcap
    (1, 128, 2, 2, 64, True, 0, None), (2, 96, 4, 2, 32, True, 0, None),
    (1, 160, 2, 1, 64, True, 48, None), (1, 64, 2, 2, 128, False, 0, 30.0),
    (1, 72, 1, 1, 16, True, 0, None), (2, 300, 48, 1, 128, True, 0, None),
    (1, 200, 8, 1, 128, False, 70, 20.0),
    # around the 128-row query and 128-key tiles; G = Hq / Hkv of 1, 2, 3,
    # 8 and 48; every head dim; softcap under the causal mask; a window
    # whose edge crosses a key tile
    (1, 1, 2, 1, 64, True, 0, None), (1, 127, 3, 1, 128, True, 0, None),
    (2, 128, 8, 1, 32, True, 0, None), (1, 129, 4, 4, 16, True, 0, None),
    (1, 255, 6, 2, 64, True, 0, 50.0), (1, 257, 48, 1, 128, True, 0, None),
    (1, 257, 2, 2, 32, False, 0, None), (1, 300, 4, 1, 64, True, 130, None),
    (1, 300, 3, 3, 128, True, 130, 30.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_attention_kernel_matches_plain(cuda, dtype, case):
    B, S, Hq, Hkv, D, causal, window, cap = case
    gen = torch.Generator().manual_seed(S + Hq)
    q, k, v = (torch.randn(B, S, h, D, generator=gen).to(dtype).to(cuda)
               for h in (Hq, Hkv, Hkv))
    kw = dict(scale=D ** -0.5, causal=causal, window=window, softcap=cap)
    n0 = build.launch_counts.get(fa.KERNEL, 0)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert build.launch_counts[fa.KERNEL] == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got, fa.attention_plain(q, k, v, **kw), **FLASH_TOL[dtype])
    assert torch.equal(got, fa.flash_attention(q, k, v, **kw))


@pytest.mark.gpu
def test_flash_attention_kernel_rows_at_long_sequence(cuda):
    """MQA at S=8,192 in bf16, where a late row's outputs are far smaller
    than TOL's atol: each row within a relative L2 error of 1e-2 of the
    plain version's (1.3 bf16 ulps at the bottom of a binade)."""
    gen = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn(1, 8192, h, 128, generator=gen).to(torch.bfloat16).to(cuda)
               for h in (8, 1, 1))
    got = fa.flash_attention(q, k, v, scale=128 ** -0.5).float()
    want = fa.attention_plain(q, k, v, scale=128 ** -0.5, chunk=1024).float()
    rel = (got - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(rel.max()) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("heads", [(8, 2), (48, 1)], ids=["gqa", "mqa"])
def test_decode_attention_on_card_matches_cpu(cuda, dtype, heads):
    """Decode attention's products on the card (cuBLAS, bf16 operands, fp32
    results) equal the CPU's fp32 products of the upcast operands up to the
    order of the sums; the cache is written in place on both.  A score
    that differs in its last fp32 bit may round P to another bf16 value,
    and an output that cancels to near zero then moves by many of its own
    ulps: each row is held by its relative L2 error."""
    (Hq, Hkv), B, cap, n = heads, 3, 320, 300
    gen = torch.Generator().manual_seed(Hq)
    q = torch.randn(B, Hq, 128, generator=gen).to(dtype)
    kc, vc = (torch.randn(B, cap, Hkv, 128, generator=gen).to(dtype) for _ in range(2))
    kn, vn = (torch.randn(B, Hkv, 128, generator=gen).to(dtype) for _ in range(2))
    want = lm_attention.decode_attention(q, kc.clone(), vc.clone(), kn, vn, n,
                                         scale=128 ** -0.5)
    kcd, vcd = kc.to(cuda), vc.to(cuda)
    got = lm_attention.decode_attention(q.to(cuda), kcd, vcd, kn.to(cuda), vn.to(cuda), n,
                                        scale=128 ** -0.5)
    assert got.dtype == dtype and torch.equal(kcd[:, n].cpu(), kn)
    got, want = got.cpu().float(), want.float()
    rel = (got - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(rel.max()) <= (1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_attention_kernel_reads_strided_views(cuda, dtype, d):
    """K and V read in place from a cache of larger capacity, Q as a slice
    of a wider projection: the same result as contiguous copies, one launch
    each, within TOL of the plain version."""
    gen = torch.Generator().manual_seed(3)
    cache = torch.randn(2, 2, 256, 1, d, generator=gen).to(dtype).to(cuda)
    qkv = torch.randn(2, 200, 10, d, generator=gen).to(dtype).to(cuda)
    q, k, v = qkv[:, :, :8], cache[0, :, :200], cache[1, :, :200]
    n0 = build.launch_counts.get(fa.KERNEL, 0)
    got = fa.flash_attention(q, k, v, scale=d ** -0.5)
    assert build.launch_counts[fa.KERNEL] == n0 + 1
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale=d ** -0.5)
    assert torch.equal(got, want)
    torch.testing.assert_close(got, fa.attention_plain(q, k, v, scale=d ** -0.5),
                               **FLASH_TOL[dtype])


@pytest.mark.gpu
def test_flash_attention_kernel_raises_on_what_it_does_not_take(cuda):
    q = torch.randn(1, 32, 4, 64, device=cuda)
    with pytest.raises(ValueError, match="on cpu"):
        fa.flash_attention(q, q[:, :, :2].cpu(), q[:, :, :2], scale=1.0)
    with pytest.raises(ValueError, match="head dim"):
        x = torch.randn(1, 32, 4, 48, device=cuda)
        fa.flash_attention(x, x, x, scale=1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        x = q.half()
        fa.flash_attention(x, x, x, scale=1.0)
    with pytest.raises(ValueError, match="strides"):
        x = torch.randn(1, 32, 4, 128, device=cuda)[..., ::2]
        fa.flash_attention(x, x, x, scale=1.0)


@pytest.mark.gpu
def test_granite_smoke_cells_on_card(cuda):
    """Prefill through the kernel (one launch per layer) and decode steps
    (none) agree with the full forward through the plain attention, fp32."""
    cfg = granite_34b.smoke_config().with_(param_dtype=torch.float32,
                                           cache_dtype=torch.float32)
    params = lm.init_transformer(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)
    tok = torch.randint(0, cfg.vocab, (2, 140), device=cuda)
    with torch.no_grad():
        n0 = build.launch_counts.get(fa.KERNEL, 0)
        last, cache = lm.prefill_step(params, tok[:, :130], cfg, capacity=140)
        assert build.launch_counts[fa.KERNEL] == n0 + cfg.n_layers
        steps = [last]
        for i in range(130, 140):
            logits, cache = lm.decode_step(params, cache, tok[:, i:i + 1], i, cfg)
            steps.append(logits[:, 0])
        assert build.launch_counts[fa.KERNEL] == n0 + cfg.n_layers
        full = lm.forward(params, tok, cfg,
                          attention=lambda q, k, v, scale: fa.attention_plain(
                              q, k, v, scale=scale, causal=True))
    torch.testing.assert_close(torch.stack(steps, 1), full[:, 129:140], rtol=1e-4, atol=1e-5)


MLP_AGG_E_TOL = {torch.float32: dict(rtol=3e-5, atol=3e-5),
                 torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
MLP_AGG_TOL = dict(rtol=1e-4, atol=1e-4)


def _mlp_agg_case(device, n, E, fin, hh, hid, block_n, block_e, dtype, seed=0):
    """A random graph with some edges past the last node (dropped by the
    layout), its dst-aligned layout and the op's operands on ``device``."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n + n // 20 + 1, E)
    layout = sa.dst_aligned_layout(dst, n, block_n, block_e)
    T = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(dt).to(device)
    feats = T(rng.normal(size=(E, fin)), dtype)
    wgt = T(rng.uniform(0.5, 1.0, E))
    mlp = (T(rng.normal(size=(fin, hh)) * 0.2), T(rng.normal(size=hh) * 0.1),
           T(rng.normal(size=(hh, hid)) * 0.2), T(rng.normal(size=hid) * 0.1))
    return dst, layout, feats, wgt, mlp


def _mlp_agg_tiles(layout, feats, wgt):
    perm = torch.from_numpy(layout["perm"]).to(feats.device)
    valid = perm >= 0
    tiles = torch.where(valid[..., None], feats[perm.clamp(min=0)], 0)
    w = torch.where(valid, wgt[perm.clamp(min=0)], 0)
    return tiles, torch.from_numpy(layout["dstl"]).to(feats.device), w


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # n, E, Fin, Hh, H, block_n, block_e: the CPU tests' blocks, full width
    # with Hh != H, Fin whose rows are not 16-byte multiples (element loads)
    (90, 400, 24, 16, 16, 16, 32), (3000, 20000, 96, 32, 32, 128, 256),
    (700, 4000, 96, 20, 32, 128, 256), (500, 3000, 22, 32, 16, 128, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_edge_mlp_agg_kernel_matches_plain(cuda, dtype, case):
    n, E, fin, hh, hid, block_n, block_e = case
    _, layout, feats, wgt, mlp = _mlp_agg_case(cuda, n, E, fin, hh, hid, block_n,
                                               block_e, dtype)
    tiles = _mlp_agg_tiles(layout, feats, wgt)
    kw = dict(n_node_blocks=layout["n_node_blocks"], block_n=block_n, block_e=block_e)
    n0 = build.launch_counts.get(sa.KERNEL_MLP_AGG, 0)
    e_new, agg = sa.edge_mlp_agg(*tiles, *mlp, **kw)
    torch.cuda.synchronize()
    assert build.launch_counts[sa.KERNEL_MLP_AGG] == n0 + 1
    assert e_new.dtype == dtype and e_new.shape == tiles[0].shape[:3] + (hid,)
    assert agg.dtype == torch.float32 and agg.shape == (kw["n_node_blocks"], block_n, hid)
    want_e, want_agg = sa.edge_mlp_agg_plain(*tiles, *mlp, **kw)
    torch.testing.assert_close(e_new, want_e, **MLP_AGG_E_TOL[dtype])
    torch.testing.assert_close(agg, want_agg, **MLP_AGG_TOL)
    again = sa.edge_mlp_agg(*tiles, *mlp, **kw)
    assert torch.equal(e_new, again[0]) and torch.equal(agg, again[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_fused_edge_mlp_agg_on_card_launches_once_and_matches_cpu(cuda, dtype):
    """The op on CUDA tensors: one launch per call, the CPU's plain result
    within the bands, dropped edges' e_new exactly 0."""
    dst, layout, feats, wgt, mlp = _mlp_agg_case(cuda, 2000, 12000, 96, 32, 32, 128, 256,
                                                 dtype, seed=3)
    kw = dict(n_nodes=2000, block_n=128, block_e=256)
    n0 = build.launch_counts.get(sa.KERNEL_MLP_AGG, 0)
    e_new, agg = sa.fused_edge_mlp_agg(feats, torch.from_numpy(dst).to(cuda), wgt, *mlp,
                                       layout, **kw)
    torch.cuda.synchronize()
    assert build.launch_counts[sa.KERNEL_MLP_AGG] == n0 + 1
    cpu = lambda t: t.cpu()
    want_e, want_agg = sa.fused_edge_mlp_agg(cpu(feats), torch.from_numpy(dst), cpu(wgt),
                                             *map(cpu, mlp), layout, **kw)
    assert build.launch_counts[sa.KERNEL_MLP_AGG] == n0 + 1
    torch.testing.assert_close(e_new.cpu(), want_e, **MLP_AGG_E_TOL[dtype])
    torch.testing.assert_close(agg.cpu(), want_agg, **MLP_AGG_TOL)
    dropped = torch.from_numpy(dst >= 2000).to(cuda)
    assert int(dropped.sum()) > 0 and not bool(e_new[dropped].any())


@pytest.mark.gpu
def test_edge_mlp_agg_kernel_drops_out_of_range_dst_local(cuda):
    """Slots whose dst_local lies outside [0, block_n) add to no node, in
    the kernel as in the plain version."""
    _, layout, feats, wgt, mlp = _mlp_agg_case(cuda, 90, 400, 24, 16, 16, 16, 32,
                                               torch.float32)
    f, dstl, w = _mlp_agg_tiles(layout, feats, wgt)
    dstl = dstl.clone()
    dstl[0, 0, :5] = torch.tensor([-1, 16, 17, 40, -7], dtype=dstl.dtype, device=cuda)
    kw = dict(n_node_blocks=layout["n_node_blocks"], block_n=16, block_e=32)
    e_new, agg = sa.edge_mlp_agg(f, dstl, w, *mlp, **kw)
    want_e, want_agg = sa.edge_mlp_agg_plain(f, dstl, w, *mlp, **kw)
    torch.testing.assert_close(e_new, want_e, **MLP_AGG_E_TOL[torch.float32])
    torch.testing.assert_close(agg, want_agg, **MLP_AGG_TOL)


@pytest.mark.gpu
def test_edge_mlp_agg_kernel_raises_on_what_it_does_not_take(cuda):
    _, layout, feats, wgt, mlp = _mlp_agg_case(cuda, 90, 400, 24, 16, 16, 16, 32,
                                               torch.float32)
    tiles = _mlp_agg_tiles(layout, feats, wgt)
    kw = dict(n_node_blocks=layout["n_node_blocks"], block_n=16, block_e=32)
    w1, b1, w2, b2 = mlp
    with pytest.raises(ValueError, match="Hh and H <= 32"):
        sa.edge_mlp_agg(*tiles, torch.zeros(24, 40, device=cuda),
                        torch.zeros(40, device=cuda), torch.zeros(40, 16, device=cuda),
                        b2, **kw)
    with pytest.raises(ValueError, match="block_n <= 256"):
        sa.edge_mlp_agg(*tiles, *mlp, **dict(kw, block_n=512))
    with pytest.raises(TypeError, match="dtype"):
        sa.edge_mlp_agg(tiles[0], tiles[1].long(), tiles[2], *mlp, **kw)
    with pytest.raises(TypeError, match="dtype"):
        sa.edge_mlp_agg(*tiles, w1.double(), b1, w2, b2, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        sa.edge_mlp_agg(*tiles, w1.t().contiguous().t(), b1, w2, b2, **kw)
    with pytest.raises(ValueError, match="on cpu|expected cuda"):
        sa.edge_mlp_agg(*tiles, w1.cpu(), b1, w2, b2, **kw)


def _edge_blocks_case(device, fin, hid, block_n, block_e, dtype):
    """Three node blocks of ``block_n``: the first with many edges (a tile
    that ends part-way at any block_e), the second with one slot, the third
    with padding only."""
    rng = np.random.default_rng(fin * 1000 + hid * 10 + block_e)
    n = 3 * block_n
    dst = np.concatenate([rng.integers(0, block_n, 5 * block_e // 2 + 7),
                          [block_n + block_n // 3]])
    rng.shuffle(dst)
    layout = sa.dst_aligned_layout(dst, n, block_n, block_e)
    T = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(dt).to(device)
    feats = T(rng.normal(size=(dst.size, fin)), dtype)
    wgt = T(rng.uniform(0.5, 1.0, dst.size))
    mlp = (T(rng.normal(size=(fin, hid)) * 0.3), T(rng.normal(size=hid) * 0.1),
           T(rng.normal(size=(hid, hid)) * 0.3), T(rng.normal(size=hid) * 0.1))
    return layout, _mlp_agg_tiles(layout, feats, wgt), mlp


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hid", [16, 20, 32])
@pytest.mark.parametrize("fin", [3, 24, 96, 128])
@pytest.mark.parametrize("block_e", [32, 128, 256])
def test_edge_mlp_agg_kernel_tile_edges(cuda, block_e, fin, hid, dtype):
    """Kernel 3 at its tile edges: 64-slot tiles against any block_e, Fin
    and H that are not multiples of 8 (zero-padded k-steps and n-tiles),
    rows that are not 16-byte multiples (element loads), a node block of
    one slot and one of padding only: within the bands of plain, exactly
    one launch, two launches bitwise equal."""
    layout, tiles, mlp = _edge_blocks_case(cuda, fin, hid, 128, block_e, dtype)
    kw = dict(n_node_blocks=3, block_n=128, block_e=block_e)
    n0 = build.launch_counts.get(sa.KERNEL_MLP_AGG, 0)
    e_new, agg = sa.edge_mlp_agg(*tiles, *mlp, **kw)
    torch.cuda.synchronize()
    assert build.launch_counts[sa.KERNEL_MLP_AGG] == n0 + 1
    want_e, want_agg = sa.edge_mlp_agg_plain(*tiles, *mlp, **kw)
    torch.testing.assert_close(e_new, want_e, **MLP_AGG_E_TOL[dtype])
    torch.testing.assert_close(agg, want_agg, **MLP_AGG_TOL)
    assert not bool(agg[2].any()) and int((agg[1].abs().sum(-1) > 0).sum()) == 1
    again = sa.edge_mlp_agg(*tiles, *mlp, **kw)
    assert torch.equal(e_new, again[0]) and torch.equal(agg, again[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("block_n", [1, 16, 64, 100, 129, 200, 256])
def test_edge_mlp_agg_kernel_block_n(cuda, block_n, dtype):
    """Every node m-tile count the kernel is built for (block_n up to 64,
    128 and 256 per warp group), block_n not a multiple of 16: within the
    bands of plain, bitwise repeatable; the launch plan fits the card."""
    layout, tiles, mlp = _edge_blocks_case(cuda, 24, 16, block_n, 32, dtype)
    kw = dict(n_node_blocks=3, block_n=block_n, block_e=32)
    e_new, agg = sa.edge_mlp_agg(*tiles, *mlp, **kw)
    want_e, want_agg = sa.edge_mlp_agg_plain(*tiles, *mlp, **kw)
    torch.testing.assert_close(e_new, want_e, **MLP_AGG_E_TOL[dtype])
    torch.testing.assert_close(agg, want_agg, **MLP_AGG_TOL)
    again = sa.edge_mlp_agg(*tiles, *mlp, **kw)
    assert torch.equal(e_new, again[0]) and torch.equal(agg, again[1])
    plan = sa.mlp_agg_launch_plan(24, block_n, dtype, 3)
    assert plan["grid"] == 3 and plan["groups"] == 1 and plan["blocks_per_sm"] >= 1


@pytest.mark.gpu
def test_edge_mlp_agg_launch_plan_at_full_width(cuda):
    """At the serving mesh's 5,687 node blocks: fp32 feats run 3 groups of
    4 warps per SM, bf16 feats 4, one persistent block per SM."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype, groups in ((torch.float32, 3), (torch.bfloat16, 4)):
        plan = sa.mlp_agg_launch_plan(96, 128, dtype, 5687)
        assert plan == dict(grid=sms, groups=groups, smem_bytes=plan["smem_bytes"],
                            blocks_per_sm=1, threads=128 * groups)
    assert sa.mlp_agg_launch_plan(96, 128, torch.float32, 5687)["smem_bytes"] == 228_608


def _packed_graph(grid, device):
    sem = box_mesh((4, 2, 2), p=2)
    pg = partition_mesh(sem, grid)
    plan = NMPPlan.build(pg, NEIGHBOR, packed=True)
    return pg, plan, ShardedGraph.build(pg, sem.coords, plan, device=device)


def _per_round_exchange(a, graph, plan):
    """The packed exchange as one pack and one unpack-add per round and
    receiver (the exchange before it was one op)."""
    out = list(a.unbind(0))
    for k, perm in enumerate(plan.halo.perms):
        send, recv = graph.wire(f"pk{k}_send"), graph.wire(f"pk{k}_recv")
        new = list(out)
        for s, r in perm:
            new[r] = hp.halo_unpack_add(out[r], hp.halo_pack(a[s], send.rank(s)),
                                        recv.rank(r))
        out = new
    return torch.stack(out)


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [(2, 2, 1), (4, 1, 1)], ids=["2x2", "4x1"])
def test_halo_exchange_pack_bitwise_plain(cuda, grid):
    """The exchange pack (one launch over every round and sender, send and
    recv wires): torch.equal to each round's plain pack of each rank."""
    pg, plan, graph = _packed_graph(grid, cuda)
    a = torch.from_numpy(np.random.default_rng(5).normal(
        size=(pg.R, pg.n_pad, 32)).astype(np.float32)).to(cuda)
    for side in ("send", "recv"):
        wire = graph.wire(f"pk_{side}")
        n0 = build.launch_counts.get(hp.PACK, 0)
        got = hp._pack(a, wire.idx, wire.mask)
        torch.cuda.synchronize()
        assert build.launch_counts[hp.PACK] == n0 + 1
        off = 0
        for k in range(len(plan.halo.perms)):
            rw = graph.wire(f"pk{k}_{side}")
            w = rw.idx.shape[-1]
            for r in range(pg.R):
                assert torch.equal(got[r, off:off + w],
                                   hp.halo_pack_plain(a[r], *rw.rank(r)[:2]))
            off += w
        assert off == got.shape[1]


@pytest.mark.gpu
def test_halo_exchange_on_card_launches_and_bitwise(cuda):
    """halo_sync_stacked's packed exchange on the card: one pack and one
    unpack-add per round and receiver forward, the same again backward;
    the forward bitwise equal to the per-round path, values and gradients
    bitwise equal to the CPU's plain exchange and to a second run."""
    pg, plan, graph = _packed_graph((2, 2, 1), cuda)
    _, _, cpu_graph = _packed_graph((2, 2, 1), "cpu")
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.normal(size=(pg.R, pg.n_pad, 32)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=a.shape).astype(np.float32))
    pairs = sum(len(p) for p in plan.halo.perms)

    def run(device, graph):
        x = a.to(device).requires_grad_(True)
        counts = dict(build.launch_counts)
        y = halo_sync_stacked(x, graph, plan.halo)
        (gx,) = torch.autograd.grad(y, x, g.to(device))
        delta = {k: build.launch_counts.get(k, 0) - counts.get(k, 0)
                 for k in (hp.PACK, hp.UNPACK)}
        return y.detach(), gx, delta

    y, gx, delta = run(cuda, graph)
    assert delta == {hp.PACK: 2, hp.UNPACK: 2 * pairs}
    y2, gx2, _ = run(cuda, graph)
    assert torch.equal(y, y2) and torch.equal(gx, gx2)
    with torch.no_grad():
        assert torch.equal(y, _per_round_exchange(a.to(cuda), graph, plan))
    yc, gc, delta = run("cpu", cpu_graph)
    assert delta == {hp.PACK: 0, hp.UNPACK: 0}
    assert torch.equal(y.cpu(), yc) and torch.equal(gx.cpu(), gc)


@pytest.mark.gpu
def test_distributed_step_on_card_bitwise_stacked(cuda):
    """4 gloo processes sharing the card (``launch/consistency.py``): each
    rank's exchange of a seeded aggregate, its gradient and its forward
    bitwise equal to the stacked emulator's rank slice on the card, and
    each process's launches per packed forward exactly one pack and one
    unpack-add per round it receives in, per layer."""
    from repro_torch.launch import consistency as cons
    cfg = GNNConfig.small()
    job = cons.Job(elements=(4, 4, 2), order=3, cfg=cfg, device="cuda",
                   backends=(FUSED,), modes=("packed", "a2a"), halo=True)
    procs = cons.run_world(job, 4)
    sem = box_mesh(job.elements, p=job.order)
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device=cuda)
    for grid, data in cons.CASES[4]:
        pg = partition_mesh(sem, grid)
        case = cons.case_name(grid, data)
        a = torch.from_numpy(cons.seeded(1, (pg.R, pg.n_pad, cfg.hidden))).to(cuda)
        w = torch.from_numpy(cons.seeded(2, a.shape)).to(cuda)
        x = torch.from_numpy(gather_node_features(pg, taylor_green_velocity(sem.coords)))
        for mode in ("packed", "a2a"):
            plan = cons.plan_for(pg, mode, FUSED)
            g = ShardedGraph.build(pg, sem.coords, plan, device=cuda)
            xa = a.clone().requires_grad_(True)
            y = halo_sync_stacked(xa, g, plan.halo)
            (ga,) = torch.autograd.grad(y, xa, w)
            with torch.no_grad():
                pred = gnn_forward_stacked(params, x.to(cuda), g, plan,
                                           sync_fn=halo_sync_stacked)
            rounds = [sum(1 for _, d in perm if d == r) for perm in plan.halo.perms
                      for r in range(pg.R)]
            for p in procs:
                r, rec = p[case]["rank"], p[case]
                assert np.array_equal(rec["halo"][mode]["out"], y[r].detach().cpu().numpy())
                if mode == "packed":
                    assert np.array_equal(rec["halo"][mode]["grad"], ga[r].cpu().numpy())
                    got = rec["steps"][(FUSED, mode)]["fwd_launches"]
                    recv = sum(rounds[k * pg.R + r] for k in range(len(plan.halo.perms)))
                    assert got == {"nmp_fwd": cfg.n_mp_layers, hp.PACK: cfg.n_mp_layers,
                                   hp.UNPACK: cfg.n_mp_layers * recv}
                assert np.array_equal(rec["steps"][(FUSED, mode)]["pred"][0, 0],
                                      pred[r].cpu().numpy())
