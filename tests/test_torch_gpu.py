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
padding only, every block_n it is built for).  Kernels 1 and 2's
generic-width entries (``csrc/nmp_any.cu``: H 4, 12, 64, 100, 512, 1024
x 1, 2, 7 hidden layers) are held to the same bands on the tile-edge and
ragged graphs, bitwise on a rerun, each launch on its own counter.  Every kernel, and a training step through them, is
bitwise repeatable.  The rest of the GNN zoo (GAT, NequIP, MACE) runs no
kernel at one rank: its cells on the card are held to the CPU in the
reference's bands, and GAT over 4 processes launches kernels 4 and 5 in
its sum exchanges alone (none in the max exchange of its softmax shift).
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
from repro_torch.nn import BF16, tree_leaves
from repro_torch.train.loop import TrainConfig, train_consistent_gnn
from repro_torch.runtime.fault_tolerance import FaultPlan, ResilientConfig
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
    """The edge pass's launch as the card reports it, and where the tuned
    kernel's limit now sends a shape: more hidden layers than its
    accumulators hold run the generic backward (``csrc/nmp_any.cu``), within
    the gradient bands of plain, counted on its own counter; the bf16
    entries refuse that depth, naming their ROADMAP item."""
    plan = sa.bwd_launch_plan(32, 5, 4_315_696)
    assert plan["smem_bytes"] == 220_672 and plan["blocks_per_sm"] >= 1
    assert 1 <= plan["grid"] <= 132 * plan["blocks_per_sm"]
    assert sa.bwd_launch_plan(8, 0, 10)["grid"] == 1
    gen = torch.Generator().manual_seed(0)
    cfg = GNNConfig(hidden=8, n_mp_layers=1, mlp_hidden_layers=6)
    edge = init_gnn(gen, cfg, device=cuda)["mp"][0]["edge"]
    rng = np.random.default_rng(0)
    lay, src_lay, mask, inv, _ = _ragged_layout(rng, cuda)
    R = lambda *s: torch.randn(*s, generator=gen).to(cuda)  # noqa: E731
    args = (R(300, 8), R(1128, 8), edge, *lay, *src_lay, mask, inv, R(1128, 8), R(300, 8))
    counts = {k: build.launch_counts.get(k, 0) for k in (sa.KERNEL_BWD, sa.KERNEL_BWD_ANY)}
    got = sa.fused_nmp_edge_agg_bwd(*args)
    torch.cuda.synchronize()
    assert build.launch_counts[sa.KERNEL_BWD_ANY] == counts[sa.KERNEL_BWD_ANY] + 1
    assert build.launch_counts.get(sa.KERNEL_BWD, 0) == counts[sa.KERNEL_BWD]
    want = sa.fused_nmp_edge_agg_bwd_plain(*args[:6], *args[8:])
    torch.testing.assert_close(got[0], want[0], rtol=G_RTOL, atol=G_ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=G_RTOL, atol=G_ATOL)
    assert all(_rel_norm(a, b) <= W_REL for a, b in zip(got[2:], want[2:]))
    with pytest.raises(ValueError, match="queue 2"):
        sa.fused_nmp_edge_agg_bwd(*args, precision=BF16)


#: kernels 1 and 2 at the widths and depths the tuned pair does not take
ANY_WIDTHS = (4, 12, 64, 100, 512, 1024)
ANY_DEPTHS = (1, 2, 7)


def _any_counts():
    return {k: build.launch_counts.get(k, 0)
            for k in (sa.KERNEL, sa.KERNEL_ANY, sa.KERNEL_BWD, sa.KERNEL_BWD_ANY, sa.KERNEL_DST)}


def _dst_launches(hidden, n_hidden):
    """The per-node x_dst pass launches once per call on the tensor-core route."""
    return int(sa.any_route(hidden, n_hidden) == sa.TC)


def _moved(before):
    return {k: build.launch_counts.get(k, 0) - v for k, v in before.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("n_hidden", ANY_DEPTHS)
@pytest.mark.parametrize("hidden", ANY_WIDTHS)
def test_nmp_any_fwd_matches_plain(cuda, hidden, n_hidden):
    """The generic forward on the tile-edge graph (nodes across 2 to 5 of
    its 64-slot tiles, degree-0 nodes, padding edges, a ragged last tile):
    within the forward band of plain, e' of edges outside the layout 0,
    two launches bitwise equal, one launch of its own counter each and
    none of the tuned kernel's."""
    args, outside = _tile_edge_case(cuda, hidden, n_hidden, True, hidden + n_hidden)
    before = _any_counts()
    e_new, agg = sa.fused_nmp_edge_agg(*args)
    torch.cuda.synchronize()
    assert _moved(before) == {sa.KERNEL: 0, sa.KERNEL_ANY: 1, sa.KERNEL_BWD: 0,
                              sa.KERNEL_BWD_ANY: 0, sa.KERNEL_DST: _dst_launches(hidden, n_hidden)}
    pe, pa = sa.fused_nmp_edge_agg_plain(*args)
    torch.testing.assert_close(e_new, pe, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(agg, pa, rtol=RTOL, atol=ATOL)
    assert not e_new[torch.from_numpy(outside).to(cuda)].any()
    e2, a2 = sa.fused_nmp_edge_agg(*args)
    assert torch.equal(e_new, e2) and torch.equal(agg, a2)


@pytest.mark.gpu
@pytest.mark.parametrize("has_ln", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("hidden", [4, 12, 100])
def test_nmp_any_fwd_without_ln_and_hidden_layers(cuda, hidden, has_ln):
    """No hidden layer (the first product is the last) with and without
    LayerNorm, at widths no multiple of 8: within the forward band."""
    args, _ = _tile_edge_case(cuda, hidden, 0, has_ln, hidden)
    e_new, agg = sa.fused_nmp_edge_agg(*args)
    pe, pa = sa.fused_nmp_edge_agg_plain(*args)
    torch.testing.assert_close(e_new, pe, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(agg, pa, rtol=RTOL, atol=ATOL)


def _any_bwd_case(cuda, hidden, n_hidden, has_ln, seed):
    rng = np.random.default_rng(seed)
    lay, src_lay, mask, inv, outside = _ragged_layout(rng, cuda)
    n, n_edges = 300, mask.shape[0]
    gen = torch.Generator().manual_seed(seed)
    cfg = GNNConfig(hidden=hidden, n_mp_layers=1, mlp_hidden_layers=n_hidden)
    edge = init_gnn(gen, cfg, device=cuda)["mp"][0]["edge"]
    if not has_ln:
        edge.pop("ln")
    for lp in edge["layers"]:
        lp["b"] = 0.1 * torch.randn(lp["b"].shape, generator=gen).to(cuda)
    R = lambda *s: torch.randn(*s, generator=gen).to(cuda)  # noqa: E731
    x, e, g_enew, g_agg = R(n, hidden), R(n_edges, hidden), R(n_edges, hidden), R(n, hidden)
    return (x, e, edge, *lay, *src_lay, mask, inv, g_enew, g_agg), outside


@pytest.mark.gpu
@pytest.mark.parametrize("has_ln", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("n_hidden", ANY_DEPTHS)
@pytest.mark.parametrize("hidden", ANY_WIDTHS)
def test_nmp_any_bwd_matches_plain(cuda, hidden, n_hidden, has_ln):
    """The generic backward on the ragged graph (a node's slots across 4
    tiles, an all-masked run, isolated nodes, edges outside the layout, a
    ragged last tile): g_x / g_e within the gradient band of plain, weight
    gradients by relative L2, g_e outside the layout 0, two launches
    bitwise equal, one launch of its own counter each."""
    args, outside = _any_bwd_case(cuda, hidden, n_hidden, has_ln, hidden + n_hidden)
    before = _any_counts()
    got = sa.fused_nmp_edge_agg_bwd(*args)
    torch.cuda.synchronize()
    assert _moved(before) == {sa.KERNEL: 0, sa.KERNEL_ANY: 0, sa.KERNEL_BWD: 0,
                              sa.KERNEL_BWD_ANY: 1, sa.KERNEL_DST: _dst_launches(hidden, n_hidden)}
    want = sa.fused_nmp_edge_agg_bwd_plain(*args[:6], *args[8:])
    torch.testing.assert_close(got[0], want[0], rtol=G_RTOL, atol=G_ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=G_RTOL, atol=G_ATOL)
    assert not got[1][torch.from_numpy(outside).to(cuda)].any()
    for i, (a, b) in enumerate(zip(got[2:], want[2:])):
        if i in (4, 5) and not has_ln:
            assert not a.any() and not b.any()
        else:
            assert _rel_norm(a, b) <= W_REL, i
    again = sa.fused_nmp_edge_agg_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_nmp_any_dispatch_and_plans(cuda):
    """The tuned widths keep the tuned kernels (their counters move, the
    generic ones do not), H=4 goes to the generic pair; bf16 at H=12
    raises naming its ROADMAP item; the launch plans at GraphCast's width
    (the slabs in global memory) and at H=100 (in shared memory)."""
    for hidden, tuned_width in ((32, True), (4, False)):
        args, _ = _any_bwd_case(cuda, hidden, 2, True, 3)
        before = _any_counts()
        sa.fused_nmp_edge_agg(*args[:6], *args[8:10])
        sa.fused_nmp_edge_agg_bwd(*args)
        torch.cuda.synchronize()
        k = (sa.KERNEL, sa.KERNEL_BWD) if tuned_width else (sa.KERNEL_ANY, sa.KERNEL_BWD_ANY)
        assert _moved(before) == {name: int(name in k) for name in before}   # H=4: FMA route
    args, _ = _any_bwd_case(cuda, 12, 1, True, 4)
    with pytest.raises(ValueError, match="queue 2"):
        sa.fused_nmp_edge_agg(*args[:6], *args[8:10], precision=BF16)
    with pytest.raises(ValueError, match="queue 2"):
        sa.fused_nmp_edge_agg_bwd(*args, precision=BF16)
    # the FMA route at GraphCast's width (its plan through the route
    # argument): the slabs in global memory
    plan = sa.fwd_any_launch_plan(512, 1, 180_180, route=sa.FMA)
    assert plan["work_floats"] == 2 * 64 * 512 and plan["tiles"] == -(-180_180 // 64)
    assert 1 <= plan["grid"] <= 132 * plan["blocks_per_sm"] and plan["route"] == sa.FMA
    assert sa.fwd_any_launch_plan(100, 1, 1000, route=sa.FMA)["work_floats"] == 0
    bplan = sa.bwd_any_launch_plan(512, 1, 180_180, route=sa.FMA)
    assert bplan["work_floats"] == 4 * 64 * 512 and bplan["grid"] >= 1
    assert sa.bwd_any_launch_plan(4, 7, 100)["work_floats"] == 0
    # the tensor-core route there by the rule: 128-slot tiles, one block of
    # 3 warpgroups per SM
    tplan = sa.fwd_any_launch_plan(512, 1, 180_180)
    assert tplan["route"] == sa.TC and tplan["tiles"] == -(-180_180 // 128)
    assert tplan["blocks_per_sm"] == 1 and 1 <= tplan["grid"] <= 132
    assert sa.bwd_any_launch_plan(512, 1, 180_180, 26_622)["route"] == sa.TC


#: the tensor-core route's cases: the sweep's wide widths x 0, 1, 2, 7
#: hidden layers, with and without LayerNorm
TC_WIDTHS = (64, 100, 512, 1024)
TC_DEPTHS = (0, 1, 2, 7)


def _double(*trees):
    def f64(v):
        if isinstance(v, dict):
            return {k: f64(u) for k, u in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(f64(u) for u in v)
        return v.double()
    return [f64(t) for t in trees]


def _within(got, want, rtol, atol):
    return bool(((got.double() - want.double()).abs()
                 <= atol + rtol * want.double().abs()).all())


def _plain_or_f64(got, want, exact, rtol, atol):
    """Element by element within the band of plain fp32 or the same band
    around the float64 version: at high in-degrees and wide rows two fp32
    paths part by more than the band, and then plain is one of them
    (chip_smoke.py's generic sweep holds its cases the same way)."""
    d = got.double()
    near_plain = (d - want.double()).abs() <= atol + rtol * want.double().abs()
    near_f64 = (d - exact).abs() <= atol + rtol * exact.abs()
    return bool((near_plain | near_f64).all())


@pytest.mark.gpu
@pytest.mark.parametrize("has_ln", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("n_hidden", TC_DEPTHS)
@pytest.mark.parametrize("hidden", TC_WIDTHS)
def test_nmp_any_tc_fwd_matches_plain(cuda, hidden, n_hidden, has_ln):
    """The tensor-core forward on the tile-edge graph (its nodes cut by the
    route's 128-slot tiles): e' and agg within plain's band or the float64
    forward's, e' outside the layout 0, one launch of the entry and one of
    the per-node pass, two calls bitwise equal."""
    assert sa.any_route(hidden, n_hidden) == sa.TC
    args, outside = _tile_edge_case(cuda, hidden, n_hidden, has_ln, 3 * hidden + n_hidden)
    before = _any_counts()
    got = sa.fused_nmp_edge_agg(*args)
    torch.cuda.synchronize()
    assert _moved(before) == {sa.KERNEL: 0, sa.KERNEL_ANY: 1, sa.KERNEL_BWD: 0,
                              sa.KERNEL_BWD_ANY: 0, sa.KERNEL_DST: 1}
    want = sa.fused_nmp_edge_agg_plain(*args)
    exact = sa.fused_nmp_edge_agg_plain(*_double(*args[:3]), *args[3:6], *_double(*args[6:]))
    for a, b, c in zip(got, want, exact):
        assert _plain_or_f64(a, b, c, RTOL, ATOL)
    assert not got[0][torch.from_numpy(outside).to(cuda)].any()
    again = sa.fused_nmp_edge_agg(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("has_ln", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("n_hidden", TC_DEPTHS)
@pytest.mark.parametrize("hidden", TC_WIDTHS)
def test_nmp_any_tc_bwd_matches_plain(cuda, hidden, n_hidden, has_ln):
    """The tensor-core backward on the ragged graph (a node's slots across
    128-slot tiles, an all-masked run, isolated nodes, edges outside the
    layout): g_x / g_e within plain's gradient band or the float64 VJP's,
    weight gradients by relative L2, g_e outside the layout 0, absent
    LayerNorm's gradients 0, one launch of the entry and one of the
    per-node pass."""
    args, outside = _any_bwd_case(cuda, hidden, n_hidden, has_ln, 3 * hidden + n_hidden)
    before = _any_counts()
    got = sa.fused_nmp_edge_agg_bwd(*args)
    torch.cuda.synchronize()
    assert _moved(before) == {sa.KERNEL: 0, sa.KERNEL_ANY: 0, sa.KERNEL_BWD: 0,
                              sa.KERNEL_BWD_ANY: 1, sa.KERNEL_DST: 1}
    plain_args = (*args[:6], *args[8:])
    want = sa.fused_nmp_edge_agg_bwd_plain(*plain_args)
    exact = sa.fused_nmp_edge_agg_bwd_plain(*_double(*plain_args[:3]), *plain_args[3:6],
                                            *_double(*plain_args[6:]))
    for a, b, c in zip(got[:2], want[:2], exact[:2]):
        assert _plain_or_f64(a, b, c, G_RTOL, G_ATOL)
    assert not got[1][torch.from_numpy(outside).to(cuda)].any()
    for i, (a, b) in enumerate(zip(got[2:], want[2:])):
        if (i in (4, 5) and not has_ln) or (i in (2, 3) and n_hidden == 0):
            assert not a.any() and not b.any()
        else:
            assert _rel_norm(a, b) <= W_REL, i


@pytest.mark.gpu
def test_nmp_any_tc_bitwise_rerun_h512(cuda):
    """Both tensor-core entries at GraphCast's width twice on the same
    inputs: bitwise equal (no float atomics, fixed sum orders)."""
    args, _ = _any_bwd_case(cuda, 512, 1, True, 512)
    fwd_args = (*args[:6], *args[8:10])
    first, second = sa.fused_nmp_edge_agg(*fwd_args), sa.fused_nmp_edge_agg(*fwd_args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    first, second = sa.fused_nmp_edge_agg_bwd(*args), sa.fused_nmp_edge_agg_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_nmp_any_tc_tile_edge_graph_cuts_nodes(cuda):
    """The tile-edge graph cuts nodes at the tensor-core route's 128-slot
    tiles (a node across 2 tiles, one across 3 or more, a tile ending on a
    node boundary), and the forward holds agg there at H=64."""
    rng = np.random.default_rng(64)
    src, dst, mask, inv, n = tile_edge_graph(rng)
    rowptr = sa.compact_gather_layout(src, dst, n, 32)["rowptr"]
    tm = 128
    first, last = rowptr[:-1] // tm, (rowptr[1:] - 1) // tm
    real = rowptr[1:] > rowptr[:-1]
    assert (real & (last - first == 1)).any() and (real & (last - first >= 2)).any()
    assert np.isin(np.arange(tm, int(rowptr[-1]), tm), rowptr).any()
    args, _ = _tile_edge_case(cuda, 64, 1, True, 64)
    got, want = sa.fused_nmp_edge_agg(*args), sa.fused_nmp_edge_agg_plain(*args)
    torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("hidden", ANY_WIDTHS)
def test_nmp_any_route_in_plan_matches_rule(cuda, hidden):
    """The route the launch plans report is ops.any_route's at every depth,
    and a call moves the per-node pass's counter exactly when that route is
    the tensor cores'; the FMA route runs at every width through the plan's
    route argument too and holds plain's band."""
    for n_hidden in (0, 1, 2, 7):
        rule = sa.any_route(hidden, n_hidden)
        assert sa.fwd_any_launch_plan(hidden, n_hidden, 1000)["route"] == rule
        assert sa.bwd_any_launch_plan(hidden, n_hidden, 1000, 300)["route"] == rule
    args, _ = _tile_edge_case(cuda, hidden, 1, True, hidden)
    before = _any_counts()
    got = sa.fused_nmp_edge_agg(*args)
    torch.cuda.synchronize()
    assert _moved(before)[sa.KERNEL_DST] == _dst_launches(hidden, 1)
    x, e, edge, *lay = args
    *ops, n_h, has_ln = sa._stack_edge_mlp(edge)
    fma = sa._fwd(x, e, tuple(ops), n_h, has_ln, *lay, sa.FP32, route=sa.FMA)
    want = sa.fused_nmp_edge_agg_plain(*args)
    exact = sa.fused_nmp_edge_agg_plain(*_double(*args[:3]), *args[3:6], *_double(*args[6:]))
    for a, b, c in zip(fma, want, exact):
        assert _plain_or_f64(a, b, c, RTOL, ATOL)
    for a, b, c in zip(got, want, exact):
        assert _plain_or_f64(a, b, c, RTOL, ATOL)


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


# ---------------------------------------------------------------------------
# the overlap schedule: kernels 1 and 2 on each side's layout
# ---------------------------------------------------------------------------

def _side_case(cuda, grid, part, r, hidden=32, layers=6, seed=0):
    plan = NMPPlan(backend=FUSED, schedule="overlap", block_e=32)
    _, pg, g = _graph((4, 2, 2), grid, plan, cuda)
    g = g.rank(r)
    gen = torch.Generator().manual_seed(seed)
    cfg = GNNConfig(hidden=hidden, n_mp_layers=1, mlp_hidden_layers=layers - 1)
    edge = init_gnn(gen, cfg, device=cuda)["mp"][0]["edge"]
    for lp in edge["layers"]:                  # non-trivial biases
        lp["b"] = 0.1 * torch.randn(lp["b"].shape, generator=gen).to(cuda)
    x = torch.randn(pg.n_pad, hidden, generator=gen).to(cuda)
    e = torch.randn(pg.e_pad, hidden, generator=gen).to(cuda)
    g_enew = torch.randn(pg.e_pad, hidden, generator=gen).to(cuda)
    g_agg = torch.randn(pg.n_pad, hidden, generator=gen).to(cuda)
    lay = tuple(g[f"seg_{k}_{part}"] for k in ("perm", "src", "rowptr"))
    src_lay = (g[f"seg_src_slots_{part}"], g[f"seg_src_rowptr_{part}"])
    return x, e, edge, lay, src_lay, (g["edge_mask"], g["edge_inv_mult"]), (g_enew, g_agg)


@pytest.mark.gpu
@pytest.mark.parametrize("hidden", [8, 32])
def test_fused_nmp_kernels_on_an_empty_layout(cuda, hidden):
    """One rank's boundary side holds no edge (one tile of perm -1, an
    all-zero rowptr): the forward writes e' = 0 on every edge and agg = 0
    on every row, the backward zero gradients, as the plain versions."""
    x, e, edge, lay, src_lay, rest, cot = _side_case(cuda, (1, 1, 1), "bnd", 0, hidden)
    assert not lay[2].any() and bool((lay[0] == -1).all())
    e_new, agg = sa.fused_nmp_edge_agg(x, e, edge, *lay, *rest)
    assert not e_new.any() and not agg.any()
    pe, pa = sa.fused_nmp_edge_agg_plain(x, e, edge, *lay, *rest)
    assert not pe.any() and not pa.any()
    got = sa.fused_nmp_edge_agg_bwd(x, e, edge, *lay, *src_lay, *rest, *cot)
    assert not any(t.any() for t in got)
    want = sa.fused_nmp_edge_agg_bwd_plain(x, e, edge, *lay, *rest, *cot)
    assert not any(t.any() for t in want)


@pytest.mark.gpu
@pytest.mark.parametrize("part", ["bnd", "int"])
@pytest.mark.parametrize("grid,rank", [((2, 2, 1), 0), ((2, 2, 1), 3), ((4, 1, 1), 1),
                                       ((1, 1, 1), 0)],
                         ids=["2x2_r0", "2x2_r3", "4x1_r1", "1x1_r0"])
def test_fused_nmp_kernels_on_each_side_layout(cuda, grid, rank, part):
    """Kernels 1 and 2 on one side of the interior/boundary split: within
    the forward and gradient bands of the plain versions, e' zero outside
    the side's edges, two launches bitwise equal; the two sides' outputs
    sum to the full layout's within the forward band."""
    x, e, edge, lay, src_lay, rest, cot = _side_case(cuda, grid, part, rank)
    e_new, agg = sa.fused_nmp_edge_agg(x, e, edge, *lay, *rest)
    pe, pa = sa.fused_nmp_edge_agg_plain(x, e, edge, *lay, *rest)
    torch.testing.assert_close(e_new, pe, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(agg, pa, rtol=RTOL, atol=ATOL)
    n_side = int(lay[2][-1])
    inside = torch.zeros(e.shape[0], dtype=torch.bool, device=cuda)
    inside[lay[0].reshape(-1)[:n_side].long()] = True
    assert not e_new[~inside].any()
    e2, a2 = sa.fused_nmp_edge_agg(x, e, edge, *lay, *rest)
    assert torch.equal(e_new, e2) and torch.equal(agg, a2)
    got = sa.fused_nmp_edge_agg_bwd(x, e, edge, *lay, *src_lay, *rest, *cot)
    want = sa.fused_nmp_edge_agg_bwd_plain(x, e, edge, *lay, *rest, *cot)
    torch.testing.assert_close(got[0], want[0], rtol=G_RTOL, atol=G_ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=G_RTOL, atol=G_ATOL)
    for i, (a, b) in enumerate(zip(got[2:], want[2:])):
        if n_side == 0:
            assert not a.any() and not b.any()
        else:
            assert _rel_norm(a, b) <= W_REL, i
    other = "int" if part == "bnd" else "bnd"
    _, _, _, lay_o, _, _, _ = _side_case(cuda, grid, other, rank)
    e_o, a_o = sa.fused_nmp_edge_agg(x, e, edge, *lay_o, *rest)
    full = NMPPlan(backend=FUSED, block_e=32)
    _, _, gf = _graph((4, 2, 2), grid, full, cuda)
    gf = gf.rank(rank)
    e_f, a_f = sa.fused_nmp_edge_agg(x, e, edge, gf["seg_perm"], gf["seg_src"],
                                     gf["seg_rowptr"], *rest)
    torch.testing.assert_close(e_new + e_o, e_f, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(agg + a_o, a_f, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_overlap_on_card_posted_exchange_and_forward_bitwise_stacked(cuda):
    """4 gloo processes sharing the card (``launch/consistency.py``,
    ``schedules=("blocking", "overlap")``): each rank's posted packed
    exchange bitwise equal to the blocking one and to the stacked
    emulator's slice, each rank's overlap forward (posted exchanges)
    bitwise equal to the stacked overlap forward's slice on the card, and
    the overlap forward's launches per process exactly two kernel-1 launches
    per layer, one pack and one unpack-add per round received."""
    from repro_torch.launch import consistency as cons
    cfg = GNNConfig.small()
    grid = (2, 2, 1)
    job = cons.Job(elements=(4, 4, 2), order=3, cfg=cfg, device="cuda",
                   backends=(FUSED,), modes=("packed",), cases=((grid, 1),),
                   schedules=("blocking", "overlap"), halo=True)
    procs = cons.run_world(job, 4)
    sem = box_mesh(job.elements, p=job.order)
    pg = partition_mesh(sem, grid)
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device=cuda)
    case = cons.case_name(grid, 1)
    a = torch.from_numpy(cons.seeded(1, (pg.R, pg.n_pad, cfg.hidden))).to(cuda)
    x = torch.from_numpy(gather_node_features(pg, taylor_green_velocity(sem.coords)))
    plan = cons.plan_for(pg, "packed", FUSED, "overlap")
    g = ShardedGraph.build(pg, sem.coords, plan, device=cuda)
    with torch.no_grad():
        y = halo_sync_stacked(a, g, plan.halo)
        pred = gnn_forward_stacked(params, x.to(cuda), g, plan, sync_fn=halo_sync_stacked)
    for p in procs:
        r, rec = p[case]["rank"], p[case]
        halo = rec["halo"]["packed"]
        assert np.array_equal(halo["posted"], halo["out"])
        assert np.array_equal(halo["posted"], y[r].cpu().numpy())
        step = rec["steps_overlap"][(FUSED, "packed")]
        assert np.array_equal(step["pred"][0, 0], pred[r].cpu().numpy())
        recv = sum(any(d == r for _, d in perm) for perm in plan.halo.perms)
        M = cfg.n_mp_layers
        assert step["fwd_launches"] == {sa.KERNEL: 2 * M, hp.PACK: M, hp.UNPACK: M * recv}
        assert step["fwd_exchanges"] == {"posted": M, "overlapped": M}


# ---------------------------------------------------------------------------
# kernels 1 and 2 in bf16 (precision="bf16"): the bands of
# tests/test_torch_bf16.py.  A pre-activation one fp32 bit apart (another
# summation order) can round to the neighbouring bf16 value, so the forward
# is held by its relative L2 distance from the plain bf16 version (at most
# 1e-3) and by that distance's ratio to its distance from the plain fp32
# version (at most 0.2: the kernel rounded where the plain version does),
# max |err| at most 5e-2; every gradient within rtol 1e-2 / atol 1e-2 *
# max(1, max|ref|), the reference's band for its own bf16 pair.
# ---------------------------------------------------------------------------

BF_REL, BF_RATIO, BF_MAX = 1e-3, 0.2, 5e-2


def _bf16_fwd_close(got, want, want_fp32):
    rel, rel32 = _rel_norm(got, want), _rel_norm(got, want_fp32)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    assert rel <= BF_REL and rel <= BF_RATIO * rel32 and err <= BF_MAX, (rel, rel32, err)


def _bf16_grads_close(got, want):
    for a, b in zip(got, want):
        atol = 1e-2 * max(1.0, float(b.abs().max()) if b.numel() else 0.0)
        torch.testing.assert_close(a, b, rtol=1e-2, atol=atol)


def _counts(*names):
    return {k: build.launch_counts.get(k, 0) for k in names}


_NMP_COUNTERS = (sa.KERNEL, sa.KERNEL_BWD, sa.KERNEL_BF16, sa.KERNEL_BWD_BF16)


def _fwd_bf16_checks(args, outside=None):
    """The bf16 forward of ``args`` against plain bf16 and plain fp32: the
    bands, one bf16 launch and no fp32 one, two launches bitwise equal."""
    n0 = _counts(*_NMP_COUNTERS)
    e_new, agg = sa.fused_nmp_edge_agg(*args, precision=BF16)
    torch.cuda.synchronize()
    n1 = _counts(*_NMP_COUNTERS)
    assert n1[sa.KERNEL_BF16] == n0[sa.KERNEL_BF16] + 1 and n1[sa.KERNEL] == n0[sa.KERNEL]
    pe, pa = sa.fused_nmp_edge_agg_plain(*args, precision=BF16)
    fe, fa_ = sa.fused_nmp_edge_agg_plain(*args)
    _bf16_fwd_close(e_new, pe, fe)
    _bf16_fwd_close(agg, pa, fa_)
    if outside is not None:
        assert not e_new[torch.from_numpy(outside).to(e_new.device)].any()
    e2, a2 = sa.fused_nmp_edge_agg(*args, precision=BF16)
    assert torch.equal(e_new, e2) and torch.equal(agg, a2)
    return e_new, agg


@pytest.mark.gpu
@pytest.mark.parametrize("hidden,layers", [(8, 2), (16, 1), (32, 5)])
def test_fused_nmp_bf16_kernel_matches_plain(cuda, hidden, layers):
    plan = NMPPlan(backend=FUSED, block_e=32)
    _, pg, g = _graph((3, 2, 2), (1, 1, 1), plan, cuda)
    g = g.rank(0)
    gen = torch.Generator().manual_seed(hidden)
    cfg = GNNConfig(hidden=hidden, n_mp_layers=1, mlp_hidden_layers=layers)
    edge = init_gnn(gen, cfg, device=cuda)["mp"][0]["edge"]
    x = torch.randn(pg.n_pad, hidden, generator=gen).to(cuda)
    e = torch.randn(pg.e_pad, hidden, generator=gen).to(cuda)
    _fwd_bf16_checks((x, e, edge, g["seg_perm"], g["seg_src"], g["seg_rowptr"],
                      g["edge_mask"], g["edge_inv_mult"]))


@pytest.mark.gpu
@pytest.mark.parametrize("has_ln", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("n_hidden", [0, 7])
@pytest.mark.parametrize("hidden", [8, 16, 32])
def test_fused_nmp_bf16_kernel_tile_edges(cuda, hidden, n_hidden, has_ln):
    """The forward's tile edges (``tile_edge_graph``) in bf16: H 8/16/32
    (at H=8 layer 0's K=24 ends on a half k-step of 16), Lp 0 and 7, with
    and without LayerNorm."""
    args, outside = _tile_edge_case(cuda, hidden, n_hidden, has_ln, hidden + n_hidden)
    _fwd_bf16_checks(args, outside)


@pytest.mark.gpu
def test_fused_nmp_bf16_kernel_weights_past_shared_memory_and_plans(cuda):
    """bf16 weights take a quarter of the pre-split ones' shared memory:
    more hidden layers fit, the rest are read from global memory and
    rounded per fragment; the serving mesh's launches as the card plans
    them (csrc/nmp_bf16.cu: a ring of 3 staged tiles forward, 2 backward,
    one block per SM)."""
    args, _ = _tile_edge_case(cuda, 32, 48, True, 5)
    n_slots = args[3].numel()
    plan = sa.fwd_launch_plan(32, 48, n_slots, BF16)
    assert sa.fwd_launch_plan(32, 48, n_slots)["smem_layers"] < plan["smem_layers"] < 48
    n0 = _counts(sa.KERNEL_BF16)[sa.KERNEL_BF16]
    e_new, agg = sa.fused_nmp_edge_agg(*args, precision=BF16)
    assert build.launch_counts[sa.KERNEL_BF16] == n0 + 1
    pe, pa = sa.fused_nmp_edge_agg_plain(*args, precision=BF16)
    fe, fa_ = sa.fused_nmp_edge_agg_plain(*args)
    _bf16_fwd_close(e_new, pe, fe)
    _bf16_fwd_close(agg, pa, fa_)
    full = sa.fwd_launch_plan(32, 5, 4_315_696, BF16)
    assert full["smem_layers"] == 5 and full["tiles"] == -(-4_315_696 // 128)
    assert full["smem_bytes"] < sa.fwd_launch_plan(32, 5, 4_315_696)["smem_bytes"]
    assert full["stages"] == 3 and full["blocks_per_sm"] == 1
    bwd = sa.bwd_launch_plan(32, 5, 4_315_696, BF16)
    assert bwd["smem_bytes"] == 232_096 and bwd["blocks_per_sm"] == 1
    assert bwd["stages"] == 2 and bwd["tiles"] == full["tiles"]


def _bwd_bf16_checks(x, e, edge, lay, src_lay, rest, n_hidden, has_ln=True, empty=False):
    n0 = _counts(*_NMP_COUNTERS)
    got = sa.fused_nmp_edge_agg_bwd(x, e, edge, *lay, *src_lay, *rest, precision=BF16)
    torch.cuda.synchronize()
    n1 = _counts(*_NMP_COUNTERS)
    assert n1[sa.KERNEL_BWD_BF16] == n0[sa.KERNEL_BWD_BF16] + 1
    assert n1[sa.KERNEL_BWD] == n0[sa.KERNEL_BWD]
    want = sa.fused_nmp_edge_agg_bwd_plain(x, e, edge, *lay, *rest, precision=BF16)
    if empty:
        assert not any(t.any() for t in got) and not any(t.any() for t in want)
    _bf16_grads_close(got, want)
    # the rounding happened on every side, not on the weight gradients
    # alone: each output nearer plain bf16 than the fp32 kernel's, by the
    # forward's ratio; but the last layer's bias gradient (ln_b, or without
    # LN b0 with no hidden layer, brest with one: all of it the last bias),
    # the column sum of the incoming cotangent, which no product touches,
    # is the same in both
    untouched = "ln_b" if has_ln else {0: "b0", 1: "brest"}.get(n_hidden)
    k32 = sa.fused_nmp_edge_agg_bwd(x, e, edge, *lay, *src_lay, *rest)
    for name, a, b, c in zip(("g_x", "g_e", "w0", "b0", "wrest", "brest", "ln_g", "ln_b"),
                             got, want, k32):
        if name != untouched:
            assert _rel_norm(a, b) <= BF_RATIO * _rel_norm(a, c), name
    for i, (a, b) in enumerate(zip(got[2:], want[2:])):
        if (i in (2, 3) and n_hidden == 0) or (i in (4, 5) and not has_ln):
            assert not a.any() and not b.any()
    # each weight gradient rounded once to bf16, as the plain version's
    for w in (got[2], got[4]):
        assert torch.equal(w, w.to(torch.bfloat16).float())
    again = sa.fused_nmp_edge_agg_bwd(x, e, edge, *lay, *src_lay, *rest, precision=BF16)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("has_ln", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("layers", [1, 6], ids=["lp0", "lp5"])
@pytest.mark.parametrize("hidden", [8, 16, 32])
def test_fused_nmp_bf16_bwd_kernel_matches_plain(cuda, hidden, layers, has_ln):
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
    R = lambda *s: torch.randn(*s, generator=gen).to(cuda)  # noqa: E731
    x, e = R(pg.n_pad, hidden), R(pg.e_pad, hidden)
    rest = (g["edge_mask"], g["edge_inv_mult"], R(pg.e_pad, hidden), R(pg.n_pad, hidden))
    _bwd_bf16_checks(x, e, edge, (g["seg_perm"], g["seg_src"], g["seg_rowptr"]),
                     (g["seg_src_slots"], g["seg_src_rowptr"]), rest, layers - 1, has_ln)


@pytest.mark.gpu
@pytest.mark.parametrize("hidden,layers", [(8, 1), (16, 3), (32, 6)])
def test_fused_nmp_bf16_bwd_kernel_ragged_tiles(cuda, hidden, layers):
    rng = np.random.default_rng(hidden)
    lay, src_lay, mask, inv, outside = _ragged_layout(rng, cuda)
    n, n_edges = 300, mask.shape[0]
    gen = torch.Generator().manual_seed(hidden)
    cfg = GNNConfig(hidden=hidden, n_mp_layers=1, mlp_hidden_layers=layers - 1)
    edge = init_gnn(gen, cfg, device=cuda)["mp"][0]["edge"]
    for lp in edge["layers"]:
        lp["b"] = 0.1 * torch.randn(lp["b"].shape, generator=gen).to(cuda)
    R = lambda *s: torch.randn(*s, generator=gen).to(cuda)  # noqa: E731
    x, e = R(n, hidden), R(n_edges, hidden)
    got = _bwd_bf16_checks(x, e, edge, lay, src_lay, (mask, inv, R(n_edges, hidden),
                                                      R(n, hidden)), layers - 1)
    assert not got[1][torch.from_numpy(outside).to(cuda)].any()


def _bf16_bwd_layout_case(cuda, src, dst, mask, inv, n, hidden, n_hidden, has_ln, seed,
                          block_e=32):
    """The bf16 backward's checks on the graph (src, dst) of n nodes at H =
    ``hidden`` with ``n_hidden`` hidden layers, random inputs, cotangents
    and biases; returns the gradients and the layout."""
    lay = sa.compact_gather_layout(src, dst, n, block_e)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    gen = torch.Generator().manual_seed(seed)
    cfg = GNNConfig(hidden=hidden, n_mp_layers=1, mlp_hidden_layers=n_hidden)
    edge = init_gnn(gen, cfg, device=cuda)["mp"][0]["edge"]
    if not has_ln:
        edge.pop("ln")
    for lp in edge["layers"]:                  # non-trivial biases
        lp["b"] = 0.1 * torch.randn(lp["b"].shape, generator=gen).to(cuda)
    R = lambda *s: torch.randn(*s, generator=gen).to(cuda)  # noqa: E731
    x, e = R(n, hidden), R(dst.size, hidden)
    rest = (T(mask), T(inv), R(dst.size, hidden), R(n, hidden))
    got = _bwd_bf16_checks(x, e, edge, (T(lay["perm"]), T(lay["src"]), T(lay["rowptr"])),
                           (T(lay["src_slots"]), T(lay["src_rowptr"])), rest, n_hidden,
                           has_ln)
    return got, lay


@pytest.mark.gpu
@pytest.mark.parametrize("has_ln", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("n_hidden", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("hidden", [8, 16, 32])
def test_fused_nmp_bf16_bwd_kernel_tile_edges(cuda, hidden, n_hidden, has_ln):
    """The bf16 backward's node walk on ``tile_edge_graph``: node 21's 300
    dst slots span three tiles (its x_dst sum: partial rows of tiles 2, 3
    and 4 summed by the fix-up), node 18's 129 two, tile 0 ends on a node
    boundary, nodes of degree 0 (on a tile edge too) get their src side
    only, padding edges keep g_e = 0; every depth the kernel takes, with
    and without LayerNorm."""
    rng = np.random.default_rng(100 + hidden + n_hidden)
    src, dst, mask, inv, n = tile_edge_graph(rng)
    got, lay = _bf16_bwd_layout_case(cuda, src, dst, mask, inv, n, hidden, n_hidden, has_ln,
                                     hidden + n_hidden)
    rowptr = lay["rowptr"]
    assert (rowptr[22] - 1) // 128 - rowptr[21] // 128 >= 2    # node 21 across 3 tiles
    assert not got[1][torch.from_numpy(np.nonzero(dst == n)[0]).to(cuda)].any()


@pytest.mark.gpu
@pytest.mark.parametrize("n_edges", [60, 200, 300])
@pytest.mark.parametrize("hidden", [8, 32])
def test_fused_nmp_bf16_kernels_fewer_tiles_than_stages(cuda, hidden, n_edges):
    """One to three real tiles, fewer than or as many as the rings' stages
    (3 forward, 2 backward), in a layout padded to 512 slots, so the launch
    plans' grids (one block per 128-slot tile of the layout) exceed the real
    tiles and blocks find no tile: the bands, launches and repeats of the
    bf16 pair, a zero partial weight-gradient row from each idle block."""
    rng = np.random.default_rng(n_edges)
    n = 40
    dst = np.concatenate([rng.integers(0, n - 5, n_edges), np.full(3, n)]).astype(np.int32)
    src = rng.integers(0, n, dst.size).astype(np.int32)
    mask = np.where(dst < n, 1.0, 0.0).astype(np.float32)
    counts = np.bincount(np.minimum(dst, n), minlength=n + 1)
    inv = (1.0 / counts[np.minimum(dst, n)]).astype(np.float32)
    lay = sa.compact_gather_layout(src, dst, n, 512)
    n_slots = lay["perm"].size
    real_tiles = -(-n_edges // 128)
    for kind in ("fwd", "bwd"):
        plan = (sa.fwd_launch_plan if kind == "fwd" else sa.bwd_launch_plan)(
            hidden, 3, n_slots, BF16)
        assert plan["grid"] == n_slots // 128 > real_tiles
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    gen = torch.Generator().manual_seed(hidden)
    cfg = GNNConfig(hidden=hidden, n_mp_layers=1, mlp_hidden_layers=3)
    edge = init_gnn(gen, cfg, device=cuda)["mp"][0]["edge"]
    x = torch.randn(n, hidden, generator=gen).to(cuda)
    e = torch.randn(dst.size, hidden, generator=gen).to(cuda)
    _fwd_bf16_checks((x, e, edge, T(lay["perm"]), T(lay["src"]), T(lay["rowptr"]), T(mask),
                      T(inv)), np.nonzero(dst == n)[0])
    _bf16_bwd_layout_case(cuda, src, dst, mask, inv, n, hidden, 3, True, hidden, block_e=512)


@pytest.mark.gpu
@pytest.mark.parametrize("hidden,n_hidden", [(32, 5), (16, 2)])
def test_fused_nmp_bf16_kernels_ring_wraps(cuda, hidden, n_hidden):
    """Enough tiles (70,000 edges: 547 tiles) that every block of the card's
    grid walks four or more, so each ring (3 stages forward, 2 backward)
    wraps and its barriers change phase: the bands, the launches and two
    launches bitwise equal, forward and backward."""
    rng = np.random.default_rng(hidden)
    n = 9000
    dst = rng.integers(0, n, 70_000).astype(np.int32)
    src = rng.integers(0, n, dst.size).astype(np.int32)
    mask = np.where(rng.random(dst.size) < 0.05, 0.0, 1.0).astype(np.float32)
    inv = (1.0 / np.bincount(dst, minlength=n)[dst]).astype(np.float32)
    lay = sa.compact_gather_layout(src, dst, n, 128)
    plan = sa.bwd_launch_plan(hidden, n_hidden, lay["perm"].size, BF16)
    assert plan["tiles"] >= 4 * plan["grid"]
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    gen = torch.Generator().manual_seed(hidden)
    cfg = GNNConfig(hidden=hidden, n_mp_layers=1, mlp_hidden_layers=n_hidden)
    edge = init_gnn(gen, cfg, device=cuda)["mp"][0]["edge"]
    x = torch.randn(n, hidden, generator=gen).to(cuda)
    e = torch.randn(dst.size, hidden, generator=gen).to(cuda)
    _fwd_bf16_checks((x, e, edge, T(lay["perm"]), T(lay["src"]), T(lay["rowptr"]), T(mask),
                      T(inv)))
    _bf16_bwd_layout_case(cuda, src, dst, mask, inv, n, hidden, n_hidden, True, hidden,
                          block_e=128)


@pytest.mark.gpu
@pytest.mark.parametrize("part", ["bnd", "int"])
@pytest.mark.parametrize("grid,rank", [((2, 2, 1), 0), ((1, 1, 1), 0)], ids=["2x2_r0", "1x1_r0"])
def test_fused_nmp_bf16_kernels_on_each_side_layout(cuda, grid, rank, part):
    """The overlap schedule's per-side layouts in bf16, the empty boundary
    side of one rank included: zeros from both kernels, as plain."""
    x, e, edge, lay, src_lay, rest, cot = _side_case(cuda, grid, part, rank)
    n_side = int(lay[2][-1])
    e_new, agg = sa.fused_nmp_edge_agg(x, e, edge, *lay, *rest, precision=BF16)
    if n_side == 0:
        assert not e_new.any() and not agg.any()
    else:
        _fwd_bf16_checks((x, e, edge, *lay, *rest))
    _bwd_bf16_checks(x, e, edge, lay, src_lay, rest + cot, 5, empty=n_side == 0)


@pytest.mark.gpu
def test_bf16_plan_launches_bf16_kernels_only(cuda):
    """The stacked R=4 packed forward and gradient on a bf16 plan launch
    the bf16 entries and never the fp32 ones, and the reverse on an fp32
    plan; 1 rank == 4 ranks in bf16 within the loss and prediction bands;
    an unknown precision raises on CUDA tensors."""
    from repro_torch.core.reference import loss_and_grad_stacked
    cfg = GNNConfig(hidden=32, n_mp_layers=2, mlp_hidden_layers=5)
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device=cuda)
    sem = box_mesh((4, 2, 2), p=2)
    x = taylor_green_velocity(sem.coords)
    out = {}
    for prec in (BF16, "fp32"):
        for grid, mode in (((1, 1, 1), NONE), ((2, 2, 1), NEIGHBOR)):
            pg = partition_mesh(sem, grid)
            plan = NMPPlan.build(pg, mode, packed=True, backend=FUSED, precision=prec)
            g = ShardedGraph.build(pg, sem.coords, plan, device=cuda)
            xs = torch.from_numpy(gather_node_features(pg, x)).to(cuda)
            n0 = _counts(*_NMP_COUNTERS)
            loss, y, _ = loss_and_grad_stacked(params, xs, xs, g, plan, cfg.node_out,
                                               sync_fn=halo_sync_stacked)
            torch.cuda.synchronize()
            n1 = _counts(*_NMP_COUNTERS)
            d = {k: n1[k] - n0[k] for k in _NMP_COUNTERS}
            launches = pg.R * cfg.n_mp_layers
            fwd, bwd = (sa.KERNEL_BF16, sa.KERNEL_BWD_BF16) if prec == BF16 else \
                (sa.KERNEL, sa.KERNEL_BWD)
            assert d == {k: launches if k in (fwd, bwd) else 0 for k in _NMP_COUNTERS}, d
            out[prec, grid] = (float(loss), scatter_node_outputs(pg, y.cpu().numpy()))
    (l1, y1), (l4, y4) = out[BF16, (1, 1, 1)], out[BF16, (2, 2, 1)]
    assert abs(l4 - l1) <= 2e-6 * abs(l1)
    np.testing.assert_allclose(y4, y1, rtol=RTOL, atol=ATOL)
    assert l1 != out["fp32", (1, 1, 1)][0]
    with pytest.raises(ValueError, match="precision"):
        sa.fused_nmp_edge_agg(torch.zeros(4, 8, device=cuda), torch.zeros(4, 8, device=cuda),
                              init_gnn(torch.Generator().manual_seed(0),
                                       GNNConfig(hidden=8, n_mp_layers=1,
                                                 mlp_hidden_layers=1),
                                       device=cuda)["mp"][0]["edge"],
                              *(torch.zeros(1, 4, dtype=torch.int32, device=cuda),) * 2,
                              torch.zeros(5, dtype=torch.int32, device=cuda),
                              torch.zeros(4, device=cuda), torch.zeros(4, device=cuda),
                              precision="fp8")


@pytest.mark.gpu
def test_fused_bf16_training_steps_bitwise_repeatable(cuda):
    sem = box_mesh((4, 2, 2), p=2)
    pg = partition_mesh(sem, (1, 1, 1))
    cfg = GNNConfig(hidden=32, n_mp_layers=2, mlp_hidden_layers=5)
    start = init_gnn(torch.Generator().manual_seed(2), cfg, device="cpu")
    runs = []
    for _ in range(2):
        n0 = _counts(*_NMP_COUNTERS)
        hist = train_consistent_gnn(
            pg, sem, cfg,
            TrainConfig(n_steps=3, plan=NMPPlan(backend=FUSED, precision=BF16)),
            params=start, device=cuda)
        n1 = _counts(*_NMP_COUNTERS)
        assert n1[sa.KERNEL_BWD_BF16] == n0[sa.KERNEL_BWD_BF16] + 3 * 2
        assert n1[sa.KERNEL_BWD] == n0[sa.KERNEL_BWD] and n1[sa.KERNEL] == n0[sa.KERNEL]
        runs.append(hist)
    assert runs[0]["losses"] == runs[1]["losses"]
    assert all(np.isfinite(runs[0]["losses"]))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(runs[0]["params"]),
                                                 tree_leaves(runs[1]["params"])))


# ---------------------------------------------------------------------------
# kernels 1 and 2 on the multilevel V-cycle's coarse layouts: element and
# block adjacency (up to 17 neighbours here, 26 at full size), levels
# smaller than one 128-slot tile, ranks without an edge at the last level
# ---------------------------------------------------------------------------

def _coarse_case(cuda, elems, grid, lvl, rank, part="", hidden=32, layers=6, seed=0):
    """Level ``lvl`` of a 3-level hierarchy of ``box_mesh(elems, p=2)`` on
    ``grid``, rank ``rank``'s layout (``part``: "" the whole level, "_bnd"
    / "_int" an overlap side), with random inputs and cotangents."""
    from repro_torch.core.coarsen import build_hierarchy
    ml = build_hierarchy(box_mesh(elems, p=2), grid, 3)
    plan = NMPPlan.build(ml, NEIGHBOR, packed=True, backend=FUSED, schedule="overlap")
    g = ShardedGraph.build(ml.levels[0], ml.coords[0], plan, device=cuda,
                           hierarchy=ml).level(lvl).rank(rank)
    n, n_e = g["node_mask"].shape[0], g["edge_mask"].shape[0]
    gen = torch.Generator().manual_seed(seed)
    cfg = GNNConfig(hidden=hidden, n_mp_layers=1, mlp_hidden_layers=layers - 1)
    edge = init_gnn(gen, cfg, device=cuda)["mp"][0]["edge"]
    for lp in edge["layers"]:                  # non-trivial biases
        lp["b"] = 0.1 * torch.randn(lp["b"].shape, generator=gen).to(cuda)
    R = lambda *s: torch.randn(*s, generator=gen).to(cuda)  # noqa: E731
    lay = tuple(g[f"seg_{k}{part}"] for k in ("perm", "src", "rowptr"))
    src_lay = (g[f"seg_src_slots{part}"], g[f"seg_src_rowptr{part}"])
    return (R(n, hidden), R(n_e, hidden), edge, lay, src_lay,
            (g["edge_mask"], g["edge_inv_mult"]), (R(n_e, hidden), R(n, hidden)))


COARSE_CASES = {
    # 32 element nodes, 368 edges of in-degree up to 17 across three tiles
    "l1_1x1": ((4, 4, 2), (1, 1, 1), 1, 0),
    # 4 block nodes (8 padded), 12 edges: less than one tile
    "l2_1x1": ((4, 4, 2), (1, 1, 1), 2, 0),
    # a 2x2 rank's level 2: 3 edges into its one block
    "l2_2x2_r1": ((4, 4, 2), (2, 2, 1), 2, 1),
    # the (4,1,1) split's rank 1 owns no block: no edge at the last level
    "l2_4x1_r1_empty": ((4, 4, 2), (4, 1, 1), 2, 1),
    # a single-block level: no edge on any rank
    "l2_2x1_single_block": ((2, 2, 2), (2, 1, 1), 2, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("part", ["", "_bnd", "_int"], ids=["all", "bnd", "int"])
@pytest.mark.parametrize("case", sorted(COARSE_CASES))
def test_fused_nmp_kernels_on_coarse_layouts(cuda, case, part):
    """Kernels 1 and 2 (fp32) on a coarse level's layout and on each of its
    overlap sides: within the forward and gradient bands of the plain
    versions, one launch each, two launches bitwise equal; a layout without
    an edge gives zeros, as the plain versions."""
    x, e, edge, lay, src_lay, rest, cot = _coarse_case(cuda, *COARSE_CASES[case], part)
    n_side = int(lay[2][-1])
    n0 = _counts(*_NMP_COUNTERS)
    e_new, agg = sa.fused_nmp_edge_agg(x, e, edge, *lay, *rest)
    got = sa.fused_nmp_edge_agg_bwd(x, e, edge, *lay, *src_lay, *rest, *cot)
    torch.cuda.synchronize()
    n1 = _counts(*_NMP_COUNTERS)
    assert {k: n1[k] - n0[k] for k in _NMP_COUNTERS} == {
        sa.KERNEL: 1, sa.KERNEL_BWD: 1, sa.KERNEL_BF16: 0, sa.KERNEL_BWD_BF16: 0}
    pe, pa = sa.fused_nmp_edge_agg_plain(x, e, edge, *lay, *rest)
    torch.testing.assert_close(e_new, pe, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(agg, pa, rtol=RTOL, atol=ATOL)
    want = sa.fused_nmp_edge_agg_bwd_plain(x, e, edge, *lay, *rest, *cot)
    torch.testing.assert_close(got[0], want[0], rtol=G_RTOL, atol=G_ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=G_RTOL, atol=G_ATOL)
    for i, (a, b) in enumerate(zip(got[2:], want[2:])):
        if n_side == 0:
            assert not a.any() and not b.any()
        else:
            assert _rel_norm(a, b) <= W_REL, i
    if n_side == 0:
        assert not e_new.any() and not agg.any()
    e2, a2 = sa.fused_nmp_edge_agg(x, e, edge, *lay, *rest)
    again = sa.fused_nmp_edge_agg_bwd(x, e, edge, *lay, *src_lay, *rest, *cot)
    assert torch.equal(e_new, e2) and torch.equal(agg, a2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("part", ["", "_bnd", "_int"], ids=["all", "bnd", "int"])
@pytest.mark.parametrize("case", sorted(COARSE_CASES))
def test_fused_nmp_bf16_kernels_on_coarse_layouts(cuda, case, part):
    """The same layouts in bf16: the bf16 bands, bf16 launches only, zeros
    where the layout holds no edge."""
    x, e, edge, lay, src_lay, rest, cot = _coarse_case(cuda, *COARSE_CASES[case], part)
    n_side = int(lay[2][-1])
    if n_side == 0:
        e_new, agg = sa.fused_nmp_edge_agg(x, e, edge, *lay, *rest, precision=BF16)
        assert not e_new.any() and not agg.any()
    else:
        _fwd_bf16_checks((x, e, edge, *lay, *rest))
    _bwd_bf16_checks(x, e, edge, lay, src_lay, rest + cot, 5, empty=n_side == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["fp32", BF16])
@pytest.mark.parametrize("schedule", ["blocking", "overlap"])
@pytest.mark.parametrize("grid", [(1, 1, 1), (4, 1, 1), (2, 2, 1)],
                         ids=["1x1", "4x1", "2x2"])
def test_vcycle_on_card_fused_matches_plain(cuda, grid, schedule, precision):
    """The stacked V-cycle's loss, prediction and gradients on the card
    (packed neighbor exchange), fused against the plain backend: fp32 in the
    forward and gradient bands, bf16 in the bf16 bands; kernel 1 launched
    once per rank and layer (per side under overlap) on every level, kernel
    2 as often, the bf16 entries alone on a bf16 plan; two runs bitwise.
    In bf16 the prediction comes out of 6 NMP layers of bf16 products,
    where an fp32 bit (another summation order) that rounds a
    pre-activation to the neighbouring bf16 value is carried on: the two
    paths read 6e-4 to 1.2e-3 apart (rel L2) against ~6e-3 from fp32 on
    the card, against 6e-7 with one layer per level, where no rounding
    flipped.  So the bf16 prediction is held, like the gradients, to the
    reference's band for its own bf16 pair (rtol / atol 1e-2 x max(1,
    max|ref|)) and must lie nearer the plain bf16 prediction than the
    fp32 one; each kernel's own bf16 band is held on the coarse layouts
    above."""
    from repro_torch.core.coarsen import build_hierarchy
    from repro_torch.core.reference import loss_and_grad_stacked
    sem = box_mesh((4, 4, 2), p=2)
    ml = build_hierarchy(sem, grid, 3)
    cfg = GNNConfig(hidden=32, n_mp_layers=2, mlp_hidden_layers=5, n_levels=3,
                    coarse_mp_layers=2)
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device=cuda)
    mode = NONE if grid == (1, 1, 1) else NEIGHBOR
    xs = torch.from_numpy(gather_node_features(
        ml.levels[0], taylor_green_velocity(sem.coords))).to(cuda)
    out = {}
    runs = [(FUSED, precision), (FUSED, precision), (XLA, precision)]
    for backend, prec in runs + ([(XLA, "fp32")] if precision == BF16 else []):
        plan = NMPPlan.build(ml, mode, packed=True, backend=backend, schedule=schedule,
                             precision=prec)
        g = ShardedGraph.build(ml.levels[0], sem.coords, plan, device=cuda, hierarchy=ml)
        n0 = _counts(*_NMP_COUNTERS)
        loss, y, grads = loss_and_grad_stacked(params, xs, xs, g, plan, cfg.node_out,
                                               sync_fn=halo_sync_stacked)
        torch.cuda.synchronize()
        n1 = _counts(*_NMP_COUNTERS)
        out.setdefault((backend, prec), []).append((loss, y, tree_leaves(grads)))
        if backend == FUSED:
            layers = len(ml.levels[0].global_ids) * (
                cfg.n_mp_layers + 2 * cfg.coarse_mp_layers)
            layers *= 2 if schedule == "overlap" else 1
            fwd, bwd = (sa.KERNEL_BF16, sa.KERNEL_BWD_BF16) if precision == BF16 else \
                (sa.KERNEL, sa.KERNEL_BWD)
            assert {k: n1[k] - n0[k] for k in _NMP_COUNTERS} == {
                k: layers if k in (fwd, bwd) else 0 for k in _NMP_COUNTERS}
    (lf, yf, gf), (lf2, yf2, gf2) = out[FUSED, precision]
    assert torch.equal(lf, lf2) and torch.equal(yf, yf2)
    assert all(torch.equal(a, b) for a, b in zip(gf, gf2))
    lx, yx, gx = out[XLA, precision][0]
    # the loss: fp32 fused vs plain within rel 1e-4, bf16 within BF_REL
    assert abs(float(lf) - float(lx)) <= (BF_REL if precision == BF16 else 1e-4) \
        * abs(float(lx))
    if precision == BF16:
        _bf16_grads_close(gf, gx)
        _bf16_grads_close([yf], [yx])
        y32 = out[XLA, "fp32"][0][1]
        assert _rel_norm(yf, yx) < _rel_norm(yf, y32)
    else:
        torch.testing.assert_close(yf, yx, rtol=RTOL, atol=ATOL)
        # a weight gradient is a sum over every edge: held by its relative
        # L2 norm where its elements cancel past the elementwise band
        for a, b in zip(gf, gx):
            assert torch.allclose(a, b, rtol=G_RTOL, atol=G_ATOL) or \
                _rel_norm(a, b) <= W_REL


# ---------------------------------------------------------------------------
# the exchange's remaining forms and the plan's choice: vertex-cut (spectral)
# layouts, the bf16 wire, rounds2d, combine="max", the measured autotune
# ---------------------------------------------------------------------------

def _spectral_case(cuda, grid, rank, part, hidden=32, layers=3, seed=0):
    """Kernel 1 and 2 inputs on one rank of a spectral (vertex-cut: d_ij ==
    1, uneven ranks) split of a stretched mesh, or one overlap side."""
    sem = box_mesh((8, 2, 2), p=2, lengths=(4.0, 1.0, 1.0))
    pg = partition_mesh(sem, grid, method="spectral")
    plan = NMPPlan.build(pg, NEIGHBOR, packed=True, backend=FUSED, schedule="overlap")
    g = ShardedGraph.build(pg, sem.coords, plan, device=cuda).rank(rank)
    n, n_e = g["node_mask"].shape[0], g["edge_mask"].shape[0]
    gen = torch.Generator().manual_seed(seed)
    cfg = GNNConfig(hidden=hidden, n_mp_layers=1, mlp_hidden_layers=layers - 1)
    edge = init_gnn(gen, cfg, device=cuda)["mp"][0]["edge"]
    for lp in edge["layers"]:
        lp["b"] = 0.1 * torch.randn(lp["b"].shape, generator=gen).to(cuda)
    R = lambda *s: torch.randn(*s, generator=gen).to(cuda)  # noqa: E731
    lay = tuple(g[f"seg_{k}{part}"] for k in ("perm", "src", "rowptr"))
    src_lay = (g[f"seg_src_slots{part}"], g[f"seg_src_rowptr{part}"])
    return (R(n, hidden), R(n_e, hidden), edge, lay, src_lay,
            (g["edge_mask"], g["edge_inv_mult"]), (R(n_e, hidden), R(n, hidden)))


@pytest.mark.gpu
@pytest.mark.parametrize("part", ["", "_bnd", "_int"], ids=["all", "bnd", "int"])
@pytest.mark.parametrize("grid,rank", [((2, 2, 1), 0), ((2, 2, 1), 3), ((3, 1, 1), 1)],
                         ids=["2x2_r0", "2x2_r3", "3x1_r1"])
def test_fused_nmp_kernels_on_spectral_layouts(cuda, grid, rank, part):
    """Kernels 1 and 2 (fp32) on a vertex-cut layout of the spectral
    partitioner and on each overlap side: within the forward and gradient
    bands of the plain versions, one launch each, bitwise repeatable."""
    x, e, edge, lay, src_lay, rest, cot = _spectral_case(cuda, grid, rank, part)
    n0 = _counts(*_NMP_COUNTERS)
    e_new, agg = sa.fused_nmp_edge_agg(x, e, edge, *lay, *rest)
    got = sa.fused_nmp_edge_agg_bwd(x, e, edge, *lay, *src_lay, *rest, *cot)
    torch.cuda.synchronize()
    n1 = _counts(*_NMP_COUNTERS)
    assert {k: n1[k] - n0[k] for k in _NMP_COUNTERS} == {
        sa.KERNEL: 1, sa.KERNEL_BWD: 1, sa.KERNEL_BF16: 0, sa.KERNEL_BWD_BF16: 0}
    pe, pa = sa.fused_nmp_edge_agg_plain(x, e, edge, *lay, *rest)
    torch.testing.assert_close(e_new, pe, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(agg, pa, rtol=RTOL, atol=ATOL)
    want = sa.fused_nmp_edge_agg_bwd_plain(x, e, edge, *lay, *rest, *cot)
    torch.testing.assert_close(got[0], want[0], rtol=G_RTOL, atol=G_ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=G_RTOL, atol=G_ATOL)
    for i, (a, b) in enumerate(zip(got[2:], want[2:])):
        assert _rel_norm(a, b) <= W_REL, i
    e2, a2 = sa.fused_nmp_edge_agg(x, e, edge, *lay, *rest)
    assert torch.equal(e_new, e2) and torch.equal(agg, a2)


def _form_graphs(device):
    from repro_torch.launch import consistency as cons
    sem = box_mesh((4, 4, 2), p=2)
    parts = cons.form_partitions(sem)
    return cons, parts, {k: ShardedGraph.build(pg, sem.coords,
                                               NMPPlan.build(pg, NEIGHBOR, packed=True),
                                               device=device)
                         for k, pg in parts.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["a2a_bf16_sum", "neighbor_bf16_sum", "packed_sum",
                                  "packed_bf16_sum", "rounds2d_packed_sum",
                                  "rounds2d_packed_bf16_sum", "rounds2d_bf16_sum",
                                  "a2a_max", "packed_max", "packed_bf16_max",
                                  "rounds2d_max", "rounds2d_packed_bf16_max"])
def test_exchange_forms_on_card_bitwise_cpu(cuda, name):
    """Each form of the stacked exchange on the card (kernels 4 and 5 under
    a bf16 wire and on rounds2d rounds; the scatter-max under
    ``torch.use_deterministic_algorithms``): values and, under sum,
    gradients bitwise equal to the CPU's plain exchange and to a second
    run; pack / unpack-add launch for the packed sum forms exactly as
    under the fp32 wire, never under max."""
    cons, parts, graphs = _form_graphs(cuda)
    _, _, cpu_graphs = _form_graphs("cpu")
    part, _, packed, _, combine = cons.FORMS[name]
    pg = parts[part]
    spec = cons.form_spec(pg, name)
    a = torch.from_numpy(cons.seeded(6, (4, pg.n_pad, 32)) * pg.node_mask[..., None])
    w = torch.from_numpy(cons.seeded(7, tuple(a.shape)))
    pairs = sum(len(p) for p in spec.perms)

    def run(device, g):
        x = a.to(device).requires_grad_(combine == "sum")
        n0 = _counts(hp.PACK, hp.UNPACK)
        y = halo_sync_stacked(x, g, spec, combine=combine)
        gx = torch.autograd.grad((y * w.to(device)).sum(), x)[0] if combine == "sum" else None
        n1 = _counts(hp.PACK, hp.UNPACK)
        return y.detach(), gx, {k: n1[k] - n0[k] for k in n1}

    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        y, gx, delta = run(cuda, graphs[part])
        y2, gx2, _ = run(cuda, graphs[part])
    finally:
        torch.use_deterministic_algorithms(det)
    want = ({hp.PACK: 2, hp.UNPACK: 2 * pairs} if packed and combine == "sum"
            else {hp.PACK: 0, hp.UNPACK: 0})
    assert delta == want
    yc, gc, _ = run("cpu", cpu_graphs[part])
    assert torch.equal(y, y2) and torch.equal(y.cpu(), yc)
    if combine == "sum":
        assert torch.equal(gx, gx2) and torch.equal(gx.cpu(), gc)


@pytest.mark.gpu
def test_autotune_on_card_grid_argmin_and_cache(cuda):
    """halo mode auto with a bf16 wire on a stacked graph on the card: the
    grid is 2 schedules x 3 mode labels (the packed candidate runs kernels
    4 and 5 here) x 2 wires, the pick is the table's argmin, and a second
    autotune launches nothing."""
    from repro_torch.core import consistent_mp as cmp
    sem = box_mesh((4, 4, 2), p=2)
    pg = partition_mesh(sem, (2, 2, 1))
    plan = NMPPlan.build(pg, "auto", schedule="auto", wire_dtype=torch.bfloat16,
                         backend=FUSED)
    g = ShardedGraph.build(pg, sem.coords, plan, device=cuda)
    n0 = _counts(sa.KERNEL, hp.PACK, hp.UNPACK)
    out = plan.autotune(g, hidden=32, iters=2)
    n1 = _counts(sa.KERNEL, hp.PACK, hp.UNPACK)
    assert n1[sa.KERNEL] > n0[sa.KERNEL] and n1[hp.PACK] > n0[hp.PACK]
    table = cmp.measure_plan_candidates(plan, g, hidden=32)
    assert len(table) == 12 and {k[1] for k in table} == set(cmp.MODE_LABELS)
    assert cmp._pick_of(out) == min(table, key=table.get)
    again = plan.autotune(g, hidden=32, iters=2)
    assert _counts(sa.KERNEL, hp.PACK, hp.UNPACK) == n1 and again == out


@pytest.mark.gpu
def test_resilient_training_recovers_bitwise_on_card(cuda, tmp_path):
    """A crash before step 5 of 8 (a checkpoint every 3) recovers from step
    3 on the card: losses and params bitwise the uninterrupted resilient
    run's, kernels 1 and 2 launched once per layer of every step executed
    (8, and 5 + 4 with the replay)."""
    sem = box_mesh((4, 2, 2), p=2)
    pg = partition_mesh(sem, (1, 1, 1))
    cfg = GNNConfig(hidden=32, n_mp_layers=2, mlp_hidden_layers=5)
    start = init_gnn(torch.Generator().manual_seed(2), cfg, device="cpu")

    def run(name, fault=None):
        rcfg = ResilientConfig(ckpt_dir=str(tmp_path / name), ckpt_every=3,
                               backoff_base=0.001)
        build.reset_launch_counts()
        hist = train_consistent_gnn(
            pg, sem, cfg, TrainConfig(n_steps=8, plan=NMPPlan(backend=FUSED),
                                      resilience=rcfg),
            params=start, device=cuda, fault=fault)
        return hist, {k: v for k, v in build.launch_counts.items() if v}

    ref, n_ref = run("ref")
    hist, n = run("crash", FaultPlan(crash_at_step=5))
    assert hist["restarts"] == 1 and hist["resume_steps"] == [3]
    assert hist["losses"] == ref["losses"] and all(np.isfinite(ref["losses"]))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(hist["params"]),
                                                 tree_leaves(ref["params"])))
    assert n_ref == {sa.KERNEL: 8 * 2, sa.KERNEL_BWD: 8 * 2}
    assert n == {sa.KERNEL: 9 * 2, sa.KERNEL_BWD: 9 * 2}


# ---------------------------------------------------------------------------
# GraphCast's training cell and edge-parallel slices on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_graphcast_train_step_launches_on_card(cuda):
    """GraphCast at d512 (4 layers) on a cora_like graph through
    ``configs/gnn_common.py``'s step builder (``launch/graphcast_checks.py::
    run_case``), fused: the forward launches kernel 1c and its per-node
    pass 1d once per layer, the step-0 gradient and each AdamW step 1c, 2c
    once and 1d twice per layer, nothing else; forward, loss and gradients
    within the bands of the plain backend's."""
    from repro_torch.core.graph_state import XLA as PLAIN
    from repro_torch.launch import graphcast_checks as gcx
    from repro_torch.launch.consistency import grads_close
    from repro_torch.launch.mesh import to_host
    from repro_torch.models.gnn_zoo.graphcast import GraphCastConfig
    import dataclasses
    cfg = GraphCastConfig(in_dim=16, hidden=512, n_layers=4, out_dim=4)
    job = gcx.Job(cases=(), cfg=dataclasses.asdict(cfg),
                  graph=dict(seed=2, n=300, m_und=1200, d=16, n_classes=4),
                  backend=FUSED, device=str(cuda), steps=2)
    got = to_host(gcx.run_case(job, gcx.Case("r1")))
    want = to_host(gcx.run_case(dataclasses.replace(job, backend=PLAIN, steps=0),
                                gcx.Case("r1")))
    L = cfg.n_layers
    step = {sa.KERNEL_ANY: L, sa.KERNEL_DST: 2 * L, sa.KERNEL_BWD_ANY: L}
    assert got["launches_eval"] == {sa.KERNEL_ANY: L, sa.KERNEL_DST: L}
    assert got["launches_grad"] == step
    assert got["launches_step"] == [step, step]
    assert want["launches_eval"] == {} and want["launches_grad"] == {}
    np.testing.assert_allclose(got["pred"], want["pred"], rtol=RTOL, atol=ATOL)
    assert abs(got["loss0"] - want["loss0"]) <= 2e-6 * abs(want["loss0"])
    assert grads_close(got["grads0"], want["grads0"], G_RTOL, G_ATOL, W_REL)[2]
    assert np.isfinite(got["losses"]).all() and got["losses"][1] != got["losses"][0]


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ["blocking", "overlap"])
def test_empty_edge_slice_on_card(cuda, schedule):
    """A model shard's edge slice that holds no real edge (a partition
    padded far past its edges, ``core/graph_state.py::edge_shard``): its
    layout is one tile of empty slots, and kernels 1c and 2c at H=512 on
    the tensor-core route run on it (each side's under the overlap
    schedule) without trapping, every output and gradient zero as the
    plain backend's, launches counted; the other slice, which holds every
    edge, within the bands of the plain backend."""
    from repro_torch.core.consistent_mp import (
        edge_update_aggregate, edge_update_aggregate_part, init_nmp_layer)
    from repro_torch.core.graph_state import XLA as PLAIN
    from repro_torch.core.graph_state import edge_shard, pad_edges
    from repro_torch.core.partition import partition_graph
    from repro_torch.graph.datasets import cora_like
    from repro_torch.nn import value_and_grad
    H = 512
    edges, _, _ = cora_like(seed=3, n=70, m_und=200, d=4, n_classes=2)
    pg = pad_edges(partition_graph(70, edges, 1), 1024)
    assert pg.edge_mask[0, 512:].sum() == 0 and pg.edge_mask[0, :512].sum() > 0
    plan = NMPPlan(backend=FUSED, schedule=schedule)
    params = init_nmp_layer(torch.Generator().manual_seed(0), H, 1, device=cuda)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(pg.n_pad, H, generator=gen).to(cuda)
    e = torch.randn(pg.e_pad // 2, H, generator=gen).to(cuda)
    gx = torch.randn(pg.n_pad, H, generator=gen).to(cuda)

    def run(g, pl):
        def loss(p):
            if pl.schedule == "overlap":
                outs = [edge_update_aggregate_part(p, x, e, g, part, pl)
                        for part in ("bnd", "int")]
                e_new, agg = outs[0][0] + outs[1][0], outs[0][1] + outs[1][1]
            else:
                e_new, agg = edge_update_aggregate(p, x, e, g, pl)
            return (agg * gx).sum() + e_new.sum()
        return value_and_grad(loss, params)

    for index in (1, 0):
        g = ShardedGraph.build(edge_shard(pg, index, 2), None, plan, device=cuda, rank=0)
        build.reset_launch_counts()
        val, grads = run(g, plan)
        torch.cuda.synchronize()
        sides = 2 if schedule == "overlap" else 1
        assert {k: v for k, v in build.launch_counts.items() if v} == {
            sa.KERNEL_ANY: sides, sa.KERNEL_BWD_ANY: sides, sa.KERNEL_DST: 2 * sides}
        pval, pgrads = run(g, plan.replace(backend=PLAIN))
        if index == 1:
            assert bool((g["seg_perm"] == -1).all())
            assert float(val) == float(pval) == 0.0
            assert not any(t.any() for t in tree_leaves(grads))
        else:
            for a, b in zip(tree_leaves(grads), tree_leaves(pgrads)):
                assert _within(a, b, G_RTOL, G_ATOL) or _rel_norm(a, b) <= W_REL


# ---------------------------------------------------------------------------
# the rest of the GNN zoo (GAT, NequIP, MACE) on the card
# ---------------------------------------------------------------------------

ZOO_GRAPH = dict(seed=1, n=120, m_und=400, d=16, n_classes=4)


def _zoo_job(arch, device, **kw):
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch import graphcast_checks as gcx
    mod, _ = get_arch(arch)
    cfg = mod.smoke_config()
    if arch == "gat-cora":
        cfg = dataclasses.replace(cfg, in_dim=ZOO_GRAPH["d"], n_classes=ZOO_GRAPH["n_classes"])
    return gcx.Job(cases=(), cfg=dataclasses.asdict(cfg), graph=ZOO_GRAPH, device=device,
                   arch=arch, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gat-cora", "nequip", "mace"])
def test_gnn_zoo_forward_on_card_matches_cpu(cuda, arch):
    """Each zoo model's cell (``launch/graphcast_checks.py::run_case``, one
    rank) on the card against the same code on the CPU: the eval forward
    in the forward band, the first loss within 2e-6, the gradients in the
    gradient band (weight sums by rel L2 5e-4), two AdamW steps finite;
    no kernel launches at one rank."""
    import dataclasses
    from repro_torch.launch import graphcast_checks as gcx
    from repro_torch.launch.consistency import grads_close
    from repro_torch.launch.mesh import to_host
    job = _zoo_job(arch, str(cuda), steps=2)
    got = to_host(gcx.run_case(job, gcx.Case("r1")))
    want = to_host(gcx.run_case(dataclasses.replace(job, device="cpu", steps=0),
                                gcx.Case("r1")))
    assert got["launches_eval"] == {} and got["launches_grad"] == {}
    np.testing.assert_allclose(got["pred"], want["pred"], rtol=RTOL, atol=ATOL)
    assert abs(got["loss0"] - want["loss0"]) <= 2e-6 * abs(want["loss0"])
    assert grads_close(got["grads0"], want["grads0"], G_RTOL, G_ATOL, W_REL)[2]
    assert np.isfinite(got["losses"]).all() and got["losses"][1] != got["losses"][0]


@pytest.mark.gpu
def test_segment_max_on_card_matches_cpu(cuda):
    """The sorted segment max on the card: the CPU's values, ``-inf`` for
    an empty segment, bitwise on a rerun."""
    from repro_torch.graph.segment import segment_max
    gen = torch.Generator().manual_seed(0)
    data = torch.randn(300, 4, generator=gen)
    ids = torch.randint(0, 50, (300,), generator=gen)
    ids[ids == 7] = 8
    want = segment_max(data, ids, 60)
    got = segment_max(data.to(cuda), ids.to(cuda), 60)
    assert torch.equal(got.cpu(), want) and torch.isneginf(got[[7, 55]]).all()
    assert torch.equal(got, segment_max(data.to(cuda), ids.to(cuda), 60))


@pytest.mark.gpu
def test_gat_exchange_launches_on_card(cuda):
    """GAT over 4 gloo processes sharing the card, graph 4: under the
    packed neighbor exchange each of its 2 layers runs 3 exchanges, of
    which the 2 sums launch one pack (kernel 4) and one unpack-add
    (kernel 5) per round received, and the max exchange of the softmax
    shift neither: per process 4 packs and 4 x rounds received unpack-adds
    an eval forward, twice that with the gradient; all-to-all launches
    neither kernel; each process's rows within the forward band of the
    one-rank run on the card."""
    import dataclasses
    from repro_torch.core.graph_state import pad_edges
    from repro_torch.core.partition import partition_graph
    from repro_torch.graph.datasets import cora_like
    from repro_torch.launch import graphcast_checks as gcx
    from repro_torch.launch.mesh import to_host
    cases = (gcx.Case("gat_packed", graph=4, mode="packed"),
             gcx.Case("gat_a2a", graph=4, mode="a2a"))
    job = _zoo_job("gat-cora", "cuda", steps=0)
    r1 = to_host(gcx.run_case(job, gcx.Case("r1")))
    procs = gcx.run_world(dataclasses.replace(job, cases=cases), 4)
    edges, _, _ = cora_like(**ZOO_GRAPH)
    pg = pad_edges(partition_graph(ZOO_GRAPH["n"], edges, 4))
    perms = gcx.plan_of(pg, cases[0], XLA).halo.perms
    m1 = r1["node_mask"] > 0
    want = dict(zip(r1["global_ids"][m1].tolist(), r1["pred"][m1]))
    for p in procs:
        rec = p["gat_packed"]
        recv = sum(any(d == rec["rank"] for _, d in perm) for perm in perms)
        assert recv > 0
        assert rec["launches_eval"] == {hp.PACK: 4, hp.UNPACK: 4 * recv}
        assert rec["launches_grad"] == {hp.PACK: 8, hp.UNPACK: 8 * recv}
        assert p["gat_a2a"]["launches_eval"] == {} and p["gat_a2a"]["launches_grad"] == {}
        for name in ("gat_packed", "gat_a2a"):
            r = p[name]
            m = r["node_mask"] > 0
            for gid, row in zip(r["global_ids"][m].tolist(), r["pred"][m]):
                np.testing.assert_allclose(row, want[gid], rtol=RTOL, atol=ATOL)
