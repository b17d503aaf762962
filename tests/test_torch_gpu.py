"""The torch port's CUDA kernels on the card, each against its plain
PyTorch version, plus the determinism the serving contract needs.

Every test here is ``gpu``-marked and skips on a host without a CUDA card
(CUDA kernels have no CPU mode); the card is detected inside a fixture,
never at import.  The file imports only ``torch`` and ``repro_torch``, so it
runs on a GPU host without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: the fused NMP kernel sums the MLP and the aggregate in another
order than the plain version: rtol 1e-4 / atol 1e-5 (the reference's own
forward band).  Its backward: node and edge gradients rtol 1e-3 / atol
2e-5 (the reference's gradient band); the weight gradients are sums over
every edge, so they are held to a relative L2 norm of 5e-4.  Pack and
unpack-add are pure data movement: bitwise, values and gradients.  Every
kernel, and a training step through them, is bitwise repeatable.
"""
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
from repro_torch.kernels import build
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
    idx, mask = torch.from_numpy(idx).to(cuda), torch.from_numpy(mask).to(cuda)
    assert torch.equal(hp.halo_pack(x, idx, mask), hp.halo_pack_plain(x, idx, mask))
    assert torch.equal(hp.halo_unpack_add(a, buf, idx, mask),
                       hp.halo_unpack_add_plain(a, buf, idx, mask))


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


@pytest.mark.gpu
def test_halo_kernel_grads_bitwise_plain(cuda):
    rng = np.random.default_rng(3)
    n, w, f = 301, 72, 32
    idx = np.zeros(w, np.int32)
    idx[:60] = rng.choice(np.arange(n), 60, replace=False)
    mask = np.zeros(w, np.float32)
    mask[:60] = 1.0
    idx, mask = torch.from_numpy(idx).to(cuda), torch.from_numpy(mask).to(cuda)
    T = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)  # noqa: E731
    x, a, buf, g_buf, g_out = T(n, f), T(n, f), T(w, f), T(w, f), T(n, f)
    counts = dict(build.launch_counts)
    xk = x.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(hp.halo_pack(xk, idx, mask), xk, g_buf)
    ak, bk = a.clone().requires_grad_(True), buf.clone().requires_grad_(True)
    ga, gb = torch.autograd.grad(hp.halo_unpack_add(ak, bk, idx, mask), (ak, bk), g_out)
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
