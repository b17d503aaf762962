"""The port's legacy dst-aligned edge-MLP + aggregation op against the JAX
reference package on the same numpy inputs (CPU tensors: the plain
version of the kernel).

``dst_aligned_layout`` must be array-equal to the reference's, dtypes
included.  ``fused_edge_mlp_agg`` is held to the bands
``tests/test_kernels.py`` holds the reference's own op to against its
oracle: e_new rtol / atol 3e-5, agg 1e-4 (the two sum in another order),
against the reference's op in interpret mode and against
``edge_mlp_agg_ref``; edges the layout drops keep e_new exactly 0.  The
kernel itself is held against the plain version on the card in
``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core.mesh_gen import box_mesh as ref_box_mesh
from repro.core.mesh_gen import mesh_graph_edges as ref_mesh_graph_edges
from repro.core.mesh_gen import undirected_to_directed as ref_undirected_to_directed
from repro.kernels.segment_agg.ops import dst_aligned_layout as ref_layout
from repro.kernels.segment_agg.ops import fused_edge_mlp_agg as ref_fused
from repro.kernels.segment_agg.ref import edge_mlp_agg_ref as ref_oracle

from repro_torch.core.mesh_gen import box_mesh, mesh_graph_edges, undirected_to_directed
from repro_torch.kernels.segment_agg import ops as sa
from repro_torch.kernels.segment_agg.ref import edge_mlp_agg_ref

E_TOL = dict(rtol=3e-5, atol=3e-5)
AGG_TOL = dict(rtol=1e-4, atol=1e-4)


def _assert_layouts_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w and type(g) is type(w), k


@pytest.mark.parametrize("seed", range(3))
def test_dst_aligned_layout_equals_reference_with_dropped_edges(seed):
    """tests/test_kernels.py's layout cases: some dst >= n are dropped."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(10, 70))
    E = int(rng.integers(20, 300))
    dst = rng.integers(0, n + 5, E)
    _assert_layouts_equal(sa.dst_aligned_layout(dst, n, 16, 8), ref_layout(dst, n, 16, 8))


def test_dst_aligned_layout_equals_reference_on_mesh_graph():
    """The mesh of test_segment_agg_mesh_graph_low_waste, at its blocks."""
    ref_mesh = ref_box_mesh((4, 4, 2), p=3)
    mesh = box_mesh((4, 4, 2), p=3)
    e = undirected_to_directed(mesh_graph_edges(mesh))
    np.testing.assert_array_equal(e, ref_undirected_to_directed(ref_mesh_graph_edges(ref_mesh)))
    got = sa.dst_aligned_layout(e[:, 1], mesh.n_nodes, 128, 256)
    _assert_layouts_equal(got, ref_layout(e[:, 1], ref_mesh.n_nodes, 128, 256))
    assert got["waste"] < 0.6


def _case(seed, fin=24, hh=16, hid=16, dropped=0):
    """tests/test_kernels.py::test_segment_agg_random_graphs's inputs; with
    ``dropped`` > 0 that many edges point past the last node."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 90))
    E = int(rng.integers(50, 400))
    dst = rng.integers(0, n, E)
    feats = rng.normal(size=(E, fin)).astype(np.float32)
    wgt = rng.uniform(0.5, 1.0, E).astype(np.float32)
    w1 = rng.normal(size=(fin, hh)).astype(np.float32) * 0.2
    b1 = rng.normal(size=(hh,)).astype(np.float32) * 0.1
    w2 = rng.normal(size=(hh, hid)).astype(np.float32) * 0.2
    b2 = rng.normal(size=(hid,)).astype(np.float32) * 0.1
    if dropped:
        dst[rng.choice(E, dropped, replace=False)] = n + rng.integers(0, 5, dropped)
    return n, dst, feats, wgt, w1, b1, w2, b2


CASES = [(s, {}) for s in range(4)] + [(7, dict(fin=24, hh=20, hid=16, dropped=33))]


@pytest.mark.parametrize("seed,kw", CASES, ids=["seed0", "seed1", "seed2", "seed3",
                                                "dropped_hh20"])
def test_fused_edge_mlp_agg_matches_reference(seed, kw):
    n, dst, feats, wgt, w1, b1, w2, b2 = _case(seed, **kw)
    block_n, block_e = 16, 32
    layout = sa.dst_aligned_layout(dst, n, block_n, block_e)
    T = torch.from_numpy
    e_new, agg = sa.fused_edge_mlp_agg(
        T(feats), T(dst), T(wgt), T(w1), T(b1), T(w2), T(b2), layout,
        n_nodes=n, block_n=block_n, block_e=block_e)
    assert e_new.shape == (len(dst), w2.shape[1]) and e_new.dtype == torch.float32
    assert agg.shape == (layout["n_node_blocks"] * block_n, w2.shape[1])
    J = jnp.asarray
    ref_e, ref_agg = ref_fused(J(feats), J(dst, jnp.int32), J(wgt), J(w1), J(b1), J(w2),
                               J(b2), ref_layout(dst, n, block_n, block_e), n_nodes=n,
                               block_n=block_n, block_e=block_e, interpret=True)
    np.testing.assert_allclose(e_new.numpy(), np.asarray(ref_e), **E_TOL)
    np.testing.assert_allclose(agg.numpy(), np.asarray(ref_agg), **AGG_TOL)
    kept = dst < n
    oracle_e, oracle_agg = ref_oracle(J(feats), J(w1), J(b1), J(w2), J(b2), J(dst), J(wgt), n)
    np.testing.assert_allclose(e_new.numpy()[kept], np.asarray(oracle_e)[kept], **E_TOL)
    np.testing.assert_allclose(agg.numpy()[:n], np.asarray(oracle_agg), **AGG_TOL)
    assert kw.get("dropped", 0) == int((~kept).sum())
    assert torch.equal(e_new[torch.from_numpy(~kept)],
                       torch.zeros(int((~kept).sum()), w2.shape[1]))


@pytest.mark.parametrize("dropped", [0, 33])
def test_edge_mlp_agg_ref_matches_reference(dropped):
    n, dst, feats, wgt, w1, b1, w2, b2 = _case(5, hh=20, dropped=dropped)
    T, J = torch.from_numpy, jnp.asarray
    e_new, agg = edge_mlp_agg_ref(T(feats), T(w1), T(b1), T(w2), T(b2), T(dst), T(wgt), n)
    want_e, want_agg = ref_oracle(J(feats), J(w1), J(b1), J(w2), J(b2), J(dst), J(wgt), n)
    np.testing.assert_allclose(e_new.numpy(), np.asarray(want_e), **E_TOL)
    np.testing.assert_allclose(agg.numpy(), np.asarray(want_agg), **AGG_TOL)


def _tiles(seed=1, dtype=torch.float32):
    n, dst, feats, wgt, w1, b1, w2, b2 = _case(seed, hh=20)
    layout = sa.dst_aligned_layout(dst, n, 16, 32)
    perm = torch.from_numpy(layout["perm"])
    valid = perm >= 0
    f = torch.from_numpy(feats).to(dtype)[perm.clamp(min=0)] * valid[..., None]
    w = torch.from_numpy(wgt)[perm.clamp(min=0)] * valid
    args = (f, torch.from_numpy(layout["dstl"]), w) + tuple(
        torch.from_numpy(a) for a in (w1, b1, w2, b2))
    return args, dict(n_node_blocks=layout["n_node_blocks"], block_n=16, block_e=32)


def test_edge_mlp_agg_bf16_tiles_compute_in_fp32():
    """bf16 feats: e_new is the fp32 result on the same values, rounded once;
    agg is the fp32 aggregate of the unrounded e_new."""
    args, kw = _tiles(dtype=torch.bfloat16)
    e_new, agg = sa.edge_mlp_agg(*args, **kw)
    want_e, want_agg = sa.edge_mlp_agg_plain(args[0].float(), *args[1:], **kw)
    assert e_new.dtype == torch.bfloat16 and agg.dtype == torch.float32
    assert torch.equal(e_new, want_e.to(torch.bfloat16)) and torch.equal(agg, want_agg)


def test_edge_mlp_agg_drops_out_of_range_dst_local():
    """A slot whose dst_local lies outside [0, block_n) adds to no node, as
    the TPU kernel's one-hot product never matches it."""
    args, kw = _tiles()
    f, dstl, w, *mlp = args
    bad = dstl.clone()
    bad[0, 0, :5] = torch.tensor([-1, 16, 17, 40, -7], dtype=bad.dtype)
    e_new, agg = sa.edge_mlp_agg(f, bad, w, *mlp, **kw)
    w0 = w.clone()
    w0[0, 0, :5] = 0
    want_e, want_agg = sa.edge_mlp_agg(f, dstl, w0, *mlp, **kw)
    assert torch.equal(e_new, want_e) and torch.equal(agg, want_agg)


def test_edge_mlp_agg_raises_on_what_it_does_not_take():
    args, kw = _tiles()
    f, dstl, w, w1, b1, w2, b2 = args
    with pytest.raises(RuntimeError, match="forward-only"):
        sa.edge_mlp_agg(f, dstl, w, w1.clone().requires_grad_(), b1, w2, b2, **kw)
    with torch.no_grad():                     # fine without a gradient
        sa.edge_mlp_agg(f, dstl, w, w1.clone().requires_grad_(), b1, w2, b2, **kw)
    with pytest.raises(ValueError, match="feats"):
        sa.edge_mlp_agg(f, dstl, w, w1, b1, w2, b2, **dict(kw, block_e=16))
    with pytest.raises(ValueError, match="dst_local"):
        sa.edge_mlp_agg(f, dstl[:, :, :-1], w, w1, b1, w2, b2, **kw)
    with pytest.raises(ValueError, match="MLP"):
        sa.edge_mlp_agg(f, dstl, w, w1[:-1], b1, w2, b2, **kw)
    with pytest.raises(ValueError, match="MLP"):
        sa.edge_mlp_agg(f, dstl, w, w1, b1, w2, b2[:-1], **kw)
    with pytest.raises(TypeError, match="dtype"):
        sa.edge_mlp_agg(f.double(), dstl, w, w1, b1, w2, b2, **kw)
    n, dst, *_ = _case(1)
    with pytest.raises(ValueError, match="layout blocks"):
        sa.fused_edge_mlp_agg(torch.zeros(len(dst), 24), torch.from_numpy(dst),
                              torch.ones(len(dst)), w1, b1, w2, b2,
                              sa.dst_aligned_layout(dst, n, 16, 32), n_nodes=n,
                              block_n=16, block_e=64)
