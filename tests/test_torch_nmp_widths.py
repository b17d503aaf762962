"""The fused NMP op's plain versions (``fused_nmp_edge_agg_plain`` and the
plain backward) at widths and depths only the generic-width CUDA entries
(``csrc/nmp_any.cu``) take on a card: against ``repro``'s XLA aggregate
(``repro/core/consistent_mp.py::_agg_xla``) and its ``jax.vjp``, on the
graph ``tests/test_torch_gpu.py`` builds to hit the kernels' tile edges
(nodes across several 64-slot tiles, degree-0 nodes, padding edges, masked
edges).  These plain versions are what the card's tests hold the generic
kernels to.  Bands: the reference's forward band (rtol 1e-4 / atol 1e-5)
and gradient band (rtol 1e-3 / atol 2e-5).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import NMPPlan as RefPlan
from repro.core.consistent_mp import _agg_xla as ref_agg_xla

from repro_torch.convert import params_from_jax
from repro_torch.kernels.segment_agg import ops as sa
from repro_torch.nn import tree_leaves

from test_torch_gpu import tile_edge_graph

RTOL, ATOL = 1e-4, 1e-5
G_RTOL, G_ATOL = 1e-3, 2e-5


def _edge_mlp_np(rng, hidden, n_hidden):
    """Random edge-MLP params (numpy) with non-trivial biases and LayerNorm."""
    dims = [3 * hidden] + [hidden] * (n_hidden + 1)
    layers = [{"w": (rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32),
               "b": (0.1 * rng.normal(size=b)).astype(np.float32)}
              for a, b in zip(dims[:-1], dims[1:])]
    return {"layers": layers,
            "ln": {"g": (1 + 0.1 * rng.normal(size=hidden)).astype(np.float32),
                   "b": (0.1 * rng.normal(size=hidden)).astype(np.float32)}}


@pytest.mark.parametrize("n_hidden", [1, 7])
@pytest.mark.parametrize("hidden", [4, 12, 64])
def test_plain_versions_match_reference_at_odd_widths(hidden, n_hidden):
    rng = np.random.default_rng(10 * hidden + n_hidden)
    src, dst, mask, inv, n = tile_edge_graph(rng)
    edge = _edge_mlp_np(rng, hidden, n_hidden)
    x = rng.normal(size=(n, hidden)).astype(np.float32)
    e = rng.normal(size=(dst.size, hidden)).astype(np.float32)
    g_enew = rng.normal(size=e.shape).astype(np.float32)
    g_agg = rng.normal(size=x.shape).astype(np.float32)
    # the reference's padding edges point at node 0 with mask 0, as its
    # partitioner writes them; the port's layout drops them
    ref_graph = {"edge_src": jnp.asarray(src), "edge_dst": jnp.asarray(np.where(dst < n, dst, 0)),
                 "edge_mask": jnp.asarray(mask), "edge_inv_mult": jnp.asarray(inv)}

    def ref_fn(p, xx, ee):
        return ref_agg_xla({"edge": p}, xx, ee, ref_graph, RefPlan())
    (ref_e, ref_agg), vjp = jax.vjp(ref_fn, jax.tree.map(jnp.asarray, edge), jnp.asarray(x),
                                    jnp.asarray(e))
    ref_gp, ref_gx, ref_ge = vjp((jnp.asarray(g_enew), jnp.asarray(g_agg)))

    lay = sa.compact_gather_layout(src, dst, n, 32)
    T = torch.from_numpy
    params = params_from_jax(edge, "cpu")
    args = (T(x), T(e), params, T(lay["perm"]), T(lay["src"]), T(lay["rowptr"]), T(mask),
            T(inv))
    e_new, agg = sa.fused_nmp_edge_agg_plain(*args)
    np.testing.assert_allclose(e_new.numpy(), np.asarray(ref_e), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(agg.numpy(), np.asarray(ref_agg), rtol=RTOL, atol=ATOL)
    assert not e_new.numpy()[dst == n].any()

    got = sa.fused_nmp_edge_agg_bwd_plain(*args, T(g_enew), T(g_agg))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref_gx), rtol=G_RTOL, atol=G_ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref_ge), rtol=G_RTOL, atol=G_ATOL)
    # the stacked weight gradients, unstacked into the params' leaves
    w0, b0, wrest, brest, lng, lnb = (t.numpy() for t in got[2:])
    grads = sa._unstack_edge_mlp(*(torch.from_numpy(a) for a in (w0, b0, wrest, brest, lng, lnb)),
                                 n_hidden, True)
    want = jax.tree_util.tree_leaves(ref_gp)
    assert len(tree_leaves(grads)) == len(want) == 2 * (n_hidden + 1) + 2
    for a, b in zip(tree_leaves(grads), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=G_RTOL, atol=G_ATOL)


#: which generic width and depth takes which route of kernels 1 and 2
#: (``ops.any_route``): the tensor cores from H = 64 on where H % 4 == 0
ROUTE_TABLE = {1: sa.FMA, 4: sa.FMA, 12: sa.FMA, 60: sa.FMA, 64: sa.TC, 66: sa.FMA,
               100: sa.TC, 102: sa.FMA, 128: sa.TC, 512: sa.TC, 1024: sa.TC}


@pytest.mark.parametrize("n_hidden", [0, 1, 2, 7, 48])
def test_any_route_table(n_hidden):
    """The route rule's table at every depth, and the route argument's
    checks: an unknown route and the tensor cores at H % 4 != 0 raise."""
    assert {h: sa.any_route(h, n_hidden) for h in ROUTE_TABLE} == ROUTE_TABLE
    assert sa.TC_MIN_HIDDEN == 64 and sa.ROUTES == (sa.FMA, sa.TC)
    assert sa._route(512, n_hidden, sa.FMA) == sa.FMA
    assert sa._route(4, n_hidden, sa.TC) == sa.TC
    with pytest.raises(ValueError, match="H % 4"):
        sa._route(102, n_hidden, sa.TC)
    with pytest.raises(ValueError, match="unknown route"):
        sa._route(512, n_hidden, "wgmma")


def test_node_dst_product_plain_on_cpu():
    """The tensor-core route's per-node pass on CPU tensors is its plain
    version, x @ w0's rows H .. 2H - 1, and counts no launch."""
    from repro_torch.kernels import build
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(7, 12)).astype(np.float32))
    w0 = torch.from_numpy(rng.normal(size=(36, 12)).astype(np.float32))
    before = build.launch_counts.get(sa.KERNEL_DST, 0)
    got = sa.node_dst_product(x, w0)
    assert torch.equal(got, x @ w0[12:24])
    assert build.launch_counts.get(sa.KERNEL_DST, 0) == before
