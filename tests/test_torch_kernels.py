"""Kernel modules of the torch port: each plain version against the JAX
reference package on the same numpy inputs, and the CPU dispatch of every
wrapper.

Tolerances: the fused NMP forward sums in another order than the
reference, so it is held to the band the reference holds its own fused
backend to (rtol 1e-4 / atol 1e-5), its gradients to the reference's
gradient band (rtol 1e-3 / atol 2e-5, ``tests/test_consistency.py``); the
pack/unpack ops are pure data movement and must be bitwise equal, values
and gradients.  The kernels themselves are held against these plain
versions on the card in ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import GNNConfig as RefConfig
from repro.core import NMPPlan as RefPlan
from repro.core import ShardedGraph as RefGraph
from repro.core import box_mesh as ref_box_mesh
from repro.core import init_gnn as ref_init_gnn
from repro.core import partition_mesh as ref_partition_mesh
from repro.core.consistent_mp import _agg_xla as ref_agg_xla
from repro.kernels.halo_pack.ref import halo_pack_ref, halo_unpack_add_ref
from repro.kernels.segment_agg.ops import compact_gather_layout as ref_layout

from repro_torch.convert import params_from_jax
from repro_torch.core.graph_state import FUSED, NMPPlan, ShardedGraph
from repro_torch.core.mesh_gen import box_mesh
from repro_torch.core.partition import partition_mesh
from repro_torch.kernels import build
from repro_torch.kernels.halo_pack import ops as hp
from repro_torch.kernels.segment_agg import ops as sa
from repro_torch.nn import tree_leaves

RTOL, ATOL = 1e-4, 1e-5
G_RTOL, G_ATOL = 1e-3, 2e-5        # the reference's gradient band


def _layer_case(hidden, mlp_hidden_layers):
    """One NMP layer's params, inputs and rank-local graphs in both packages."""
    cfg = RefConfig(hidden=hidden, n_mp_layers=1,
                    mlp_hidden_layers=mlp_hidden_layers)
    np_params = jax.tree.map(np.asarray, ref_init_gnn(jax.random.PRNGKey(3), cfg))
    sem = ref_box_mesh((2, 2, 2), p=2)
    ref_pg = ref_partition_mesh(sem, (1, 1, 1))
    ref_g = RefGraph.build(ref_pg, sem.coords, RefPlan()).rank(0)
    port_g = ShardedGraph.build(partition_mesh(box_mesh((2, 2, 2), p=2), (1, 1, 1)),
                                sem.coords, NMPPlan(backend=FUSED, block_e=32),
                                device="cpu").rank(0)
    rng = np.random.default_rng(hidden)
    n, e = ref_pg.n_pad, ref_pg.e_pad
    x = rng.normal(size=(n, hidden)).astype(np.float32)
    ev = rng.normal(size=(e, hidden)).astype(np.float32)
    return np_params["mp"][0], x, ev, ref_g, port_g


def _fused_args(lp, x, e, g, device):
    t = params_from_jax(lp, device)
    return (torch.from_numpy(x).to(device), torch.from_numpy(e).to(device),
            t["edge"], g["seg_perm"], g["seg_src"], g["seg_rowptr"],
            g["edge_mask"], g["edge_inv_mult"])


@pytest.mark.parametrize("hidden,layers", [(8, 2), (32, 5)])
def test_fused_nmp_plain_matches_reference_agg(hidden, layers):
    lp, x, e, ref_g, port_g = _layer_case(hidden, layers)
    ref_e, ref_agg = ref_agg_xla(jax.tree.map(jnp.asarray, lp), jnp.asarray(x),
                                 jnp.asarray(e), ref_g, RefPlan())
    # the wrapper on CPU tensors runs the plain version
    e_new, agg = sa.fused_nmp_edge_agg(*_fused_args(lp, x, e, port_g, "cpu"))
    np.testing.assert_allclose(e_new.numpy(), np.asarray(ref_e), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(agg.numpy(), np.asarray(ref_agg), rtol=RTOL, atol=ATOL)


def test_fused_nmp_rejects_wrong_edge_mlp_width():
    lp, x, e, _, port_g = _layer_case(8, 2)
    args = list(_fused_args(lp, x, e, port_g, "cpu"))
    args[2] = params_from_jax(lp, "cpu")["node"]        # consumes 2H, not 3H
    with pytest.raises(ValueError, match="3\\*H"):
        sa.fused_nmp_edge_agg(*args)


def _wire_case(seed=0, n=53, w=24, f=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    a = rng.normal(size=(n, f)).astype(np.float32)
    buf = rng.normal(size=(w, f)).astype(np.float32)
    idx = np.zeros(w, np.int32)
    real = w - 5                                  # tail slots are padding
    idx[:real] = rng.choice(n, real, replace=False)
    mask = np.zeros(w, np.float32)
    mask[:real] = 1.0
    return x, a, buf, idx, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_halo_pack_plain_bitwise_reference(seed):
    x, a, buf, idx, mask = _wire_case(seed)
    T = torch.from_numpy
    got = hp.halo_pack(T(x), T(idx), T(mask)).numpy()
    want = np.asarray(halo_pack_ref(jnp.asarray(x), jnp.asarray(idx),
                                    jnp.asarray(mask)))
    assert np.array_equal(got, want)
    got = hp.halo_unpack_add(T(a), T(buf), T(idx), T(mask)).numpy()
    want = np.asarray(halo_unpack_add_ref(jnp.asarray(a), jnp.asarray(buf),
                                          jnp.asarray(idx), jnp.asarray(mask)))
    assert np.array_equal(got, want)


def test_halo_wrappers_validate_shapes():
    x, a, buf, idx, mask = _wire_case()
    T = torch.from_numpy
    with pytest.raises(ValueError, match="buf"):
        hp.halo_unpack_add(T(a), T(buf[:-1]), T(idx), T(mask))
    with pytest.raises(ValueError, match="mask"):
        hp.halo_pack(T(x), T(idx), T(mask[:-1]))


def test_cpu_wrappers_never_launch_kernels():
    build.reset_launch_counts()
    x, a, buf, idx, mask = _wire_case()
    T = torch.from_numpy
    hp.halo_pack(T(x), T(idx), T(mask))
    hp.halo_unpack_add(T(a), T(buf), T(idx), T(mask))
    lp, xx, e, _, port_g = _layer_case(8, 2)
    sa.fused_nmp_edge_agg(*_fused_args(lp, xx, e, port_g, "cpu"))
    assert all(v == 0 for v in build.launch_counts.values())


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def _edge_mlp_np(rng, hidden, n_hidden, has_ln):
    """Random edge-MLP params (numpy) with non-trivial biases and LayerNorm."""
    dims = [3 * hidden] + [hidden] * (n_hidden + 1)
    layers = [{"w": (rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32),
               "b": (0.1 * rng.normal(size=b)).astype(np.float32)}
              for a, b in zip(dims[:-1], dims[1:])]
    p = {"layers": layers}
    if has_ln:
        p["ln"] = {"g": (1 + 0.1 * rng.normal(size=hidden)).astype(np.float32),
                   "b": (0.1 * rng.normal(size=hidden)).astype(np.float32)}
    return p


@pytest.mark.parametrize("has_ln", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("n_hidden", [0, 2, 5])
@pytest.mark.parametrize("hidden", [8, 32])
def test_fused_nmp_grads_match_reference_vjp(hidden, n_hidden, has_ln):
    """The autograd op (plain backward on CPU tensors) against jax.vjp of
    the reference's XLA aggregate, cotangents on both outputs."""
    _, x, e, ref_g, port_g = _layer_case(hidden, 1)
    rng = np.random.default_rng(100 * hidden + 10 * n_hidden + has_ln)
    edge = _edge_mlp_np(rng, hidden, n_hidden, has_ln)
    g_enew = rng.normal(size=e.shape).astype(np.float32)
    g_agg = rng.normal(size=x.shape).astype(np.float32)

    def ref_fn(p, xx, ee):
        return ref_agg_xla({"edge": p}, xx, ee, ref_g, RefPlan())
    to_j = lambda t: jax.tree.map(jnp.asarray, t)   # noqa: E731
    _, vjp = jax.vjp(ref_fn, to_j(edge), jnp.asarray(x), jnp.asarray(e))
    ref_gp, ref_gx, ref_ge = vjp((jnp.asarray(g_enew), jnp.asarray(g_agg)))

    params = params_from_jax(edge, "cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    et = torch.from_numpy(e).requires_grad_(True)
    leaves = [xt, et] + tree_leaves(params)    # JAX's flatten order
    for t in leaves[2:]:
        t.requires_grad_(True)
    e_new, agg = sa.fused_nmp_edge_agg(
        xt, et, params, port_g["seg_perm"], port_g["seg_src"],
        port_g["seg_rowptr"], port_g["edge_mask"], port_g["edge_inv_mult"],
        seg_src_slots=port_g["seg_src_slots"],
        seg_src_rowptr=port_g["seg_src_rowptr"])
    grads = torch.autograd.grad((e_new, agg), leaves,
                                (torch.from_numpy(g_enew), torch.from_numpy(g_agg)))
    want = [ref_gx, ref_ge] + jax.tree_util.tree_leaves(ref_gp)
    assert len(want) == len(grads) == 2 + 2 * (n_hidden + 1) + 2 * has_ln
    for got, ref in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=G_RTOL, atol=G_ATOL)


def test_fused_nmp_saves_nothing_without_grad():
    lp, x, e, _, port_g = _layer_case(8, 2)
    args = _fused_args(lp, x, e, port_g, "cpu")
    with torch.no_grad():
        e_new, agg = sa.fused_nmp_edge_agg(*args)
    assert e_new.grad_fn is None and agg.grad_fn is None
    want = sa.fused_nmp_edge_agg_plain(*args)
    assert torch.equal(e_new, want[0]) and torch.equal(agg, want[1])


def test_fused_nmp_bwd_wrapper_matches_plain_on_cpu():
    lp, x, e, _, port_g = _layer_case(8, 2)
    args = _fused_args(lp, x, e, port_g, "cpu")
    rng = np.random.default_rng(7)
    g_enew = torch.from_numpy(rng.normal(size=e.shape).astype(np.float32))
    g_agg = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    got = sa.fused_nmp_edge_agg_bwd(*args[:6], port_g["seg_src_slots"],
                                    port_g["seg_src_rowptr"], *args[6:],
                                    g_enew, g_agg)
    want = sa.fused_nmp_edge_agg_bwd_plain(*args, g_enew, g_agg)
    assert len(got) == len(want) == 8
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("block_e", [8, 32])
def test_src_sorted_layout_is_a_valid_permutation(block_e):
    rng = np.random.default_rng(block_e)
    n = 41
    src = rng.integers(0, n, 300)
    dst = rng.integers(0, n, 300)
    dst[::5] = n                                  # padding edges: dropped
    lay = sa.compact_gather_layout(src, dst, n, block_e)
    ref = ref_layout(src, dst, n, block_e)
    for k in ("perm", "src", "dst", "n_tiles", "block_e", "n_edges"):
        assert np.array_equal(lay[k], ref[k]), k
    n_real = lay["n_edges"]
    slots, rp = lay["src_slots"], lay["src_rowptr"]
    assert np.array_equal(np.sort(slots), np.arange(n_real))
    assert rp[0] == 0 and rp[-1] == n_real and np.all(np.diff(rp) >= 0)
    flat_src = lay["src"].reshape(-1)
    for node in range(n):
        mine = slots[rp[node]:rp[node + 1]]
        assert np.all(flat_src[mine] == node)
        assert np.all(np.diff(mine) > 0)          # stable: slot order kept
    assert rp[-1] == np.count_nonzero(dst < n)


def test_partition_carries_src_layout_beside_reference_keys():
    sem = ref_box_mesh((4, 2, 2), p=2)
    ref_pg = ref_partition_mesh(sem, (2, 2, 1))
    port_pg = partition_mesh(box_mesh((4, 2, 2), p=2), (2, 2, 1))
    ref_arrays = ref_pg.device_arrays(seg_layout=(128, 32))
    arrays = port_pg.device_arrays(seg_layout=(128, 32))
    for k in ("seg_perm", "seg_src", "seg_dst"):
        assert np.array_equal(arrays[k], np.asarray(ref_arrays[k])), k
    for r in range(port_pg.R):
        rp, slots = arrays["seg_src_rowptr"][r], arrays["seg_src_slots"][r]
        n_real = arrays["seg_rowptr"][r][-1]
        assert rp[-1] == n_real
        assert np.array_equal(np.sort(slots[:n_real]), np.arange(n_real))
        flat_src = arrays["seg_src"][r].reshape(-1)
        counts = np.bincount(flat_src[:n_real], minlength=port_pg.n_pad)
        assert np.array_equal(np.diff(rp), counts)


@pytest.mark.parametrize("seed", [0, 1])
def test_halo_grads_bitwise_reference_vjps(seed):
    """Pack/unpack gradients (each op the other's adjoint) against jax.vjp
    of the reference expressions — bitwise."""
    x, a, buf, idx, mask = _wire_case(seed)
    rng = np.random.default_rng(seed + 10)
    g_buf = rng.normal(size=buf.shape).astype(np.float32)
    g_out = rng.normal(size=a.shape).astype(np.float32)
    J, T = jnp.asarray, torch.from_numpy
    _, vjp = jax.vjp(lambda xx: halo_pack_ref(xx, J(idx), J(mask)), J(x))
    (ref_gx,) = vjp(J(g_buf))
    _, vjp = jax.vjp(lambda aa, bb: halo_unpack_add_ref(aa, bb, J(idx), J(mask)),
                     J(a), J(buf))
    ref_ga, ref_gbuf = vjp(J(g_out))

    xt = T(x).requires_grad_(True)
    (gx,) = torch.autograd.grad(hp.halo_pack(xt, T(idx), T(mask)), xt, T(g_buf))
    at, bt = T(a).requires_grad_(True), T(buf).requires_grad_(True)
    ga, gbuf = torch.autograd.grad(hp.halo_unpack_add(at, bt, T(idx), T(mask)),
                                   (at, bt), T(g_out))
    assert np.array_equal(gx.numpy(), np.asarray(ref_gx))
    assert np.array_equal(ga.numpy(), np.asarray(ref_ga))
    assert np.array_equal(gbuf.numpy(), np.asarray(ref_gbuf))
