"""Kernel modules of the torch port: each plain version against the JAX
reference package on the same numpy inputs, and the CPU dispatch of every
wrapper.

Tolerances: the fused NMP forward sums in another order than the
reference, so it is held to the band the reference holds its own fused
backend to (rtol 1e-4 / atol 1e-5), its gradients to the reference's
gradient band (rtol 1e-3 / atol 2e-5, ``tests/test_consistency.py``); the
pack/unpack ops are pure data movement and must be bitwise equal, values
and gradients; so is the packed exchange's forward (one pack for all
rounds) against the per-round path, and within the reference's forward
band of the reference's exchange; its gradient (the reversed exchange)
sums each sender's parts in another order than autograd through the
per-round path: rtol / atol 1e-6.  The embedding bag's plain version is held to
``tests/test_kernels.py``'s ``TOL`` against the reference's interpret-mode
kernel and its oracle, and its gradient (a sorted segment sum, where the
reference's scatter-add may add duplicate rows in another order) to the
same band.  The flash-attention plain version is held to the same
``TOL`` against the reference's interpret-mode Pallas kernel and its oracle
over ``FLASH_CASES`` and an MQA case.  The kernels themselves are held against these plain
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
from repro.kernels.embedding_bag.ops import embedding_bag as ref_embedding_bag
from repro.kernels.flash_attention.ops import flash_attention as ref_flash_attention
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.embedding_bag.ref import embedding_bag_ref
from repro.core.halo import halo_sync_stacked as ref_halo_sync_stacked
from repro.kernels.halo_pack.ref import halo_pack_ref, halo_unpack_add_ref
from repro.kernels.segment_agg.ops import compact_gather_layout as ref_layout

from repro_torch.convert import params_from_jax
from repro_torch.core.graph_state import FUSED, NMPPlan, ShardedGraph
from repro_torch.core.halo import NEIGHBOR, halo_sync_stacked
from repro_torch.core.mesh_gen import box_mesh
from repro_torch.core.partition import partition_mesh
from repro_torch.kernels import build
from repro_torch.kernels.embedding_bag import ops as eb
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.halo_pack import ops as hp
from repro_torch.kernels.segment_agg import ops as sa
from repro_torch.nn import tree_leaves

from test_torch_gpu import _per_round_exchange, tile_edge_graph

RTOL, ATOL = 1e-4, 1e-5
G_RTOL, G_ATOL = 1e-3, 2e-5        # the reference's gradient band
# tests/test_kernels.py's TOL, for the embedding bag and flash attention
TOL = {jnp.float32: dict(rtol=2e-5, atol=2e-5), jnp.bfloat16: dict(rtol=2e-2, atol=2e-2)}


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


@pytest.mark.parametrize("has_ln", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("hidden,n_hidden", [(8, 0), (16, 7), (32, 0), (32, 7)])
def test_fused_nmp_plain_matches_reference_on_tile_edges(hidden, n_hidden, has_ln):
    """The graph the GPU tests build to hit the forward kernel's tile edges
    (``tests/test_torch_gpu.py::tile_edge_graph``) through the port's CPU
    forward and the reference's XLA aggregate on the same arrays, so the
    plain version the card's tests trust is held to ``repro`` there.  The
    reference's padding edges point at node 0 (mask 0), as its partitioner
    writes them; the port's layout drops them."""
    rng = np.random.default_rng(10 * hidden + n_hidden)
    src, dst, mask, inv, n = tile_edge_graph(rng)
    edge = _edge_mlp_np(rng, hidden, n_hidden, has_ln)
    x = rng.normal(size=(n, hidden)).astype(np.float32)
    e = rng.normal(size=(dst.size, hidden)).astype(np.float32)
    ref_graph = {"edge_src": jnp.asarray(src), "edge_dst": jnp.asarray(np.where(dst < n, dst, 0)),
                 "edge_mask": jnp.asarray(mask), "edge_inv_mult": jnp.asarray(inv)}
    ref_e, ref_agg = ref_agg_xla({"edge": jax.tree.map(jnp.asarray, edge)}, jnp.asarray(x),
                                 jnp.asarray(e), ref_graph, RefPlan())
    lay = sa.compact_gather_layout(src, dst, n, 32)
    T = torch.from_numpy
    e_new, agg = sa.fused_nmp_edge_agg(
        T(x), T(e), params_from_jax(edge, "cpu"), T(lay["perm"]), T(lay["src"]),
        T(lay["rowptr"]), T(mask), T(inv))
    np.testing.assert_allclose(e_new.numpy(), np.asarray(ref_e), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(agg.numpy(), np.asarray(ref_agg), rtol=RTOL, atol=ATOL)
    assert not e_new.numpy()[dst == n].any()


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
    wire = hp.halo_wire(T(idx), T(mask), x.shape[0])
    got = hp.halo_pack(T(x), wire).numpy()
    want = np.asarray(halo_pack_ref(jnp.asarray(x), jnp.asarray(idx),
                                    jnp.asarray(mask)))
    assert np.array_equal(got, want)
    got = hp.halo_unpack_add(T(a), T(buf), wire).numpy()
    want = np.asarray(halo_unpack_add_ref(jnp.asarray(a), jnp.asarray(buf),
                                          jnp.asarray(idx), jnp.asarray(mask)))
    assert np.array_equal(got, want)


def test_halo_wrappers_validate_shapes():
    x, a, buf, idx, mask = _wire_case()
    T = torch.from_numpy
    with pytest.raises(ValueError, match="buf"):
        hp.halo_unpack_add(T(a), T(buf[:-1]), hp.HaloWire(T(idx), T(mask)))
    with pytest.raises(ValueError, match="mask"):
        hp.halo_pack(T(x), hp.HaloWire(T(idx), T(mask[:-1])))


def test_cpu_wrappers_never_launch_kernels():
    build.reset_launch_counts()
    x, a, buf, idx, mask = _wire_case()
    T = torch.from_numpy
    wire = hp.halo_wire(T(idx), T(mask), x.shape[0])
    hp.halo_pack(T(x), wire)
    hp.halo_unpack_add(T(a), T(buf), wire)
    lp, xx, e, _, port_g = _layer_case(8, 2)
    sa.fused_nmp_edge_agg(*_fused_args(lp, xx, e, port_g, "cpu"))
    table = torch.randn(10, 4, requires_grad=True)
    eb.embedding_bag(table, torch.zeros(3, 2, dtype=torch.int32)).sum().backward()
    dst = np.arange(40) % 13
    layout = sa.dst_aligned_layout(dst, 13, 8, 16)
    sa.fused_edge_mlp_agg(torch.randn(40, 6), torch.from_numpy(dst), torch.ones(40),
                          torch.randn(6, 5), torch.zeros(5), torch.randn(5, 4),
                          torch.zeros(4), layout, n_nodes=13, block_n=8, block_e=16)
    assert all(v == 0 for v in build.launch_counts.values())


# ---------------------------------------------------------------------------
# embedding bag
# ---------------------------------------------------------------------------

def _bag_case(shape, dtype, seed=1):
    """tests/test_kernels.py's inputs: (jax table, jax idx, torch table, idx)."""
    B, H, V, D = shape
    rng = np.random.default_rng(seed)
    table = jnp.asarray(rng.normal(size=(V, D)), dtype)
    idx = jnp.asarray(rng.integers(0, V, (B, H)), jnp.int32)
    # the same values in torch: bf16 is exact in fp32
    t = torch.from_numpy(np.array(table, np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return table, idx, t, torch.from_numpy(np.array(idx))


@pytest.mark.parametrize("shape", [(8, 4, 64, 32), (16, 1, 256, 16), (4, 8, 128, 8)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_embedding_bag_plain_matches_reference(shape, dtype):
    table, idx, t, ti = _bag_case(shape, dtype)
    got = eb.embedding_bag(t, ti)                 # CPU tensors: the plain version
    assert got.dtype == t.dtype and torch.equal(got, eb.embedding_bag_plain(t, ti))
    got = got.float().numpy()
    for want in (ref_embedding_bag(table, idx, interpret=True),
                 embedding_bag_ref(table, idx)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("shape", [(8, 4, 64, 32), (16, 1, 256, 16), (40, 8, 24, 8)])
def test_embedding_bag_grad_matches_jax(shape):
    table, idx, t, ti = _bag_case(shape, jnp.float32)
    g = np.random.default_rng(2).normal(size=(shape[0], shape[3])).astype(np.float32)
    (want,) = jax.vjp(lambda tb: embedding_bag_ref(tb, idx), table)[1](jnp.asarray(g))
    t.requires_grad_(True)
    (got,) = torch.autograd.grad(eb.embedding_bag(t, ti), t, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[jnp.float32])


def test_embedding_bag_validates_inputs():
    t = torch.randn(10, 4)
    with pytest.raises(ValueError, match="idx \\[B, H\\]"):
        eb.embedding_bag(t, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="table \\[V, D\\]"):
        eb.embedding_bag(t[0], torch.zeros(3, 1, dtype=torch.int32))
    for bad in (10, -1):     # ids outside [0, V) raise; the kernel traps on them
        with pytest.raises(IndexError):
            eb.embedding_bag(t, torch.tensor([[0, bad]], dtype=torch.int32))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

# tests/test_kernels.py's FLASH_CASES (B, Sq, Skv, Hq, Hkv, D, causal, window,
# softcap, bq, bk), and an MQA case (G = 8) in the layout of Granite's
FLASH_CASES = [
    (1, 128, 128, 2, 2, 64, True, 0, None, 32, 32),
    (2, 96, 96, 4, 2, 32, True, 0, None, 32, 16),
    (1, 160, 160, 2, 1, 64, True, 48, None, 32, 32),
    (1, 64, 64, 2, 2, 128, False, 0, 30.0, 32, 32),
    (1, 72, 72, 1, 1, 16, True, 0, None, 16, 16),
    (1, 80, 80, 8, 1, 128, True, 0, None, 16, 16),
]


def _attn_case(case, dtype):
    B, Sq, Skv, Hq, Hkv, D = case[:6]
    rng = np.random.default_rng(0)
    arrs = [jnp.asarray(rng.normal(size=(B, S, H, D)), dtype)
            for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv))]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return arrs, [torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in arrs]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_attention_plain_matches_reference(case, dtype):
    B, Sq, Skv, Hq, Hkv, D, caus, win, cap, bq, bk = case
    (q, k, v), (tq, tk, tv) = _attn_case(case, dtype)
    kw = dict(scale=D ** -0.5, causal=caus, window=win, softcap=cap)
    got = fa.flash_attention(tq, tk, tv, **kw)       # CPU tensors: the plain version
    assert got.dtype == tq.dtype and got.shape == (B, Sq, Hq, D)
    assert torch.equal(got, fa.attention_plain(tq, tk, tv, **kw))
    G = Hq // Hkv
    oracle = attention_ref(q.transpose(0, 2, 1, 3),
                           jnp.repeat(k.transpose(0, 2, 1, 3), G, 1),
                           jnp.repeat(v.transpose(0, 2, 1, 3), G, 1),
                           **kw).transpose(0, 2, 1, 3)
    for want in (ref_flash_attention(q, k, v, block_q=bq, block_k=bk, interpret=True, **kw),
                 oracle):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   **TOL[dtype])


def test_attention_plain_row_chunks_agree():
    case = FLASH_CASES[2]
    _, (tq, tk, tv) = _attn_case(case, jnp.float32)
    kw = dict(scale=64 ** -0.5, causal=True, window=48)
    torch.testing.assert_close(fa.attention_plain(tq, tk, tv, chunk=37, **kw),
                               fa.attention_plain(tq, tk, tv, **kw), rtol=1e-6, atol=1e-6)


def test_flash_attention_validates_inputs():
    q, kv = torch.randn(1, 8, 4, 16), torch.randn(1, 8, 2, 16)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        fa.flash_attention(q, torch.randn(1, 8, 3, 16), torch.randn(1, 8, 3, 16), scale=1.0)
    with pytest.raises(ValueError, match="same B and D"):
        fa.flash_attention(q, kv[..., :8], kv[..., :8], scale=1.0)
    # keys of their own length are taken (the context-parallel shape)
    assert torch.equal(fa.flash_attention(q, kv[:, :7], kv[:, :7], scale=1.0),
                       fa.attention_plain(q, kv[:, :7], kv[:, :7], scale=1.0))
    with pytest.raises(ValueError, match="expected q"):
        fa.flash_attention(q, kv, kv[..., :8], scale=1.0)
    with pytest.raises(TypeError, match="differ"):
        fa.flash_attention(q, kv.double(), kv.double(), scale=1.0)
    with pytest.raises(ValueError, match="softcap"):
        fa.flash_attention(q, kv, kv, scale=1.0, softcap=-1.0)
    # a gradient goes through the plain versions on the CPU (no kernel)
    build.reset_launch_counts()
    out = fa.flash_attention(q.requires_grad_(), kv, kv, scale=1.0)
    assert out.grad_fn is not None
    out.sum().backward()
    assert q.grad.shape == q.shape and bool(torch.isfinite(q.grad).all())
    with torch.no_grad():
        fa.flash_attention(q, kv, kv, scale=1.0)
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
    wire = hp.halo_wire(T(idx), T(mask), x.shape[0])
    (gx,) = torch.autograd.grad(hp.halo_pack(xt, wire), xt, T(g_buf))
    at, bt = T(a).requires_grad_(True), T(buf).requires_grad_(True)
    ga, gbuf = torch.autograd.grad(hp.halo_unpack_add(at, bt, wire),
                                   (at, bt), T(g_out))
    assert np.array_equal(gx.numpy(), np.asarray(ref_gx))
    assert np.array_equal(ga.numpy(), np.asarray(ref_ga))
    assert np.array_equal(gbuf.numpy(), np.asarray(ref_gbuf))


# ---------------------------------------------------------------------------
# the packed halo exchange (one pack for all rounds; the reversed exchange)
# ---------------------------------------------------------------------------

EXCHANGE_GRIDS = [(2, 2, 1), (4, 1, 1)]


def _exchange_case(grid, f=8, seed=0):
    """Both packages' packed 2x2 / 4x1 partitions of a small box mesh, the
    port's packed plan and graph (CPU), and a stacked aggregate."""
    sem = ref_box_mesh((4, 2, 2), p=2)
    ref_pg = ref_partition_mesh(sem, grid)
    pg = partition_mesh(box_mesh((4, 2, 2), p=2), grid)
    plan = NMPPlan.build(pg, NEIGHBOR, packed=True)
    graph = ShardedGraph.build(pg, sem.coords, plan, device="cpu")
    a = np.random.default_rng(seed).normal(size=(pg.R, pg.n_pad, f)).astype(np.float32)
    return sem, ref_pg, plan, graph, a


@pytest.mark.parametrize("grid", EXCHANGE_GRIDS, ids=["2x2", "4x1"])
def test_exchange_wire_pack_bitwise_reference(grid):
    """The exchange wires' plain pack (every round of every rank, one call)
    equals, bitwise, the concatenation of the reference's pack of each
    round and rank over the reference's own packed arrays."""
    sem, ref_pg, plan, graph, a = _exchange_case(grid)
    ref_arrays = ref_pg.device_arrays(packed=True)
    K = len(plan.halo.perms)
    for side in ("send", "recv"):
        wire = graph.wire(f"pk_{side}")
        got = hp._pack(torch.from_numpy(a), wire.idx, wire.mask).numpy()
        want = np.concatenate([np.stack([np.asarray(halo_pack_ref(
            jnp.asarray(a[r]), jnp.asarray(ref_arrays[f"pk{k}_{side}_idx"][r]),
            jnp.asarray(ref_arrays[f"pk{k}_{side}_mask"][r]))) for r in range(ref_pg.R)])
            for k in range(K)], axis=1)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("grid", EXCHANGE_GRIDS, ids=["2x2", "4x1"])
def test_packed_exchange_forward_bitwise_per_round_and_reference(grid):
    """halo_sync_stacked's packed exchange: bitwise equal to a pack and an
    unpack-add per round and receiver, and within the reference's band of
    the reference's halo_sync_stacked over its dense neighbor wires (its
    packed Pallas path does not run in interpret mode on this JAX; its own
    tests hold packed and dense bitwise equal)."""
    sem, ref_pg, plan, graph, a = _exchange_case(grid, seed=1)
    got = halo_sync_stacked(torch.from_numpy(a), graph, plan.halo)
    assert torch.equal(got, _per_round_exchange(torch.from_numpy(a), graph, plan))
    ref_plan = RefPlan.build(ref_pg, "neighbor")
    want = ref_halo_sync_stacked(jnp.asarray(a), RefGraph.build(ref_pg, sem.coords, ref_plan),
                                 ref_plan.halo)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("grid", EXCHANGE_GRIDS, ids=["2x2", "4x1"])
def test_packed_exchange_grad_matches_per_round_autograd(grid):
    """The exchange's backward (one pack of the gradient through the recv
    wire, then each round's unpack-add onto its senders, seeded with the
    gradient) against autograd through the per-round path, against
    jax.vjp of the reference's (dense neighbor) exchange, and gradcheck in
    float64."""
    sem, ref_pg, plan, graph, a = _exchange_case(grid, f=4, seed=2)
    g = np.random.default_rng(3).normal(size=a.shape).astype(np.float32)
    build.reset_launch_counts()
    x = torch.from_numpy(a).requires_grad_(True)
    (got,) = torch.autograd.grad(halo_sync_stacked(x, graph, plan.halo), x, torch.from_numpy(g))
    x = torch.from_numpy(a).requires_grad_(True)
    (want,) = torch.autograd.grad(_per_round_exchange(x, graph, plan), x, torch.from_numpy(g))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    ref_plan = RefPlan.build(ref_pg, "neighbor")
    ref_graph = RefGraph.build(ref_pg, sem.coords, ref_plan)
    _, vjp = jax.vjp(lambda v: ref_halo_sync_stacked(v, ref_graph, ref_plan.halo),
                     jnp.asarray(a))
    (ref_g,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_g), rtol=1e-6, atol=1e-6)
    x64 = torch.from_numpy(a[..., :2]).double().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda v: halo_sync_stacked(v, graph, plan.halo), (x64,))
    assert all(v == 0 for v in build.launch_counts.values())
