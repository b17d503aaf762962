"""Kernel modules of the torch port: each plain version against the JAX
reference package on the same numpy inputs, and the CPU dispatch of every
wrapper.

Tolerances: the fused NMP forward sums in another order than the
reference, so it is held to the band the reference holds its own fused
backend to (rtol 1e-4 / atol 1e-5); the pack/unpack ops are pure data
movement and must be bitwise equal.  The kernels themselves are held
against these plain versions on the card in ``tests/test_torch_gpu.py``.
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

from repro_torch.convert import params_from_jax
from repro_torch.core.graph_state import FUSED, NMPPlan, ShardedGraph
from repro_torch.core.mesh_gen import box_mesh
from repro_torch.core.partition import partition_mesh
from repro_torch.kernels import build
from repro_torch.kernels.halo_pack import ops as hp
from repro_torch.kernels.segment_agg import ops as sa

RTOL, ATOL = 1e-4, 1e-5


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
