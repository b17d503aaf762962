"""The port's spectral partitioner, partition quality metrics, wire-byte
metric and block-size table against the JAX reference package.

* ``spectral_node2part`` (R = 2, 3, 4, 8, two seeds) and ``mesh_node2part``
  array-equal to ``repro``'s on the reference tests' stretched mesh
  (``box_mesh((8, 2, 2), p=2, lengths=(4, 1, 1))``) and on a generic graph
  (a seeded random edge list with self-loops, duplicates and an isolated
  node); the degenerate cases (one part, no edges) too.
* ``partition_mesh(method="spectral")`` and ``partition_graph`` (block,
  spectral, an explicit ``node2part`` with an empty rank) array-equal to
  ``repro``'s, every array of the partition and its halo plan.
* ``partition_quality`` equal to ``repro``'s, key by key, on block and
  spectral splits; on the reference's longer stretched mesh at 4 ranks the
  spectral split holds less halo volume than the block grid (its
  criterion).
* ``PartitionedGraphs.wire_bytes`` equal to ``repro``'s for a2a, neighbor
  and packed neighbor, fp32 and bf16 wires, at two widths.
* ``pick_block_sizes``: the CPU rows equal to ``repro``'s, the
  ``REPRO_SEG_BLOCKS`` override, bf16 going twice as deep, and
  ``NMPPlan.autotune_blocks``.

Inputs are numpy from a seed.
"""
import importlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import partition as ref_part
from repro.core.mesh_gen import box_mesh as ref_box_mesh
from repro.core.mesh_gen import mesh_graph_edges as ref_mesh_graph_edges
from repro.kernels.segment_agg.ops import pick_block_sizes as ref_pick_block_sizes

from repro_torch.core import partition as part
from repro_torch.core.graph_state import NMPPlan
from repro_torch.core.mesh_gen import box_mesh, mesh_graph_edges
from repro_torch.kernels.segment_agg import ops as sa

# ``repro.core`` re-exports the function under the module's name
ref_pq = importlib.import_module("repro.core.partition_quality")
pq = importlib.import_module("repro_torch.core.partition_quality")

PG_FIELDS = ("global_ids", "node_mask", "node_inv_mult", "edge_src", "edge_dst",
             "edge_mask", "edge_inv_mult")
HALO_FIELDS = ("a2a_send_idx", "a2a_send_mask", "a2a_recv_idx", "a2a_recv_mask",
               "nbr_send_idx", "nbr_send_mask", "nbr_recv_idx", "nbr_recv_mask")


def _stretched(mod):
    return mod((8, 2, 2), p=2, lengths=(4.0, 1.0, 1.0))


def _generic_graph(n=60, m=200, seed=3):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n - 1, size=(m, 2))        # node n-1 isolated
    e[:5, 1] = e[:5, 0]                            # self-loops
    return n, np.concatenate([e, e[:7]])           # duplicates


def _assert_pg_equal(got, want):
    assert (got.R, got.n_global) == (want.R, want.n_global)
    for f in PG_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in HALO_FIELDS:
        a, b = getattr(got.halo, f), getattr(want.halo, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert [list(map(tuple, p)) for p in got.halo.perms] == \
        [list(map(tuple, p)) for p in want.halo.perms]


@pytest.mark.parametrize("R", [2, 3, 4, 8])
@pytest.mark.parametrize("seed", [0, 5])
def test_spectral_node2part_array_equal_stretched_mesh(R, seed):
    edges = mesh_graph_edges(_stretched(box_mesh))
    ref_edges = ref_mesh_graph_edges(_stretched(ref_box_mesh))
    np.testing.assert_array_equal(edges, ref_edges)
    n = int(edges.max()) + 1
    got = pq.spectral_node2part(n, edges, R, seed=seed)
    want = ref_pq.spectral_node2part(n, ref_edges, R, seed=seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("R", [1, 2, 3, 5])
def test_spectral_node2part_array_equal_generic_graph(R):
    n, e = _generic_graph()
    np.testing.assert_array_equal(pq.spectral_node2part(n, e, R),
                                  ref_pq.spectral_node2part(n, e, R))


def test_spectral_node2part_degenerate_and_refusals():
    empty = np.zeros((0, 2), dtype=np.int64)
    np.testing.assert_array_equal(pq.spectral_node2part(9, empty, 3),
                                  ref_pq.spectral_node2part(9, empty, 3))
    assert pq.spectral_node2part(0, empty, 4).shape == (0,)
    with pytest.raises(ValueError, match="n_parts"):
        pq.spectral_node2part(4, empty, 0)
    with pytest.raises(ValueError, match="outside"):
        pq.spectral_node2part(3, np.array([[0, 3]]), 2)


@pytest.mark.parametrize("R", [2, 4])
def test_mesh_node2part_array_equal(R):
    np.testing.assert_array_equal(pq.mesh_node2part(_stretched(box_mesh), R),
                                  ref_pq.mesh_node2part(_stretched(ref_box_mesh), R))


@pytest.mark.parametrize("grid", [(2, 1, 1), (2, 2, 1), (3, 1, 1)])
def test_partition_mesh_spectral_array_equal(grid):
    got = part.partition_mesh(_stretched(box_mesh), grid, method="spectral")
    want = ref_part.partition_mesh(_stretched(ref_box_mesh), grid, method="spectral")
    _assert_pg_equal(got, want)
    # a vertex cut: every edge on one rank (d_ij == 1)
    assert np.all(got.edge_inv_mult[got.edge_mask > 0] == 1.0)


def test_partition_mesh_unknown_method_refused():
    with pytest.raises(ValueError, match="unknown partition method"):
        part.partition_mesh(box_mesh((2, 2, 1), p=2), (2, 1, 1), method="metis")


@pytest.mark.parametrize("how", ["block", "spectral", "node2part", "src"])
def test_partition_graph_array_equal(how):
    n, e = _generic_graph()
    kw = {"method": how} if how in ("block", "spectral") else {}
    if how == "node2part":
        kw["node2part"] = np.random.default_rng(1).integers(0, 2, n)   # rank 2 empty
    if how == "src":
        kw["assign"] = "src"
    got = part.partition_graph(n, e, 3, **kw)
    want = ref_part.partition_graph(n, e, 3, **kw)
    _assert_pg_equal(got, want)


@pytest.mark.parametrize("grid,method", [((2, 2, 1), "block"), ((4, 1, 1), "block"),
                                         ((2, 2, 1), "spectral"), ((3, 1, 1), "spectral")])
def test_partition_quality_equal(grid, method):
    got = pq.partition_quality(part.partition_mesh(_stretched(box_mesh), grid,
                                                   method=method))
    want = ref_pq.partition_quality(ref_part.partition_mesh(_stretched(ref_box_mesh),
                                                            grid, method=method))
    assert got == want


def test_spectral_cuts_halo_volume_on_stretched_mesh():
    """The reference's criterion (tests/test_partition_quality.py): on
    ``box_mesh((16, 2, 2), p=2, lengths=(8, 1, 1))`` at (2, 2, 1) the
    spectral split holds less halo volume than the block grid."""
    mesh = box_mesh((16, 2, 2), p=2, lengths=(8.0, 1.0, 1.0))
    block = pq.partition_quality(part.partition_mesh(mesh, (2, 2, 1)))
    spectral = pq.partition_quality(part.partition_mesh(mesh, (2, 2, 1),
                                                        method="spectral"))
    assert spectral["halo_volume"] < block["halo_volume"]
    assert spectral["empty_ranks"] == 0 and spectral["imbalance"] < 1.8


@pytest.mark.parametrize("method", ["block", "spectral"])
@pytest.mark.parametrize("mode,packed", [("a2a", False), ("neighbor", False),
                                         ("neighbor", True)])
@pytest.mark.parametrize("wire", [None, "bfloat16"])
@pytest.mark.parametrize("feat", [1, 8])
def test_wire_bytes_equal(method, mode, packed, wire, feat):
    got = part.partition_mesh(_stretched(box_mesh), (2, 2, 1), method=method)
    want = ref_part.partition_mesh(_stretched(ref_box_mesh), (2, 2, 1), method=method)
    ref_wire = None if wire is None else jnp.bfloat16
    assert got.wire_bytes(mode, packed, feat, wire) == \
        want.wire_bytes(mode, packed, feat, ref_wire)
    # a torch dtype names the same wire
    if wire is not None:
        assert got.wire_bytes(mode, packed, feat, torch.bfloat16) == \
            got.wire_bytes(mode, packed, feat, wire)


def test_wire_bytes_refusals_and_bf16_halves():
    pg = part.partition_mesh(box_mesh((4, 2, 2), p=2), (2, 2, 1))
    with pytest.raises(ValueError, match="neighbor-only"):
        pg.wire_bytes("a2a", packed=True)
    with pytest.raises(ValueError, match="unknown halo mode"):
        pg.wire_bytes("ring")
    with pytest.raises(ValueError, match="wire dtype"):
        pg.wire_bytes("a2a", wire_dtype="int4")
    full = pg.wire_bytes("neighbor", True, 8)
    half = pg.wire_bytes("neighbor", True, 8, torch.bfloat16)
    assert [2 * v for v in half["per_rank"]] == full["per_rank"]


@pytest.mark.parametrize("hidden", [8, 32, 64, 128, 256, 512, 8192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pick_block_sizes_cpu_rows_equal(hidden, dtype, monkeypatch):
    monkeypatch.delenv(sa.BLOCKS_ENV, raising=False)
    got = sa.pick_block_sizes(hidden, getattr(torch, dtype), backend="cpu")
    assert got == ref_pick_block_sizes(hidden, getattr(jnp, dtype), backend="cpu")


def test_pick_block_sizes_override_cuda_row_and_plan(monkeypatch):
    monkeypatch.delenv(sa.BLOCKS_ENV, raising=False)
    bn, be = sa.pick_block_sizes(32, torch.float32, backend="cuda")
    assert (bn, be) == sa.BLOCK_TABLE["cuda"][0][1:]
    assert bn <= sa.MLP_AGG_MAX_BLOCK_N
    assert sa.pick_block_sizes(32, torch.bfloat16, backend="cuda") == (bn, 2 * be)
    monkeypatch.setenv(sa.BLOCKS_ENV, "48,96")
    assert sa.pick_block_sizes(32, torch.float32, backend="cuda") == (48, 96)
    assert ref_pick_block_sizes(32, jnp.float32) == (48, 96)
    plan = NMPPlan(backend="fused").autotune_blocks(32)
    assert (plan.block_n, plan.block_e) == (48, 96)
