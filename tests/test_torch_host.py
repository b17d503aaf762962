"""Host-side parity of the torch port: mesh generation, block partition,
halo plan, packed halo arrays and the compact gather layout must be
array-equal to the JAX reference package's."""
import numpy as np
import pytest

from repro.core import mesh_gen as ref_mesh
from repro.core import partition as ref_part
from repro.kernels.segment_agg.ops import compact_gather_layout as ref_layout

from repro_torch.core import mesh_gen, partition
from repro_torch.kernels.segment_agg.ops import compact_gather_layout

CASES = [((2, 2, 2), (1, 1, 1)), ((2, 2, 2), (2, 2, 1)),
         ((4, 2, 2), (1, 1, 1)), ((4, 2, 2), (4, 1, 1)),
         ((4, 2, 2), (2, 2, 1))]


def _pair(elems, grid, p=2):
    return (ref_part.partition_mesh(ref_mesh.box_mesh(elems, p=p), grid),
            partition.partition_mesh(mesh_gen.box_mesh(elems, p=p), grid))


@pytest.mark.parametrize("p", [1, 2, 7])
def test_mesh_gen_matches_reference(p):
    a, b = ref_mesh.box_mesh((2, 3, 2), p=p), mesh_gen.box_mesh((2, 3, 2), p=p)
    assert np.array_equal(a.coords, b.coords)
    assert np.array_equal(a.elem_nodes, b.elem_nodes)
    assert np.array_equal(ref_mesh.mesh_graph_edges(a), mesh_gen.mesh_graph_edges(b))
    d = ref_mesh.undirected_to_directed(ref_mesh.mesh_graph_edges(a))
    assert np.array_equal(ref_mesh.edge_features(a.coords, d),
                          mesh_gen.edge_features(b.coords, d))
    assert np.array_equal(ref_mesh.taylor_green_velocity(a.coords, t=0.3),
                          mesh_gen.taylor_green_velocity(b.coords, t=0.3))


@pytest.mark.parametrize("elems,grid", CASES)
def test_device_arrays_match_reference(elems, grid):
    ref, port = _pair(elems, grid)
    a = ref.device_arrays(seg_layout=(16, 32), packed=True)
    b = port.device_arrays(seg_layout=(16, 32), packed=True)
    assert set(a) <= set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k]), k
    for k in ("global_ids", "n_global", "R"):
        assert np.array_equal(getattr(ref, k), getattr(port, k)), k
    assert ref.halo.perms == port.halo.perms


@pytest.mark.parametrize("elems,grid", CASES)
def test_rank_graphs_match_reference(elems, grid):
    ma, mb = ref_mesh.box_mesh(elems, p=2), mesh_gen.box_mesh(elems, p=2)
    R = int(np.prod(grid))
    ga = ref_part.from_element_partition(
        ma, ref_part.partition_elements(ma, grid), R)
    gb = partition.from_element_partition(
        mb, partition.partition_elements(mb, grid), R)
    for x, y in zip(ga, gb):
        for f in ("global_ids", "edges", "edge_inv_mult", "node_inv_mult"):
            u, v = getattr(x, f), getattr(y, f)
            assert u.dtype == v.dtype and np.array_equal(u, v), f


@pytest.mark.parametrize("block_e", [8, 32])
def test_compact_layout_matches_reference_and_rowptr(block_e):
    rng = np.random.default_rng(0)
    n = 37
    src = rng.integers(0, n, 200)
    dst = rng.integers(0, n, 200)
    dst[::7] = n                                  # padding edges: dropped
    a = ref_layout(src, dst, n, block_e)
    b = compact_gather_layout(src, dst, n, block_e)
    for k in ("perm", "src", "dst", "n_tiles", "block_e", "n_edges"):
        assert np.array_equal(a[k], b[k]), k
    # rowptr delimits each node's run of dst-sorted slots
    d = b["dst"].reshape(-1)[:b["n_edges"]]
    for node in range(n):
        lo, hi = b["rowptr"][node], b["rowptr"][node + 1]
        assert np.all(d[lo:hi] == node)
    assert b["rowptr"][-1] == b["n_edges"]


def test_gather_scatter_roundtrip_matches_reference():
    ref, port = _pair((4, 2, 2), (2, 2, 1))
    x = np.random.default_rng(1).normal(size=(port.n_global, 3)).astype(np.float32)
    xa, xb = ref_part.gather_node_features(ref, x), partition.gather_node_features(port, x)
    assert np.array_equal(xa, xb)
    assert np.array_equal(partition.scatter_node_outputs(port, xb), x)


def test_spectral_partitioner_not_ported_raises():
    with pytest.raises(NotImplementedError, match="spectral"):
        partition.partition_mesh(mesh_gen.box_mesh((2, 2, 2), p=2), (2, 1, 1),
                                 method="spectral")
