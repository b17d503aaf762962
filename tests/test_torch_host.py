"""Host-side parity of the torch port: mesh generation, block partition,
halo plan, packed halo arrays and the compact gather layout must be
array-equal to the JAX reference package's; the port-only per-round
inverse maps of the packed halo must invert its row maps."""
import numpy as np
import pytest
import torch

from repro.core import mesh_gen as ref_mesh
from repro.core import partition as ref_part
from repro.kernels.segment_agg.ops import compact_gather_layout as ref_layout

from repro_torch.core import mesh_gen, partition
from repro_torch.core.graph_state import NMPPlan, ShardedGraph
from repro_torch.core.halo import NEIGHBOR
from repro_torch.kernels.halo_pack.ops import halo_wire
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
    # the spectral partitioner is ported (tests/test_torch_partition_quality.py
    # holds it array-equal to repro's); only an unknown method raises
    mesh = mesh_gen.box_mesh((2, 2, 2), p=2)
    assert partition.partition_mesh(mesh, (2, 1, 1), method="spectral").R == 2
    with pytest.raises(ValueError, match="spectral"):
        partition.partition_mesh(mesh, (2, 1, 1), method="metis")


def _packed_graph(elems, grid):
    """The port's partition and its packed graph on the CPU."""
    _, port = _pair(elems, grid)
    coords = mesh_gen.box_mesh(elems, p=2).coords
    plan = NMPPlan.build(port, NEIGHBOR, packed=True)
    return port, ShardedGraph.build(port, coords, plan, device="cpu")


def _gather_through_inverse(a, buf, mask, inv):
    """The unpack-add kernel's arithmetic in numpy: one gather per row."""
    out = a.copy()
    rows = np.nonzero(inv >= 0)[0]
    w = inv[rows]
    out[rows] = a[rows] + buf[w] * mask[w][:, None]
    return out


@pytest.mark.parametrize("side", ["send", "recv"])
@pytest.mark.parametrize("elems,grid", [((2, 2, 2), (2, 2, 1)),
                                        ((4, 2, 2), (2, 2, 1))])
def test_packed_inverse_inverts_every_round_and_rank(elems, grid, side):
    """The packed graph's pk{k}_{side} wire carries the pk{k}_{side}_idx /
    _mask arrays, and its inv inverts idx over the slots with a non-zero
    mask, for every round and rank, and maps no other row."""
    port, graph = _packed_graph(elems, grid)
    arrays = port.device_arrays(packed=True)
    K = len(port.halo.perms)
    assert K > 0
    for k in range(K):
        wire = graph.wire(f"pk{k}_{side}")
        idx = arrays[f"pk{k}_{side}_idx"]
        mask = arrays[f"pk{k}_{side}_mask"]
        assert np.array_equal(wire.idx.numpy(), idx)
        assert np.array_equal(wire.mask.numpy(), mask)
        inv = wire.inv.numpy()
        assert inv.dtype == np.int32 and inv.shape == (port.R, port.n_pad)
        for r in range(port.R):
            real = np.nonzero(mask[r] != 0)[0]
            assert np.array_equal(inv[r][idx[r][real]], real)
            hit = np.nonzero(inv[r] >= 0)[0]
            assert np.array_equal(np.sort(hit), np.sort(idx[r][real]))
            assert torch.equal(graph.rank(r).wire(f"pk{k}_{side}").inv, wire.inv[r])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_through_inverse_equals_scatter_add(seed):
    """The kernel's one-pass gather through the recv inverse equals the
    reference's masked scatter-add bitwise, on every round and rank of a
    2x2 partition, padding slots (index 0, mask 0) included."""
    port, graph = _packed_graph((4, 2, 2), (2, 2, 1))
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(port.n_pad, 5)).astype(np.float32)
    a[0] = -0.0
    for k in range(len(port.halo.perms)):
        for r in range(port.R):
            idx, mask, inv = (t.numpy() for t in graph.wire(f"pk{k}_recv").rank(r))
            buf = rng.normal(size=(idx.shape[0], 5)).astype(np.float32)
            want = torch.from_numpy(a).index_add(
                0, torch.from_numpy(idx).long(),
                torch.from_numpy(buf * mask[:, None])).numpy()
            got = _gather_through_inverse(a, buf, mask, inv)
            assert np.array_equal(got, want)     # -0.0 == +0.0 here too


def test_wire_inverse_edges_and_errors():
    T = torch.tensor
    idx = T([[3, 0, 0, 0], [0, 2, 0, 0]], dtype=torch.int32)
    mask = T([[1, 1, 0, 0], [1, 1, 0, 0]], dtype=torch.float32)
    wire = halo_wire(idx, mask, 5)
    assert wire.idx is idx and wire.mask is mask and wire.inv.dtype == torch.int32
    assert wire.inv.tolist() == [[1, -1, -1, 0, -1], [0, -1, 1, -1, -1]]
    assert wire.rank(1).inv.tolist() == [0, -1, 1, -1, -1]
    empty = halo_wire(torch.zeros(0, dtype=torch.int32), torch.zeros(0), 3)
    assert empty.inv.tolist() == [-1, -1, -1]
    assert torch.equal(halo_wire(idx, 0 * mask, 5).inv,
                       torch.full((2, 5), -1, dtype=torch.int32))
    with pytest.raises(ValueError, match="share a row"):
        halo_wire(T([1, 1]), T([1.0, 1.0]), 3)
    with pytest.raises(ValueError, match="outside"):
        halo_wire(T([0, 3]), T([1.0, 1.0]), 3)
    with pytest.raises(ValueError, match="mask"):
        halo_wire(T([0, 1]), T([1.0]), 3)


@pytest.mark.parametrize("elems,grid", [((2, 2, 2), (2, 2, 1)), ((4, 2, 2), (4, 1, 1))])
def test_exchange_wires_concatenate_rounds(elems, grid):
    """The packed graph's exchange wires pk_send / pk_recv are the rounds'
    pk{k}_* arrays concatenated in round order (round k from the sum of
    the earlier widths on), carry no inverse (a row may be sent in several
    rounds), and slice per rank like the round wires."""
    port, graph = _packed_graph(elems, grid)
    arrays = port.device_arrays(packed=True)
    K = len(port.halo.perms)
    for side in ("send", "recv"):
        wire = graph.wire(f"pk_{side}")
        for part, got in (("idx", wire.idx), ("mask", wire.mask)):
            want = np.concatenate([arrays[f"pk{k}_{side}_{part}"] for k in range(K)], -1)
            assert np.array_equal(got.numpy(), want)
        assert wire.inv is None
        for r in range(port.R):
            assert torch.equal(graph.rank(r).wire(f"pk_{side}").idx, wire.idx[r])
