"""Spectral-element mesh generation (NekRS-style) and mesh-based graph creation.

Reproduces Sec. II-A of the paper: a box domain is discretized by
non-intersecting hexahedral (or quad, in 2D) elements, each carrying a
(p+1)^dim lattice of Gauss-Legendre-Lobatto (GLL) quadrature points. The
quadrature points become graph nodes; undirected edges connect neighboring
quadrature points along each lattice axis within every element (Fig. 2).

Coincidence structure (Fig. 3) is derived *exactly* via integer lattice
indices (element-endpoint GLL points of adjacent elements share a global
lattice index), avoiding any floating-point coordinate matching.

Host-side numpy, a copy of ``repro.core.mesh_gen``: the torch port keeps its
own so that importing it never pulls in ``repro`` (whose package import
installs JAX shims).  ``tests/test_torch_host.py`` pins the two equal.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# GLL quadrature
# ---------------------------------------------------------------------------

def gll_points(p: int) -> np.ndarray:
    """GLL nodes on [-1, 1] for polynomial order p ((p+1) points).

    Nodes are the roots of (1-x^2) P'_p(x): endpoints plus the extrema of the
    Legendre polynomial P_p.
    """
    if p < 1:
        raise ValueError("polynomial order must be >= 1")
    if p == 1:
        return np.array([-1.0, 1.0])
    # interior nodes: roots of P'_p
    cp = np.zeros(p + 1)
    cp[p] = 1.0
    dcp = np.polynomial.legendre.legder(cp)
    interior = np.polynomial.legendre.legroots(dcp)
    return np.concatenate([[-1.0], np.sort(interior), [1.0]])


# ---------------------------------------------------------------------------
# mesh / graph containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SEMMesh:
    """Box spectral-element mesh.

    Attributes:
      dim: spatial dimension (2 or 3).
      p: polynomial order.
      nelem_axes: elements per axis, length `dim`.
      elem_nodes: [n_elem, (p+1)^dim] global (deduplicated) node ids of every
        element's GLL lattice, in lexicographic lattice order.
      coords: [n_nodes, dim] physical coordinates of each unique global node.
      n_nodes: number of unique global nodes.
    """
    dim: int
    p: int
    nelem_axes: Tuple[int, ...]
    elem_nodes: np.ndarray
    coords: np.ndarray

    @property
    def n_elem(self) -> int:
        return int(self.elem_nodes.shape[0])

    @property
    def n_nodes(self) -> int:
        return int(self.coords.shape[0])

    @property
    def nodes_per_elem(self) -> int:
        return int(self.elem_nodes.shape[1])

    def element_grid_index(self, e: int) -> Tuple[int, ...]:
        """Element's (ex, ey[, ez]) grid position, lexicographic (x fastest)."""
        idx = []
        rem = e
        for n in self.nelem_axes:
            idx.append(rem % n)
            rem //= n
        return tuple(idx)


def box_mesh(nelem_axes: Tuple[int, ...], p: int, lengths: Tuple[float, ...] | None = None) -> SEMMesh:
    """Build a box SEM mesh with `nelem_axes` elements per axis at order p.

    Global node ids come from the global GLL lattice: element `ex` covers
    lattice slots `[ex*p, ex*p + p]` along each axis; adjacent elements share
    the endpoint slot — exactly the coincident-node structure of Fig. 3.
    """
    dim = len(nelem_axes)
    if dim not in (1, 2, 3):
        raise ValueError("dim must be 1, 2, or 3")
    lengths = lengths or tuple(1.0 for _ in range(dim))
    npts_axes = tuple(n * p + 1 for n in nelem_axes)  # global lattice points per axis

    # physical coordinates along each axis (per-element GLL spacing)
    ref = (gll_points(p) + 1.0) / 2.0  # [0, 1] within element
    axis_coords = []
    for ax in range(dim):
        n, L = nelem_axes[ax], lengths[ax]
        h = L / n
        c = np.empty(npts_axes[ax])
        for e in range(n):
            c[e * p:(e + 1) * p + 1] = (e + ref) * h
        axis_coords.append(c)

    # unique global nodes = full lattice
    grids = np.meshgrid(*axis_coords, indexing="ij")
    coords = np.stack([g.reshape(-1) for g in grids], axis=-1)  # lexicographic, axis0 slowest

    # strides for flattening a lattice index (axis 0 slowest, matching reshape above)
    strides = np.ones(dim, dtype=np.int64)
    for ax in range(dim - 2, -1, -1):
        strides[ax] = strides[ax + 1] * npts_axes[ax + 1]

    n_elem = int(np.prod(nelem_axes))
    local_lattice = np.stack(
        np.meshgrid(*[np.arange(p + 1)] * dim, indexing="ij"), axis=-1
    ).reshape(-1, dim)  # [(p+1)^dim, dim]

    elem_nodes = np.empty((n_elem, (p + 1) ** dim), dtype=np.int64)
    for e in range(n_elem):
        # element grid position, x fastest
        idx = []
        rem = e
        for n in nelem_axes:
            idx.append(rem % n)
            rem //= n
        base = np.array(idx, dtype=np.int64) * p  # offset per axis
        glat = local_lattice + base[None, :]
        elem_nodes[e] = (glat * strides[None, :]).sum(axis=1)

    return SEMMesh(dim=dim, p=p, nelem_axes=tuple(nelem_axes), elem_nodes=elem_nodes, coords=coords)


# ---------------------------------------------------------------------------
# graph generation
# ---------------------------------------------------------------------------

def element_lattice_edges(p: int, dim: int) -> np.ndarray:
    """Undirected lattice edges within one element: neighbors along each axis.

    Returns [n_edges, 2] pairs of *local* lattice indices (lexicographic,
    axis 0 slowest — matching `elem_nodes` ordering).
    """
    shape = (p + 1,) * dim
    ids = np.arange(np.prod(shape)).reshape(shape)
    pairs = []
    for ax in range(dim):
        a = np.take(ids, np.arange(p), axis=ax).reshape(-1)
        b = np.take(ids, np.arange(1, p + 1), axis=ax).reshape(-1)
        pairs.append(np.stack([a, b], axis=-1))
    return np.concatenate(pairs, axis=0)


def mesh_graph_edges(mesh: SEMMesh) -> np.ndarray:
    """Deduplicated undirected edges [n_edges, 2] (global ids, sorted pairs)."""
    le = element_lattice_edges(mesh.p, mesh.dim)  # [m, 2]
    src = mesh.elem_nodes[:, le[:, 0]].reshape(-1)
    dst = mesh.elem_nodes[:, le[:, 1]].reshape(-1)
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    pairs = np.unique(np.stack([lo, hi], axis=-1), axis=0)
    return pairs


def undirected_to_directed(pairs: np.ndarray) -> np.ndarray:
    """[m,2] undirected -> [2m,2] both directions (message passing form)."""
    return np.concatenate([pairs, pairs[:, ::-1]], axis=0)


def edge_features(coords: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Paper's edge feature init: relative position (dim), distance vector is
    the same thing here, plus its magnitude -> for dim=3 that is the 7-dim
    feature of Sec. III with relative node features added by the caller."""
    rel = coords[edges[:, 1]] - coords[edges[:, 0]]
    mag = np.linalg.norm(rel, axis=-1, keepdims=True)
    return np.concatenate([rel, mag], axis=-1)


def taylor_green_velocity(coords: np.ndarray, t: float = 0.0, nu: float = 0.01) -> np.ndarray:
    """Analytic Taylor-Green vortex velocity field (paper's test data source).

    For dim=3 uses the classical initial condition advected by viscous decay;
    for dim=2 the exact decaying TGV solution.
    """
    dim = coords.shape[1]
    two_pi = 2.0 * np.pi
    decay = np.exp(-2.0 * nu * (two_pi ** 2) * t)
    x = coords * two_pi
    if dim == 3:
        u = np.sin(x[:, 0]) * np.cos(x[:, 1]) * np.cos(x[:, 2])
        v = -np.cos(x[:, 0]) * np.sin(x[:, 1]) * np.cos(x[:, 2])
        w = np.zeros_like(u)
        return (np.stack([u, v, w], axis=-1) * decay).astype(np.float32)
    if dim == 2:
        u = np.sin(x[:, 0]) * np.cos(x[:, 1])
        v = -np.cos(x[:, 0]) * np.sin(x[:, 1])
        return (np.stack([u, v], axis=-1) * decay).astype(np.float32)
    return (np.sin(x) * decay).astype(np.float32)
