"""Minimal O(3)-irrep machinery for NequIP/MACE (l <= 3, with parity): port
of ``repro.models.gnn_zoo.irreps``.

The coupling tensors are derived *numerically* on the host, once, from
the module's own real spherical-harmonic definitions, as the reference
derives them:

  * Wigner matrices D_l(R) in the real-SH basis are obtained by least-squares
    from SH evaluations at rotated sample points (exact to fp64 round-off);
  * the CG tensor C for (l1 x l2 -> l3) is the (1-dimensional) null space of
    the equivariance constraint  C - D3^T C (D1 (x) D2)  stacked over random
    rotations, found by SVD.

The host part (``sh_l`` on numpy arrays, ``_rand_rotations``,
``wigner_d_from_R``, ``clebsch_gordan``) is the reference's numpy code,
call for call: C is an SVD null vector whose sign is whatever LAPACK
returns, so the same code on the same machine gives the same tensor as
the reference (no sign is normalised here).  The reference's
``wigner_d``, which only raises and which nothing calls, is left out.
Each C is copied to a device once and cached there (:func:`cg_on`).

The device part (the weighted and channel-wise tensor products, the
equivariant linear layer, the gate and the radial basis) computes in the
dtype of its inputs, with the weights and C cast to it, and keeps the
reference's order of contraction.  Parity bookkeeping: an irrep is
(l, p) with p = +-1; SH of a displacement carries p = (-1)^l;
tensor-product parity multiplies; E(3) selection keeps only
parity-consistent paths.  Initializers draw from a CPU
``torch.Generator`` and return the reference's tree (after its
``split_tree``: plain dicts and lists, no logical-axis leaves).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# real spherical harmonics (unnormalized but fixed convention)
# ---------------------------------------------------------------------------

def sh_l(vec, l: int):
    """Real solid harmonics of degree l for unit-ish vectors [..., 3].

    Components ordered by the reference's fixed convention.  Works on a
    numpy array or a tensor."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    if isinstance(vec, torch.Tensor):
        if l == 0:
            return torch.ones(vec.shape[:-1] + (1,), dtype=vec.dtype, device=vec.device)
        stack = torch.stack
    else:
        if l == 0:
            return np.ones(vec.shape[:-1] + (1,), vec.dtype)
        stack = np.stack
    if l == 1:
        return stack([x, y, z], axis=-1)
    if l == 2:
        return stack([
            x * y, y * z, z * x,
            x * x - y * y,
            2 * z * z - x * x - y * y,
        ], axis=-1)
    if l == 3:
        return stack([
            x * y * z,
            x * (x * x - 3 * y * y),
            y * (3 * x * x - y * y),
            z * (x * x - y * y),
            x * (4 * z * z - x * x - y * y),
            y * (4 * z * z - x * x - y * y),
            z * (2 * z * z - 3 * x * x - 3 * y * y),
        ], axis=-1)
    raise NotImplementedError(l)


def _rand_rotations(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    qs = rng.normal(size=(n, 4))
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    w, x, y, z = qs.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)


def wigner_d_from_R(l: int, R: np.ndarray) -> np.ndarray:
    """D_l(R) in our real-SH basis: Y_l(R v) = D_l(R) Y_l(v)."""
    if l == 0:
        return np.ones((1, 1))
    rng = np.random.default_rng(l * 7919 + 13)
    pts = rng.normal(size=(max(64, 4 * (2 * l + 1) ** 2), 3))
    Y = sh_l(pts, l)                      # [P, 2l+1]
    Yr = sh_l(pts @ R.T, l)               # [P, 2l+1]
    D, *_ = np.linalg.lstsq(Y, Yr, rcond=None)
    return D.T                             # Yr^T = D Y^T


@functools.lru_cache(maxsize=None)
def clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real coupling tensor C [2l1+1, 2l2+1, 2l3+1] (None if path forbidden).

    C is the null space of the *bilinear-map equivariance* constraint

        sum_{ab} D1_{aA} D2_{bB} C_{abc}  =  sum_C D3_{cC} C_{ABC}    for all R,

    which is the correct condition for ``out_c = C_{abc} x_a y_b`` to be
    covariant even though our (unnormalized real-SH) Wigner matrices are not
    orthogonal. Solved once on the host by SVD over stacked rotations.
    """
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return None
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    n = d1 * d2 * d3
    eye1, eye2, eye3 = np.eye(d1), np.eye(d2), np.eye(d3)
    rows = []
    for R in _rand_rotations(6, seed=l1 * 100 + l2 * 10 + l3):
        D1 = wigner_d_from_R(l1, R)
        D2 = wigner_d_from_R(l2, R)
        D3 = wigner_d_from_R(l3, R)
        # T1[(A,B,c),(a,b,c')] = D1_{aA} D2_{bB} delta_{c c'}
        T1 = np.einsum("aA,bB,cx->ABxabc", D1, D2, eye3).reshape(n, n)
        # T2[(A,B,c),(a',b',C)] = delta_{Aa'} delta_{Bb'} D3_{cC}
        T2 = np.einsum("Aa,Bb,cC->ABcabC", eye1, eye2, D3).reshape(n, n)
        rows.append(T1 - T2)
    A = np.concatenate(rows, axis=0)
    _, s, vt = np.linalg.svd(A)
    if s[-1] > 1e-8 * s[0]:
        return None
    c = vt[-1].reshape(d1, d2, d3)
    c = c / np.linalg.norm(c)
    return c


@functools.lru_cache(maxsize=None)
def cg_on(l1: int, l2: int, l3: int, device) -> torch.Tensor:
    """:func:`clebsch_gordan` as a float32 tensor on ``device``, made once
    per device (None where the path is forbidden)."""
    c = clebsch_gordan(l1, l2, l3)
    return None if c is None else torch.as_tensor(c, dtype=torch.float32,
                                                  device=torch.device(device))


# ---------------------------------------------------------------------------
# irreps containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Irreps:
    """List of (multiplicity, l, parity) blocks; arrays are [..., dim]."""
    blocks: Tuple[Tuple[int, int, int], ...]   # (mul, l, p)

    @staticmethod
    def make(spec: Sequence[Tuple[int, int, int]]) -> "Irreps":
        return Irreps(tuple((int(m), int(l), int(p)) for m, l, p in spec))

    @staticmethod
    def scalars(mul: int) -> "Irreps":
        return Irreps(((mul, 0, 1),))

    @property
    def dim(self) -> int:
        return sum(m * (2 * l + 1) for m, l, _ in self.blocks)

    def slices(self):
        out, off = [], 0
        for m, l, p in self.blocks:
            d = m * (2 * l + 1)
            out.append((slice(off, off + d), m, l, p))
            off += d
        return out

    def mul_of(self, l: int, p: int) -> int:
        return sum(m for m, ll, pp in self.blocks if ll == l and pp == p)


def split_irreps(x: torch.Tensor, irreps: Irreps):
    """[..., dim] -> list of [..., mul, 2l+1] blocks."""
    out = []
    for sl, m, l, p in irreps.slices():
        out.append(x[..., sl].reshape(x.shape[:-1] + (m, 2 * l + 1)))
    return out


def merge_irreps(blocks: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([b.reshape(b.shape[:-2] + (-1,)) for b in blocks], dim=-1)


def _merge_out(out_blocks, ir_out: Irreps, like: torch.Tensor) -> torch.Tensor:
    """The output blocks merged, zeros where no path reached a block."""
    full = []
    for k, (m3, l3, p3) in enumerate(ir_out.blocks):
        if out_blocks[k] is None:
            full.append(like.new_zeros(like.shape[:-1] + (m3, 2 * l3 + 1)))
        else:
            full.append(out_blocks[k])
    return merge_irreps(full)


# ---------------------------------------------------------------------------
# weighted tensor product (the NequIP/MACE workhorse)
# ---------------------------------------------------------------------------

def tp_paths(ir1: Irreps, ir2: Irreps, ir_out: Irreps, device="cpu"):
    """Allowed (i, j, k) block triples with their CG tensors on ``device``,
    in the reference's (i, j, k) loop order (the weight lists are zipped
    against it)."""
    paths = []
    for i, (m1, l1, p1) in enumerate(ir1.blocks):
        for j, (m2, l2, p2) in enumerate(ir2.blocks):
            for k, (m3, l3, p3) in enumerate(ir_out.blocks):
                if p1 * p2 != p3:
                    continue
                C = cg_on(l1, l2, l3, torch.device(device))
                if C is None:
                    continue
                paths.append((i, j, k, C))
    return paths


def normal(gen, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(device)


def init_tp_weights(gen: torch.Generator, ir1: Irreps, ir2: Irreps, ir_out: Irreps,
                    n_radial: int, device="cuda"):
    """Per-path weights modulated by a radial embedding of size n_radial.

    Weight shape per path: [n_radial, m1, m3] — 'uvu'-style (channel mixing
    from input-1 multiplicity to output multiplicity, input-2 broadcast).
    """
    ws = []
    for i, j, k, _ in tp_paths(ir1, ir2, ir_out):
        m1 = ir1.blocks[i][0]
        m3 = ir_out.blocks[k][0]
        ws.append(normal(gen, (n_radial, m1, m3), device) * (m1 * n_radial) ** -0.5)
    return {"path_w": ws}


def weighted_tensor_product(params, x1: torch.Tensor, x2: torch.Tensor,
                            radial: torch.Tensor,
                            ir1: Irreps, ir2: Irreps, ir_out: Irreps):
    """x1: [E, ir1.dim]; x2: [E, ir2.dim] (mul-1 blocks, e.g. SH); radial: [E, n_radial].

    Returns [E, ir_out.dim]. Per edge: out_k += C_{abc} (W(r) x1)_{u a} x2_b.
    """
    paths = tp_paths(ir1, ir2, ir_out, x1.device)
    b1 = split_irreps(x1, ir1)
    b2 = split_irreps(x2, ir2)
    out_blocks = [None] * len(ir_out.blocks)
    for (i, j, k, C), w in zip(paths, params["path_w"]):
        # x1 block: [E, m1, d1]; x2 block: [E, m2, d2] with m2 == 1 (SH)
        x2b = b2[j][..., 0, :]                              # [E, d2]
        x2c = torch.einsum("eb,abc->eac", x2b, C.to(x1.dtype))   # [E, d1, d3]
        t = torch.einsum("eua,eac->euc", b1[i], x2c)        # [E, m1, d3]
        # memory-aware contraction order (the reference's): the naive
        # per-edge weight tensor einsum('er,rum->eum') materializes
        # [E, m1, m3] (32 GiB at MACE's m=128 on 531k edges a device);
        # contracting radial into t first keeps the intermediate at
        # [E, m1, d3, n_radial]
        s = torch.einsum("euc,er->eucr", t, radial.to(t.dtype))
        r = torch.einsum("eucr,rum->emc", s, w.to(t.dtype))   # [E, m3, d3]
        out_blocks[k] = r if out_blocks[k] is None else out_blocks[k] + r
    return _merge_out(out_blocks, ir_out, x1)


def _linear_pairs(ir_in: Irreps, ir_out: Irreps):
    pairs = []
    for i, (m1, l1, p1) in enumerate(ir_in.blocks):
        for k, (m3, l3, p3) in enumerate(ir_out.blocks):
            if l1 == l3 and p1 == p3:
                pairs.append((i, k))
    return pairs


def init_linear_irreps(gen: torch.Generator, ir_in: Irreps, ir_out: Irreps,
                       device="cuda"):
    ws = []
    for i, k in _linear_pairs(ir_in, ir_out):
        m_in = ir_in.blocks[i][0]
        m_out = ir_out.blocks[k][0]
        ws.append(normal(gen, (m_in, m_out), device) * m_in ** -0.5)
    return {"lin_w": ws}


def linear_irreps(params, x: torch.Tensor, ir_in: Irreps, ir_out: Irreps):
    """Equivariant linear layer: mixes multiplicities within each (l, p)."""
    bin_ = split_irreps(x, ir_in)
    out_blocks = [None] * len(ir_out.blocks)
    for (i, k), w in zip(_linear_pairs(ir_in, ir_out), params["lin_w"]):
        r = torch.einsum("...ua,um->...ma", bin_[i], w.to(x.dtype))
        out_blocks[k] = r if out_blocks[k] is None else out_blocks[k] + r
    return _merge_out(out_blocks, ir_out, x)


def gate_irreps(x: torch.Tensor, ir: Irreps):
    """Equivariant gated nonlinearity: silu on scalars, each l>0 block
    scaled by the sigmoid of the mean of the first scalar block (simple,
    equivariant)."""
    blocks = split_irreps(x, ir)
    scalar = next((b for b, (m, l, p) in zip(blocks, ir.blocks) if l == 0), None)
    out = []
    for b, (m, l, p) in zip(blocks, ir.blocks):
        if l == 0:
            out.append(F.silu(b))
        elif scalar is not None:
            out.append(b * torch.sigmoid(scalar.mean(dim=(-2, -1), keepdim=True)))
        else:
            out.append(b)
    return merge_irreps(out)


def init_channel_tp_weights(gen: torch.Generator, ir1: Irreps, ir2: Irreps,
                            ir_out: Irreps, device="cuda"):
    """Channel-aligned (MACE 'uuu') tensor product weights: one scalar per
    (path, channel). Requires matching multiplicities on all three blocks."""
    ws = []
    for i, j, k, _ in tp_paths(ir1, ir2, ir_out):
        m = ir1.blocks[i][0]
        if ir2.blocks[j][0] != m or ir_out.blocks[k][0] != m:
            raise ValueError("channel TP needs equal multiplicities")
        ws.append(normal(gen, (m,), device))
    return {"ctp_w": ws}


def channel_tensor_product(params, x1: torch.Tensor, x2: torch.Tensor,
                           ir1: Irreps, ir2: Irreps, ir_out: Irreps):
    """Per-channel CG product (MACE higher-order B-basis): out_uc += w_u
    C_{abc} x1_{ua} x2_{ub}. All blocks share multiplicity."""
    paths = tp_paths(ir1, ir2, ir_out, x1.device)
    b1 = split_irreps(x1, ir1)
    b2 = split_irreps(x2, ir2)
    out_blocks = [None] * len(ir_out.blocks)
    for (i, j, k, C), w in zip(paths, params["ctp_w"]):
        d1, d2, d3 = C.shape
        outer = b1[i][..., :, None] * b2[j][..., None, :]   # [..., u, d1, d2]
        t = (outer.reshape(outer.shape[:-2] + (d1 * d2,))
             @ C.to(x1.dtype).reshape(d1 * d2, d3))         # [..., u, d3]
        t = t * w.to(x1.dtype)[:, None]
        out_blocks[k] = t if out_blocks[k] is None else out_blocks[k] + t
    return _merge_out(out_blocks, ir_out, x1)


# ---------------------------------------------------------------------------
# radial basis
# ---------------------------------------------------------------------------

def bessel_rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """NequIP's Bessel radial basis with smooth polynomial cutoff envelope."""
    r = torch.clamp(r, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    basis = torch.sin(n[None, :] * torch.pi * r[:, None] / cutoff) / r[:, None]
    u = torch.clamp(r / cutoff, 0.0, 1.0)
    env = 1 - 10 * u ** 3 + 15 * u ** 4 - 6 * u ** 5   # C2-smooth cutoff
    return basis * env[:, None]
