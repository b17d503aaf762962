"""Consistent loss (Sec. II-C, Eq. 6) and consistent node reductions, port
of ``repro.core.consistent_loss``.

Squared errors are weighted by inverse node multiplicity 1/d_i (padding
rows carry weight 0), summed locally, then AllReduce'd over the graph
group together with N_eff = sum_i 1/d_i, which makes the partitioned MSE
equal the un-partitioned Eq. 5 value.  ``group`` is a mesh's graph group
(:class:`repro_torch.launch.mesh.Group`); ``group=None`` sums over this
process's arrays alone (one rank, or a stacked [R, ...] input summed over
every rank directly) with the arithmetic of a single process.
Data-parallel averaging is applied by the caller on the already-consistent
loss (``core/distributed.py``).
"""
from __future__ import annotations

import torch


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group.  Its backward is a sum too: the incoming
    gradient is AllReduce'd, as JAX transposes ``psum`` under
    ``shard_map(check_vma=False)``.

    So with the loss L_d of replica d replicated on its R graph ranks, the
    process of rank q computes d(sum of the R copies of L_d)/d theta_q =
    R * dL_d/d theta_q (theta_q: its own copy of the parameters; the halo
    exchanges' reversals carry the other ranks' paths to it).  The loss's
    mean over the D replicas, the same reduction divided by D, passes
    each L_d the gradient D / D = 1.  The average over all R * D processes,
    (1 / RD) sum_d sum_q R dL_d/d theta_q = (1 / D) sum_d dL_d/d theta, is
    then exactly the gradient of the data-mean loss
    (``core/distributed.py::average_gradients``), as the reference's
    ``pmean`` over every axis is (``repro/core/distributed.py:72-76``).
    """

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous()), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (identity for None)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def consistent_mse(y: torch.Tensor, y_hat: torch.Tensor,
                   node_inv_mult: torch.Tensor, group=None) -> torch.Tensor:
    """Eq. 6 on [N_pad, Fy] or [B, N_pad, Fy] (batch mean). Returns a scalar,
    the same on every process of ``group``."""
    fy = y.shape[-1]
    err2 = ((y - y_hat) ** 2).sum(dim=-1)             # [..., N_pad]
    s = (err2 * node_inv_mult).sum(dim=-1)            # Eq. 6b
    if s.dim():
        s = s.mean()
    s = all_reduce_sum(s, group)                      # AllReduce #1
    n_eff = all_reduce_sum(node_inv_mult.sum(), group)  # AllReduce #2 (Eq. 6c)
    return s / (n_eff * fy)


def consistent_node_sum(values: torch.Tensor, node_inv_mult: torch.Tensor,
                        group=None) -> torch.Tensor:
    """Partition-invariant sum over graph nodes of a node field
    ([N_pad, ...] -> [...])."""
    w = node_inv_mult[(...,) + (None,) * (values.dim() - 1)]
    return all_reduce_sum((values * w).sum(dim=0), group)


def consistent_node_count(node_inv_mult: torch.Tensor, group=None) -> torch.Tensor:
    """N_eff of Eq. 6c: equals the un-partitioned node count."""
    return all_reduce_sum(node_inv_mult.sum(), group)
