"""DLRM RM2 [arXiv:1906.00091] on one device (port of ``repro.models.dlrm``):
sparse embedding bags + dot interaction + MLPs.

The reference builds its lookup from ``take`` + ``segment_sum`` and
row-shards the table inside a ``shard_map``; on one card the port runs it
as the reference does with ``mesh=None``: one lookup over all ``B*F`` bags,
one launch of the embedding-bag kernel (``kernels/embedding_bag``) per
forward.  Sharded lookups come with ``ROADMAP.md`` queue item 2.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.embedding_bag.ops import embedding_bag


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    bot_mlp: Tuple[int, ...] = (512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 256, 1)
    # per-field vocabulary sizes (Criteo-like log-uniform spread)
    vocab_sizes: Tuple[int, ...] = ()
    multi_hot: int = 1          # indices per field (bag size)
    name: str = "dlrm-rm2"

    @staticmethod
    def rm2(total_rows: int = 50_000_000, n_sparse: int = 26) -> "DLRMConfig":
        # log-spread vocabularies summing to ~total_rows; the concatenated
        # table is padded to a multiple of 4096 rows, as the reference pads
        # it for row-sharding
        w = np.logspace(0, 3.2, n_sparse)
        w = w / w.sum()
        sizes = [int(max(128, round(total_rows * wi))) for wi in w]
        total = sum(sizes)
        pad = (-total) % 4096
        sizes[-1] += pad
        return DLRMConfig(vocab_sizes=tuple(sizes))

    @staticmethod
    def smoke() -> "DLRMConfig":
        return DLRMConfig(
            n_dense=13, n_sparse=4, embed_dim=16,
            bot_mlp=(32, 16), top_mlp=(32, 1),
            vocab_sizes=(64, 128, 256, 512), multi_hot=2, name="dlrm-smoke")

    @property
    def n_interactions(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2


def init_dlrm(generator: torch.Generator, cfg: DLRMConfig, device="cuda"):
    """Parameter tree drawn on ``generator``'s device (a CUDA generator
    draws RM2's 3.2 B table entries on the card) and moved to ``device``:
    the reference's tree and distributions, N(0, 0.01^2) table rows,
    N(0, 1/d_in) weights, zero biases; fp32."""
    total = sum(cfg.vocab_sizes)
    table = torch.randn((total, cfg.embed_dim), generator=generator,
                        device=generator.device).mul_(0.01)
    return {
        # one concatenated table [sum(vocab), D] with per-field offsets
        "tables": table.to(device),
        "bot": _init_mlp_stack(generator, cfg.n_dense, cfg.bot_mlp, device),
        "top": _init_mlp_stack(generator, cfg.n_interactions + cfg.bot_mlp[-1],
                               cfg.top_mlp, device),
    }


def _init_mlp_stack(generator, d_in, dims, device):
    layers = []
    for d in dims:
        w = torch.randn((d_in, d), generator=generator,
                        device=generator.device) * d_in ** -0.5
        layers.append({"w": w.to(device), "b": torch.zeros(d, device=device)})
        d_in = d
    return layers


def _mlp_stack(layers, x, final_act=False):
    for i, p in enumerate(layers):
        x = x @ p["w"] + p["b"]
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def field_offsets(cfg: DLRMConfig) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(cfg.vocab_sizes)[:-1]]).astype(np.int32)


def dlrm_interact(params, dense: torch.Tensor, emb: torch.Tensor, cfg: DLRMConfig):
    """Bottom MLP + dot interaction + top MLP given looked-up bags [B, F, D]."""
    bot = _mlp_stack(params["bot"], dense)                     # [B, D]
    feats = torch.cat([bot[:, None, :], emb], dim=1)           # [B, F+1, D]
    inter = torch.bmm(feats, feats.transpose(1, 2))            # [B, F+1, F+1]
    iu, ju = torch.triu_indices(cfg.n_sparse + 1, cfg.n_sparse + 1, 1,
                                device=inter.device)
    inter_flat = inter[:, iu, ju]
    top_in = torch.cat([bot, inter_flat], dim=-1)
    return _mlp_stack(params["top"], top_in)


def lookup_local(table: torch.Tensor, idx: torch.Tensor, cfg: DLRMConfig):
    """idx [B, F, H] global row ids -> bags [B, F, D]: one kernel launch over
    the B*F bags (the reference's unsharded ``lookup_local``)."""
    B = idx.shape[0]
    out = embedding_bag(table, idx.reshape(B * cfg.n_sparse, cfg.multi_hot))
    return out.reshape(B, cfg.n_sparse, cfg.embed_dim)


def dlrm_forward(params, dense: torch.Tensor, sparse_idx: torch.Tensor,
                 cfg: DLRMConfig):
    """dense: [B, n_dense]; sparse_idx: [B, n_sparse, multi_hot] int32 global
    row ids (field offsets already applied).  Returns logits [B, 1]."""
    emb = lookup_local(params["tables"], sparse_idx, cfg)
    return dlrm_interact(params, dense, emb, cfg)


def retrieval_score(params, dense: torch.Tensor, sparse_idx: torch.Tensor,
                    cand_emb: torch.Tensor, cfg: DLRMConfig, top_k: int = 100):
    """Score 1 query against n_candidates item embeddings: user tower ->
    batched dot -> top-k.  cand_emb: [n_cand, D].  Returns (values, ids)."""
    bot = _mlp_stack(params["bot"], dense)                     # [1, D]
    scores = (cand_emb @ bot[0]).float()                       # [n_cand]
    return torch.topk(scores, top_k)


__all__ = ["DLRMConfig", "dlrm_forward", "dlrm_interact", "field_offsets",
           "init_dlrm", "lookup_local", "retrieval_score"]
