"""DLRM RM2 [arXiv:1906.00091]: 13 dense + 26 sparse, dim 64,
bot 13-512-256-64, top 415-512-512-256-1, dot interaction, ~50M embedding
rows (port of ``repro.configs.dlrm_rm2``).

``build_cell(shape_id)`` is the one-device counterpart of the reference's
``build_dryrun_cell``: it returns ``(step, args, meta)`` with seeded random
weights drawn on ``device`` and concrete ``criteo_like`` inputs there, so
``step(*args)`` runs the cell.  The train step updates its state (args[0])
in place, the counterpart of the reference's donated state: RM2's params,
grads and two moments are 4 x 12.8 GB.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.recsys_common import RECSYS_SHAPES
from repro_torch.graph.datasets import criteo_like
from repro_torch.models.dlrm import DLRMConfig, dlrm_forward, init_dlrm, retrieval_score
from repro_torch.nn import value_and_grad
from repro_torch.train.optimizer import AdamWConfig, adamw_update_, init_adamw

ARCH_ID = "dlrm-rm2"


def config() -> DLRMConfig:
    return DLRMConfig(
        n_dense=13, n_sparse=26, embed_dim=64,
        bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1),
        vocab_sizes=DLRMConfig.rm2().vocab_sizes, multi_hot=1)


def smoke_config() -> DLRMConfig:
    return DLRMConfig.smoke()


def bce_loss(params, dense, sparse, labels, cfg: DLRMConfig):
    """Mean binary cross-entropy of the logits (the reference's loss_fn)."""
    logits = dlrm_forward(params, dense, sparse, cfg)
    logp = F.logsigmoid(logits)
    logn = F.logsigmoid(-logits)
    return -(labels * logp + (1 - labels) * logn).mean()


def make_train_step(cfg: DLRMConfig, opt: AdamWConfig):
    """step(state, dense, sparse, labels) -> (state, loss): BCE, autograd,
    clip + AdamW written into ``state`` in place."""
    def step(state, dense, sparse, labels):
        loss, grads = value_and_grad(bce_loss, state["params"], dense, sparse,
                                     labels, cfg)
        adamw_update_(grads, state["opt"], state["params"], opt)
        return state, loss
    return step


def build_cell(shape_id: str, device="cuda", seed: int = 0, cfg: DLRMConfig = None):
    """(step, args, meta) for one ``RECSYS_SHAPES`` cell on one device, at
    RM2's full width unless ``cfg`` is given."""
    cfg = cfg or config()
    shape = RECSYS_SHAPES[shape_id]
    B = shape["batch"]
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_dlrm(gen, cfg, device)
    dense, sparse, labels = (torch.from_numpy(a).to(device)
                             for a in criteo_like(B, cfg, seed))
    meta = dict(kind=shape["kind"], batch=B)

    if shape["kind"] == "train":
        opt = AdamWConfig()
        state = {"params": params, "opt": init_adamw(params, opt)}
        # fwd+bwd on MLPs + interactions; embedding grads are scatter updates
        meta["model_flops"] = 6 * B * _mlp_flops(cfg)
        return make_train_step(cfg, opt), (state, dense, sparse, labels), meta

    if shape["kind"] == "serve":
        @torch.no_grad()
        def step(params_, dense_, sparse_):
            return dlrm_forward(params_, dense_, sparse_, cfg)
        meta["model_flops"] = 2 * B * _mlp_flops(cfg)
        return step, (params, dense, sparse), meta

    # retrieval: 1 query vs n_candidates item embeddings
    n_cand = shape["n_candidates"]
    cand = torch.randn((n_cand, cfg.embed_dim), generator=gen, device=device)

    @torch.no_grad()
    def step(params_, dense_, sparse_, cand_):
        return retrieval_score(params_, dense_, sparse_, cand_, cfg, top_k=100)
    meta["model_flops"] = 2 * n_cand * cfg.embed_dim
    return step, (params, dense, sparse, cand), meta


def _mlp_flops(cfg: DLRMConfig) -> int:
    dims_b = (cfg.n_dense,) + cfg.bot_mlp
    dims_t = (cfg.n_interactions + cfg.bot_mlp[-1],) + cfg.top_mlp
    f = sum(a * b for a, b in zip(dims_b[:-1], dims_b[1:]))
    f += sum(a * b for a, b in zip(dims_t[:-1], dims_t[1:]))
    f += (cfg.n_sparse + 1) ** 2 * cfg.embed_dim  # interaction
    return f
