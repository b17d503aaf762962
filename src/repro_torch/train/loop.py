"""Run fingerprints for checkpoints (port of the fingerprint helpers of
``repro.train.loop``; the training loop itself is a later slice).

``mesh_fingerprint_hash`` hashes the global mesh (node coords + element
connectivity) exactly as the reference does, so a checkpoint written by
either package names the same mesh.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np

from repro_torch.core.gnn import GNNConfig
from repro_torch.core.graph_state import NMPPlan
from repro_torch.core.mesh_gen import SEMMesh
from repro_torch.core.partition import PartitionedGraphs


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The training-run fields a checkpoint fingerprint records, with the
    reference's defaults."""
    batch: int = 1
    lr: float = 1e-3
    halo_mode: str = "neighbor"
    seed: int = 0
    rollout_steps: int = 1
    pushforward_noise: float = 0.0
    rollout_curriculum: tuple = ()
    pushforward_noise_final: Optional[float] = None
    partitioner: str = "block"


def mesh_fingerprint_hash(sem_mesh: SEMMesh) -> str:
    """Content hash of the global mesh (node coords + element connectivity).
    Partition-independent: every rank count of the same mesh hashes
    identically."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(sem_mesh.coords).tobytes())
    h.update(np.ascontiguousarray(sem_mesh.elem_nodes).tobytes())
    return h.hexdigest()[:16]


def run_fingerprint(sem_mesh: SEMMesh, pg: PartitionedGraphs, cfg: GNNConfig,
                    tcfg: TrainConfig, plan: NMPPlan) -> dict:
    """The manifest ``extra["fingerprint"]`` a checkpoint carries."""
    return {
        "mesh_hash": mesh_fingerprint_hash(sem_mesh),
        "n_global": int(pg.n_global),
        "ranks": int(pg.R),
        "partitioner": tcfg.partitioner,
        "halo_mode": tcfg.halo_mode,
        "policy": plan.policy(),
        "seed": int(tcfg.seed),
        "batch": int(tcfg.batch),
        "lr": float(tcfg.lr),
        "rollout_steps": int(tcfg.rollout_steps),
        "rollout_curriculum": list(tcfg.rollout_curriculum),
        "pushforward_noise": float(tcfg.pushforward_noise),
        "pushforward_noise_final": tcfg.pushforward_noise_final,
        "n_levels": int(cfg.n_levels),
        "hidden": int(cfg.hidden),
    }
