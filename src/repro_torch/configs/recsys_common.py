"""RecSys-family shapes (DLRM cells); a copy of
``repro.configs.recsys_common``."""
from __future__ import annotations

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}
