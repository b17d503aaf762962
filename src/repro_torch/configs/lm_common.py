"""LM input-shape cells; a copy of ``repro.configs.lm_common.LM_SHAPES``.

``lm_rules`` and ``batch_axes_for`` are the reference's sharding rules for
``jax.sharding`` meshes; the port's processes hold their shards themselves
(``models/transformer/model.py::ParallelCtx``), so it has no copy of them."""
from __future__ import annotations

LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}
