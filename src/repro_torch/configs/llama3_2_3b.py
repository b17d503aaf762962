"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-3B]: 28L d3072, GQA 24 query heads
over 8 KV heads of dim 128, SwiGLU 8192, vocab 128,256, RoPE theta 500,000,
tied embeddings (port of ``repro.configs.llama3_2_3b``).

The reference serves it context-parallel (``attn_parallel="seq"``: 24
heads do not divide a 16-way ``model`` axis) and trains it under the
"dots" remat policy; the port serves it on one device or over a ``model``
group of processes (``model.ParallelCtx``), and its train step refuses
"dots" (ROADMAP queue 1 item 2).

``build_cell(shape_id)`` is the counterpart of the reference's
``launch/dryrun.py::build_lm_cell`` for the two serving cells: it returns
``(step, args, meta)`` with weights drawn on ``device`` from ``seed``, so
``step(*args)`` runs the cell.  Weights are 3.21 B parameters, 6.43 GB in
bf16; a sequence's KV cache at 32,768 positions is 3.76 GB (28 layers x K
and V x 32,768 x 8 heads x 128 x 2 B).  Cut to one H100 (80 GB), each cut
only where memory forces it, all 28 layers kept:

- prefill_32k: batch 32 -> 8 (a 30.1 GB cache and the prompt's
  activations; 32 sequences' cache alone would be 120 GB).
- decode_32k: batch 128 -> 16 (a 60.1 GB cache filled to 32,767
  positions; 128 sequences' would be 481 GB).

``batch`` cuts the batch further (``meta["reduced"]`` records it): processes
of a model group that share one card hold a sequence each.  Over a model
group (``ctx``) every process draws the same weights and tokens, and the
decode cell's cache is the process's shard of the one-device cell's.
"""
from __future__ import annotations

from repro_torch.configs.lm_common import serve_cell
from repro_torch.models.transformer.config import TransformerConfig

ARCH_ID = "llama3.2-3b"
N_LAYERS_ONE_CARD = {"prefill_32k": 28, "decode_32k": 28}
BATCH_ONE_CARD = {"prefill_32k": 8, "decode_32k": 16}


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        vocab=128256, d_model=3072, n_layers=28,
        n_q=24, n_kv=8, head_dim=128,
        d_ff=8192, mlp_variant="swiglu",
        rope_theta=500000.0,
        tied_embeddings=True,
        train_microbatches=4,
        attn_parallel="seq",                      # 24 heads don't divide 16
        remat="dots")


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        vocab=256, d_model=32, n_layers=2,
        n_q=4, n_kv=2, head_dim=16,
        d_ff=64, mlp_variant="swiglu",
        tied_embeddings=True,
        attn_parallel="seq",
        remat="dots")


def build_cell(shape_id: str, device="cuda", seed: int = 0, cfg: TransformerConfig = None,
               ctx=None, batch: int = None):
    """(step, args, meta) for prefill_32k or decode_32k at Llama's full width
    and the cell's depth in ``N_LAYERS_ONE_CARD`` unless ``cfg`` is given,
    ``batch`` sequences (default ``BATCH_ONE_CARD``), over ``ctx``'s model
    group if given: ``lm_common.serve_cell``."""
    return serve_cell(ARCH_ID, config(), N_LAYERS_ONE_CARD, BATCH_ONE_CARD, shape_id, device,
                      seed, cfg, ctx, batch)
