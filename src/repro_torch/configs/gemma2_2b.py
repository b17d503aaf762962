"""Gemma-2-2B [arXiv:2408.00118]: 26L d2304, GQA 8 query heads over 4 KV
heads of dim 256, GeGLU 9216, vocab 256,000, tied embeddings, alternating
local (4,096-token window, even layers) and global attention, softcaps of
50 on the attention scores and 30 on the final logits, RMSNorms before and
after the attention and the MLP, the embedding scaled by sqrt(2304) = 48
(port of ``repro.configs.gemma2_2b``).

The reference serves it context-parallel (``attn_parallel="seq"``: 8
heads do not divide a 16-way ``model`` axis); the port serves it on one
device or over a ``model`` group of processes (``model.ParallelCtx``);
like Llama's, its configuration keeps the reference's "dots" remat policy,
which only a train step reads.
Its attention runs through kernel 6 at head dim 256.  Training it needs
a gradient through the softcap and kernel 6b at head dim 256, which the
port does not have yet (ROADMAP queue 1 item 2): train_4k and long_500k
raise here.

``build_cell(shape_id)`` is the counterpart of the reference's
``launch/dryrun.py::build_lm_cell`` for the two serving cells
(``lm_common.serve_cell``): it returns ``(step, args, meta)`` with weights
drawn on ``device`` from ``seed``.  Weights are 2.61 B parameters, 5.23 GB
in bf16; a sequence's KV cache at 32,768 positions is 3.49 GB (26 layers x
K and V x 32,768 x 4 heads x 256 x 2 B).  Cut to one H100 (80 GB), each cut
only where memory forces it, all 26 layers kept:

- prefill_32k: batch 32 -> 8 (a 27.9 GB cache, the weights and the
  prompt's activations: an MLP matrix of 262,144 tokens x 9,216 is 4.8 GB
  in bf16; 32 sequences' cache alone would be 112 GB).
- decode_32k: batch 128 -> 16 (a 55.8 GB cache filled to 32,767
  positions; 128 sequences' would be 447 GB).

``batch`` cuts the batch further (``meta["reduced"]`` records it).  Over a
model group (``ctx``) every process draws the same weights and tokens, and
the decode cell's cache is the process's shard of the one-device cell's.
"""
from __future__ import annotations

from repro_torch.configs.lm_common import serve_cell
from repro_torch.models.transformer.config import TransformerConfig

ARCH_ID = "gemma2-2b"
N_LAYERS_ONE_CARD = {"prefill_32k": 26, "decode_32k": 26}
BATCH_ONE_CARD = {"prefill_32k": 8, "decode_32k": 16}


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        vocab=256000, d_model=2304, n_layers=26,
        n_q=8, n_kv=4, head_dim=256,
        d_ff=9216, mlp_variant="geglu",
        rope_theta=10000.0,
        window=4096, window_pattern="alternate",
        attn_softcap=50.0, final_softcap=30.0,
        post_norms=True, gemma_norm=True,
        tied_embeddings=True,
        train_microbatches=4,
        attn_parallel="seq",                      # 8 heads don't divide 16
        remat="dots")


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        vocab=256, d_model=32, n_layers=2,
        n_q=4, n_kv=2, head_dim=16,
        d_ff=64, mlp_variant="geglu",
        window=8, window_pattern="alternate",
        attn_softcap=50.0, final_softcap=30.0,
        post_norms=True, gemma_norm=True,
        tied_embeddings=True,
        attn_parallel="seq",
        remat="dots")


def build_cell(shape_id: str, device="cuda", seed: int = 0, cfg: TransformerConfig = None,
               ctx=None, batch: int = None):
    """(step, args, meta) for prefill_32k or decode_32k at Gemma's full width
    and the cell's depth in ``N_LAYERS_ONE_CARD`` unless ``cfg`` is given,
    ``batch`` sequences (default ``BATCH_ONE_CARD``), over ``ctx``'s model
    group if given: ``lm_common.serve_cell``."""
    return serve_cell(ARCH_ID, config(), N_LAYERS_ONE_CARD, BATCH_ONE_CARD, shape_id, device,
                      seed, cfg, ctx, batch)
