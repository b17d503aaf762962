"""The softcap of kernel 6 at head dim 256 (Gemma-2's layers) on the CPU.

On the card the bf16 kernel at D = 256 computes ``cap * tanh(scale s /
cap)`` as ``(e - 1) / (e + 1) * cap`` with ``e = 2^(2 log2(e) scale s /
cap)`` on the special-function unit (``csrc/flash_attention.cu::
cap_score_ex2``).  Its plain mirror, ``ref.softcap_ex2`` (the same steps
with correctly rounded fp32 operations), is held here to the reference's
``softcap`` (``repro/models/transformer/layers.py``) run through JAX, at
caps 30 and 50 over scores up to 10 caps: within ``8 * 2**-23 * cap``, a
few fp32 units in the last place of the largest capped score, the
reference's own ``tanh`` being up to about 4 units from float64 (both are
also held to a float64 ``cap * tanh(x / cap)`` within the same band).
And ``attention_plain`` at D = 256 with a softcap, the version the card's
kernel is checked against, is held to a float64 attention within fp32
TOL (rtol / atol 2e-5), windows included; its row log-sum-exp within the
kernel's LSE_TOL of 2e-5.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.models.transformer.layers import softcap as ref_softcap

from repro_torch.kernels.flash_attention.ref import attention_plain, softcap_ex2


def _scores(cap, scale, seed):
    """Raw fp32 scores: uniform over |scale s| <= 10 cap, normal ones like a
    layer's (scaled N(0, 1)), and a dense run around 0."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-10 * cap, 10 * cap, 100_000) / scale,
                           rng.normal(0.0, 1.0, 100_000) / scale,
                           np.linspace(-1e-3, 1e-3, 2001) / scale]).astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 256 ** -0.5], ids=["unscaled", "d256"])
@pytest.mark.parametrize("cap", [30.0, 50.0])
def test_softcap_mirror_matches_reference(cap, scale):
    s = _scores(cap, scale, int(cap))
    band = 8 * 2.0 ** -23 * cap
    got = softcap_ex2(torch.from_numpy(s), cap, scale).double().numpy()
    ref = np.asarray(ref_softcap(jnp.asarray(s * np.float32(scale)), cap), np.float64)
    exact = cap * np.tanh(s.astype(np.float64) * scale / cap)
    assert np.abs(got - ref).max() <= band
    assert np.abs(got - exact).max() <= band
    assert np.abs(ref - exact).max() <= band


@pytest.mark.parametrize("cap", [30.0, 50.0])
def test_softcap_mirror_ends_and_sign(cap):
    """0 maps to 0, scores past the clamp to +-cap exactly (no inf * 0), and
    the sign is kept (a score so small that 2^y rounds to 1 maps to 0)."""
    s = torch.tensor([0.0, 1e-30, -1e-30, 1e4 * cap, -1e4 * cap, 3.4e38, -3.4e38])
    got = softcap_ex2(s, cap)
    assert got[0] == 0 and torch.isfinite(got).all()
    assert got[3] == cap and got[5] == cap and got[4] == -cap and got[6] == -cap
    x = torch.from_numpy(_scores(cap, 1.0, 7))
    got = softcap_ex2(x, cap)
    assert bool(((torch.sign(got) == torch.sign(x)) | (got == 0)).all())
    assert float(x[got == 0].abs().max()) < 1e-6


def _attention64(q, k, v, scale, window, cap):
    """Causal softcapped attention in float64: (out [B, S, Hq, D], row LSE
    [B, Hq, S])."""
    B, S, Hq, D = q.shape
    G = Hq // k.shape[2]
    kk = k.double().repeat_interleave(G, dim=2)
    vv = v.double().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kk) * scale
    s = cap * torch.tanh(s / cap)
    pos = torch.arange(S)
    keep = pos[:, None] >= pos[None, :]
    if window:
        keep &= (pos[:, None] - pos[None, :]) < window
    s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]), vv)
    return out, lse


@pytest.mark.parametrize("case", [(1, 200, 8, 4, 0, 50.0), (2, 130, 4, 2, 0, 30.0),
                                  (1, 300, 8, 4, 64, 50.0), (1, 257, 2, 1, 100, 30.0)],
                         ids=["global-50", "global-30-b2", "window-50", "window-30-mqa"])
def test_attention_plain_d256_softcap_matches_float64(case):
    B, S, Hq, Hkv, window, cap = case
    rng = np.random.default_rng(S + Hq)
    # q and k of std 3: scaled scores of std 9, up to about 45, where the caps bend them
    q, k, v = (torch.from_numpy(rng.normal(0, 1.0 if i == 2 else 3.0, (B, S, h, 256))
                                .astype(np.float32)) for i, h in enumerate((Hq, Hkv, Hkv)))
    scale = 256 ** -0.5
    got, lse = attention_plain(q, k, v, scale=scale, window=window, softcap=cap,
                               return_lse=True)
    want, want_lse = _attention64(q, k, v, scale, window, cap)
    torch.testing.assert_close(got.double(), want, rtol=2e-5, atol=2e-5)
    assert float((lse.double() - want_lse).abs().max()) <= 2e-5
