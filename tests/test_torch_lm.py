"""Granite-34B-code's serving path in the torch port against the JAX
reference package, at the smoke config on the CPU: forward, prefill (logits
and KV cache), decode steps, the greedy serving loop, the cell builder,
the bf16 converter and the layers that differ between the frameworks.

Both packages start from ``repro``'s own params (``init_transformer`` with
``PRNGKey(0)``, carried across bitwise by ``repro_torch.convert``) and the
same numpy tokens.  fp32 (``param_dtype`` and ``cache_dtype`` fp32) holds
the algorithm: rtol 1e-4 / atol 1e-5, the reference's forward band (the
port's one-pass softmax against the reference's blocked one: only the
summation order differs).  bf16 is held to rtol / atol 2e-2, the
reference's own band for bf16 prefill + decode
(``tests/test_transformer.py``).  XLA by default lets a jitted bf16 chain
skip the roundings between fused ops ("excess precision"), where PyTorch
rounds after every op; the reference is therefore compiled here with
``xla_allow_excess_precision=False``, which rounds op by op as its eager
semantics do; with XLA's default the two differ by more than the band.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import granite_34b as ref_granite
from repro.models.transformer import model as ref_model
from repro.models.transformer.layers import apply_rope as ref_apply_rope
from repro.sharding import split_tree as ref_split_tree

from repro_torch.configs import get_arch, granite_34b
from repro_torch.configs.lm_common import LM_SHAPES
from repro_torch.convert import params_from_jax
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_plain
from repro_torch.models.transformer import model
from repro_torch.models.transformer.layers import apply_rope, gelu_tanh
from repro_torch.models.transformer.steps import (
    greedy_generate, make_decode_step, make_prefill_step)

BANDS = {"fp32": dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
STRICT = {"xla_allow_excess_precision": False}
B, S_PRE, S_TOTAL = 2, 8, 12


def _ref_jit(fn, *args):
    """``fn(*args)`` compiled by XLA with op-by-op rounding (see above)."""
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)(*args)


def _close(got, want, band, msg=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               err_msg=msg, **band)


def _configs(name):
    jdt, tdt = DTYPES[name]
    return (ref_granite.smoke_config().with_(param_dtype=jdt, cache_dtype=jdt),
            granite_34b.smoke_config().with_(param_dtype=tdt, cache_dtype=tdt))


@pytest.fixture(scope="module", params=list(DTYPES))
def run(request):
    """Both packages' forward, prefill and decode steps on the same params
    and tokens, in one dtype."""
    name = request.param
    ref_cfg, cfg = _configs(name)
    ctx = ref_model.ParallelCtx.single_device()
    params, _ = ref_split_tree(ref_model.init_transformer(jax.random.PRNGKey(0), ref_cfg), {})
    port = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    tok = np.random.default_rng(4).integers(0, ref_cfg.vocab, (B, S_TOTAL))
    jt, tt = jnp.asarray(tok, jnp.int32), torch.from_numpy(tok)
    out = dict(name=name, band=BANDS[name])
    out["ref_fwd"], _ = _ref_jit(lambda p, t: ref_model.forward(p, t, ref_cfg, ctx), params, jt)
    out["ref_last"], cache = _ref_jit(
        lambda p, t: ref_model.prefill_step(p, t, ref_cfg, ctx, capacity=S_TOTAL),
        params, jt[:, :S_PRE])
    out["ref_cache0"] = jax.tree.map(np.asarray, cache["layers"])
    build.reset_launch_counts()
    out["fwd"] = model.forward(port, tt, cfg)
    out["last"], pcache = make_prefill_step(cfg, S_TOTAL)(port, tt[:, :S_PRE])
    out["cache0"] = {k: v.clone() for k, v in pcache.items()}
    decode = make_decode_step(cfg)
    out["ref_dec"], out["dec"] = [], []
    for i in range(S_PRE, S_TOTAL):
        logits, cache = _ref_jit(
            lambda p, c, t, n: ref_model.decode_step(p, c, t, n, ref_cfg, ctx),
            params, cache, jt[:, i:i + 1], jnp.int32(i))
        out["ref_dec"].append((np.asarray(logits, np.float32),
                               jax.tree.map(np.asarray, cache["layers"])))
        logits, pcache = decode(port, pcache, tt[:, i:i + 1], i)
        out["dec"].append((logits, {k: v.clone() for k, v in pcache.items()}))
    out["launches"] = dict(build.launch_counts)
    return out


def test_forward_matches_reference(run):
    assert run["fwd"].shape == (B, S_TOTAL, 256)
    _close(run["fwd"], run["ref_fwd"], run["band"])


def test_prefill_matches_reference(run):
    _close(run["last"], run["ref_last"], run["band"])
    for leaf in ("k", "v"):
        assert run["cache0"][leaf].shape == run["ref_cache0"][leaf].shape
        _close(run["cache0"][leaf], run["ref_cache0"][leaf], run["band"], leaf)
        assert not run["cache0"][leaf][:, :, S_PRE:].any()     # the rest still empty


def test_decode_steps_match_reference(run):
    for i, ((got, cache), (want, ref_cache)) in enumerate(zip(run["dec"], run["ref_dec"])):
        _close(got, want, run["band"], f"decode step {i}")
        for leaf in ("k", "v"):
            _close(cache[leaf], ref_cache[leaf], run["band"], f"{leaf} after step {i}")


def test_prefill_then_decode_matches_forward(run):
    """The port against itself, as the reference's own test holds itself."""
    _close(run["last"], run["fwd"][:, S_PRE - 1].float().numpy(), run["band"])
    for i, (logits, _) in enumerate(run["dec"]):
        _close(logits[:, 0], run["fwd"][:, S_PRE + i].float().numpy(), run["band"],
               f"decode step {i}")
    assert all(v == 0 for v in run["launches"].values())   # CPU: plain versions


def test_greedy_generate_matches_reference_loop():
    """``examples/serve_lm.py``'s loop: prefill, then greedy decode; the
    generated tokens equal (fp32)."""
    ref_cfg, cfg = _configs("fp32")
    ctx = ref_model.ParallelCtx.single_device()
    params, _ = ref_split_tree(ref_model.init_transformer(jax.random.PRNGKey(1), ref_cfg), {})
    prompts = np.random.default_rng(5).integers(0, ref_cfg.vocab, (3, 10))
    gen_len = 6
    prefill = jax.jit(lambda p, t: ref_model.prefill_step(p, t, ref_cfg, ctx,
                                                          capacity=10 + gen_len))
    decode = jax.jit(lambda p, c, t, n: ref_model.decode_step(p, c, t, n, ref_cfg, ctx))
    # tokens go back through the host each step, as a server reads them
    logits, cache = prefill(params, jnp.asarray(prompts, jnp.int32))
    tok = np.asarray(jnp.argmax(logits, axis=-1))[:, None]
    want = [tok]
    for i in range(gen_len - 1):
        logits, cache = decode(params, cache, jnp.asarray(tok, jnp.int32), jnp.int32(10 + i))
        tok = np.asarray(jnp.argmax(logits[:, 0], axis=-1))[:, None]
        want.append(tok)
    port = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    got = greedy_generate(port, torch.from_numpy(prompts), cfg, gen_len)
    assert got.shape == (3, gen_len)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=1))


def test_forward_takes_another_attention():
    """The plain attention through ``forward(attention=)``, as the full-width
    check on the card runs it, gives the default path's logits."""
    _, cfg = _configs("fp32")
    params = model.init_transformer(torch.Generator().manual_seed(0), cfg, "cpu")
    tok = torch.randint(0, cfg.vocab, (1, 20), generator=torch.Generator().manual_seed(1))
    want = model.forward(params, tok, cfg)
    got = model.forward(params, tok, cfg,
                        attention=lambda q, k, v, scale, **kw: attention_plain(
                            q, k, v, scale=scale, causal=True, chunk=7))
    torch.testing.assert_close(got, want, **BANDS["fp32"])


@pytest.mark.parametrize("name", list(DTYPES))
def test_rope_matches_reference_at_long_positions(name):
    jdt, tdt = DTYPES[name]
    x = np.random.default_rng(6).normal(size=(2, 5, 3, 128)).astype(np.float32)
    pos = np.array([[0, 1, 4095, 32766, 32767], [7, 100, 2047, 16384, 32000]])
    want = ref_apply_rope(jnp.asarray(x, jdt), jnp.asarray(pos), 10000.0)
    got = apply_rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos), 10000.0)
    # fp32: the angle is the same fp32 product; cos/sin of up to 3.3e4 rad
    # differ by a few ulps between the two libraries
    band = dict(rtol=1e-5, atol=1e-5) if name == "fp32" else BANDS["bf16"]
    _close(got, want, band)


def test_gelu_tanh_matches_reference():
    x = np.random.default_rng(7).normal(size=(4096,)).astype(np.float32) * 3
    want = jax.nn.gelu(jnp.asarray(x, jnp.bfloat16), approximate=True)
    got = gelu_tanh(torch.from_numpy(x).to(torch.bfloat16))
    assert torch.equal(got.float(), torch.from_numpy(np.asarray(want, np.float32)))
    want = jax.nn.gelu(jnp.asarray(x), approximate=True)
    _close(gelu_tanh(torch.from_numpy(x)), want, dict(rtol=1e-6, atol=1e-6))


def test_bf16_params_convert_bitwise():
    ref_cfg, _ = _configs("bf16")
    params, _ = ref_split_tree(ref_model.init_transformer(jax.random.PRNGKey(2), ref_cfg), {})
    np_tree = jax.tree.map(np.asarray, params)
    port = params_from_jax(np_tree, "cpu")
    want = np_tree["layers"]["ffn"]["wi"]
    got = port["layers"]["ffn"]["wi"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    # fp32 leaves (the norm gains) stay fp32 and equal
    assert port["final_norm"]["g"].dtype == torch.float32
    assert np.array_equal(port["final_norm"]["g"].numpy(), np_tree["final_norm"]["g"])


@pytest.mark.parametrize("name", ["full", "smoke", "one card"])
def test_param_count_matches_reference(name):
    ref_cfg = ref_granite.config() if name != "smoke" else ref_granite.smoke_config()
    cfg = granite_34b.config() if name != "smoke" else granite_34b.smoke_config()
    if name == "one card":
        ref_cfg = ref_cfg.with_(n_layers=granite_34b.N_LAYERS_ONE_CARD["decode_32k"])
        cfg = cfg.with_(n_layers=granite_34b.N_LAYERS_ONE_CARD["decode_32k"])
    assert cfg.n_params() == ref_cfg.n_params()
    if name == "one card":
        assert cfg.n_params() == 16_980_639_744     # 33.96 GB in bf16
    for f in ("vocab", "d_model", "n_layers", "n_q", "n_kv", "head_dim", "d_ff",
              "rope_theta", "norm_eps"):
        assert getattr(cfg, f) == getattr(ref_cfg, f), f


@pytest.mark.parametrize("shape_id", ["prefill_32k", "decode_32k"])
def test_build_cell_smoke_on_cpu(shape_id, monkeypatch):
    """The cell builder at the smoke config, with the sequence cut to 24
    so that the CPU runs it; its step equals the model's functions."""
    S = 24
    monkeypatch.setitem(LM_SHAPES, shape_id, dict(LM_SHAPES[shape_id], seq_len=S))
    mod, family = get_arch("granite-34b")
    assert mod is granite_34b and family == "lm"
    cfg = granite_34b.smoke_config()
    step, args, meta = granite_34b.build_cell(shape_id, device="cpu", seed=3, cfg=cfg)
    Bc = granite_34b.BATCH_ONE_CARD[shape_id]
    ref_B = LM_SHAPES[shape_id]["global_batch"]
    assert (meta["batch"], meta["seq"], meta["n_layers"]) == (Bc, S, cfg.n_layers)
    assert meta["cfg"] == cfg
    assert meta["reduced"] == dict(n_layers=(88, cfg.n_layers), batch=(ref_B, Bc))
    params = args[0]
    build.reset_launch_counts()
    if shape_id == "prefill_32k":
        tokens = args[1]
        assert tokens.shape == (Bc, S) and meta["model_flops"] == 2 * cfg.n_params() * Bc * S
        logits, cache = step(*args)
        assert logits.shape == (Bc, cfg.vocab) and cache["k"].shape[2] == S
        torch.testing.assert_close(logits, model.forward(params, tokens, cfg)[:, -1])
    else:
        cache, tokens, cache_len = args[1:]
        assert cache_len == S - 1 and tokens.shape == (Bc, 1)
        assert cache["k"].shape == (cfg.n_layers, Bc, S, cfg.n_kv, cfg.head_dim)
        assert bool((cache["k"][:, :, :S - 1] != 0).all()) and not cache["k"][:, :, S - 1].any()
        assert meta["model_flops"] == 2 * cfg.n_params() * Bc
        before = {k: v.clone() for k, v in cache.items()}
        logits, cache = step(*args)
        assert logits.shape == (Bc, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
        assert cache["k"][:, :, S - 1].any()                        # written in place
        want, _ = model.decode_step(params, before, tokens, cache_len, cfg)
        torch.testing.assert_close(logits, want)
    assert all(v == 0 for v in build.launch_counts.values())


@pytest.mark.parametrize("shape_id", ["train_4k", "long_500k"])
def test_build_cell_refuses_cells_not_ported(shape_id):
    """Every LM cell is ported to one card; what stays refused by name is
    a shape the table does not hold and a gradient through the reference's
    "dots" remat policy (the train cell).  A serving cell takes "dots", as
    Llama-3.2-3B's config sets it."""
    with pytest.raises(ValueError, match="not ported"):
        granite_34b.build_cell(shape_id + "_sharded", device="cpu",
                               cfg=granite_34b.smoke_config())
    dots = granite_34b.smoke_config().with_(remat="dots")
    if LM_SHAPES[shape_id]["kind"] == "train":
        with pytest.raises(ValueError, match="not ported"):
            granite_34b.build_cell(shape_id, device="cpu", cfg=dots)
    else:
        assert granite_34b.build_cell(shape_id, device="cpu", cfg=dots)[2]["cfg"] is dots
