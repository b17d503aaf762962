"""Granite-34B-code's training path in the torch port against the JAX
reference package, on the CPU: the flash attention's gradient (the
Function whose backward is kernel 6b on the card; here its plain versions),
``lm_loss`` and its gradients, AdamW with bf16 moments, gradient
accumulation, ``make_train_step`` over micro-batches, the train and
long-context cells of ``build_cell``, and the train state's converter.

Both packages start from ``repro``'s own weights (``init_transformer`` with
``PRNGKey(0)``, carried across by ``repro_torch.convert``) and the same
numpy tokens.  Bands: fp32 losses rtol 1e-4 / atol 1e-5 and gradients rtol
1e-3 / atol 2e-5 (the reference's forward and gradient bands; the port's
one-pass softmax against the reference's blocked one only reorders sums);
bf16 losses 2e-2 (the reference's bf16 band, compiled with op-by-op
rounding as ``tests/test_torch_lm.py`` explains) and gradients within
1e-2 of each leaf's largest magnitude (the reference's per-leaf bf16
band); train states after 2 steps rtol 1e-4 / atol 1e-5 (fp32 compute:
AdamW's first steps are nearly sign(g) * lr, so a bf16 gradient's noise
would flip the update of near-zero elements).
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import granite_34b as ref_granite
from repro.models.transformer import model as ref_model
from repro.models.transformer import steps as ref_steps
from repro.models.transformer.attention import blocked_attention as ref_blocked_attention
from repro.sharding import split_tree as ref_split_tree
from repro.train import optimizer as ref_opt

from repro_torch import nn
from repro_torch.configs import granite_34b
from repro_torch.configs.lm_common import LM_SHAPES
from repro_torch.convert import (
    lm_train_state_from_jax, lm_train_state_to_jax, params_from_jax)
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models.transformer import model
from repro_torch.models.transformer.attention import blocked_attention
from repro_torch.models.transformer.steps import lm_init_train_state, make_train_step
from repro_torch.train import optimizer

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=2e-5)
BF16_LOSS, BF16_LEAF = 2e-2, 1e-2
BF16_STEP_REL = 2e-2
STRICT = {"xla_allow_excess_precision": False}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 16


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _configs(name):
    jdt, tdt = DTYPES[name]
    return (ref_granite.smoke_config().with_(param_dtype=jdt, cache_dtype=jdt),
            granite_34b.smoke_config().with_(param_dtype=tdt, cache_dtype=tdt))


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    """``repro``'s params of the smoke config, drawn once per module (a
    draw takes JAX seconds); bf16: the fp32 draw's weights rounded to bf16,
    the norm gains fp32 as ``init_transformer`` keeps them."""
    if name == "bf16":
        def cast(path, x):
            norm = any("ln" in str(k) or "norm" in str(k) for k in path)
            return x if norm else x.astype(jnp.bfloat16)
        return jax.tree_util.tree_map_with_path(cast, _ref_params("fp32"))
    ref_cfg, _ = _configs(name)
    params, _ = ref_split_tree(jax.jit(lambda k: ref_model.init_transformer(k, ref_cfg))(
        jax.random.PRNGKey(0)), {})
    return params


def _ref_train_state(ref_opt_cfg, name="fp32"):
    """``repro``'s ``lm_init_train_state`` on the cached params: the fp32
    master of every leaf and ``init_adamw``'s state."""
    master = jax.tree.map(lambda x: x.astype(jnp.float32), _ref_params(name))
    return {"params": master, "opt": ref_opt.init_adamw(master, ref_opt_cfg)}


def _tokens(vocab, seed=4, shape=(B, S)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, shape), rng.integers(0, vocab, shape)


def _leaf_close(got, want, name):
    got, want = got.float().numpy(), _np(want)
    band = BF16_LEAF * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=BF16_LEAF, atol=band, err_msg=name)


# ---------------------------------------------------------------------------
# attention's gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads", [(4, 2), (4, 1)], ids=["gqa", "mqa"])
def test_blocked_attention_grad_matches_reference(heads):
    """The reference's blocked attention (16-row tiles, S = 37 not a tile
    multiple) differentiated by JAX, against the port's blocked attention
    under autograd (its Function: the plain forward with the row LSE and
    ``attention_plain_bwd``), ``attention_plain`` under autograd and
    ``attention_plain_bwd`` called directly."""
    (Hq, Hkv), Sx, D = heads, 37, 16
    rng = np.random.default_rng(11)
    q, k, v, g = (rng.normal(size=(B, Sx, h, D)).astype(np.float32)
                  for h in (Hq, Hkv, Hkv, Hq))
    scale = D ** -0.5
    def ref_vjp(q, k, v, g):
        _, vjp = jax.vjp(lambda a, b, c: ref_blocked_attention(
            a, b, c, scale=scale, causal=True, q_block=16, kv_block=16), q, k, v)
        return vjp(g)
    want = jax.jit(ref_vjp)(q, k, v, g)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tg = torch.from_numpy(g)
    build.reset_launch_counts()
    out = blocked_attention(tq, tk, tv, scale=scale)
    got = torch.autograd.grad(out, (tq, tk, tv), tg)
    plain = fa.attention_plain(tq, tk, tv, scale=scale)
    got_plain = torch.autograd.grad(plain, (tq, tk, tv), tg)
    o, lse = fa.attention_plain(*(t.detach() for t in (tq, tk, tv)), scale=scale,
                                return_lse=True)
    got_bwd = fa.attention_plain_bwd(tq.detach(), tk.detach(), tv.detach(), o, lse, tg,
                                     scale=scale, chunk=16)
    for name, grads in (("blocked", got), ("plain autograd", got_plain),
                        ("plain_bwd", got_bwd)):
        for leaf, a, b in zip("qkv", grads, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"{name} d{leaf}",
                                       **GRAD)
    assert all(v == 0 for v in build.launch_counts.values())     # CPU: plain versions


def test_flash_attention_refuses_a_softcap_gradient():
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        fa.flash_attention(q, q.detach(), q.detach(), scale=1.0, softcap=30.0)


# ---------------------------------------------------------------------------
# lm_loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(DTYPES))
def test_lm_loss_and_grads_match_reference(name):
    ref_cfg, cfg = _configs(name)
    ctx = ref_model.ParallelCtx.single_device()
    params = _ref_params(name)
    tok, tgt = _tokens(ref_cfg.vocab)
    jt, jg = jnp.asarray(tok, jnp.int32), jnp.asarray(tgt, jnp.int32)

    def ref_fn(p):
        return ref_model.lm_loss(p, jt, jg, ref_cfg, ctx)

    fn = jax.value_and_grad(ref_fn, has_aux=True)
    (loss, aux), grads = jax.jit(fn).lower(params).compile(compiler_options=STRICT)(params)
    port = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    (got, got_aux), got_grads = nn.value_and_grad(
        lambda p: model.lm_loss(p, torch.from_numpy(tok), torch.from_numpy(tgt), cfg),
        port, has_aux=True)
    leaves = nn.tree_leaves(got_grads)
    assert len(leaves) == len(jax.tree.leaves(grads))
    if name == "fp32":
        for a, b in ((got, loss), (got_aux["ce"], aux["ce"]), (got_aux["z"], aux["z"])):
            np.testing.assert_allclose(float(a), float(b), **FWD)
        for i, (a, b) in enumerate(zip(leaves, jax.tree.leaves(grads))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"leaf {i}", **GRAD)
    else:
        np.testing.assert_allclose(float(got), float(loss), rtol=BF16_LOSS, atol=BF16_LOSS)
        for i, (a, b) in enumerate(zip(leaves, jax.tree.leaves(grads))):
            _leaf_close(a, b, f"leaf {i}")


def test_remat_full_is_bitwise_remat_none():
    """Recomputing every layer in the backward changes no bit of the loss
    or the gradients (one CPU thread: multithreaded CPU GEMMs are not
    bitwise repeatable)."""
    _, cfg = _configs("fp32")
    params = model.init_transformer(torch.Generator().manual_seed(0), cfg, "cpu")
    tok, tgt = (torch.from_numpy(t) for t in _tokens(cfg.vocab, seed=5))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for remat in ("none", "full"):
            c = cfg.with_(remat=remat)
            out[remat] = nn.value_and_grad(lambda p: model.lm_loss(p, tok, tgt, c)[0], params)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(out["none"][0], out["full"][0])
    assert all(torch.equal(a, b) for a, b in zip(nn.tree_leaves(out["none"][1]),
                                                 nn.tree_leaves(out["full"][1])))


def test_remat_dots_is_refused():
    """A configuration takes the reference's "dots" policy (Llama-3.2-3B's
    sets it and is served); the train step refuses it."""
    cfg = granite_34b.smoke_config().with_(remat="dots")
    with pytest.raises(ValueError, match="not ported"):
        make_train_step(cfg, optimizer.AdamWConfig())


# ---------------------------------------------------------------------------
# optimizer: bf16 moments, gradient accumulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moments", ["fp32", "bf16"])
def test_adamw_moments_match_reference(moments, monkeypatch):
    """Two AdamW steps of the reference and the port on the same params and
    bf16 gradients (clipped in bf16), bf16 or fp32 moments, the port's
    update chunked by elements across a leaf's rows."""
    jdt, tdt = DTYPES[moments]
    rng = np.random.default_rng(3)
    params = {"w": rng.normal(size=(3, 7, 5)).astype(np.float32),
              "ln": {"g": rng.normal(size=(5,)).astype(np.float32)}}
    ref_cfg = ref_opt.AdamWConfig(moment_dtype=jdt, weight_decay=0.1, clip_norm=0.5)
    cfg = optimizer.AdamWConfig(moment_dtype=tdt, weight_decay=0.1, clip_norm=0.5)
    ref_p = jax.tree.map(jnp.asarray, params)
    ref_state = ref_opt.init_adamw(ref_p, ref_cfg)
    port = params_from_jax(params, "cpu")
    state = optimizer.init_adamw(port, cfg)
    monkeypatch.setattr(optimizer, "CHUNK_ELEMS", 16)
    for _ in range(2):
        g = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        jg = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), g)
        ref_p, ref_state, info = ref_opt.adamw_update(jg, ref_state, ref_p, ref_cfg)
        tg = params_from_jax(jax.tree.map(np.asarray, jg), "cpu")
        port, state, got = optimizer.adamw_update_(tg, state, port, cfg)
        np.testing.assert_allclose(float(got["grad_norm"]), float(info["grad_norm"]),
                                   rtol=1e-6)
    assert state["m"]["w"].dtype == tdt and int(state["step"]) == 2
    for tree, ref in ((port, ref_p), (state["m"], ref_state["m"]),
                      (state["v"], ref_state["v"])):
        for a, b in zip(nn.tree_leaves(tree), jax.tree.leaves(ref)):
            np.testing.assert_allclose(a.float().numpy(), _np(b), rtol=1e-6, atol=1e-9)


def test_accumulate_gradients_matches_reference():
    rng = np.random.default_rng(8)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    x = rng.normal(size=(3, 5, 4)).astype(np.float32)       # [n_micro, batch, in]

    def ref_grad(p, xb):
        return jax.value_and_grad(lambda q: jnp.sum(jnp.tanh(xb @ q["w"]) ** 2))(p)

    want_l, want_g = ref_opt.accumulate_gradients(ref_grad, 3)({"w": jnp.asarray(w)},
                                                              jnp.asarray(x))

    def grad(p, xb):
        return nn.value_and_grad(lambda q: torch.sum(torch.tanh(xb @ q["w"]) ** 2), p)

    got_l, got_g = optimizer.accumulate_gradients(grad, 3)({"w": torch.from_numpy(w)},
                                                           torch.from_numpy(x))
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-6)
    np.testing.assert_allclose(got_g["w"].numpy(), np.asarray(want_g["w"]), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moments", ["fp32", "bf16"])
def test_train_step_matches_reference(moments):
    """Two steps of the reference's ``make_train_step`` (2 micro-batches)
    from ``lm_init_train_state``'s state, against the port's step from the
    same state carried across, at n_micro 2 with the compute copy cast once
    and once per micro-batch, and at n_micro 1: losses, grad norms, the
    master weights and the moments (fp32 compute, where these three forms
    differ from the reference's only in the order of sums; see the module
    docstring)."""
    ref_cfg, cfg = _configs("fp32")
    ctx = ref_model.ParallelCtx.single_device()
    jdt, tdt = DTYPES[moments]
    ref_o = ref_opt.AdamWConfig(moment_dtype=jdt)
    opt = optimizer.AdamWConfig(moment_dtype=tdt)
    ref_state = _ref_train_state(ref_o)
    batches = [tuple(_tokens(cfg.vocab, seed=20 + i)) for i in range(2)]
    ref_step = jax.jit(ref_steps.make_train_step(ref_cfg, ctx, ref_o, n_micro=2)).lower(
        ref_state, *(jnp.asarray(t, jnp.int32) for t in batches[0])).compile()
    want = []
    for tok, tgt in batches:
        ref_state, info = ref_step(ref_state, jnp.asarray(tok, jnp.int32),
                                   jnp.asarray(tgt, jnp.int32))
        want.append(info)
    for n_micro, cast_per_micro in ((2, False), (2, True), (1, False)):
        state = lm_train_state_from_jax(jax.tree.map(np.asarray, _ref_train_state(ref_o)),
                                        "cpu")
        step = make_train_step(cfg, opt, n_micro=n_micro, cast_per_micro=cast_per_micro)
        for (tok, tgt), w in zip(batches, want):
            state, got = step(state, torch.from_numpy(tok), torch.from_numpy(tgt))
            np.testing.assert_allclose(float(got["loss"]), float(w["loss"]), **FWD)
            np.testing.assert_allclose(float(got["grad_norm"]), float(w["grad_norm"]),
                                       rtol=1e-3)
            assert float(got["lr"]) == float(w["lr"])
        back = lm_train_state_to_jax(state)
        assert int(back["opt"]["step"]) == int(ref_state["opt"]["step"]) == 2
        for part in (back["params"], back["opt"]["m"], back["opt"]["v"]):
            assert all(x.dtype == (np.float32 if part is back["params"] else jdt)
                       for x in jax.tree.leaves(part))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_state)):
            np.testing.assert_allclose(_np(a), _np(b), err_msg=f"n_micro {n_micro} "
                                       f"cast_per_micro {cast_per_micro}", **FWD)


@pytest.mark.parametrize("accum", list(DTYPES))
def test_bf16_train_step_matches_reference(accum):
    """One step of the reference's bf16 ``make_train_step`` (2 micro-batches,
    the compute copy cast once, bf16 moments, ``accum_dtype`` fp32 or bf16;
    compiled with ``STRICT``) against the port's from the same state: the
    loss in the bf16 loss band, the grad norm in the per-leaf band, and the
    first moment, m = (1 - b1) x the clipped mean gradient, per leaf within
    rel L2 ``BF16_STEP_REL``.  Not elementwise: two bf16 backward passes
    part by about 1% rel L2 per leaf here, each about 1.5% from the fp32
    gradient, and a few elements by 3-4% of their leaf's largest |m|;
    every |m| is far below 1, so the per-leaf band's floor at 1 would hold
    nothing.  Whether the micro-batches are summed in fp32 is
    ``test_bf16_train_step_sums_micro_gradients_in_fp32``'s to check."""
    ref_cfg, cfg = _configs("bf16")
    ctx = ref_model.ParallelCtx.single_device()
    jdt, tdt = DTYPES[accum]
    ref_o = ref_opt.AdamWConfig(moment_dtype=jnp.bfloat16)
    opt = optimizer.AdamWConfig(moment_dtype=torch.bfloat16)
    ref_state = _ref_train_state(ref_o, "bf16")
    tok, tgt = _tokens(cfg.vocab, seed=30)
    jt, jg = jnp.asarray(tok, jnp.int32), jnp.asarray(tgt, jnp.int32)
    ref_step = jax.jit(ref_steps.make_train_step(ref_cfg, ctx, ref_o, n_micro=2,
                                                 accum_dtype=jdt))
    want_state, want = ref_step.lower(ref_state, jt, jg).compile(
        compiler_options=STRICT)(ref_state, jt, jg)
    state = lm_train_state_from_jax(jax.tree.map(np.asarray, ref_state), "cpu")
    state, got = make_train_step(cfg, opt, n_micro=2, accum_dtype=tdt)(
        state, torch.from_numpy(tok), torch.from_numpy(tgt))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=BF16_LOSS,
                               atol=BF16_LOSS)
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]),
                               rtol=BF16_LEAF)
    got_m = nn.tree_leaves(state["opt"]["m"])
    want_m = jax.tree.leaves(want_state["opt"]["m"])
    assert len(got_m) == len(want_m) and all(m.dtype == torch.bfloat16 for m in got_m)
    for i, (a, b) in enumerate(zip(got_m, want_m)):
        a, b = a.float().numpy(), _np(b)
        assert np.linalg.norm(b) > 0, f"leaf {i}"
        assert np.linalg.norm(a - b) <= BF16_STEP_REL * np.linalg.norm(b), f"leaf {i}"


@pytest.mark.parametrize("cast_per_micro", [False, True], ids=["cast_once", "cast_per_micro"])
def test_bf16_train_step_sums_micro_gradients_in_fp32(cast_per_micro):
    """The bf16 step's mean gradient is bitwise the fp32 sum of its two
    micro-batches' bf16 gradients, taken on the bf16 compute copy, over 2
    (the cast's backward only widens them, so casting per micro-batch
    gives the same bits): read from m after one AdamW step with b1 = 0, no
    clip and fp32 moments, where m is the gradient itself.  A bf16
    accumulator would round the sum (one CPU thread: multithreaded CPU
    GEMMs are not bitwise repeatable)."""
    _, cfg = _configs("bf16")
    opt = optimizer.AdamWConfig(b1=0.0, clip_norm=None)
    state = lm_init_train_state(torch.Generator().manual_seed(6), cfg, opt, "cpu")
    tok, tgt = (torch.from_numpy(t) for t in _tokens(cfg.vocab, seed=31))
    compute = nn.tree_map(lambda t: t.to(torch.bfloat16), state["params"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        g = [nn.value_and_grad(lambda p: model.lm_loss(p, tok[i:i + 1], tgt[i:i + 1],
                                                       cfg)[0], compute)[1] for i in range(2)]
        state, _ = make_train_step(cfg, opt, n_micro=2, cast_per_micro=cast_per_micro)(
            state, tok, tgt)
    finally:
        torch.set_num_threads(threads)
    want = nn.tree_map(lambda a, b: (a.float() + b.float()) / 2, g[0], g[1])
    assert all(a.dtype == torch.bfloat16 for a in nn.tree_leaves(g[0]))
    got = nn.tree_leaves(state["opt"]["m"])
    assert all(m.dtype == torch.float32 for m in got)
    assert all(torch.equal(a, b) for a, b in zip(got, nn.tree_leaves(want)))


def test_train_state_converts_both_ways_bitwise():
    ref_state = _ref_train_state(ref_opt.AdamWConfig(moment_dtype=jnp.bfloat16), "bf16")
    ref_state["opt"]["m"] = jax.tree.map(lambda x: (x + 0.3).astype(x.dtype),
                                         ref_state["opt"]["m"])
    np_state = jax.tree.map(np.asarray, ref_state)
    state = lm_train_state_from_jax(np_state, "cpu")
    assert state["params"]["embed"].dtype == torch.float32
    assert state["opt"]["m"]["embed"].dtype == torch.bfloat16
    back = lm_train_state_to_jax(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_state)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

def test_build_cell_train_4k_smoke_on_cpu(monkeypatch):
    """train_4k at the smoke config (16 micro-batches as Granite sets them,
    remat "full"), the sequence cut to 12: one step equals the same step
    built by hand from the same seed, and runs no kernel on the CPU."""
    monkeypatch.setitem(LM_SHAPES, "train_4k", dict(LM_SHAPES["train_4k"], seq_len=12))
    cfg = granite_34b.smoke_config().with_(train_microbatches=16, remat="full")
    step, (state, tokens, targets), meta = granite_34b.build_cell(
        "train_4k", device="cpu", seed=3, cfg=cfg)
    assert (meta["batch"], meta["seq"], meta["n_micro"]) == (16, 12, 16)
    assert meta["reduced"] == dict(n_layers=(88, cfg.n_layers), batch=(256, 16))
    assert meta["model_flops"] == 6 * cfg.n_params() * 16 * 12
    assert meta["opt"].moment_dtype == torch.bfloat16
    assert tokens.shape == targets.shape == (16, 12)
    assert all(t.dtype == torch.float32 for t in nn.tree_leaves(state["params"]))
    assert all(t.dtype == torch.bfloat16 for t in nn.tree_leaves(state["opt"]["m"]))
    gen = torch.Generator().manual_seed(3)
    want_state = lm_init_train_state(gen, cfg, meta["opt"], "cpu")
    assert all(torch.equal(a, b) for a, b in zip(nn.tree_leaves(state),
                                                 nn.tree_leaves(want_state)))
    build.reset_launch_counts()
    state, got = step(state, tokens, targets)
    _, want = make_train_step(cfg, meta["opt"], n_micro=16)(want_state, tokens, targets)
    assert torch.equal(got["loss"], want["loss"]) and np.isfinite(float(got["loss"]))
    assert all(torch.equal(a, b) for a, b in zip(nn.tree_leaves(state),
                                                 nn.tree_leaves(want_state)))
    assert int(state["opt"]["step"]) == 1
    assert all(v == 0 for v in build.launch_counts.values())


def test_build_cell_long_500k_smoke_on_cpu(monkeypatch):
    """long_500k at the smoke config, the cache cut to 40: B = 1 (no batch
    cut), the cache filled to 39, one decode step equal to decode_step."""
    Sx = 40
    monkeypatch.setitem(LM_SHAPES, "long_500k", dict(LM_SHAPES["long_500k"], seq_len=Sx))
    cfg = granite_34b.smoke_config()
    step, (params, cache, tokens, cache_len), meta = granite_34b.build_cell(
        "long_500k", device="cpu", seed=2, cfg=cfg)
    assert meta["reduced"] == dict(n_layers=(88, cfg.n_layers))
    assert (meta["batch"], meta["seq"], cache_len) == (1, Sx, Sx - 1)
    assert cache["k"].shape == (cfg.n_layers, 1, Sx, cfg.n_kv, cfg.head_dim)
    assert granite_34b.N_LAYERS_ONE_CARD["long_500k"] == 72
    before = {k: v.clone() for k, v in cache.items()}
    logits, cache = step(params, cache, tokens, cache_len)
    want, _ = model.decode_step(params, before, tokens, cache_len, cfg)
    torch.testing.assert_close(logits, want)
    assert logits.shape == (1, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
