"""Gemma-2-2B's serving path in the torch port against the JAX reference
package, on the CPU: GeGLU, the tanh softcap, kernel 6's plain version at
head dim 256 with a sliding window and a softcap of 50 (against the Pallas
kernel in interpret mode), and the forward, prefill, decode steps and
greedy loop of the smoke config and of a head-dim-256 variant on one
device and over a ``model`` group of gloo processes (context-parallel
prefill, sequence-sharded decode, ``launch/lm_checks.py``).  The prompt
(16 tokens) is longer than the local layers' window (8), so those layers
truncate in the prefill and in every decode step, and a planted fault (the
window one key wider) must leave the band.

The reference's mesh runs need 4 host devices, which JAX fixes when it
starts; so, as ``tests/test_torch_lm_seq.py`` does, this file also runs
the reference as a script (``python tests/test_torch_gemma.py OUT``) on
one device and on ``(1, 2)`` and ``(1, 4)`` ``("data", "model")`` meshes
and pickles the results.  Both packages start from ``repro``'s params
(``PRNGKey(0)``, carried by ``convert.params_from_jax``) and the same numpy
tokens.  Bands: fp32 rtol 1e-4 / atol 1e-5 (the reference's forward
band), bf16 rtol / atol 2e-2 with the reference compiled op by op
(``xla_allow_excess_precision=False``).  The port's processes of one model
group must agree bitwise.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import gemma2_2b as ref_gemma
from repro.kernels.flash_attention.ops import flash_attention as ref_flash_attention
from repro.launch.mesh import make_mesh as ref_make_mesh
from repro.models.transformer import model as ref_model
from repro.models.transformer.attention import blocked_attention as ref_blocked_attention
from repro.models.transformer.layers import ffn as ref_ffn
from repro.models.transformer.layers import softcap as ref_softcap
from repro.sharding import split_tree as ref_split_tree

from repro_torch.configs import get_arch, gemma2_2b
from repro_torch.configs.lm_common import LM_SHAPES
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch import lm_checks as lmx
from repro_torch.models.transformer import attention as attn
from repro_torch.models.transformer import model
from repro_torch.models.transformer.layers import ffn, softcap

ROOT = Path(__file__).resolve().parents[1]
BANDS = {"fp32": dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
STRICT = {"xla_allow_excess_precision": False}
# prompts [B, S_PRE] then STEPS decode steps: S_PRE and S_PRE + STEPS split
# over 2 and 4 shards; S_PRE is twice the configurations' window
B, S_PRE, STEPS = 2, 16, 4
# the reference's configurations by name: (dtype, config); "d256" is the
# smoke config at head dim 256
RUNS = {"smoke": "fp32", "smoke_bf16": "bf16", "d256": "fp32"}


def _ref_config(run):
    jdt = DTYPES[RUNS[run]][0]
    cfg = ref_gemma.smoke_config().with_(param_dtype=jdt, cache_dtype=jdt)
    if run == "d256":
        cfg = cfg.with_(d_model=64, head_dim=256, d_ff=128)
    return cfg


def _config(run, **kw):
    tdt = DTYPES[RUNS[run]][1]
    cfg = gemma2_2b.smoke_config().with_(param_dtype=tdt, cache_dtype=tdt, **kw)
    if run == "d256":
        cfg = cfg.with_(d_model=64, head_dim=256, d_ff=128)
    return cfg


def _close(got, want, band, msg=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), err_msg=msg, **band)


def _in_band(got, want, band):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    return bool(np.allclose(got, np.asarray(want, np.float32), **band))


# ---------------------------------------------------------------------------
# the reference's runs (this file run as a script)
# ---------------------------------------------------------------------------

def _ref_serve(params, tok, cfg, ctx, greedy=False):
    """The reference's prefill of tok[:, :S_PRE] and STEPS decode steps fed
    tok's next columns, compiled op by op; with ``greedy`` also the logits
    of the same steps fed the greedy tokens."""
    def compiled(fn, *args):
        return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)
    prefill = compiled(lambda p, t: ref_model.prefill_step(p, t, cfg, ctx,
                                                          capacity=S_PRE + STEPS),
                       params, tok[:, :S_PRE])
    last, cache = prefill(params, tok[:, :S_PRE])
    decode = compiled(lambda p, c, t, n: ref_model.decode_step(p, c, t, n, cfg, ctx),
                      params, cache, tok[:, :1], jnp.int32(0))
    out = dict(cache0={k: np.asarray(v, np.float32) for k, v in cache["layers"].items()})
    for key in ("logits", "greedy")[:1 + greedy]:
        last, cache = prefill(params, tok[:, :S_PRE])
        logits = [np.asarray(last, np.float32)]
        for i in range(STEPS):
            feed = (jnp.asarray(logits[-1].argmax(-1)[:, None], jnp.int32) if key == "greedy"
                    else tok[:, S_PRE + i:S_PRE + i + 1])
            lg, cache = decode(params, cache, feed, jnp.int32(S_PRE + i))
            logits.append(np.asarray(lg[:, 0], np.float32))
        out[key] = np.stack(logits, 1)
    return out


def _reference_main(path):
    ctx1 = ref_model.ParallelCtx.single_device()
    meshes = {n: ref_model.ParallelCtx(mesh=ref_make_mesh((1, n), ("data", "model")),
                                       batch_axes=("data",), rules={}) for n in (2, 4)}
    res = {}
    for run in RUNS:
        cfg = _ref_config(run)
        params, _ = ref_split_tree(ref_model.init_transformer(jax.random.PRNGKey(0), cfg), {})
        tok = np.random.default_rng(4).integers(0, cfg.vocab, (B, S_PRE + STEPS))
        jt = jnp.asarray(tok, jnp.int32)
        fwd = jax.jit(lambda p, t: ref_model.forward(p, t, cfg, ctx1)[0]).lower(
            params, jt).compile(compiler_options=STRICT)
        res[run] = dict(params=jax.tree.map(np.asarray, params), tokens=tok,
                        forward=np.asarray(fwd(params, jt), np.float32),
                        one=_ref_serve(params, jt, cfg, ctx1, greedy=run == "smoke"),
                        mesh4=_ref_serve(params, jt, cfg, meshes[4]))
        if run != "smoke_bf16":
            res[run]["mesh2"] = _ref_serve(params, jt, cfg, meshes[2])
    with open(path, "wb") as fh:
        pickle.dump(res, fh)


# ---------------------------------------------------------------------------
# fixtures: the reference's runs, the port's world of 4 processes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("gemma") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, __file__, str(out)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(out, "rb") as fh:
        return pickle.load(fh)


def _job(ref, run, cases, **kw):
    r = ref[run]
    return lmx.Job(cases=cases, cfg=lmx.cfg_dict(_config(run)), arch=gemma2_2b.ARCH_ID,
                   params=r["params"], prompts=r["tokens"][:, :S_PRE],
                   feed=r["tokens"][:, S_PRE:], steps=STEPS, return_cache=True,
                   device="cpu", **kw)


@pytest.fixture(scope="module")
def world(ref):
    """One spawn of 4 gloo processes: the smoke config in fp32 over data 2 x
    model 2 and model 4, in bf16 over model 4, and the head-dim-256 variant
    over data 2 x model 2 and model 4; each process's records by case."""
    jobs = (_job(ref, "smoke", (lmx.Case("d2m2", data=2, model=2), lmx.Case("m4", model=4)),
                 greedy=True),
            _job(ref, "smoke_bf16", (lmx.Case("bf16_m4", model=4),)),
            _job(ref, "d256", (lmx.Case("d256_d2m2", data=2, model=2),
                               lmx.Case("d256_m4", model=4))))
    return lmx.run_world(jobs, 4)


# case: (the reference's run, its mesh)
CASES = {"d2m2": ("smoke", "mesh2"), "m4": ("smoke", "mesh4"),
         "bf16_m4": ("smoke_bf16", "mesh4"), "d256_d2m2": ("d256", "mesh2"),
         "d256_m4": ("d256", "mesh4")}


# ---------------------------------------------------------------------------
# the configuration, GeGLU, the softcap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", ["repro_torch.configs.gemma2_2b",
                                 "repro_torch.configs.lm_common"])
def test_gemma_modules_import_alone_without_jax(mod):
    code = (f"import importlib, sys\nimportlib.import_module({mod!r})\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("name", ["full", "smoke"])
def test_gemma_config_matches_reference(name):
    ref_cfg = ref_gemma.config() if name == "full" else ref_gemma.smoke_config()
    cfg = gemma2_2b.config() if name == "full" else gemma2_2b.smoke_config()
    assert cfg.n_params() == ref_cfg.n_params()
    assert cfg.layer_windows == ref_cfg.layer_windows
    if name == "full":
        assert cfg.n_params() == 2_614_099_968                  # 5.23 GB in bf16
        assert cfg.layer_windows == (4096, 0) * 13
        # the one-card cells keep every layer; only the batch is cut
        assert gemma2_2b.N_LAYERS_ONE_CARD == {"prefill_32k": 26, "decode_32k": 26}
        assert gemma2_2b.BATCH_ONE_CARD == {"prefill_32k": 8, "decode_32k": 16}
    for f in ("vocab", "d_model", "n_layers", "n_q", "n_kv", "head_dim", "d_ff", "mlp_variant",
              "rope_theta", "window", "window_pattern", "attn_softcap", "final_softcap",
              "post_norms", "gemma_norm", "norm_eps", "tied_embeddings", "attn_parallel",
              "remat", "seq_shard_decode", "train_microbatches"):
        assert getattr(cfg, f) == getattr(ref_cfg, f), f
    assert get_arch("gemma2-2b") == (gemma2_2b, "lm")
    with pytest.raises(ValueError, match="not ported"):
        cfg.with_(window_pattern="every_third")


@pytest.mark.parametrize("name", list(DTYPES))
def test_geglu_ffn_matches_reference(name):
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(9)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.2
         for k, s in (("wi", (32, 64)), ("wg", (32, 64)), ("wo", (64, 32)))}
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    fn = jax.jit(lambda p, x: ref_ffn(p, x, "geglu")).lower(
        {k: jnp.asarray(v, jdt) for k, v in p.items()}, jnp.asarray(x, jdt)).compile(
        compiler_options=STRICT)
    want = fn({k: jnp.asarray(v, jdt) for k, v in p.items()}, jnp.asarray(x, jdt))
    got = ffn({k: torch.from_numpy(v).to(tdt) for k, v in p.items()},
              torch.from_numpy(x).to(tdt), "geglu")
    _close(got, want, BANDS[name])


@pytest.mark.parametrize("name", list(DTYPES))
def test_softcap_matches_reference(name):
    """fp32 inside, cast back: within 1e-6 relative in fp32; in bf16 within
    one bf16 ulp (2^-7 relative: tanh of XLA and of torch may part in the
    last fp32 bit, which can round to the neighbouring bf16 value)."""
    jdt, tdt = DTYPES[name]
    x = np.random.default_rng(10).normal(size=(4096,)).astype(np.float32) * 60
    for cap in (30.0, 50.0):
        want = ref_softcap(jnp.asarray(x, jdt), cap)
        got = softcap(torch.from_numpy(x).to(tdt), cap)
        assert got.dtype == tdt
        band = dict(rtol=1e-6, atol=1e-6) if name == "fp32" else dict(rtol=2 ** -7, atol=0)
        _close(got, want, band)
        assert float(got.float().abs().max()) <= cap
    x = torch.ones(3)
    assert softcap(x, None) is x


# ---------------------------------------------------------------------------
# kernel 6's plain version at head dim 256 with a window and a softcap
# ---------------------------------------------------------------------------

def _qkv(B_, Sq, Skv, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B_, S, H, D)).astype(np.float32)
            for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv))]


@pytest.mark.parametrize("case", [
    # B, Sq, Skv, Hq, Hkv, causal, window, softcap: Gemma's local and
    # global layers (window crossing the 32-key blocks, softcap 50), the
    # TPU kernel's Sq < Skv and Sq > Skv at q_offset 0 (rows past Skv keep
    # every key), non-causal rows
    (1, 96, 96, 4, 2, True, 20, 50.0), (1, 96, 96, 2, 1, True, 0, 50.0),
    (1, 64, 160, 2, 1, True, 40, 50.0), (1, 100, 48, 2, 2, True, 0, 50.0),
    (2, 40, 72, 4, 2, False, 0, 30.0)],
    ids=["local", "global", "sq_lt_skv", "sq_gt_skv", "noncausal"])
def test_attention_plain_at_d256_matches_pallas(case):
    """Interpret mode, fp32, the reference's forward band."""
    B_, Sq, Skv, Hq, Hkv, causal, window, cap = case
    q, k, v = _qkv(B_, Sq, Skv, Hq, Hkv, 256, seed=11)
    kw = dict(scale=256 ** -0.5, causal=causal, window=window, softcap=cap)
    want = ref_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=32,
                               block_k=32, interpret=True, **kw)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = fa.attention_plain(tq, tk, tv, chunk=29, **kw)
    _close(got, want, BANDS["fp32"])
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(fa.flash_attention(tq, tk, tv, **kw), fa.attention_plain(tq, tk, tv, **kw))


@pytest.mark.parametrize("n", [2, 4])
def test_attention_plain_at_d256_shard_rows_match_blocked_attention(n):
    """A context-parallel shard's rows at ``q_offset`` against all keys, with
    Gemma's window and softcap, against the reference's
    ``blocked_attention(q_offset=)`` (the function its seq-parallel layer
    calls), and the port's ``attention_seq_parallel`` over a fake group
    bitwise the same rows of the whole sequence's."""
    S, Hq, Hkv, D, w = 64, 4, 2, 256, 20
    q, k, v = _qkv(1, S, S, Hq, Hkv, D, seed=12)
    kw = dict(scale=D ** -0.5, causal=True, window=w, softcap=50.0)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    whole = attn.blocked_attention(tq, tk, tv, **kw)
    rows = S // n
    kv = [torch.cat((tk, tv), 2)[:, i * rows:(i + 1) * rows] for i in range(n)]
    for shard in range(n):
        sl = slice(shard * rows, (shard + 1) * rows)
        want = ref_blocked_attention(jnp.asarray(q[:, sl]), jnp.asarray(k), jnp.asarray(v),
                                     q_offset=shard * rows, q_block=16, kv_block=16, **kw)
        _close(fa.attention_plain(tq[:, sl], tk, tv, q_offset=shard * rows, **kw), want,
               BANDS["fp32"], f"shard {shard}")
        ctx = model.ParallelCtx(_FakeMesh(n, shard, [kv]))
        out = attn.attention_seq_parallel(tq[:, sl], tk[:, sl], tv[:, sl], ctx, scale=D ** -0.5,
                                          window=w, softcap=50.0)
        assert torch.equal(out, whole[:, sl])


# ---------------------------------------------------------------------------
# the sequence-sharded decode with a window and a softcap
# ---------------------------------------------------------------------------

class _FakeGroup:
    """A model group inside one process: ``all_gather`` concatenates the
    tensors that ``parts`` holds for every shard (this shard's comes from
    the call)."""

    def __init__(self, parts, shard):
        self.parts, self.shard = parts, shard

    def all_gather(self, t, dim=0):
        parts = list(self.parts.pop(0))
        parts[self.shard] = t
        return torch.cat(parts, dim=dim)


class _FakeMesh:
    graph = 1

    def __init__(self, model_, shard, parts=()):
        self.model, self.shard = model_, shard
        self.edge_group = _FakeGroup(list(parts), shard)


@pytest.mark.parametrize("cache_len", [3, 9, 17, 30])
@pytest.mark.parametrize("window", [0, 6, 11])
def test_sharded_decode_window_and_softcap(cache_len, window):
    """The decode over 4 cache shards of 8 positions with a window and a
    softcap of 50: each shard's partial keeps only the keys within the
    window of the query's global position (a shard wholly below it gives an
    empty partial), and the merge equals the one-device decode, which
    equals the softmax over the last ``window`` of the ``cache_len + 1``
    positions computed directly, in the fp32 band."""
    Bq, cap, Hq, Hkv, D, n, sc = 2, 32, 4, 2, 256, 4, 50.0
    gen = torch.Generator().manual_seed(cache_len + window)
    q = torch.randn(Bq, Hq, D, generator=gen) * 4
    kc, vc = (torch.randn(Bq, cap, Hkv, D, generator=gen) for _ in range(2))
    kn, vn = (torch.randn(Bq, Hkv, D, generator=gen) for _ in range(2))
    kw = dict(scale=D ** -0.5, window=window, softcap=sc)
    k1, v1 = kc.clone(), vc.clone()
    want = attn.decode_attention(q, k1, v1, kn, vn, cache_len, **kw)
    lo = max(cache_len + 1 - window, 0) if window else 0
    s = torch.einsum("bhgd,bshd->bhgs", q.view(Bq, Hkv, 2, D), k1[:, lo:cache_len + 1]) * kw["scale"]
    direct = torch.einsum("bhgs,bshd->bhgd", (sc * torch.tanh(s / sc)).softmax(-1),
                          v1[:, lo:cache_len + 1]).reshape(Bq, Hq, D)
    _close(want, direct, BANDS["fp32"], "one device")
    loc = cap // n
    partials = []
    for i in range(n):
        ks, vs = kc[:, i * loc:(i + 1) * loc].clone(), vc[:, i * loc:(i + 1) * loc].clone()
        if i * loc <= cache_len < (i + 1) * loc:
            ks[:, cache_len - i * loc], vs[:, cache_len - i * loc] = kn, vn
        o, m, l = attn._local_decode_scores(q, ks, vs, i * loc, cache_len + 1, **kw)
        partials.append(torch.cat((o, m[..., None], l[..., None]), -1)[None])
        if (i + 1) * loc <= lo or i * loc > cache_len:      # no key of this shard is kept
            assert not o.any() and not l.any() and bool((m == attn.NEG).all())
    for i in range(n):
        ks, vs = kc[:, i * loc:(i + 1) * loc].clone(), vc[:, i * loc:(i + 1) * loc].clone()
        ctx = model.ParallelCtx(_FakeMesh(n, i, [partials]))
        got = attn.decode_attention_sharded(q, ks, vs, kn, vn, cache_len, ctx, **kw)
        _close(got, want, BANDS["fp32"], f"shard {i}")


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape_id", ["prefill_32k", "decode_32k"])
def test_gemma_build_cell_smoke_on_cpu(shape_id, monkeypatch):
    """The cell builder at the smoke config with the sequence cut to 24 (three
    times the window): its step equals the model's functions; the cuts are
    recorded; train_4k and long_500k are refused."""
    S = 24
    monkeypatch.setitem(LM_SHAPES, shape_id, dict(LM_SHAPES[shape_id], seq_len=S))
    cfg = gemma2_2b.smoke_config().with_(param_dtype=torch.float32,
                                         cache_dtype=torch.float32)
    step, args, meta = gemma2_2b.build_cell(shape_id, device="cpu", seed=3, cfg=cfg)
    Bc = gemma2_2b.BATCH_ONE_CARD[shape_id]
    assert meta["reduced"] == dict(n_layers=(26, 2),
                                   batch=(LM_SHAPES[shape_id]["global_batch"], Bc))
    assert meta["cfg"] is cfg and meta["seq"] == S
    params = args[0]
    assert set(params["layers"]) >= {"ln_attn_post", "ln_mlp_post"}
    assert set(params["layers"]["ffn"]) == {"wi", "wg", "wo"}
    if shape_id == "prefill_32k":
        logits, cache = step(*args)
        assert logits.shape == (Bc, cfg.vocab) and cache["k"].shape[2] == S
        assert float(logits.abs().max()) <= cfg.final_softcap
        torch.testing.assert_close(logits, model.forward(params, args[1], cfg)[:, -1])
    else:
        cache, tokens, cache_len = args[1:]
        assert cache_len == S - 1 and not cache["k"][:, :, S - 1].any()
        before = {k: v.clone() for k, v in cache.items()}
        logits, cache = step(*args)
        want, _ = model.decode_step(params, before, tokens, cache_len, cfg)
        torch.testing.assert_close(logits, want)
    for cell in ("train_4k", "long_500k"):
        with pytest.raises(ValueError, match="queue 1 item 2"):
            gemma2_2b.build_cell(cell, device="cpu", cfg=cfg)


# ---------------------------------------------------------------------------
# the smoke configs served: one device, then a model group of processes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", list(RUNS))
def test_forward_matches_reference(ref, run):
    """The forward over all S_PRE + STEPS tokens (every position, both layer
    kinds) in the dtype's band; its final logits within the softcap."""
    r = ref[run]
    cfg = _config(run)
    params = params_from_jax(r["params"], "cpu")
    with torch.no_grad():
        got = model.forward(params, torch.from_numpy(r["tokens"]), cfg)
    _close(got, r["forward"], BANDS[RUNS[run]])
    assert float(got.float().abs().max()) <= cfg.final_softcap


@pytest.mark.parametrize("run", list(RUNS))
def test_one_device_prefill_and_decode_match_reference(ref, run):
    """One device (``ctx`` None; the reference's
    ``ParallelCtx.single_device()``): the prefill's logits and cache, and
    each decode step's logits, in the dtype's band."""
    rec = lmx.run_case(_job(ref, run, ()), lmx.Case("one"))
    want = ref[run]["one"]
    _close(rec["logits"], want["logits"], BANDS[RUNS[run]])
    for leaf in ("k", "v"):
        _close(rec["cache0"][leaf], want["cache0"][leaf][:, :, :S_PRE + STEPS],
               BANDS[RUNS[run]], leaf)
    assert not rec["launches_prefill"] and not rec["launches_decode"]   # CPU: plain


@pytest.mark.parametrize("run", ["smoke", "d256"])
def test_window_off_by_one_leaves_the_band(ref, run):
    """A planted fault: the local layers' window one key wider.  The
    forward and the served logits (prefill and decode steps) then leave the
    fp32 band the right window stays in."""
    r = ref[run]
    cfg = _config(run)
    bad = cfg.with_(window=cfg.window + 1)
    params = params_from_jax(r["params"], "cpu")
    with torch.no_grad():
        assert not _in_band(model.forward(params, torch.from_numpy(r["tokens"]), bad),
                            r["forward"], BANDS["fp32"])
    rec = lmx.run_case(dataclasses.replace(_job(ref, run, ()), cfg=lmx.cfg_dict(bad)),
                       lmx.Case("one"))
    assert not _in_band(rec["logits"][:, :1], r["one"]["logits"][:, :1], BANDS["fp32"])
    assert not _in_band(rec["logits"][:, 1:], r["one"]["logits"][:, 1:], BANDS["fp32"])


def test_params_round_trip_bitwise(ref):
    """``params_from_jax`` / ``params_to_jax`` carry the post-norm gains and
    GeGLU's gate bitwise, in bf16 and fp32."""
    for run in ("smoke", "smoke_bf16"):
        tree = ref[run]["params"]
        back = params_to_jax(params_from_jax(tree, "cpu"))
        for name in ("ln_attn_post", "ln_mlp_post"):
            np.testing.assert_array_equal(back["layers"][name]["g"], tree["layers"][name]["g"])
        for name in ("wg", "wi", "wo"):
            a, b = back["layers"]["ffn"][name], tree["layers"]["ffn"][name]
            assert a.dtype == b.dtype and a.tobytes() == np.asarray(b).tobytes(), name


def test_greedy_generate_matches_reference(ref):
    """The greedy loop's tokens equal the reference's greedy tokens (fp32)."""
    job = dataclasses.replace(_job(ref, "smoke", ()), feed=None, greedy=True)
    rec = lmx.run_case(job, lmx.Case("one"))
    want = ref["smoke"]["one"]["greedy"].argmax(-1)
    np.testing.assert_array_equal(rec["tokens"].numpy(), want)
    np.testing.assert_array_equal(rec["greedy"].numpy(), want[:, :STEPS])


@pytest.mark.parametrize("case", list(CASES))
def test_model_group_matches_reference_mesh(ref, world, case):
    """Every process's logits (its replica's rows) and cache shard against
    the reference's on a (1, model) mesh, in the dtype's band."""
    run, mesh = CASES[case]
    want = ref[run][mesh]
    for proc in world:
        rec = proc[case]
        rows = slice(*rec["rows"])
        _close(rec["logits"], want["logits"][rows], BANDS[RUNS[run]], f"shard {rec['shard']}")
        loc = rec["cache0"]["k"].shape[2]
        c0 = rec["shard"] * loc
        for leaf in ("k", "v"):
            _close(rec["cache0"][leaf], want["cache0"][leaf][:, rows, c0:c0 + loc],
                   BANDS[RUNS[run]], f"{leaf} shard {rec['shard']}")
        assert not rec["launches_prefill"] and not rec["launches_decode"]


@pytest.mark.parametrize("case", list(CASES))
def test_model_group_processes_agree_bitwise(world, case):
    """The processes of one model group end every step with bitwise the same
    logits, so the same greedy tokens."""
    by_replica = {}
    for proc in world:
        by_replica.setdefault(proc[case]["replica"], []).append(proc[case])
    for recs in by_replica.values():
        assert sorted(r["shard"] for r in recs) == list(range(len(recs)))
        for r in recs[1:]:
            assert np.array_equal(r["logits"], recs[0]["logits"])
            assert np.array_equal(r["tokens"], recs[0]["tokens"])
            if "greedy" in r:
                assert np.array_equal(r["greedy"], recs[0]["greedy"])
        for r in recs:
            assert r["host_s"]["all_gather"] > 0 and r["host_s"]["combine"] > 0


if __name__ == "__main__":
    _reference_main(sys.argv[1])
