"""Llama-3.2-3B's serving path in the torch port against the JAX reference
package, on the CPU at the smoke config: kernel 6's plain version at
``Sq != Skv`` with a query offset, SwiGLU and RoPE at theta 500,000, the
prefill, decode steps and greedy loop on one device, and the
context-parallel prefill and sequence-sharded decode over a ``model`` group
of gloo processes (``launch/lm_checks.py``).

The reference's mesh runs need 4 host devices, which JAX fixes when it
starts; so this file also runs the reference: as a script
(``python tests/test_torch_lm_seq.py OUT``) it sets ``XLA_FLAGS`` before
importing JAX, serves the smoke config on one device and on a ``(1, 4)``
``("data", "model")`` mesh in fp32 and bf16, and pickles the results, which
the tests read (the reference's ring-attention test runs its mesh in a
subprocess alike).  Both
packages start from ``repro``'s params (``PRNGKey(0)``) and the same
numpy tokens.  Bands: fp32 rtol 1e-4 / atol 1e-5 (the reference's forward
band), bf16 rtol / atol 2e-2 with the reference compiled op by op
(``xla_allow_excess_precision=False``, as ``tests/test_torch_lm.py`` does).
The port's processes of one model group must agree bitwise.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import llama3_2_3b as ref_llama
from repro.kernels.flash_attention.ops import flash_attention as ref_flash_attention
from repro.launch.mesh import make_mesh as ref_make_mesh
from repro.models.transformer import model as ref_model
from repro.models.transformer.attention import blocked_attention as ref_blocked_attention
from repro.models.transformer.layers import apply_rope as ref_apply_rope
from repro.models.transformer.layers import ffn as ref_ffn
from repro.sharding import split_tree as ref_split_tree

from repro_torch.configs import get_arch, llama3_2_3b
from repro_torch.configs.lm_common import LM_SHAPES
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch import lm_checks as lmx
from repro_torch.models.transformer import attention as attn
from repro_torch.models.transformer import model
from repro_torch.models.transformer.layers import apply_rope, ffn, silu
from repro_torch.models.transformer.steps import make_train_step
from repro_torch.nn import tree_leaves
from repro_torch.train.optimizer import AdamWConfig

ROOT = Path(__file__).resolve().parents[1]
BANDS = {"fp32": dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
STRICT = {"xla_allow_excess_precision": False}
# prompts [B, S_PRE] then STEPS decode steps: S_PRE and S_PRE + STEPS split
# over 2 and 4 shards
B, S_PRE, STEPS = 2, 16, 4


def _close(got, want, band, msg=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), err_msg=msg, **band)


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
    mesh = ref_make_mesh((1, 4), ("data", "model"))
    ctx4 = ref_model.ParallelCtx(mesh=mesh, batch_axes=("data",), rules={})
    ctx1 = ref_model.ParallelCtx.single_device()
    res = {}
    for name, (jdt, _) in DTYPES.items():
        cfg = ref_llama.smoke_config().with_(param_dtype=jdt, cache_dtype=jdt)
        params, _ = ref_split_tree(ref_model.init_transformer(jax.random.PRNGKey(0), cfg), {})
        tok = np.random.default_rng(4).integers(0, cfg.vocab, (B, S_PRE + STEPS))
        jt = jnp.asarray(tok, jnp.int32)
        res[name] = dict(params=jax.tree.map(np.asarray, params), tokens=tok,
                         one=_ref_serve(params, jt, cfg, ctx1, greedy=name == "fp32"),
                         mesh=_ref_serve(params, jt, cfg, ctx4))
    with open(path, "wb") as fh:
        pickle.dump(res, fh)


# ---------------------------------------------------------------------------
# fixtures: the reference's runs, the port's world of 4 processes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("lm_seq") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, __file__, str(out)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(out, "rb") as fh:
        return pickle.load(fh)


def _job(ref, name, cases, **kw):
    _, tdt = DTYPES[name]
    cfg = llama3_2_3b.smoke_config().with_(param_dtype=tdt, cache_dtype=tdt)
    r = ref[name]
    return lmx.Job(cases=cases, cfg=lmx.cfg_dict(cfg), params=r["params"],
                   prompts=r["tokens"][:, :S_PRE], feed=r["tokens"][:, S_PRE:], steps=STEPS,
                   return_cache=True, device="cpu", **kw)


@pytest.fixture(scope="module")
def world(ref):
    """One spawn of 4 gloo processes: fp32 over data 2 x model 2 and model 4,
    bf16 over model 4; each process's records by case."""
    jobs = (_job(ref, "fp32", (lmx.Case("d2m2", data=2, model=2), lmx.Case("m4", model=4)),
                 greedy=True),
            _job(ref, "bf16", (lmx.Case("bf16_m4", model=4),)))
    return lmx.run_world(jobs, 4)


CASES = {"d2m2": "fp32", "m4": "fp32", "bf16_m4": "bf16"}


# ---------------------------------------------------------------------------
# kernel 6's plain version at Sq != Skv
# ---------------------------------------------------------------------------

def _qkv(B_, Sq, Skv, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B_, S, H, D)).astype(np.float32)
            for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv))]


@pytest.mark.parametrize("case", [
    # B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset: a context-parallel
    # shard (the last of 4, and an inner one), a window crossing the shard
    # edge, the non-causal rows, MQA
    (1, 32, 128, 4, 2, 16, True, 0, 96), (2, 24, 96, 6, 3, 32, True, 0, 24),
    (1, 40, 160, 4, 4, 16, True, 50, 80), (1, 16, 64, 2, 1, 64, False, 0, 16),
    (1, 48, 96, 8, 1, 32, True, 20, 48)])
def test_attention_plain_q_offset_matches_blocked_attention(case):
    B_, Sq, Skv, Hq, Hkv, D, causal, window, off = case
    q, k, v = _qkv(B_, Sq, Skv, Hq, Hkv, D)
    kw = dict(scale=D ** -0.5, causal=causal, window=window)
    want = ref_blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=off,
                                 q_block=16, kv_block=32, **kw)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = fa.attention_plain(tq, tk, tv, q_offset=off, chunk=13, **kw)
    _close(got, want, BANDS["fp32"])
    # the wrapper on CPU tensors is the plain version, the LSE of the rows too
    assert torch.equal(fa.flash_attention(tq, tk, tv, q_offset=off, **kw),
                       fa.attention_plain(tq, tk, tv, q_offset=off, **kw))
    out, lse = fa.attention_plain(tq, tk, tv, q_offset=off, return_lse=True, **kw)
    assert lse.shape == (B_, Hq, Sq) and bool(torch.isfinite(lse).all())


@pytest.mark.parametrize("case", [(1, 64, 200, 2, 1, 64, True), (1, 200, 64, 2, 2, 32, True),
                                  (2, 48, 80, 4, 2, 16, False)],
                         ids=["sq_lt_skv", "sq_gt_skv", "noncausal"])
def test_attention_plain_matches_pallas_at_sq_ne_skv(case):
    """At q_offset 0 the TPU kernel's own shape: ``seq_kv`` keys for Sq rows
    (interpret mode)."""
    B_, Sq, Skv, Hq, Hkv, D, causal = case
    q, k, v = _qkv(B_, Sq, Skv, Hq, Hkv, D, seed=1)
    kw = dict(scale=D ** -0.5, causal=causal)
    want = ref_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=32,
                               block_k=32, interpret=True, **kw)
    got = fa.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    _close(got, want, BANDS["fp32"])


def test_refusals():
    """What the port does not take raises: a gradient at Sq != Skv or with a
    query offset (context-parallel training), query rows that keep no key,
    the ring layout, untied embeddings, an MLP variant the reference does
    not have, kernel 6b at head dim 256 (Gemma-2's training), and the heads
    layout over a model group."""
    q, kv = torch.randn(1, 8, 4, 16, requires_grad=True), torch.randn(1, 24, 2, 16)
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        fa.flash_attention(q, kv, kv, scale=1.0)
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        fa.flash_attention(q, kv[:, :8], kv[:, :8], scale=1.0, q_offset=8)
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        fa.flash_attention_bwd(q, kv, kv, q, torch.zeros(1, 4, 8), q, scale=1.0)
    with torch.no_grad():
        with pytest.raises(ValueError, match="without a key"):
            fa.flash_attention(q, kv, kv, scale=1.0, window=4, q_offset=24)
        with pytest.raises(ValueError, match="negative"):
            fa.flash_attention(q, kv, kv, scale=1.0, q_offset=-1)
        fa.flash_attention(q, kv, kv, scale=1.0, window=4, q_offset=19)   # the last row keeps one
    with pytest.raises(ValueError, match="not ported"):
        llama3_2_3b.smoke_config().with_(attn_parallel="ring")
    with pytest.raises(ValueError, match="not ported"):
        llama3_2_3b.smoke_config().with_(tied_embeddings=False)
    with pytest.raises(ValueError, match="not ported"):
        llama3_2_3b.smoke_config().with_(mlp_variant="relu")
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):   # kernel 6b at D = 256
        fa._check_bwd_head_dim(256)
    with pytest.raises(ValueError, match="not ported"):
        make_train_step(llama3_2_3b.smoke_config(), AdamWConfig())
    cfg = llama3_2_3b.smoke_config().with_(attn_parallel="heads")
    ctx = model.ParallelCtx(_FakeMesh(2, 0))
    params = model.init_transformer(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(NotImplementedError, match="'heads' layout"):
        model.prefill_step(params, torch.zeros(1, 8, dtype=torch.long), cfg, 8, ctx)


# ---------------------------------------------------------------------------
# the context-parallel functions in one process, over a group that hands
# back every shard's tensors
# ---------------------------------------------------------------------------

class _FakeGroup:
    """A model group inside one process: ``all_gather`` concatenates the
    tensors that ``parts`` holds for every shard (this shard's comes from
    the call), as the real group would."""

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


@pytest.mark.parametrize("n", [2, 4])
def test_attention_seq_parallel_equals_blocked_attention(n):
    """Each shard's rows against the gathered K/V equal the same rows of the
    whole sequence's attention, bitwise (the plain version scores each row
    against every key alike), and the gathered K/V are every shard's."""
    S, Hq, Hkv, D = 32, 4, 2, 16
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, S, S, Hq, Hkv, D, seed=2))
    want = attn.blocked_attention(q, k, v, scale=D ** -0.5)
    rows = S // n
    kv = [torch.cat((k, v), 2)[:, i * rows:(i + 1) * rows] for i in range(n)]
    for shard in range(n):
        ctx = model.ParallelCtx(_FakeMesh(n, shard, [kv]))
        sl = slice(shard * rows, (shard + 1) * rows)
        out, k_all, v_all = attn.attention_seq_parallel(q[:, sl], k[:, sl], v[:, sl], ctx,
                                                        scale=D ** -0.5, return_kv=True)
        assert torch.equal(out, want[:, sl])
        assert torch.equal(k_all, k) and torch.equal(v_all, v)
        assert set(ctx.host_s) == {"all_gather"}


@pytest.mark.parametrize("cache_len", [0, 5, 13, 31])
def test_sharded_decode_merges_to_one_device_decode(cache_len):
    """The decode over 4 cache shards (partials gathered and merged in shard
    order) equals the one-device decode within the fp32 band, the shard
    that owns ``cache_len`` writes the new K/V, and shards past it
    contribute nothing."""
    Bq, cap, Hq, Hkv, D, n = 2, 32, 6, 2, 16, 4
    gen = torch.Generator().manual_seed(cache_len)
    q = torch.randn(Bq, Hq, D, generator=gen)
    kc, vc = (torch.randn(Bq, cap, Hkv, D, generator=gen) for _ in range(2))
    kn, vn = (torch.randn(Bq, Hkv, D, generator=gen) for _ in range(2))
    kw = dict(scale=D ** -0.5)
    k1, v1 = kc.clone(), vc.clone()
    want = attn.decode_attention(q, k1, v1, kn, vn, cache_len, **kw)
    loc = cap // n
    shards = [(kc[:, i * loc:(i + 1) * loc].clone(), vc[:, i * loc:(i + 1) * loc].clone())
              for i in range(n)]
    partials = []
    for i, (ks, vs) in enumerate(shards):
        o, m, l = attn._local_decode_scores(q, *_written(ks, vs, kn, vn, cache_len, i * loc),
                                            i * loc, cache_len + 1, **kw)
        partials.append(torch.cat((o, m[..., None], l[..., None]), -1)[None])
        if i * loc > cache_len:
            assert not o.any() and not l.any()
    for i, (ks, vs) in enumerate(shards):
        ctx = model.ParallelCtx(_FakeMesh(n, i, [partials]))
        got = attn.decode_attention_sharded(q, ks, vs, kn, vn, cache_len, ctx, **kw)
        _close(got, want, BANDS["fp32"], f"shard {i}")
        assert torch.equal(ks, k1[:, i * loc:(i + 1) * loc])         # written by its owner
        assert set(ctx.host_s) == {"combine"}


def _written(ks, vs, kn, vn, cache_len, start):
    ks, vs = ks.clone(), vs.clone()
    if start <= cache_len < start + ks.shape[1]:
        ks[:, cache_len - start], vs[:, cache_len - start] = kn, vn
    return ks, vs


def test_one_shard_decode_is_the_plain_softmax():
    """On one device (``ctx`` None) the sharded decode is today's decode:
    softmax over the ``cache_len`` filled positions, the rest masked."""
    gen = torch.Generator().manual_seed(3)
    q, kc, vc = (torch.randn(*s, generator=gen) for s in ((1, 4, 16), (1, 20, 2, 16),
                                                            (1, 20, 2, 16)))
    for cache_len in (1, 12, 20):
        o, m, l = attn._local_decode_scores(q, kc, vc, 0, cache_len, scale=0.25)
        got = attn._combine_partials(o, m, l, None)
        s = torch.einsum("hgd,shd->hgs", q.view(2, 2, 16), kc[0, :cache_len]) * 0.25
        want = torch.einsum("hgs,shd->hgd", s.softmax(-1), vc[0, :cache_len])
        _close(got[0], want, BANDS["fp32"], f"cache_len {cache_len}")


# ---------------------------------------------------------------------------
# SwiGLU, RoPE, the configuration
# ---------------------------------------------------------------------------

def test_silu_matches_reference():
    """Op by op in bf16, bitwise the reference's (``F.silu`` misses by an
    ulp in about a third of the elements); fp32 within 1e-6."""
    x = np.random.default_rng(7).normal(size=(4096,)).astype(np.float32) * 4
    want = jax.nn.silu(jnp.asarray(x, jnp.bfloat16))
    got = silu(torch.from_numpy(x).to(torch.bfloat16))
    assert torch.equal(got.float(), torch.from_numpy(np.asarray(want, np.float32)))
    _close(silu(torch.from_numpy(x)), jax.nn.silu(jnp.asarray(x)), dict(rtol=1e-6, atol=1e-6))


@pytest.mark.parametrize("name", list(DTYPES))
def test_swiglu_ffn_matches_reference(name):
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(8)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.2
         for k, s in (("wi", (32, 64)), ("wg", (32, 64)), ("wo", (64, 32)))}
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    fn = jax.jit(lambda p, x: ref_ffn(p, x, "swiglu")).lower(
        {k: jnp.asarray(v, jdt) for k, v in p.items()}, jnp.asarray(x, jdt)).compile(
        compiler_options=STRICT)
    want = fn({k: jnp.asarray(v, jdt) for k, v in p.items()}, jnp.asarray(x, jdt))
    got = ffn({k: torch.from_numpy(v).to(tdt) for k, v in p.items()},
              torch.from_numpy(x).to(tdt), "swiglu")
    _close(got, want, BANDS[name])


@pytest.mark.parametrize("name", list(DTYPES))
def test_rope_theta_500k_at_long_positions(name):
    jdt, tdt = DTYPES[name]
    x = np.random.default_rng(6).normal(size=(2, 5, 3, 128)).astype(np.float32)
    pos = np.array([[0, 1, 8191, 24576, 32767], [7, 100, 2047, 16384, 32000]])
    want = ref_apply_rope(jnp.asarray(x, jdt), jnp.asarray(pos), 500000.0)
    got = apply_rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos), 500000.0)
    _close(got, want, dict(rtol=1e-5, atol=1e-5) if name == "fp32" else BANDS["bf16"])


@pytest.mark.parametrize("name", ["full", "smoke"])
def test_llama_config_matches_reference(name):
    ref_cfg = ref_llama.config() if name == "full" else ref_llama.smoke_config()
    cfg = llama3_2_3b.config() if name == "full" else llama3_2_3b.smoke_config()
    assert cfg.n_params() == ref_cfg.n_params()
    if name == "full":
        assert cfg.n_params() == 3_212_574_720                  # 6.43 GB in bf16
    for f in ("vocab", "d_model", "n_layers", "n_q", "n_kv", "head_dim", "d_ff", "mlp_variant",
              "rope_theta", "norm_eps", "tied_embeddings", "attn_parallel", "remat",
              "seq_shard_decode"):
        assert getattr(cfg, f) == getattr(ref_cfg, f), f
    assert get_arch("llama3.2-3b")[0] is llama3_2_3b


@pytest.mark.parametrize("shape_id", ["prefill_32k", "decode_32k"])
def test_llama_build_cell_smoke_on_cpu(shape_id, monkeypatch):
    """The cell builder at the smoke config with the sequence cut to 24: its
    step equals the model's functions; the cuts are recorded."""
    S = 24
    monkeypatch.setitem(LM_SHAPES, shape_id, dict(LM_SHAPES[shape_id], seq_len=S))
    cfg = llama3_2_3b.smoke_config().with_(param_dtype=torch.float32,
                                           cache_dtype=torch.float32)
    step, args, meta = llama3_2_3b.build_cell(shape_id, device="cpu", seed=3, cfg=cfg)
    Bc = llama3_2_3b.BATCH_ONE_CARD[shape_id]
    assert meta["reduced"] == dict(n_layers=(28, 2),
                                   batch=(LM_SHAPES[shape_id]["global_batch"], Bc))
    params = args[0]
    if shape_id == "prefill_32k":
        logits, cache = step(*args)
        assert logits.shape == (Bc, cfg.vocab) and cache["k"].shape[2] == S
        torch.testing.assert_close(logits, model.forward(params, args[1], cfg)[:, -1])
    else:
        cache, tokens, cache_len = args[1:]
        assert cache_len == S - 1 and not cache["k"][:, :, S - 1].any()
        before = {k: v.clone() for k, v in cache.items()}
        logits, cache = step(*args)
        want, _ = model.decode_step(params, before, tokens, cache_len, cfg)
        torch.testing.assert_close(logits, want)


class _ThreadGroup:
    """A model group of threads in one process, a thread a shard:
    ``shard(i).all_gather`` concatenates every shard's tensor in shard
    order, as the real group does."""

    def __init__(self, n):
        self.slots, self.barrier = [None] * n, threading.Barrier(n, timeout=60)

    def shard(self, i):
        group = self

        class Shard:
            graph, model, shard = 1, len(group.slots), i

            class edge_group:
                @staticmethod
                def all_gather(t, dim=0):
                    group.slots[i] = t
                    group.barrier.wait()
                    out = torch.cat(group.slots, dim=dim)
                    group.barrier.wait()
                    return out
        return Shard


def _on_threads(n, fn):
    """``fn(shard, mesh)`` on n threads over one :class:`_ThreadGroup`."""
    group, out, errors = _ThreadGroup(n), [None] * n, []

    def run(i):
        try:
            out[i] = fn(i, group.shard(i))
        except BaseException as e:                      # noqa: BLE001 (re-raised below)
            errors.append(e)
            group.barrier.abort()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_llama_decode_cell_shards_slice_one_cache(n, monkeypatch):
    """The decode cell over a model group of ``n`` (``ctx``): each shard's
    cache is [L, B, S / n, Hkv, D], its slice of the one-device cell's cache
    (so the shards hold one cache filled to S - 1), with the same weights
    and tokens; its step, run by the group, gives every shard bitwise the
    same logits, the one-device step's in the fp32 band."""
    S = 24
    monkeypatch.setitem(LM_SHAPES, "decode_32k", dict(LM_SHAPES["decode_32k"], seq_len=S))
    cfg = llama3_2_3b.smoke_config().with_(param_dtype=torch.float32,
                                           cache_dtype=torch.float32)
    kw = dict(device="cpu", seed=5, cfg=cfg, batch=2)
    step, (params, cache, tokens, cache_len), _ = llama3_2_3b.build_cell("decode_32k", **kw)
    assert cache_len == S - 1 and bool((cache["k"][:, :, :S - 1] != 0).all())
    loc = S // n

    cells = []
    for shard in range(n):
        ctx = model.ParallelCtx(_FakeMesh(n, shard))
        _, args, _ = llama3_2_3b.build_cell("decode_32k", ctx=ctx, **kw)
        for leaf in ("k", "v"):
            assert args[1][leaf].shape == (cfg.n_layers, 2, loc, cfg.n_kv, cfg.head_dim)
            assert torch.equal(args[1][leaf], cache[leaf][:, :, shard * loc:(shard + 1) * loc])
        assert torch.equal(args[2], tokens) and args[3] == cache_len
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(args[0]),
                                                     tree_leaves(params)))
        cells.append(args)
    got = _on_threads(n, lambda shard, mesh: model.decode_step(
        *cells[shard], cfg, model.ParallelCtx(mesh))[0])
    want, _ = step(params, cache, tokens, cache_len)
    for shard in range(n):
        assert torch.equal(got[shard], got[0])
        _close(got[shard], want, BANDS["fp32"], f"shard {shard}")


# ---------------------------------------------------------------------------
# the smoke config served: one device, then a model group of processes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(DTYPES))
def test_one_device_prefill_and_decode_match_reference(ref, name):
    """One device (``ctx`` None; the reference's
    ``ParallelCtx.single_device()``): the prefill's logits and cache, and
    each decode step's logits, in the dtype's band."""
    rec = lmx.run_case(_job(ref, name, ()), lmx.Case("one"))
    want = ref[name]["one"]
    _close(rec["logits"], want["logits"], BANDS[name])
    for leaf in ("k", "v"):
        _close(rec["cache0"][leaf], want["cache0"][leaf][:, :, :S_PRE + STEPS],
               BANDS[name], leaf)
    assert not rec["launches_prefill"] and not rec["launches_decode"]   # CPU: plain


def test_greedy_generate_matches_reference(ref):
    """The greedy loop's tokens equal the reference's greedy tokens (fp32)."""
    job = dataclasses.replace(_job(ref, "fp32", ()), feed=None, greedy=True)
    rec = lmx.run_case(job, lmx.Case("one"))
    want = ref["fp32"]["one"]["greedy"].argmax(-1)
    np.testing.assert_array_equal(rec["tokens"].numpy(), want)
    np.testing.assert_array_equal(rec["greedy"].numpy(), want[:, :STEPS])


@pytest.mark.parametrize("case", list(CASES))
def test_model_group_matches_reference_mesh(ref, world, case):
    """Every process's logits (its replica's rows) and cache shard against
    the reference's on a (1, 4) mesh, in the dtype's band."""
    name = CASES[case]
    want = ref[name]["mesh"]
    for proc in world:
        rec = proc[case]
        rows = slice(*rec["rows"])
        _close(rec["logits"], want["logits"][rows], BANDS[name], f"shard {rec['shard']}")
        loc = rec["cache0"]["k"].shape[2]
        c0 = rec["shard"] * loc
        for leaf in ("k", "v"):
            _close(rec["cache0"][leaf], want["cache0"][leaf][:, rows, c0:c0 + loc],
                   BANDS[name], f"{leaf} shard {rec['shard']}")
        assert not rec["launches_prefill"] and not rec["launches_decode"]


@pytest.mark.parametrize("case", list(CASES))
def test_model_group_processes_agree_bitwise(world, case):
    """The processes of one model group end every step with bitwise the same
    logits, so the same greedy tokens; each gathered K/V and partials."""
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


def test_model_group_mesh_layout(world):
    """data 2 x model 2: each model group holds the shards of one replica,
    data-major (the mesh's edge group is the LM's model group)."""
    for w, proc in enumerate(world):
        rec = proc["d2m2"]
        assert (rec["replica"], rec["shard"]) == divmod(w, 2)
        assert rec["groups"]["edge"] == tuple(range(2 * rec["replica"], 2 * rec["replica"] + 2))
        assert rec["rows"] == (rec["replica"], rec["replica"] + 1)
        assert proc["m4"]["shard"] == w and proc["m4"]["rows"] == (0, B)


if __name__ == "__main__":
    _reference_main(sys.argv[1])
