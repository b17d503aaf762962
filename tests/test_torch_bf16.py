"""bf16 NMP of the torch port against the JAX reference package's xla bf16
path (``NMPPlan(precision="bf16")``, ``nn.mlp(precision="bf16")``): the
edge MLP's dense products on bf16-rounded operands, accumulated in fp32;
every cast operand's cotangent rounded to bf16.

Bands.  A pre-activation that differs in its last fp32 bit (another
summation order) can round to the neighbouring bf16 value, a 2^-8
relative step, and the policy carries that through the layers: the
elementwise fp32 bands cannot hold two correct bf16 paths.  So a forward
is held by its relative L2 distance from ``repro``'s bf16 result (at most
1e-3) and by that distance's ratio to its distance from ``repro``'s fp32
result (at most 0.2: the rounding happened, and the same way), with max
|err| at most 5e-2, the bf16 band of ``tests/test_kernels.py:257-259``.
Gradients: each leaf within rtol 1e-2 / atol 1e-2 * max(1, max|ref|), the
band ``repro`` holds its own bf16 pair to (``tests/test_kernels.py:
277-280``): a weight gradient summed in another order and then rounded to
bf16 can land one bf16 ulp away.  The port's own 1 rank == 4 ranks in
bf16: loss rel 2e-6, predictions rtol 1e-4 / atol 1e-5, gradients within
1e-2 of each leaf's largest magnitude.  The stacked emulator runs the layer
per rank, so its weight gradients round per rank where ``repro``'s
stacked xla path rounds once over every rank: the same gradient band.

The fused backend runs its plain versions here (CPU tensors); the kernels
are held against those on the card (``tests/test_torch_gpu.py``).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import nn as ref_nn
from repro.ckpt import checkpoint as ref_ckpt
from repro.core import GNNConfig as RefConfig
from repro.core import NMPPlan as RefPlan
from repro.core import ShardedGraph as RefGraph
from repro.core import box_mesh as ref_box_mesh
from repro.core import init_gnn as ref_init_gnn
from repro.core import partition_mesh as ref_partition_mesh
from repro.core.reference import loss_and_grad_stacked as ref_loss_and_grad
from repro.graph import segment as ref_segment
from repro.runtime.engine import EngineConfig as RefEngineConfig
from repro.runtime.engine import InferenceEngine as RefEngine
from repro.train.loop import TrainConfig as RefTrainConfig
from repro.train.loop import run_fingerprint as ref_run_fingerprint

from repro_torch import nn
from repro_torch.convert import params_from_jax
from repro_torch.core.distributed import one_rank_plan
from repro_torch.core.gnn import GNNConfig
from repro_torch.core.graph_state import (
    BF16, FP32, FUSED, XLA, NMPPlan, ShardedGraph)
from repro_torch.core.halo import A2A, NEIGHBOR, NONE, halo_sync_stacked
from repro_torch.core.mesh_gen import box_mesh, taylor_green_velocity
from repro_torch.core.partition import (
    gather_node_features, partition_mesh, scatter_node_outputs)
from repro_torch.core.reference import loss_and_grad_stacked
from repro_torch.kernels.segment_agg import ops as sa
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.runtime.engine import EngineConfig, InferenceEngine

FWD_REL, FWD_RATIO, FWD_MAX = 1e-3, 0.2, 5e-2
G_RTOL, G_ATOL = 1e-2, 1e-2
LOSS_REL, RTOL, ATOL, LEAF_REL = 2e-6, 1e-4, 1e-5, 1e-2
ELEMS, ORDER, BLOCK_E = (4, 2, 2), 2, 32


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def fwd_close(got, want_bf16, want_fp32):
    """The forward bands of the module docstring; returns the readings."""
    rel, rel32 = _rel(got, want_bf16), _rel(got, want_fp32)
    err = float(np.abs(np.asarray(got) - np.asarray(want_bf16)).max())
    assert rel <= FWD_REL and rel <= FWD_RATIO * rel32 and err <= FWD_MAX, \
        (rel, rel32, err)
    return rel, rel32


def grads_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(
            a, b, rtol=G_RTOL, atol=G_ATOL * max(1.0, float(np.abs(b).max())))


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# nn.dense / nn.mlp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hidden,layers", [(8, 2), (32, 5)], ids=["h8", "h32"])
def test_dense_and_mlp_bf16_match_reference(hidden, layers):
    rng = np.random.default_rng(hidden)
    p = jax.tree.map(np.asarray, ref_nn.init_mlp(
        jax.random.PRNGKey(hidden), 3 * hidden, [hidden] * layers, hidden))
    p["layers"][0]["b"] = rng.normal(size=hidden).astype(np.float32)
    x = rng.normal(size=(2000, 3 * hidden)).astype(np.float32)
    for name, ref_fn, port_fn, params in (
            ("dense", ref_nn.dense, nn.dense, p["layers"][0]),
            ("mlp", ref_nn.mlp, nn.mlp, p)):
        want = np.asarray(ref_fn(_jnp(params), jnp.asarray(x), precision=BF16))
        want32 = np.asarray(ref_fn(_jnp(params), jnp.asarray(x)))
        tp = params_from_jax(params, "cpu")
        leaves = nn.tree_leaves(tp)
        for t in leaves:
            t.requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        with torch.enable_grad():
            out = port_fn(tp, xt, precision=BF16)
            got_g = torch.autograd.grad(torch.sin(out).sum(), leaves + [xt])
        fwd_close(out.detach().numpy(), want, want32)
        # ``fp32`` and None are the plain product
        np.testing.assert_array_equal(port_fn(tp, xt, precision=FP32).detach().numpy(),
                                      port_fn(tp, xt).detach().numpy())
        want_g = jax.grad(lambda q, v: jnp.sum(jnp.sin(ref_fn(q, v, precision=BF16))),
                          argnums=(0, 1))(_jnp(params), jnp.asarray(x))
        grads_close([g.numpy() for g in got_g],
                    jax.tree.leaves(want_g[0]) + [want_g[1]])
        if name == "dense":
            # autograd through the casts rounds the operands' cotangents
            # to bf16, as JAX's VJP does: the weight gradient is bf16-valued
            w = got_g[[id(t) for t in leaves].index(id(tp["w"]))]
            assert torch.equal(w, w.to(torch.bfloat16).float())
    with pytest.raises(ValueError, match="precision"):
        nn.dense(params_from_jax(p["layers"][0], "cpu"), torch.from_numpy(x),
                 precision="fp8")


# ---------------------------------------------------------------------------
# the fused NMP op (its plain versions on CPU tensors)
# ---------------------------------------------------------------------------

def _random_nmp_case(seed, n_hidden, final_layernorm):
    """``tests/test_kernels.py::_random_nmp_case``'s shapes (H=8, 20-60
    nodes, 40-200 edges, ~10% masked), as numpy."""
    rng = np.random.default_rng(seed)
    n, E, H = int(rng.integers(20, 60)), int(rng.integers(40, 200)), 8
    src = rng.integers(0, n, E).astype(np.int32)
    dst = rng.integers(0, n, E).astype(np.int32)
    emask = (rng.uniform(size=E) > 0.1).astype(np.float32)
    einv = (rng.uniform(0.3, 1.0, E) * emask).astype(np.float32)
    x = rng.normal(size=(n, H)).astype(np.float32)
    e = rng.normal(size=(E, H)).astype(np.float32)
    params = jax.tree.map(np.asarray, ref_nn.init_mlp(
        jax.random.PRNGKey(seed), 3 * H, [H] * n_hidden, H,
        final_layernorm=final_layernorm))
    return n, src, dst, emask, einv, x, e, params


def _ref_nmp(p, x, e, src, dst, emask, einv, n, precision=None):
    xi, xj = ref_segment.gather(x, src), ref_segment.gather(x, dst)
    e_new = (e + ref_nn.mlp(p, jnp.concatenate([xi, xj, e], -1), precision=precision)) \
        * emask[:, None]
    return e_new, ref_segment.segment_sum(e_new * einv[:, None], dst, n)


@pytest.mark.parametrize("seed,n_hidden,ln", [(0, 2, True), (1, 0, True), (2, 3, False),
                                              (3, 5, True)])
def test_fused_nmp_plain_bf16_matches_reference(seed, n_hidden, ln):
    n, src, dst, emask, einv, x, e, params = _random_nmp_case(seed, n_hidden, ln)
    lay = sa.compact_gather_layout(src, np.where(emask > 0, dst, n), n, 32)
    T = torch.from_numpy
    layout = (T(lay["perm"]), T(lay["src"]), T(lay["rowptr"]), T(emask), T(einv))
    ref_args = (jnp.asarray(src), jnp.asarray(dst), jnp.asarray(emask),
                jnp.asarray(einv), n)
    want = _ref_nmp(_jnp(params), jnp.asarray(x), jnp.asarray(e), *ref_args,
                    precision=BF16)
    want32 = _ref_nmp(_jnp(params), jnp.asarray(x), jnp.asarray(e), *ref_args)
    tp = params_from_jax(params, "cpu")
    got = sa.fused_nmp_edge_agg(T(x), T(e), tp, *layout, precision=BF16)
    for a, b, c in zip(got, want, want32):
        fwd_close(a.numpy(), b, c)
    # the backward for given cotangents against JAX's VJP of the policy
    rng = np.random.default_rng(100 + seed)
    g_enew = rng.normal(size=e.shape).astype(np.float32)
    g_agg = rng.normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p, xx, ee: _ref_nmp(p, xx, ee, *ref_args, precision=BF16),
                     _jnp(params), jnp.asarray(x), jnp.asarray(e))
    gp, gx, ge = vjp((jnp.asarray(g_enew), jnp.asarray(g_agg)))
    got = sa.fused_nmp_edge_agg_bwd_plain(T(x), T(e), tp, *layout[:3], *layout[3:],
                                          T(g_enew), T(g_agg), precision=BF16)
    # the stacked operands' gradients back onto the tree's leaves
    leaves = [got[2], got[3]]
    for l in range(n_hidden):
        leaves += [got[4][l], got[5][l]]
    if ln:
        leaves += [got[7], got[6]]           # ln/b, ln/g in tree order
    want_layers = [v for lyr in gp["layers"] for v in (lyr["w"], lyr["b"])]
    want_ln = [gp["ln"]["b"], gp["ln"]["g"]] if ln else []
    grads_close([got[0].numpy(), got[1].numpy()] + [t.numpy() for t in leaves],
                [gx, ge] + want_layers + want_ln)
    # the same through the autograd op, and the refusal of other precisions
    with torch.enable_grad():
        leaves_t = nn.tree_leaves(tp)
        for t in leaves_t:
            t.requires_grad_(True)
        out = sa.fused_nmp_edge_agg(T(x), T(e), tp, *layout, precision=BF16)
        g_op = torch.autograd.grad(out, leaves_t, (T(g_enew), T(g_agg)))
    grads_close([t.numpy() for t in g_op], jax.tree.leaves(gp))
    with pytest.raises(ValueError, match="precision"):
        sa.fused_nmp_edge_agg(T(x), T(e), tp, *layout, precision="fp8")
    with pytest.raises(ValueError, match="precision"):
        sa.fused_nmp_edge_agg_bwd(T(x), T(e), tp, *layout[:3], None, None, *layout[3:],
                                  T(g_enew), T(g_agg), precision="fp8")


# ---------------------------------------------------------------------------
# the GNN: one rank, stacked R=4, the port's own 1 == 4 ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[(8, 2), (32, 5)], ids=["h8", "h32"])
def gnn(request):
    hidden, layers = request.param
    cfg = RefConfig(hidden=hidden, n_mp_layers=2, mlp_hidden_layers=layers)
    np_params = jax.tree.map(np.asarray, ref_init_gnn(jax.random.PRNGKey(0), cfg))
    sem = ref_box_mesh(ELEMS, p=ORDER)
    x = taylor_green_velocity(sem.coords)
    y = taylor_green_velocity(sem.coords, t=0.05)
    return dict(cfg=cfg, np_params=np_params, sem=sem, port_sem=box_mesh(ELEMS, p=ORDER),
                x=x, y=y, params=params_from_jax(np_params, "cpu"), ref={})


def _ref_run(gnn, grid, mode, precision):
    key = (grid, mode, precision)
    if key not in gnn["ref"]:
        pg = ref_partition_mesh(gnn["sem"], grid)
        plan = RefPlan.build(pg, mode, precision=precision)
        g = RefGraph.build(pg, gnn["sem"].coords, plan)
        xs, ys = (jnp.asarray(gather_node_features(pg, f)) for f in (gnn["x"], gnn["y"]))
        loss, y, grads = ref_loss_and_grad(_jnp(gnn["np_params"]), xs, ys, g, plan,
                                           gnn["cfg"].node_out)
        gnn["ref"][key] = (float(loss), scatter_node_outputs(pg, np.asarray(y)),
                           [np.asarray(t) for t in jax.tree.leaves(grads)])
    return gnn["ref"][key]


def _port_run(gnn, grid, mode, backend, precision=BF16, packed=False):
    pg = partition_mesh(gnn["port_sem"], grid)
    plan = NMPPlan.build(pg, mode, packed=packed, backend=backend, precision=precision,
                         block_e=BLOCK_E)
    g = ShardedGraph.build(pg, gnn["port_sem"].coords, plan, device="cpu")
    xs, ys = (torch.from_numpy(gather_node_features(pg, f)) for f in (gnn["x"], gnn["y"]))
    loss, y, grads = loss_and_grad_stacked(
        gnn["params"], xs, ys, g, plan, gnn["cfg"].node_out,
        sync_fn=halo_sync_stacked if packed else None)
    return (float(loss), scatter_node_outputs(pg, y.numpy()),
            [t.numpy() for t in nn.tree_leaves(grads)])


def _against_reference(got, want, want32):
    (lg, yg, gg), (lw, yw, gw), (l32, y32, _) = got, want, want32
    fwd_close(yg, yw, y32)
    fwd_close(np.array([lg]), np.array([lw]), np.array([l32]))
    grads_close(gg, gw)


@pytest.mark.parametrize("backend", [XLA, FUSED])
def test_one_rank_gnn_bf16_matches_reference(gnn, backend):
    """Forward, Eq. 6 loss and every parameter gradient at R=1."""
    want = _ref_run(gnn, (1, 1, 1), NONE, BF16)
    want32 = _ref_run(gnn, (1, 1, 1), NONE, FP32)
    got = _port_run(gnn, (1, 1, 1), NONE, backend)
    _against_reference(got, want, want32)


def test_stacked_four_ranks_bf16_matches_reference(gnn):
    """The (2,2,1) split through the stacked emulator, A2A, both packages."""
    want = _ref_run(gnn, (2, 2, 1), A2A, BF16)
    want32 = _ref_run(gnn, (2, 2, 1), A2A, FP32)
    _against_reference(_port_run(gnn, (2, 2, 1), A2A, FUSED), want, want32)


def test_port_one_rank_equals_four_ranks_bf16(gnn):
    """The paper's guarantee in bf16, on the port alone: R=1 against the
    (2,2,1) split under the packed neighbor exchange (the kernels' path)."""
    l1, y1, g1 = _port_run(gnn, (1, 1, 1), NONE, FUSED)
    l4, y4, g4 = _port_run(gnn, (2, 2, 1), NEIGHBOR, FUSED, packed=True)
    assert abs(l4 - l1) <= LOSS_REL * abs(l1), (l4, l1)
    np.testing.assert_allclose(y4, y1, rtol=RTOL, atol=ATOL)
    for a, b in zip(g4, g1):
        assert float(np.abs(a - b).max()) <= LEAF_REL * float(np.abs(b).max())


# ---------------------------------------------------------------------------
# plan, policy, the CLIs and the engine
# ---------------------------------------------------------------------------

def test_bf16_plan_policy_and_refusals():
    with pytest.raises(ValueError, match="precision"):
        NMPPlan(precision="fp8")
    plan = NMPPlan(backend=FUSED, precision=BF16, halo=NMPPlan().halo)
    assert plan.policy()["precision"] == BF16
    assert NMPPlan().policy()["precision"] == FP32
    pg = partition_mesh(box_mesh((2, 2, 1), p=2), (2, 1, 1))
    built = NMPPlan.build(pg, NEIGHBOR, packed=True, backend=FUSED, precision=BF16)
    assert built.precision == BF16 and one_rank_plan(built).precision == BF16
    job = serve_cli.ServeJob(ckpt_dir="x", precision=BF16)
    assert job.plan().precision == BF16


def test_engine_serves_bf16_plan_within_band_of_reference(tmp_path):
    """A checkpoint whose fingerprint predates ``precision`` (its policy has
    no such key) served by a bf16 fused plan: the mesh's plan carries bf16,
    streamed == offline bitwise, and the result within the forward bands of
    ``repro``'s engine on a bf16 plan."""
    cfg = dict(hidden=8, n_mp_layers=2, mlp_hidden_layers=2)
    sem = ref_box_mesh((3, 3, 2), p=2)
    params = ref_init_gnn(jax.random.PRNGKey(0), RefConfig(**cfg))
    fp = ref_run_fingerprint(sem, ref_partition_mesh(sem, (1, 1, 1)), RefConfig(**cfg),
                             RefTrainConfig(), RefPlan())
    fp["policy"].pop("precision")
    ckdir = tmp_path / "ck"
    ref_ckpt.save(ckdir, 0, {"params": params}, extra={"fingerprint": fp})
    snap = taylor_green_velocity(sem.coords, t=0.15).astype(np.float32)
    want = {}
    for prec in (BF16, FP32):
        ref = RefEngine(ckdir, RefConfig(**cfg), RefEngineConfig(batch_slots=2,
                                                                 rollout_steps=2),
                        plan=RefPlan(precision=prec))
        want[prec] = ref.offline_reference(ref.register_mesh(sem), snap)
    eng = InferenceEngine(ckdir, GNNConfig(**cfg), EngineConfig(batch_slots=2,
                                                                rollout_steps=2),
                          plan=NMPPlan(backend=FUSED, precision=BF16), device="cpu")
    port_sem = box_mesh((3, 3, 2), p=2)
    h = eng.register_mesh(port_sem)
    assert eng.entry(h).plan.precision == BF16
    got = eng.offline_reference(h, snap)
    fwd_close(got[0], want[BF16][0], want[FP32][0])
    with eng:
        served = dict(eng.stream(h, lambda s: snap, 2, n_producers=1))
    assert all(np.array_equal(r.preds, got) for r in served.values())


def test_train_cli_bf16_one_and_two_ranks(capsys):
    """``--mp-precision bf16`` through the training CLI on the CPU: 2 steps
    at R=1, and at ``--ranks 2 1 1`` (2 gloo processes through
    ``launch.mesh.spawn``, whose rendezvous is a ``FileStore``): step 0's
    loss within the consistency band of R=1's, and away from fp32's."""
    base = ["--device", "cpu", "--elements", "2", "2", "1", "--order", "2",
            "--steps", "2", "--batch", "1", "--halo", "neighbor"]
    one = train_cli.main(base + ["--mp-precision", "bf16"])
    fp32 = train_cli.main(base)
    two = train_cli.main(base + ["--mp-precision", "bf16", "--ranks", "2", "1", "1"])
    assert "precision=bf16" in capsys.readouterr().out
    for hist in (one, two):
        assert len(hist["losses"]) == 2 and np.all(np.isfinite(hist["losses"]))
    l1, l2, l32 = one["losses"][0], two["losses"][0], fp32["losses"][0]
    assert abs(l2 - l1) <= LOSS_REL * abs(l1), (l1, l2)
    assert l1 != l32
