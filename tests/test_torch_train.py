"""Training path of the torch port against the JAX reference package:
stacked loss and gradients (R=1 and R=4, a2a and packed neighbor, both
port backends), the port's own 1-rank == 4-rank gradients (Eq. 3), the
K-step rollout, AdamW, the batch functions, the training loop's loss curve
from the same weights, checkpoints the reference restores, and the CLIs.

Inputs are made with numpy from a seed; weights come from ``repro`` and
cross into the port through ``repro_torch.convert``.  Bands (the ones the
reference holds itself to, ``tests/test_consistency.py`` and the rollout
notes of ROADMAP.md): loss rel 2e-6, gradients rtol 1e-3 / atol 2e-5,
K-step rollout gradients to a relative norm of 5e-4, AdamW rtol 1e-6
(fp32 elementwise math; atol 1e-8 for moments that start at zero), and
the 5-step training curve rel 2e-6 at step 0, rel 1e-4 after (the updates
compound the fp32 summation-order spread of the gradients).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.ckpt import checkpoint as ref_ckpt
from repro.core import GNNConfig as RefConfig
from repro.core import NMPPlan as RefPlan
from repro.core import ShardedGraph as RefGraph
from repro.core import box_mesh as ref_box_mesh
from repro.core import init_gnn as ref_init_gnn
from repro.core import partition_mesh as ref_partition_mesh
from repro.core.reference import loss_and_grad_stacked as ref_loss_and_grad
from repro.core.reference import rollout_stacked as ref_rollout_stacked
from repro.launch.mesh import make_mesh
from repro.runtime.straggler import StragglerMonitor as RefMonitor
from repro.train import loop as ref_loop
from repro.train import optimizer as ref_opt
from repro.train.rollout import curriculum_k as ref_curriculum_k
from repro.train.rollout import make_tgv_rollout_batch_fn as ref_rollout_batch_fn

from repro_torch import nn
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.distributed import make_gnn_step_fns
from repro_torch.core.gnn import GNNConfig, init_gnn
from repro_torch.core.graph_state import FUSED, XLA, NMPPlan, ShardedGraph
from repro_torch.core.halo import A2A, NEIGHBOR, NONE, halo_sync_stacked
from repro_torch.core.mesh_gen import box_mesh, taylor_green_velocity
from repro_torch.core.partition import gather_node_features, partition_mesh
from repro_torch.core.reference import loss_and_grad_stacked, rollout_stacked
from repro_torch.launch import train as train_cli
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import (
    TrainConfig, legacy_key, make_tgv_batch_fn, train_consistent_gnn)
from repro_torch.train.rollout import (
    curriculum_k, make_rollout_step_fns, make_tgv_rollout_batch_fn)

LOSS_REL = 2e-6
G_RTOL, G_ATOL = 1e-3, 2e-5
ROLLOUT_GRAD_REL = 5e-4
ELEMS = (4, 2, 2)
FY = 3


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _assert_grads_close(got, want, rtol=G_RTOL, atol=G_ATOL):
    got_l = nn.tree_leaves(got)
    want_l = jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol)


def _grad_rel_norm(got, want):
    a = np.concatenate([t.numpy().ravel() for t in nn.tree_leaves(got)])
    b = np.concatenate([np.asarray(t).ravel() for t in jax.tree_util.tree_leaves(want)])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def case():
    cfg = RefConfig(hidden=8, n_mp_layers=2, mlp_hidden_layers=2)
    np_params = jax.tree.map(np.asarray, ref_init_gnn(jax.random.PRNGKey(0), cfg))
    sem = ref_box_mesh(ELEMS, p=2)
    rng = np.random.default_rng(0)
    x = taylor_green_velocity(sem.coords, t=0.1)
    y = x + 0.1 * rng.normal(size=x.shape).astype(np.float32)
    return dict(np_params=np_params, sem=sem, port_sem=box_mesh(ELEMS, p=2),
                x=x, y=y, params=params_from_jax(np_params, "cpu"))


def _graphs(case, grid, mode, packed=False, backend=XLA):
    """(reference graph + plan, port graph + plan) of one partition."""
    ref_pg = ref_partition_mesh(case["sem"], grid)
    ref_plan = RefPlan.build(ref_pg, mode)
    ref_g = RefGraph.build(ref_pg, case["sem"].coords, ref_plan)
    pg = partition_mesh(case["port_sem"], grid)
    plan = NMPPlan.build(pg, mode, packed=packed, backend=backend)
    g = ShardedGraph.build(pg, case["port_sem"].coords, plan, device="cpu")
    return (ref_g, ref_plan), (pg, g, plan)


def _stacked(pg, field):
    return gather_node_features(pg, field).astype(np.float32)


# ---------------------------------------------------------------------------
# stacked loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", [XLA, FUSED])
@pytest.mark.parametrize("grid,mode,packed", [
    ((1, 1, 1), NONE, False), ((2, 2, 1), A2A, False), ((2, 2, 1), NEIGHBOR, True)],
    ids=["r1", "r4-a2a", "r4-packed-neighbor"])
def test_loss_and_grad_stacked_matches_reference(case, grid, mode, packed, backend):
    (ref_g, ref_plan), (pg, g, plan) = _graphs(case, grid, mode, packed, backend)
    x, y = _stacked(pg, case["x"]), _stacked(pg, case["y"])
    ref_loss, _, ref_grads = ref_loss_and_grad(
        jax.tree.map(jnp.asarray, case["np_params"]), jnp.asarray(x),
        jnp.asarray(y), ref_g, ref_plan, FY)
    sync = halo_sync_stacked if packed else None
    loss, _, grads = loss_and_grad_stacked(
        case["params"], torch.from_numpy(x), torch.from_numpy(y), g, plan, FY,
        sync_fn=sync)
    assert _rel(loss, ref_loss) <= LOSS_REL
    _assert_grads_close(grads, ref_grads)


def test_port_grads_one_rank_equal_four_ranks(case):
    """Eq. 3 on the port alone: fused backend, packed neighbor exchange
    (pack/unpack as each other's adjoint) vs one rank."""
    out = []
    for grid, mode in (((1, 1, 1), NONE), ((2, 2, 1), NEIGHBOR)):
        _, (pg, g, plan) = _graphs(case, grid, mode, packed=True, backend=FUSED)
        x, y = _stacked(pg, case["x"]), _stacked(pg, case["y"])
        out.append(loss_and_grad_stacked(
            case["params"], torch.from_numpy(x), torch.from_numpy(y), g, plan,
            FY, sync_fn=halo_sync_stacked))
    (l1, _, g1), (l4, _, g4) = out
    assert _rel(l4, l1) <= LOSS_REL
    for a, b in zip(nn.tree_leaves(g4), nn.tree_leaves(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=G_RTOL, atol=G_ATOL)


@pytest.mark.parametrize("grid,mode", [((1, 1, 1), NONE), ((2, 2, 1), A2A)],
                         ids=["r1", "r4-a2a"])
def test_rollout_stacked_matches_reference(case, grid, mode):
    K = 3
    (ref_g, ref_plan), (pg, g, plan) = _graphs(case, grid, mode, backend=FUSED)
    sem = case["sem"]
    x0 = _stacked(pg, case["x"])
    targets = np.stack([_stacked(pg, taylor_green_velocity(sem.coords, t=0.1 + 0.05 * k))
                        for k in range(1, K + 1)])
    noise = _stacked(pg, 0.01 * np.random.default_rng(5).normal(
        size=case["x"].shape).astype(np.float32))

    def ref_f(p):
        return ref_rollout_stacked(p, jnp.asarray(x0), jnp.asarray(targets),
                                   ref_g, ref_plan, FY, noise=jnp.asarray(noise))[0]
    ref_loss, ref_grads = jax.value_and_grad(ref_f)(
        jax.tree.map(jnp.asarray, case["np_params"]))
    T = torch.from_numpy
    loss, grads = nn.value_and_grad(
        lambda p: rollout_stacked(p, T(x0), T(targets), g, plan, FY, noise=T(noise))[0],
        case["params"])
    assert _rel(loss, ref_loss) <= LOSS_REL
    assert _grad_rel_norm(grads, ref_grads) <= ROLLOUT_GRAD_REL


# ---------------------------------------------------------------------------
# optimizer, batches, monitor
# ---------------------------------------------------------------------------

def test_adamw_matches_reference_with_clipping_and_decay(case):
    ref_cfg = ref_opt.AdamWConfig(schedule=ref_opt.constant_lr(1e-2),
                                  weight_decay=0.1, clip_norm=0.5)
    cfg = opt.AdamWConfig(schedule=opt.constant_lr(1e-2), weight_decay=0.1,
                          clip_norm=0.5)
    assert nn.tree_leaves(opt._decay_mask(case["params"], cfg)) == \
        jax.tree_util.tree_leaves(ref_opt._decay_mask(case["np_params"], ref_cfg))
    rp = jax.tree.map(jnp.asarray, case["np_params"])
    rs = ref_opt.init_adamw(rp, ref_cfg)
    p, s = case["params"], opt.init_adamw(case["params"], cfg)
    rng = np.random.default_rng(3)
    for _ in range(3):
        g_np = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                            case["np_params"])
        rp, rs, rinfo = ref_opt.adamw_update(jax.tree.map(jnp.asarray, g_np), rs, rp,
                                             ref_cfg)
        p, s, info = opt.adamw_update(params_from_jax(g_np, "cpu"), s, p, cfg)
        assert float(rinfo["grad_norm"]) > 0.5          # the clip is active
        np.testing.assert_allclose(float(info["grad_norm"]),
                                   float(rinfo["grad_norm"]), rtol=1e-6)
        for got, want in ((p, rp), (s["m"], rs["m"]), (s["v"], rs["v"])):
            for a, b in zip(nn.tree_leaves(got), jax.tree_util.tree_leaves(want)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                           atol=1e-8)
        assert int(s["step"]) == int(rs["step"])


def test_warmup_cosine_matches_reference():
    ref_f = ref_opt.warmup_cosine(1e-3, 5, 20)
    f = opt.warmup_cosine(1e-3, 5, 20)
    for step in (0, 1, 4, 5, 6, 12, 20, 25):
        np.testing.assert_allclose(float(f(step)), float(ref_f(step)), rtol=1e-6)


def test_batch_fns_and_curriculum_match_reference(case):
    sem, pg = case["sem"], partition_mesh(case["port_sem"], (2, 2, 1))
    ref_pg = ref_partition_mesh(sem, (2, 2, 1))
    ref_bf = ref_rollout_batch_fn(ref_pg, sem, 2, 3, noise_scale=0.05, seed=7)
    bf = make_tgv_rollout_batch_fn(pg, case["port_sem"], 2, 3, noise_scale=0.05, seed=7)
    for step in (0, 4):
        for a, b in zip(bf(step), ref_bf(step)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    one = make_tgv_batch_fn(pg, case["port_sem"], 2)(3)
    assert np.array_equal(one, ref_loop.make_tgv_batch_fn(ref_pg, sem, 2)(3))
    for step in range(12):
        assert curriculum_k((1, 2, 4), 10, step) == ref_curriculum_k((1, 2, 4), 10, step)


def test_straggler_monitor_matches_reference():
    rng = np.random.default_rng(0)
    dts = list(rng.uniform(0.9, 1.1, 30)) + [5.0] + list(rng.uniform(0.9, 1.1, 5))
    mine, ref = StragglerMonitor(), RefMonitor()
    for step, dt in enumerate(dts):
        a, b = mine.observe(step, dt), ref.observe(step, dt)
        assert (a is None) == (b is None)
    assert [e.step for e in mine.events] == [e.step for e in ref.events] == [30]


def test_legacy_key_is_the_reference_prng_key():
    for seed in (0, 7, 2**33 + 5):
        assert np.array_equal(legacy_key(seed), np.asarray(jax.random.PRNGKey(seed)))


# ---------------------------------------------------------------------------
# step functions and the training loop
# ---------------------------------------------------------------------------

def test_step_fns_on_one_rank_and_refusal_of_four(case):
    _, (pg, g, plan) = _graphs(case, (1, 1, 1), NEIGHBOR, backend=FUSED)
    eval_step, loss_step, grad_step, train_step = make_gnn_step_fns(
        GNNConfig(hidden=8, n_mp_layers=2, mlp_hidden_layers=2), plan, 0.1)
    x = torch.from_numpy(_stacked(pg, case["x"]))[None]          # [1, 1, N, F]
    y = torch.from_numpy(_stacked(pg, case["y"]))[None]
    assert eval_step(case["params"], x, g).shape == (1, 1, pg.n_pad, FY)
    loss, grads = grad_step(case["params"], x, y, g)
    assert torch.equal(loss, loss_step(case["params"], x, y, g))
    loss2, new = train_step(case["params"], x, y, g)
    assert torch.equal(loss, loss2)
    assert float(loss_step(new, x, y, g)) < float(loss)
    _, (_, g4, _) = _graphs(case, (2, 2, 1), NEIGHBOR)
    with pytest.raises(ValueError, match="needs a mesh"):
        eval_step(case["params"], x, g4)


def test_rollout_step_fns_grad_matches_stacked_oracle(case):
    K = 2
    _, (pg, g, plan) = _graphs(case, (1, 1, 1), NONE, backend=FUSED)
    bf = make_tgv_rollout_batch_fn(pg, case["port_sem"], 1, K, noise_scale=0.02, seed=1)
    x0, tg, nz = (torch.from_numpy(a) for a in bf(2))
    _, rollout_grad = make_rollout_step_fns(None, plan, K)
    loss, grads = rollout_grad(case["params"], x0, tg, nz, g)
    want, want_g = nn.value_and_grad(
        lambda p: rollout_stacked(p, x0[0], tg[0], g, plan, FY, noise=nz[0])[0],
        case["params"])
    assert _rel(loss, want) <= LOSS_REL
    assert _grad_rel_norm(grads, params_to_jax(want_g)) <= ROLLOUT_GRAD_REL


@pytest.fixture(scope="module")
def trained(case, tmp_path_factory):
    """5 steps of the reference's loop and the port's (both backends) from
    the reference's own initial state."""
    cfg = RefConfig.small()
    tcfg = ref_loop.TrainConfig(n_steps=5, batch=1, lr=1e-3)
    ref_state = ref_loop._init_state(cfg, tcfg, ref_opt.AdamWConfig())
    ref_hist = ref_loop.train_consistent_gnn(
        make_mesh((1, 1), ("data", "graph")), ref_partition_mesh(case["sem"], (1, 1, 1)),
        case["sem"], cfg, tcfg)
    start = jax.tree.map(np.asarray, ref_state["params"])
    pg = partition_mesh(case["port_sem"], (1, 1, 1))
    ckdir = tmp_path_factory.mktemp("train") / "ck"
    hists = {}
    for backend in (XLA, FUSED):
        hists[backend] = train_consistent_gnn(
            pg, case["port_sem"], GNNConfig.small(),
            TrainConfig(n_steps=5, batch=1, lr=1e-3, plan=NMPPlan(backend=backend),
                        ckpt_dir=str(ckdir) if backend == FUSED else None,
                        ckpt_every=2),
            params=start, device="cpu")
    return dict(ref=ref_hist, hists=hists, ckdir=ckdir, cfg=cfg, tcfg=tcfg)


@pytest.mark.parametrize("backend", [XLA, FUSED])
def test_training_curve_matches_reference(trained, backend):
    got, want = trained["hists"][backend]["losses"], trained["ref"]["losses"]
    assert len(got) == len(want) == 5
    assert _rel(got[0], want[0]) <= LOSS_REL
    for a, b in zip(got[1:], want[1:]):
        assert _rel(a, b) <= 1e-4
    assert got[-1] < got[0]


def test_port_checkpoint_restores_in_reference(trained):
    template = ref_loop._init_state(trained["cfg"], trained["tcfg"],
                                    ref_opt.AdamWConfig())
    state, manifest = ref_ckpt.restore(trained["ckdir"], template)
    assert manifest["step"] == 4
    assert ref_ckpt.committed_steps(trained["ckdir"]) == [0, 2, 4]
    final = trained["hists"][FUSED]["params"]
    for a, b in zip(jax.tree_util.tree_leaves(state["params"]), nn.tree_leaves(final)):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert int(state["opt"]["step"]) == 5
    assert np.array_equal(np.asarray(state["rng"]), np.asarray(template["rng"]))
    fp = manifest["extra"]["fingerprint"]
    assert fp["ranks"] == 1 and fp["policy"]["backend"] == FUSED
    assert manifest["extra"]["losses"] == trained["hists"][FUSED]["losses"]


def test_training_loop_updates_its_own_copy_of_the_params(case):
    """AdamW runs in place; the caller's starting tensors stay as they were."""
    start = init_gnn(torch.Generator().manual_seed(0), GNNConfig.small(), device="cpu")
    before = nn.tree_map(torch.clone, start)
    hist = train_consistent_gnn(partition_mesh(case["port_sem"], (1, 1, 1)),
                                case["port_sem"], GNNConfig.small(),
                                TrainConfig(n_steps=2, batch=1), params=start,
                                device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(nn.tree_leaves(start),
                                                 nn.tree_leaves(before)))
    assert not all(torch.equal(a, b) for a, b in zip(nn.tree_leaves(hist["params"]),
                                                     nn.tree_leaves(before)))


def test_training_refuses_what_this_slice_lacks(case):
    pg4 = partition_mesh(case["port_sem"], (2, 2, 1))
    with pytest.raises(ValueError, match="needs a mesh"):
        train_consistent_gnn(pg4, case["port_sem"], GNNConfig.small(),
                             TrainConfig(n_steps=1), device="cpu")
    pg1 = partition_mesh(case["port_sem"], (1, 1, 1))
    with pytest.raises(NotImplementedError, match="resilience"):
        train_consistent_gnn(pg1, case["port_sem"], GNNConfig.small(),
                             TrainConfig(n_steps=1, resilience=object()), device="cpu")


def test_train_cli_runs_on_cpu(capsys):
    hist = train_cli.main(["--device", "cpu", "--elements", "2", "2", "1",
                           "--order", "2", "--steps", "2", "--batch", "1",
                           "--rollout-steps", "2", "--pushforward-noise", "0.01"])
    out = capsys.readouterr().out
    assert "(2 steps, 0 straggler events)" in out
    assert len(hist["losses"]) == 2 and all(np.isfinite(hist["losses"]))
    assert hist["rollout_k"] == [2, 2]


@pytest.mark.parametrize("flags", [["--partitioner", "spectral"], ["--mp-schedule", "overlap"],
                                   ["--mp-precision", "bf16"], ["--levels", "2"],
                                   ["--ckpt-dir", "x"]])
def test_train_cli_refuses_later_slices(flags, capsys):
    with pytest.raises(SystemExit):
        train_cli.main(["--device", "cpu", "--steps", "1", *flags])
    assert "ROADMAP queue" in capsys.readouterr().err
