"""Serving path of the torch port: checkpoints in the shared on-disk format
(both directions), the port's engine serving a checkpoint written by the
JAX reference package within the forward band of the reference's own
engine, the bitwise streamed == offline contract, and the refusals."""
import numpy as np
import pytest
import jax

from repro.ckpt import checkpoint as ref_ckpt
from repro.core import GNNConfig as RefConfig
from repro.core import NMPPlan as RefPlan
from repro.core import box_mesh as ref_box_mesh
from repro.core import init_gnn as ref_init_gnn
from repro.core import partition_mesh as ref_partition_mesh
from repro.runtime.engine import EngineConfig as RefEngineConfig
from repro.runtime.engine import InferenceEngine as RefEngine
from repro.train.loop import TrainConfig as RefTrainConfig
from repro.train.loop import run_fingerprint as ref_run_fingerprint
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.convert import params_to_jax
from repro_torch.core.gnn import GNNConfig, init_gnn
from repro_torch.core.graph_state import FUSED, XLA, NMPPlan
from repro_torch.core.mesh_gen import box_mesh, taylor_green_velocity
from repro_torch.core.partition import partition_mesh
from repro_torch.data.pipeline import PrefetchingLoader
from repro_torch.launch import serve as serve_cli
from repro_torch.runtime.engine import (
    EngineConfig, EngineError, InferenceEngine, MeshMismatchError,
    config_from_checkpoint)
from repro_torch.train.loop import (
    TrainConfig, mesh_fingerprint_hash, run_fingerprint)

K = 2
DT = 0.05
RTOL, ATOL = 1e-4, 1e-5
ELEMS = (3, 3, 2)
CFG = dict(hidden=8, n_mp_layers=2, mlp_hidden_layers=2)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A fingerprinted training-shaped checkpoint written by the reference."""
    sem = ref_box_mesh(ELEMS, p=2)
    params = ref_init_gnn(jax.random.PRNGKey(0), RefConfig(**CFG))
    ckdir = tmp_path_factory.mktemp("serve") / "ck"
    fp = ref_run_fingerprint(sem, ref_partition_mesh(sem, (1, 1, 1)),
                             RefConfig(**CFG), RefTrainConfig(), RefPlan())
    ref_ckpt.save(ckdir, 0,
                  {"params": params, "opt": {"m": np.zeros(4, np.float32)},
                   "rng": np.zeros(2, np.uint32)},
                  extra={"fingerprint": fp})
    return dict(sem=box_mesh(ELEMS, p=2), params=params, ckdir=ckdir, fp=fp)


def snapshot(sem, step):
    return taylor_green_velocity(sem.coords, t=(step * DT) % 2.0).astype(np.float32)


def make_engine(served, backend=FUSED, **kw):
    kw.setdefault("batch_slots", 2)
    kw.setdefault("rollout_steps", K)
    return InferenceEngine(served["ckdir"], GNNConfig(**CFG), EngineConfig(**kw),
                           plan=NMPPlan(backend=backend), device="cpu")


def test_fingerprint_hash_matches_reference(served):
    assert mesh_fingerprint_hash(served["sem"]) == served["fp"]["mesh_hash"]
    sem = served["sem"]
    fp = run_fingerprint(sem, partition_mesh(sem, (1, 1, 1)), GNNConfig(**CFG),
                         TrainConfig(), NMPPlan())
    assert {k: v for k, v in fp.items() if k != "policy"} == \
        {k: v for k, v in served["fp"].items() if k != "policy"}


def test_engine_restores_reference_written_params(served):
    eng = make_engine(served)
    got = jax.tree_util.tree_leaves(params_to_jax(eng.params))
    want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, served["params"]))
    assert len(got) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert eng.ckpt_step == 0


@pytest.mark.parametrize("backend", [XLA, FUSED])
def test_served_output_matches_reference_engine(served, backend):
    ref = RefEngine(served["ckdir"], RefConfig(**CFG),
                    RefEngineConfig(batch_slots=2, rollout_steps=K))
    h = ref.register_mesh(ref_box_mesh(ELEMS, p=2))
    want = ref.offline_reference(h, snapshot(served["sem"], 3))
    eng = make_engine(served, backend)
    got = eng.offline_reference(eng.register_mesh(served["sem"]),
                                snapshot(served["sem"], 3))
    assert got.shape == want.shape == (K, served["sem"].n_nodes, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", [XLA, FUSED])
def test_streamed_equals_offline_bitwise(served, backend):
    eng = make_engine(served, backend)
    h = eng.register_mesh(served["sem"])
    assert eng.register_mesh(served["sem"]) == h         # cache hit
    assert eng.stats["cache_builds"] == 1 and eng.stats["cache_hits"] == 1
    eng.warmup()
    with eng:
        got = dict(eng.stream(h, lambda s: snapshot(served["sem"], s), 5,
                              n_producers=2))
    assert len(got) == 5                 # producers interleave step ids
    assert eng.stats["padded_slots"] > 0                 # padding exercised
    for step, res in got.items():
        want = eng.offline_reference(h, snapshot(served["sem"], step))
        assert np.array_equal(res.preds, want), step


def test_engine_refuses_mesh_mismatch_and_bad_snapshots(served):
    eng = make_engine(served)
    with pytest.raises(MeshMismatchError, match=served["fp"]["mesh_hash"]):
        eng.register_mesh(box_mesh((2, 2, 2), p=2))
    h = eng.register_mesh(served["sem"])
    with pytest.raises(EngineError, match="shape"):
        eng.submit(h, np.zeros((3, 3), np.float32))
    with pytest.raises(MeshMismatchError):
        eng.submit("0" * 16, snapshot(served["sem"], 0))


def test_engine_refuses_unfingerprinted_and_wrong_config(served, tmp_path):
    bare = tmp_path / "bare"
    ref_ckpt.save(bare, 0, {"params": served["params"]})
    with pytest.raises(EngineError, match="fingerprint"):
        InferenceEngine(bare, GNNConfig(**CFG), device="cpu")
    with pytest.raises(EngineError, match="hidden"):
        InferenceEngine(served["ckdir"],
                        GNNConfig(hidden=16, n_mp_layers=2, mlp_hidden_layers=2),
                        device="cpu")


def test_engine_falls_back_past_corrupted_newest_step(served, tmp_path):
    ckdir = tmp_path / "corrupt"
    ckpt.save(ckdir, 0, {"params": served["params"]},
              extra={"fingerprint": served["fp"]})
    other = jax.tree.map(lambda a: np.asarray(a) + 1.0, served["params"])
    ckpt.save(ckdir, 1, {"params": other}, extra={"fingerprint": served["fp"]})
    shard = ckdir / "step_0000000001" / "shard_0.npz"
    shard.write_bytes(shard.read_bytes()[:64])          # truncate after commit
    eng = InferenceEngine(ckdir, GNNConfig(**CFG), device="cpu")
    assert eng.ckpt_step == 0


def test_port_written_checkpoint_restores_in_reference(served, tmp_path):
    params = init_gnn(torch.Generator().manual_seed(1), GNNConfig(**CFG),
                      device="cpu")
    ckdir = tmp_path / "port"
    ckpt.save(ckdir, 7, {"params": params}, extra={"fingerprint": served["fp"]})
    template = jax.tree.map(np.asarray, served["params"])
    vals, manifest = ref_ckpt.restore_partial(ckdir, template, "params")
    assert manifest["step"] == 7
    want = jax.tree_util.tree_leaves(params_to_jax(params))
    assert all(np.array_equal(np.asarray(a), b)
               for a, b in zip(jax.tree_util.tree_leaves(vals), want))
    # same key paths as a reference-written checkpoint
    assert ref_ckpt.peek_manifest(ckdir)["keys"] == [
        k for k in ref_ckpt.peek_manifest(served["ckdir"])["keys"]
        if k.startswith("params/")]
    with pytest.raises(ValueError, match="prefix"):
        ckpt.restore_partial(ckdir, template, "nonexistent")


def test_config_read_from_reference_written_checkpoint(served, tmp_path):
    cfg = config_from_checkpoint(served["ckdir"])
    assert (cfg.hidden, cfg.n_mp_layers, cfg.mlp_hidden_layers) == (8, 2, 2)
    assert (cfg.node_in, cfg.edge_in, cfg.node_out) == (3, 7, 3)
    with pytest.raises(EngineError, match="no committed"):
        config_from_checkpoint(tmp_path / "none")


@pytest.mark.parametrize("name", ["small", "large"])
def test_config_read_from_port_written_checkpoint(name, tmp_path):
    cfg = getattr(GNNConfig, name)()
    ckpt.save(tmp_path, 0, {"params": init_gnn(torch.Generator().manual_seed(0),
                                               cfg, device="cpu")})
    assert config_from_checkpoint(tmp_path) == cfg


def test_prefetching_loader_drains_then_raises():
    def fn(step):
        if step == 3:
            raise RuntimeError("producer died")
        return step

    loader = PrefetchingLoader(fn, prefetch=8)
    got = []
    with pytest.raises(RuntimeError, match="producer died"):
        for step, item in loader:
            got.append(item)
    loader.close()
    assert got == [0, 1, 2]


def test_serve_cli_serves_and_refuses_missing_checkpoint(served, tmp_path, capsys):
    # the CLI reads the paper's small config (M=4) from the checkpoint
    sem, cfg = served["sem"], GNNConfig.small()
    fp = run_fingerprint(sem, partition_mesh(sem, (1, 1, 1)), cfg,
                         TrainConfig(), NMPPlan())
    ckdir = tmp_path / "small"
    ckpt.save(ckdir, 0, {"params": init_gnn(torch.Generator().manual_seed(0),
                                            cfg, device="cpu")},
              extra={"fingerprint": fp})
    serve_cli.main(["--ckpt-dir", str(ckdir), "--mesh", "3,3,2",
                    "--requests", "3", "--batch-slots", "2", "--device", "cpu",
                    "--mp-backend", "fused"])
    out = capsys.readouterr().out
    assert "small config (N_H=8, M=4)" in out and "3 requests" in out
    # no checkpoint and --bootstrap-steps 0: nothing to serve
    with pytest.raises(SystemExit):
        serve_cli.main(["--ckpt-dir", str(tmp_path / "none"), "--device", "cpu",
                        "--bootstrap-steps", "0"])
    assert "nothing to serve" in capsys.readouterr().err
    # no checkpoint and --bootstrap-steps 2: train one, then serve from it
    boot = tmp_path / "boot"
    serve_cli.main(["--ckpt-dir", str(boot), "--mesh", "3,3,2", "--bootstrap-steps",
                    "2", "--requests", "2", "--batch-slots", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "bootstrapping with a 2-step training run" in out
    assert "from step 1" in out and "2 requests" in out
    assert ckpt.committed_steps(boot) == [0, 1]
    assert ckpt.peek_manifest(boot)["extra"]["fingerprint"]["ranks"] == 1
