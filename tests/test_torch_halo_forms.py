"""The halo exchange's remaining forms in the port: the bf16 wire, the
two-level ``rounds2d`` routing and ``combine="max"``, against the JAX
reference package and through ``torch.distributed``.

* ``build_2d_halo_rounds`` (rounds and arrays) and ``flat_rounds2d_perms``
  array-equal to ``repro``'s; ``partition_mesh_2d`` carries them into the
  plan (``NMPPlan.build(pg, "neighbor")`` gives the rounds2d spec).
* Every form (a2a, neighbor, packed neighbor, rounds2d, packed rounds2d)
  x wire {fp32, bf16} x combine {sum, max} of ``halo_sync_stacked``
  within 1e-6 of ``repro``'s ``halo_sync_stacked`` on the same seeded
  aggregate and wire (both round to nearest even; ``repro``'s packed sum
  runs its Pallas kernels, which do not trace on this JAX — ``pl.load`` was
  removed — so it is held against ``repro``'s dense form, which the
  reference holds bitwise equal to it).  The bf16 cells also within
  ``tests/test_extras.py``'s 2e-2 of the port's own fp32 wire, with the
  quantisation actually happening, and of the A2A oracle.
* ``combine="max"`` against ``repro``'s ``halo_sync_reference`` (the
  oracle of ``tests/test_consistency.py``), and packed == dense, bitwise,
  every form; a gradient through max is refused.
* A rounds2d R=4 loss against R=1 within ``tests/drivers/halo2d_driver.py``'s
  rel 2e-6, the overlap schedule's loss and gradients against blocking
  within its bands; the packed rounds2d gradient through the pack /
  unpack-add op.
* Over 4 gloo processes (``launch/consistency.py``, ``Job.forms``): every
  form's exchange bitwise equal to the stacked emulator's rank slice, and
  under sum its gradient (bitwise for the packed forms, atol 1e-6 for the
  others, where autograd accumulates in another order); no pack launch
  under max; the bf16 forms hand the backend exactly half the bytes of
  their fp32 forms.

Inputs are numpy from a seed.
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import halo as ref_halo
from repro.core import partition as ref_part
from repro.core.graph_state import NMPPlan as RefPlan
from repro.core.graph_state import ShardedGraph as RefGraph
from repro.core.mesh_gen import box_mesh as ref_box_mesh

from repro_torch.core import partition as part
from repro_torch.core.gnn import GNNConfig, init_gnn
from repro_torch.core.graph_state import FUSED, XLA, NMPPlan, ShardedGraph
from repro_torch.core.halo import (
    A2A, MAX, NEIGHBOR, NONE, SUM, HaloSpec, halo_sync_reference, halo_sync_stacked)
from repro_torch.core.mesh_gen import box_mesh, taylor_green_velocity
from repro_torch.core.partition import gather_node_features
from repro_torch.core.reference import loss_and_grad_stacked
from repro_torch.launch import consistency as cons

ELEMS, ORDER, GRID2D = (4, 4, 2), 2, (2, 2)
FORM_BASES = ("a2a", "neighbor", "packed", "rounds2d", "rounds2d_packed")
BAND = 2e-2            # tests/test_extras.py:49
REF_TOL = 1e-6
LOSS_REL = 2e-6        # tests/drivers/halo2d_driver.py
G_RTOL, G_ATOL = 2e-3, 2e-4


@pytest.fixture(scope="module")
def forms():
    """Per form base: the port's (pg, graph, spec) and the reference's
    (graph, spec, rounds_perms) on the same split."""
    sem, ref_sem = box_mesh(ELEMS, p=ORDER), ref_box_mesh(ELEMS, p=ORDER)
    out = {}
    for base in FORM_BASES:
        packed = base.endswith("packed")
        if base.startswith("rounds2d"):
            Ga, Gb = GRID2D
            graphs = ref_part.from_element_partition(
                ref_sem, ref_part.partition_elements(ref_sem, (Gb, Ga, 1)), Ga * Gb)
            rpg = ref_part.pack(graphs, ref_sem.n_nodes)
            rounds2d, nbr = ref_part.build_2d_halo_rounds(graphs, GRID2D)
            rspec = ref_halo.HaloSpec(mode="neighbor", rounds2d=rounds2d, packed=packed)
            rg = RefGraph.build(rpg, ref_sem.coords, RefPlan(halo=rspec))
            rg = rg.with_arrays(**{k: jnp.asarray(v) for k, v in nbr.items()},
                                **{k: jnp.asarray(v) for k, v in
                                   ref_part.packed_halo_arrays(nbr).items()})
            perms = ref_part.flat_rounds2d_perms(GRID2D)
            pg = part.partition_mesh_2d(sem, GRID2D)
        else:
            rpg = ref_part.partition_mesh(ref_sem, (2, 2, 1))
            mode = "a2a" if base == "a2a" else "neighbor"
            rplan = RefPlan.build(rpg, mode, packed=packed)
            rg, rspec, perms = RefGraph.build(rpg, ref_sem.coords, rplan), rplan.halo, None
            pg = part.partition_mesh(sem, (2, 2, 1))
        plan = NMPPlan.build(pg, A2A if base == "a2a" else NEIGHBOR, packed=packed)
        g = ShardedGraph.build(pg, sem.coords, plan, device="cpu")
        out[base] = (pg, g, plan.halo, rg, rspec, perms)
    return out


def _aggregate(pg, seed=7, f=8):
    a = np.random.default_rng(seed).normal(size=(pg.R, pg.n_pad, f)).astype(np.float32)
    return (a * pg.node_mask[..., None]).astype(np.float32)


def test_2d_rounds_array_equal():
    sem, ref_sem = box_mesh(ELEMS, p=ORDER), ref_box_mesh(ELEMS, p=ORDER)
    for grid in ((2, 2), (1, 4), (4, 1)):
        Ga, Gb = grid
        graphs = part.from_element_partition(
            sem, part.partition_elements(sem, (Gb, Ga, 1)), Ga * Gb)
        ref_graphs = ref_part.from_element_partition(
            ref_sem, ref_part.partition_elements(ref_sem, (Gb, Ga, 1)), Ga * Gb)
        rounds, arrays = part.build_2d_halo_rounds(graphs, grid, ("x", "y"))
        ref_rounds, ref_arrays = ref_part.build_2d_halo_rounds(ref_graphs, grid, ("x", "y"))
        assert rounds == ref_rounds
        assert arrays.keys() == ref_arrays.keys()
        for k in arrays:
            assert arrays[k].dtype == ref_arrays[k].dtype
            np.testing.assert_array_equal(arrays[k], ref_arrays[k])
        assert part.flat_rounds2d_perms(grid) == ref_part.flat_rounds2d_perms(grid)
    with pytest.raises(ValueError, match="grid"):
        part.build_2d_halo_rounds(graphs, (3, 3))


def test_partition_mesh_2d_carries_the_plan(forms):
    pg, g, spec = forms["rounds2d"][:3]
    assert spec.mode == NEIGHBOR and len(spec.rounds2d) == 8
    assert spec.grid2d == (("data", 2), ("model", 2))
    assert spec.perms == part.flat_rounds2d_perms(GRID2D)
    assert g["nbr_send_idx"].shape[1] == 8
    gp = forms["rounds2d_packed"][1]
    assert len([k for k in gp.wires if k.startswith("pk") and k.endswith("_send")]) == 9


@pytest.mark.parametrize("combine", [SUM, MAX])
@pytest.mark.parametrize("wire", [None, "bfloat16"])
@pytest.mark.parametrize("base", FORM_BASES)
def test_stacked_form_matches_reference(forms, base, wire, combine):
    pg, g, spec, rg, rspec, perms = forms[base]
    a = _aggregate(pg)
    rs = dataclasses.replace(rspec, wire_dtype=None if wire is None else jnp.bfloat16,
                             packed=rspec.packed and combine == MAX)
    want = np.asarray(ref_halo.halo_sync_stacked(jnp.asarray(a), rg, rs, combine=combine,
                                                 rounds_perms=perms))
    got = halo_sync_stacked(torch.from_numpy(a), g, dataclasses.replace(spec, wire_dtype=wire),
                            combine=combine)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REF_TOL)


@pytest.mark.parametrize("combine", [SUM, MAX])
@pytest.mark.parametrize("base", FORM_BASES)
def test_bf16_wire_band_quantisation_and_oracle(forms, base, combine):
    pg, g, spec = forms[base][:3]
    a = torch.from_numpy(_aggregate(pg))
    full = halo_sync_stacked(a, g, spec, combine=combine)
    comp = halo_sync_stacked(a, g, dataclasses.replace(spec, wire_dtype=torch.bfloat16),
                             combine=combine)
    np.testing.assert_allclose(comp.numpy(), full.numpy(), rtol=BAND, atol=BAND)
    assert float((comp - full).abs().max()) > 0          # rounding happened
    oracle = halo_sync_reference(a, g, HaloSpec(mode=A2A), combine=combine)
    np.testing.assert_allclose(comp.numpy(), oracle.numpy(), rtol=BAND, atol=BAND)
    # the bf16-rounded max neutral never reaches a combine: the result
    # holds no value below the real aggregate's minimum
    if combine == MAX:
        assert float(comp.min()) >= float(a.min()) - BAND


def test_bf16_wire_reference_oracle_and_names():
    pg = part.partition_mesh(box_mesh(ELEMS, p=ORDER), (2, 2, 1))
    g = ShardedGraph.build(pg, box_mesh(ELEMS, p=ORDER).coords, device="cpu")
    a = torch.from_numpy(_aggregate(pg))
    full = halo_sync_reference(a, g, HaloSpec(mode=A2A))
    comp = halo_sync_reference(a, g, HaloSpec(mode=A2A, wire_dtype="bfloat16"))
    assert HaloSpec(mode=A2A, wire_dtype="bfloat16").wire_dtype is torch.bfloat16
    np.testing.assert_allclose(comp.numpy(), full.numpy(), rtol=BAND, atol=BAND)
    assert float((comp - full).abs().max()) > 0
    with pytest.raises(ValueError, match="wire dtype"):
        HaloSpec(mode=A2A, wire_dtype="int4")


@pytest.mark.parametrize("base", FORM_BASES)
def test_max_matches_reference_oracle(forms, base):
    pg, g, spec, rg = forms[base][:4]
    a = _aggregate(pg, seed=3)
    want = np.asarray(ref_halo.halo_sync_reference(jnp.asarray(a), rg,
                                                   ref_halo.HaloSpec(mode="a2a"),
                                                   combine="max"))
    got = halo_sync_stacked(torch.from_numpy(a), g, spec, combine=MAX)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REF_TOL)
    oracle = halo_sync_reference(torch.from_numpy(a), g, HaloSpec(mode=A2A), combine=MAX)
    np.testing.assert_array_equal(oracle.numpy(), want)


@pytest.mark.parametrize("combine", [SUM, MAX])
@pytest.mark.parametrize("wire", [None, torch.bfloat16])
@pytest.mark.parametrize("dense", ["neighbor", "rounds2d"])
def test_packed_equals_dense_bitwise(forms, dense, wire, combine):
    pg, g, spec = forms[dense][:3]
    packed = forms[f"{'packed' if dense == 'neighbor' else 'rounds2d_packed'}"]
    a = torch.from_numpy(_aggregate(pg, seed=5))
    d = halo_sync_stacked(a, g, dataclasses.replace(spec, wire_dtype=wire), combine)
    p = halo_sync_stacked(a, packed[1], dataclasses.replace(packed[2], wire_dtype=wire),
                          combine)
    np.testing.assert_array_equal(p.numpy(), d.numpy())
    assert float((d - a).abs().max()) > 0


def test_max_gradient_refused_and_unknown_combine(forms):
    pg, g, spec = forms["packed"][:3]
    a = torch.from_numpy(_aggregate(pg)).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="GAT"):
        halo_sync_stacked(a, g, spec, combine=MAX)
    with pytest.raises(NotImplementedError, match="GAT"):
        halo_sync_reference(a, g, HaloSpec(mode=A2A), combine=MAX)
    with torch.no_grad():
        halo_sync_stacked(a, g, spec, combine=MAX)
    with pytest.raises(ValueError, match="combine"):
        halo_sync_stacked(a.detach(), g, spec, combine="min")


def test_rounds2d_spec_without_flat_pairs_refused(forms):
    pg, g, spec = forms["rounds2d"][:3]
    bare = dataclasses.replace(spec, perms=())
    with pytest.raises(ValueError, match="flat"):
        halo_sync_stacked(torch.from_numpy(_aggregate(pg)), g, bare)
    # the reference's argument names the pairs instead
    out = halo_sync_stacked(torch.from_numpy(_aggregate(pg)), g, bare,
                            rounds_perms=part.flat_rounds2d_perms(GRID2D))
    np.testing.assert_array_equal(out.numpy(), halo_sync_stacked(
        torch.from_numpy(_aggregate(pg)), g, spec).numpy())


def _loss_and_grads(pg, sem, plan, params, cfg):
    g = ShardedGraph.build(pg, sem.coords, plan, device="cpu")
    x = torch.from_numpy(gather_node_features(pg, taylor_green_velocity(sem.coords)))
    loss, _, grads = loss_and_grad_stacked(params, x, x, g, plan, cfg.node_out,
                                           sync_fn=halo_sync_stacked)
    return float(loss), [t.numpy() for t in torch.utils._pytree.tree_leaves(grads)]


@pytest.mark.parametrize("packed", [False, True])
def test_rounds2d_loss_matches_one_rank_and_overlap(packed):
    """tests/drivers/halo2d_driver.py on the stacked emulator: the rounds2d
    R=4 loss within rel 2e-6 of R=1; the overlap schedule's loss within
    rel 1e-6 and its gradients within rtol 2e-3 / atol 2e-4 of blocking."""
    sem, cfg = box_mesh(ELEMS, p=ORDER), GNNConfig.small()
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device="cpu")
    pg1 = part.partition_mesh(sem, (1, 1, 1))
    l1, _ = _loss_and_grads(pg1, sem, NMPPlan(halo=HaloSpec(mode=NONE)), params, cfg)
    pg = part.partition_mesh_2d(sem, GRID2D)
    runs = {sch: _loss_and_grads(pg, sem, NMPPlan.build(pg, NEIGHBOR, packed=packed,
                                                        backend=FUSED, schedule=sch),
                                 params, cfg)
            for sch in ("blocking", "overlap")}
    lb, gb = runs["blocking"]
    assert abs(lb - l1) <= LOSS_REL * max(1.0, abs(l1))
    lo, go = runs["overlap"]
    assert abs(lo - lb) <= 1e-6 * max(1.0, abs(lb))
    for a, b in zip(go, gb):
        np.testing.assert_allclose(a, b, rtol=G_RTOL, atol=G_ATOL)
    # without the exchange the split deviates
    ln, _ = _loss_and_grads(pg, sem, NMPPlan(halo=HaloSpec(mode=NONE), backend=XLA),
                            params, cfg)
    assert abs(ln - l1) > 1e-6


# ---------------------------------------------------------------------------
# through torch.distributed: 4 gloo processes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world4():
    job = cons.Job(elements=ELEMS, order=ORDER, cfg=GNNConfig.small(), device="cpu",
                   backends=(FUSED,), modes=(), cases=(((2, 2, 1), 1),), forms=True)
    case = cons.case_name((2, 2, 1), 1)
    return [p[case] for p in cons.run_world(job, 4)]


@pytest.fixture(scope="module")
def stacked_forms():
    sem = box_mesh(ELEMS, p=ORDER)
    parts = cons.form_partitions(sem)
    graphs = {k: ShardedGraph.build(pg, sem.coords, NMPPlan.build(pg, NEIGHBOR, packed=True),
                                    device="cpu") for k, pg in parts.items()}
    return parts, graphs


@pytest.mark.parametrize("name", sorted(cons.FORMS))
def test_distributed_form_bitwise_stacked(world4, stacked_forms, name):
    parts, graphs = stacked_forms
    part_name, _, packed, _, combine = cons.FORMS[name]
    pg, g = parts[part_name], graphs[part_name]
    spec = cons.form_spec(pg, name)
    a = torch.from_numpy(cons.seeded(6, (4, pg.n_pad, 8)) * pg.node_mask[..., None])
    with torch.no_grad():
        want = halo_sync_stacked(a, g, spec, combine=combine).numpy()
    for p in world4:
        rec = p["forms"][name]
        np.testing.assert_array_equal(rec["out"], want[p["rank"]])
        if combine == MAX or not packed:
            assert not rec["launches"].get("halo_pack")
    if combine == SUM:
        a.requires_grad_(True)
        w = torch.from_numpy(cons.seeded(7, (4, pg.n_pad, 8)))
        gw, = torch.autograd.grad((halo_sync_stacked(a, g, spec) * w).sum(), a)
        for p in world4:
            got = p["forms"][name]["grad"]
            if packed:
                np.testing.assert_array_equal(got, gw[p["rank"]].numpy())
            else:
                np.testing.assert_allclose(got, gw[p["rank"]].numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("base", FORM_BASES)
@pytest.mark.parametrize("combine", [SUM, MAX])
def test_distributed_bf16_wire_sends_half_the_bytes(world4, base, combine):
    for p in world4:
        fp32 = p["forms"][f"{base}_{combine}"]["sent_bytes"]
        bf16 = p["forms"][f"{base}_bf16_{combine}"]["sent_bytes"]
        assert fp32 > 0 and 2 * bf16 == fp32
