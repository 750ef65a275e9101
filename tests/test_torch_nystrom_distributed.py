"""The 1-D Alg. 2 of the port (``repro_torch.core.nystrom``: No-Redist and
Redist Nyström, and the counted all-to-all) on a gloo world of 4 CPU
processes, against the reference.

One world is spawned for the whole module (``tests/torch_dist_helper.py``
``alg2_worker`` runs every case and returns each rank's blocks, their
gathers and the words it received); the reference's own 1-D variants run
once on 4 fake XLA devices.  Inputs are numpy from a seed, S = X·Xᵀ/n, at
(n, r) = (64, 16) (n/r = P) and (64, 32) (n/r < P).  Held to:

  * JAX ``nystrom_reference`` and JAX ``nystrom_no_redist`` /
    ``nystrom_redist`` on 4 fake devices: B within max-abs 1e-4 and C
    within 1e-3 (the tolerances of ``tests/test_sketch_distributed.py``);
  * the second stages alone (``salt`` 3) within 1e-4 of the port's
    one-device ``sketch_t_block``;
  * per-rank words received exactly: (1 - 1/P)·r² for No-Redist (==
    ``alg2_bandwidth_words`` on (P,1,1) twice), (1 - 1/P)·n·r/P for
    Redist (the formula's n·r/P bounds it), 0 for the first stage;
  * layouts bitwise: the all-to-all, and Redist's B column blocks as
    No-Redist's B re-laid out.
"""
import dataclasses
import json
import os
import pathlib
import re
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_helper import run_distributed
from repro.core.grid import select_nystrom_grids as j_select
from repro.core.nystrom import nystrom_reference as j_nystrom_reference
from repro_torch.core import grid as tgrid
from repro_torch.core import nystrom as nys
from repro_torch.core import sketch as sk
from repro_torch.kernels.local import sketch_t_block
from repro_torch.plan import PRESETS, plan_nystrom
from torch_dist_helper import alg2_worker, run_workers

WORLD = 4
SEED = 5
SHAPES = {"n64_r16": (64, 16), "n64_r32": (64, 32)}
RANK8 = ("rank8", 128, 8, 32)          # (name, n, k, r): S = X·Xᵀ, rank k
KINDS = ["normal", "uniform", "rademacher"]
VARIANTS = ["no_redist", "redist"]
SUBGRID = 2                            # ranks 2 and 3 hold no block
SALT = 3
TOL_B, TOL_C = 1e-4, 1e-3


def _sym(n, seed):
    X = np.random.default_rng(seed).standard_normal((n, n))
    return (X @ X.T / n).astype(np.float32)


@pytest.fixture(scope="module")
def cases():
    S = _sym(64, 1)
    out = {name: (S, r) for name, (_, r) in SHAPES.items()}
    name, n, k, r = RANK8
    X = np.random.default_rng(2).standard_normal((n, k))
    out[name] = ((X @ X.T).astype(np.float32), r)
    return out


@pytest.fixture(scope="module")
def stage_cases():
    rng = np.random.default_rng(3)
    return {name: (rng.standard_normal((n, r)).astype(np.float32), r, SALT)
            for name, (n, r) in SHAPES.items()}


@pytest.fixture(scope="module")
def ranks(cases, stage_cases):
    """Every case on one world of 4 gloo processes, spawned once."""
    return run_workers(alg2_worker, WORLD, cases, SEED, KINDS, stage_cases,
                       SUBGRID)


@pytest.fixture(scope="module")
def jax_fake_devices(cases):
    """The reference's nystrom_no_redist / nystrom_redist / nystrom_auto
    on 4 fake XLA devices, once, for every shape and kind."""
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="alg2_ref_"))
    for name in SHAPES:
        np.save(tmp / f"{name}.npy", cases[name][0])
    code = f"""
import json
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.core.nystrom import nystrom_auto, nystrom_no_redist, nystrom_redist
assert len(jax.devices()) == 4
mesh = Mesh(np.asarray(jax.devices()), ("x",))
auto = {{}}
for name, (n, r) in {SHAPES!r}.items():
    S = np.load({str(tmp)!r} + "/" + name + ".npy")
    Ssh = jax.device_put(S, NamedSharding(mesh, P("x", None)))
    for kind in {KINDS!r}:
        for variant, fn in (("no_redist", nystrom_no_redist),
                            ("redist", nystrom_redist)):
            B, C = fn(Ssh, {SEED}, r, mesh, kind=kind)
            np.save({str(tmp)!r} + f"/{{name}}_{{variant}}_{{kind}}_B.npy",
                    np.asarray(B))
            np.save({str(tmp)!r} + f"/{{name}}_{{variant}}_{{kind}}_C.npy",
                    np.asarray(C))
    auto[name] = nystrom_auto(S, {SEED}, r)[3]
json.dump(auto, open({str(tmp)!r} + "/auto.json", "w"))
print("OK")
"""
    run_distributed(code, ndev=WORLD, timeout=300)
    out = {"auto": json.loads((tmp / "auto.json").read_text())}
    for name in SHAPES:
        for variant in VARIANTS:
            for kind in KINDS:
                stem = f"{name}_{variant}_{kind}"
                out[(name, variant, kind)] = (np.load(tmp / f"{stem}_B.npy"),
                                              np.load(tmp / f"{stem}_C.npy"))
    for f in tmp.iterdir():
        os.remove(f)
    tmp.rmdir()
    return out


def _reference(cases, name, kind):
    S, r = cases[name]
    B, C = j_nystrom_reference(jnp.asarray(S), SEED, r, kind)
    return np.asarray(B), np.asarray(C)


def _max_abs(a, b):
    return float(np.abs(a - b).max())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", list(SHAPES))
def test_alg2_matches_jax_reference(ranks, cases, name, variant, kind):
    B_ref, C_ref = _reference(cases, name, kind)
    first = ranks[0]["alg2"][(name, variant, kind)]
    for rank, res in enumerate(ranks):
        _, _, _, B, C = res["alg2"][(name, variant, kind)]
        assert B.shape == B_ref.shape and C.shape == C_ref.shape
        assert np.isfinite(B).all() and np.isfinite(C).all()
        assert _max_abs(B, B_ref) < TOL_B, (rank, name, variant, kind)
        assert _max_abs(C, C_ref) < TOL_C, (rank, name, variant, kind)
        # every rank gathers the same bits
        np.testing.assert_array_equal(B, first[3])
        np.testing.assert_array_equal(C, first[4])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", list(SHAPES))
def test_alg2_matches_jax_variants_on_fake_devices(ranks, jax_fake_devices,
                                                   name, variant, kind):
    B_ref, C_ref = jax_fake_devices[(name, variant, kind)]
    for res in ranks:
        _, _, _, B, C = res["alg2"][(name, variant, kind)]
        assert _max_abs(B, B_ref) < TOL_B
        assert _max_abs(C, C_ref) < TOL_C


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", list(SHAPES))
def test_alg2_blocks_are_the_variant_layout(ranks, name, variant):
    """No-Redist's B and C are row blocks (n/P x r, r/P x r), Redist's are
    column blocks (n x r/P, r x r/P): each rank's block is its
    ``nystrom_block`` of the gathered result, bitwise."""
    n, r = SHAPES[name]
    want = {"no_redist": ((n // WORLD, r), (r // WORLD, r)),
            "redist": ((n, r // WORLD), (r, r // WORLD))}[variant]
    for rank, res in enumerate(ranks):
        B, C, _, B_full, C_full = res["alg2"][(name, variant, "normal")]
        assert (B.shape, C.shape) == want
        g = sk.GridGroups((WORLD, 1, 1), rank, res["coords"])
        for blk, full in ((B, B_full), (C, C_full)):
            np.testing.assert_array_equal(
                blk, nys.nystrom_block(torch.from_numpy(full), g,
                                       variant).numpy())


@pytest.mark.parametrize("name", list(SHAPES))
def test_redist_B_is_no_redist_B_relaid_out(ranks, name):
    """The all-to-all is a layout move: Redist's B column block is the
    same columns of No-Redist's B, bitwise (the same first stage)."""
    full = ranks[0]["alg2"][(name, "no_redist", "normal")][3]
    for rank, res in enumerate(ranks):
        blk = res["alg2"][(name, "redist", "normal")][0]
        g = sk.GridGroups((WORLD, 1, 1), rank, res["coords"])
        np.testing.assert_array_equal(
            blk, nys.nystrom_block(torch.from_numpy(full), g,
                                   "redist").numpy())


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", list(SHAPES))
def test_second_stages_alone_with_a_salt(ranks, stage_cases, name, variant):
    """Either second stage fed any row-sharded B (the streamed finalize's
    form) gives the one-device ``sketch_t_block`` under the same salt."""
    B, r, salt = stage_cases[name]
    Bt = torch.from_numpy(B)
    C_ref = sketch_t_block(Bt, SEED, r, salt=salt).numpy()
    assert _max_abs(C_ref, sketch_t_block(Bt, SEED, r).numpy()) > 1e-2
    for res in ranks:
        B_k, C, _ = res["stage"][(name, variant)]
        assert _max_abs(C, C_ref) < TOL_B
        if variant == "redist":
            np.testing.assert_array_equal(B_k, B)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", list(SHAPES) + [RANK8[0]])
def test_alg2_words_received_are_exact(ranks, cases, name, variant):
    """No-Redist receives (1 - 1/P)·r² in one reduce-scatter, which is
    ``alg2_bandwidth_words`` on (P,1,1) twice (the port's copy and the
    reference's); Redist receives (1 - 1/P)·n·r/P in one all-to-all, below
    the formula's n·r/P term; nothing else moves."""
    S, r = cases[name]
    n, P = S.shape[0], WORLD
    p = (P, 1, 1)
    if variant == "no_redist":
        kind, expect = "reduce_scatter", (P - 1) * r * r // P
        assert expect == tgrid.alg2_bandwidth_words(n, r, p, p)
        assert expect == j_select(n, r, P, "no_redist").bandwidth_words
    else:
        kind, expect = "all_to_all", (P - 1) * n * r // P ** 2
        formula = tgrid.alg2_bandwidth_words(n, r, p, (1, 1, P))
        assert formula == n * r / P and expect < formula
    for res in ranks:
        for kd in KINDS:
            words = res["alg2"][(name, variant, kd)][2]
            assert words[kind] == {"calls": 1, "words": expect}, words
            assert sum(w["words"] for w in words.values()) == expect


@pytest.mark.parametrize("name", list(SHAPES) + [RANK8[0]])
def test_first_stage_moves_no_words(ranks, cases, name):
    S, r = cases[name]
    n = S.shape[0]
    for res in ranks:
        B, words = res["first"][name]
        assert words == 0 and B.shape == (n // WORLD, r)
        np.testing.assert_array_equal(
            B, res["alg2"][(name, "no_redist", "normal")][0])


@pytest.mark.parametrize("name", list(SHAPES))
def test_auto_rule_is_the_reference_rule(ranks, jax_fake_devices, cases,
                                         name):
    """redist iff P > n/r: no_redist at n/r = P, redist at n/r < P, as
    the reference's nystrom_auto (on the fake devices) and
    ``select_nystrom_grids`` (both packages) choose; the blocks are the
    explicit variant's, bitwise."""
    n, r = SHAPES[name]
    want = "redist" if WORLD > max(1, n // r) else "no_redist"
    assert want == {"n64_r16": "no_redist", "n64_r32": "redist"}[name]
    assert jax_fake_devices["auto"][name] == want
    assert tgrid.select_nystrom_grids(n, r, WORLD).variant == want
    assert j_select(n, r, WORLD).variant == want
    for res in ranks:
        variant, shape, B, C, words = res["auto"][name]
        assert (variant, shape) == (want, (WORLD, 1, 1))
        B_x, C_x, words_x, _, _ = res["alg2"][(name, want, "normal")]
        np.testing.assert_array_equal(B, B_x)
        np.testing.assert_array_equal(C, C_x)
        assert words == words_x


@pytest.mark.parametrize("variant", VARIANTS)
def test_reconstruction_of_a_rank_8_matrix(ranks, cases, variant):
    """The reference's Tab. 2 analogue: S = X·Xᵀ of rank 8 at n = 128,
    r = 32 is reconstructed from either variant's pair to below 1e-4."""
    name = RANK8[0]
    S, _ = cases[name]
    _, _, _, B, C = ranks[0]["alg2"][(name, variant, "normal")]
    err = float(nys.relative_error(torch.from_numpy(S), torch.from_numpy(B),
                                   torch.from_numpy(C)))
    assert err < 1e-4, err


@pytest.mark.parametrize("variant", VARIANTS)
def test_ranks_past_a_smaller_grid_hold_no_block(ranks, cases, variant):
    name = next(iter(SHAPES))
    B_ref, C_ref = _reference(cases, name, "normal")
    S, r = cases[name]
    for rank, res in enumerate(ranks):
        coords, words, B, C = res["sub"][variant]
        total = sum(w["words"] for w in words.values())
        if rank >= SUBGRID:
            assert coords is None and B is None and C is None
            assert total == 0
            continue
        assert coords == (rank, 0, 0)
        assert _max_abs(B, B_ref) < TOL_B and _max_abs(C, C_ref) < TOL_C
        p = (SUBGRID, 1, 1)
        assert total == (tgrid.alg2_bandwidth_words(64, r, p, p)
                         if variant == "no_redist"
                         else (SUBGRID - 1) * 64 * r // SUBGRID ** 2)


def test_all_to_all_lays_out_blocks_exactly(ranks):
    """Rank q's (2, 3·P) row block 100·q + arange: rank k receives column
    block k of every rank's rows, stacked in rank order, and counts
    (1 - 1/P) of it."""
    blocks = [np.arange(6 * WORLD, dtype=np.float32).reshape(2, 3 * WORLD)
              + 100.0 * q for q in range(WORLD)]
    full = np.concatenate(blocks, axis=0)
    for rank, res in enumerate(ranks):
        got, words = res["a2a"]
        np.testing.assert_array_equal(got, full[:, 3 * rank:3 * rank + 3])
        assert words["all_to_all"] == {"calls": 1,
                                       "words": 2 * 3 * (WORLD - 1)}


def test_all_to_all_group_of_one_moves_nothing(ranks):
    for res in ranks:
        same, words = res["a2a_one"]
        assert same and sum(w["words"] + w["calls"]
                            for w in words.values()) == 0


def test_all_to_all_needs_columns_to_split():
    from repro_torch.parallel.collectives import all_to_all
    with pytest.raises(ValueError, match="6 columns do not split 4 ways"):
        all_to_all(torch.zeros(2, 6), None, 4)


_G0 = sk.GridGroups((WORLD, 1, 1), 0, (0, 0, 0))


# (entry point, n, r): n = 66 does not split 4 ways (a row block of B
# always has n = rows·P, so only r reaches the second stages), r = 6 neither
DIVISIBILITY = ([(fn, 66, 16) for fn in ("no_redist", "redist", "auto")]
                + [(fn, 64, 6) for fn in ("no_redist", "redist",
                                          "stage_no_redist", "stage_redist",
                                          "auto")])


@pytest.mark.parametrize("fn,n,r", DIVISIBILITY,
                         ids=[f"{c[0]}-n{c[1]}-r{c[2]}" for c in DIVISIBILITY])
def test_alg2_keeps_the_divisibility_message(fn, n, r):
    """Refused on the rank before any collective, with the reference's
    message (n first, then r)."""
    call = {
        "no_redist": lambda: nys.nystrom_no_redist(
            torch.zeros(n // WORLD, n), SEED, r, _G0),
        "redist": lambda: nys.nystrom_redist(
            torch.zeros(n // WORLD, n), SEED, r, _G0),
        "stage_no_redist": lambda: nys.nystrom_second_stage_no_redist(
            torch.zeros(n // WORLD, r), SEED, r, _G0),
        "stage_redist": lambda: nys.nystrom_second_stage_redist(
            torch.zeros(n // WORLD, r), SEED, r, _G0),
        "auto": lambda: nys.nystrom_auto(torch.zeros(n, n), SEED, r,
                                         variant="no_redist",
                                         P_procs=WORLD),
    }[fn]
    msg = re.escape(f"n={n}, r={r} must divide P={WORLD}")
    with pytest.raises(ValueError, match=f"^{msg}$"):
        call()


def test_alg2_refuses_a_block_that_is_not_a_row_block():
    with pytest.raises(ValueError, match="not a row block"):
        nys.nystrom_no_redist(torch.zeros(8, 64), SEED, 16, _G0)


@pytest.mark.parametrize("kind", ["countsketch", "rowsample"])
def test_alg2_sparse_kinds_are_not_ported(kind):
    A, B = torch.zeros(16, 64), torch.zeros(16, 16)
    for fn in (lambda: nys.nystrom_no_redist(A, SEED, 16, _G0, kind=kind),
               lambda: nys.nystrom_redist(A, SEED, 16, _G0, kind=kind),
               lambda: nys.nystrom_second_stage_no_redist(B, SEED, 16, _G0,
                                                          kind=kind),
               lambda: nys.nystrom_second_stage_redist(B, SEED, 16, _G0,
                                                       kind=kind),
               lambda: nys.nystrom_auto(torch.zeros(64, 64), SEED, 16,
                                        P_procs=WORLD, kind=kind)):
        with pytest.raises(NotImplementedError,
                           match="sparse bodies are deferred"):
            fn()


def test_bound_driven_needs_the_two_grid_variants():
    """The two-grid variants run the bound-driven pair; where no pair of
    factorizations of P divides the shape (n = 63 over P = 4) it is
    refused with the reference's message, before any group is made."""
    msg = re.escape("no (p, q) factorization pair of P=4 divides (n=63, "
                    "r=16); pad the shape or change P")
    with pytest.raises(ValueError, match=f"^{msg}$"):
        nys.nystrom_auto(torch.zeros(63, 63), SEED, 16,
                         variant="bound_driven", P_procs=WORLD)


@pytest.mark.parametrize("kw", [{"variant": "plan"}, {"plan": object()}],
                         ids=["variant", "plan"])
def test_plan_needs_the_planner(kw):
    """``variant="plan"`` and ``plan=`` run the planner's choice (on a world
    of four: ``tests/test_torch_planner.py``); an analytic-only plan, a
    one-card kernel plan and an object that is no plan are refused with
    the port's messages, before any group is made."""
    if "plan" in kw:
        with pytest.raises(TypeError, match="must be a repro_torch.plan"):
            nys.nystrom_auto(torch.zeros(64, 64), SEED, 16, P_procs=WORLD,
                             **kw)
        kw = {"plan": plan_nystrom(30, 7, P=8, machine=PRESETS["cpu"])}
        assert not kw["plan"].executable
        one = plan_nystrom(64, 16, P=1, machine=PRESETS["cpu"])
        one = dataclasses.replace(one, variant="cuda_fused")
        with pytest.raises(ValueError, match="call plan.execute instead"):
            nys.nystrom_auto(torch.zeros(64, 64), SEED, 16, P_procs=WORLD,
                             plan=one)
    # (n = 30, r = 7) divides no grid of P = 8; so the planned call on
    # variant="plan" is the analytic-only plan too
    with pytest.raises(ValueError, match="is analytic-only"):
        nys.nystrom_auto(torch.zeros(30, 30), SEED, 7, P_procs=8, **kw)


def test_unknown_variant_is_refused():
    with pytest.raises(ValueError, match="^two_grid$"):
        nys.nystrom_auto(torch.zeros(64, 64), SEED, 16, variant="two_grid",
                         P_procs=WORLD)
