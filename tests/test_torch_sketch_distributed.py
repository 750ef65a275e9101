"""Alg. 1 of the port (``repro_torch.core.sketch.rand_matmul`` and its
companions) on a gloo world of 4 CPU processes, against the reference.

One world is spawned for the whole module (``tests/torch_dist_helper.py``
``alg1_worker`` runs every case and returns each rank's blocks and the
words it received); the tests below read its results.  Held to:

  * JAX ``sketch_reference`` within max-abs 1e-4 (the tolerance of
    ``tests/test_sketch_distributed.py``) on every grid of P = 4 and every
    dense kind, at that file's shape (n1 16, n2 48, r 8);
  * JAX ``rand_matmul`` on 4 fake XLA devices at (2,2,1) and (1,2,2),
    within 1e-4;
  * per-rank words received == ``alg1_bandwidth_words`` exactly (0 on
    (4,1,1)); the collectives' layout moves bitwise.
"""
import os
import pathlib
import re
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_helper import run_distributed
from repro.core.grid import alg1_bandwidth_words as j_alg1_words
from repro.core.grid import select_matmul_grid as j_select
from repro.core.sketch import sketch_reference as j_sketch_reference
from repro.plan.planner import _best_executable_alg1_grid as j_best_grid
from repro_torch.core import grid as tgrid
from repro_torch.core import sketch as sk
from repro_torch.plan import PRESETS, plan_sketch
from repro_torch.plan.model import alg1_communicating_cost
from torch_dist_helper import alg1_worker, run_workers

WORLD = 4
SEED, N1, N2, R = 11, 16, 48, 8
GRIDS_P4 = [(4, 1, 1), (2, 2, 1), (2, 1, 2), (1, 4, 1), (1, 2, 2),
            (1, 1, 4)]
GRIDS_P2 = [(2, 1, 1), (1, 1, 2)]      # ranks 2 and 3 hold no block
KINDS = ["normal", "uniform", "rademacher"]
# (n1, n2, r) for rand_matmul_auto: regime 1; regime 2 whose §4.3 grid
# (2, 2, 1) does not divide n1 = 2 (snapped); regime 3
AUTO_SHAPES = [(16, 48, 8), (2, 48, 8), (1, 8, 4)]
FAKE_DEVICE_GRIDS = [(2, 2, 1), (1, 2, 2)]
TOL = 1e-4


def _matrix(n1, n2, seed):
    return np.random.default_rng(seed).standard_normal(
        (n1, n2)).astype(np.float32)


@pytest.fixture(scope="module")
def A():
    return _matrix(N1, N2, 1)


@pytest.fixture(scope="module")
def ranks(A):
    """Every case on one world of 4 gloo processes, spawned once."""
    auto = [(_matrix(*s[:2], 2 + i), s[2]) for i, s in enumerate(AUTO_SHAPES)]
    return run_workers(alg1_worker, WORLD, A, SEED, R,
                       GRIDS_P4 + GRIDS_P2, KINDS, auto)


@pytest.fixture(scope="module")
def jax_fake_devices(A):
    """The reference's own rand_matmul on 4 fake XLA devices, once."""
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="alg1_ref_"))
    np.save(tmp / "A.npy", A)
    code = f"""
import jax, numpy as np
from repro.core import rand_matmul, make_grid_mesh
from repro.core.sketch import input_sharding
assert len(jax.devices()) == 4
A = np.load({str(tmp / "A.npy")!r})
for shape in {FAKE_DEVICE_GRIDS!r}:
    mesh = make_grid_mesh(*shape)
    B = rand_matmul(jax.device_put(A, input_sharding(mesh)), {SEED}, {R},
                    mesh)
    np.save({str(tmp)!r} + "/B_%d%d%d.npy" % shape, np.asarray(B))
print("OK")
"""
    run_distributed(code, ndev=WORLD, timeout=300)
    out = {s: np.load(tmp / ("B_%d%d%d.npy" % s)) for s in FAKE_DEVICE_GRIDS}
    for f in tmp.iterdir():
        os.remove(f)
    tmp.rmdir()
    return out


def _reference(A, kind="normal", r=R):
    return np.asarray(j_sketch_reference(jnp.asarray(A), SEED, r, kind))


def _received(words):
    return words["all_gather"]["words"] + words["reduce_scatter"]["words"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("grid", GRIDS_P4, ids=str)
def test_alg1_matches_jax_reference(ranks, A, grid, kind):
    ref = _reference(A, kind)
    full = [res["alg1"][(grid, kind)][2] for res in ranks]
    for rank, B in enumerate(full):
        assert B.shape == (N1, R)
        assert np.isfinite(B).all()
        assert float(np.abs(B - ref).max()) < TOL, (rank, grid, kind)
        # every rank gathers the same bits
        np.testing.assert_array_equal(B, full[0])


@pytest.mark.parametrize("grid", GRIDS_P4, ids=str)
def test_alg1_blocks_are_the_output_layout(ranks, grid):
    """Each rank's block is its P((p1, p2), p3) block of B, bitwise."""
    for rank, res in enumerate(ranks):
        blk, _, full = res["alg1"][(grid, "normal")]
        g = sk.GridGroups(grid, rank, res["coords"][grid])
        np.testing.assert_array_equal(
            blk, sk.output_block(torch.from_numpy(full), g).numpy())


@pytest.mark.parametrize("grid", GRIDS_P4 + GRIDS_P2, ids=str)
def test_alg1_words_equal_the_bandwidth_formula(ranks, grid):
    """Words received per rank == the paper's closed form, exactly (the
    port's own copy and the reference's), 0 on a regime-1 grid; one call
    of a collective per grid axis above 1, none otherwise."""
    p1, p2, p3 = grid
    expect = tgrid.alg1_bandwidth_words(N1, N2, R, *grid)
    assert expect == j_alg1_words(N1, N2, R, *grid)
    for rank, res in enumerate(ranks):
        _, words, _ = res["alg1"][(grid, "normal")]
        if rank >= p1 * p2 * p3:
            assert _received(words) == 0
            continue
        assert _received(words) == expect, (rank, words)
        assert words["all_gather"]["calls"] == (p3 > 1)
        assert words["reduce_scatter"]["calls"] == (p2 > 1)
    if grid[0] == p1 * p2 * p3:
        assert expect == 0


@pytest.mark.parametrize("grid", GRIDS_P4 + GRIDS_P2, ids=str)
def test_communicating_moves_more_words_for_the_same_B(ranks, A, grid):
    ref = _reference(A)
    for rank, res in enumerate(ranks):
        blk, words, full = res["communicating"][grid]
        alg1_blk, alg1_words, _ = res["alg1"][(grid, "normal")]
        if rank >= np.prod(grid):
            assert blk is None and full is None and _received(words) == 0
            continue
        assert _received(words) == alg1_communicating_cost(
            N1, N2, R, grid).words
        assert _received(words) > _received(alg1_words)
        assert float(np.abs(blk - alg1_blk).max()) < TOL
        assert float(np.abs(full - ref).max()) < TOL


@pytest.mark.parametrize("grid", GRIDS_P2, ids=str)
def test_ranks_past_the_grid_hold_no_block(ranks, A, grid):
    ref = _reference(A)
    for rank, res in enumerate(ranks):
        blk, _, full = res["alg1"][(grid, "normal")]
        if rank >= 2:
            assert res["coords"][grid] is None
            assert blk is None and full is None
        else:
            assert float(np.abs(full - ref).max()) < TOL


@pytest.mark.parametrize("case", range(len(AUTO_SHAPES)))
def test_auto_grid_is_the_reference_choice(ranks, case):
    n1, n2, r = AUTO_SHAPES[case]
    A_s = _matrix(n1, n2, 2 + case)
    want = j_select(n1, n2, r, WORLD)
    shape = want.shape
    if n1 % (shape[0] * shape[1]) or n2 % (shape[1] * shape[2]) \
            or r % shape[2]:
        shape = j_best_grid(n1, n2, r, WORLD)
    ref = _reference(A_s, r=r)
    for res in ranks:
        got, regime, words, _, comm, full = res["auto"][case]
        assert got == shape and regime == want.regime
        assert words == j_alg1_words(n1, n2, r, *shape)
        assert _received(comm) == words
        assert float(np.abs(full - ref).max()) < TOL


def test_auto_takes_the_regime_1_grid_at_four_ranks(ranks):
    got, regime, words, _, comm, _ = ranks[0]["auto"][0]
    assert (got, regime, words, _received(comm)) == ((4, 1, 1), 1, 0, 0)


@pytest.mark.parametrize("grid", FAKE_DEVICE_GRIDS, ids=str)
def test_alg1_matches_jax_rand_matmul_on_fake_devices(ranks,
                                                      jax_fake_devices,
                                                      grid):
    ref = jax_fake_devices[grid]
    for res in ranks:
        full = res["alg1"][(grid, "normal")][2]
        assert float(np.abs(full - ref).max()) < TOL


def test_all_gather_lays_out_blocks_exactly(ranks):
    blocks = [np.arange(6, dtype=np.float32).reshape(2, 3) + 100.0 * q
              for q in range(WORLD)]
    for res in ranks:
        np.testing.assert_array_equal(res["layout"]["dim1"],
                                      np.concatenate(blocks, axis=1))
        np.testing.assert_array_equal(res["layout"]["dim0"],
                                      np.concatenate(blocks, axis=0))


def test_reduce_scatter_keeps_this_ranks_rows_of_the_sum(ranks):
    total = sum((q + 1.0) * np.arange(24, dtype=np.float32).reshape(8, 3)
                for q in range(WORLD))
    for rank, res in enumerate(ranks):
        np.testing.assert_array_equal(res["layout"]["reduce_scatter"],
                                      total[2 * rank:2 * rank + 2])


def test_grid_larger_than_the_world_is_refused(ranks):
    for res in ranks:
        assert res["too_big"] == "grid 4x2x1 needs 8 devices, have 4"


@pytest.mark.parametrize("case", [
    ((18, 48), 8, (2, 2, 1)),     # n1/p1 = 9 rows do not split p2 = 2 ways
    ((16, 48), 6, (1, 1, 4)),     # r = 6 does not split p3 = 4 ways
], ids=["rows", "r"])
def test_rand_matmul_keeps_the_divisibility_check(case):
    """Refused on the rank before any collective, with the reference's
    message."""
    (n1, n2), r, grid = case
    p1, p2, p3 = grid
    blk = torch.zeros(n1 // p1, n2 // (p2 * p3))
    g = sk.GridGroups(grid, 0, (0, 0, 0))
    msg = re.escape(f"shape ({n1},{n2},r={r}) not divisible by grid "
                    f"({p1},{p2},{p3})")
    for fn in (lambda: sk.rand_matmul(blk, SEED, r, g),
               lambda: sk.rand_matmul_communicating(blk, SEED, r, g),
               lambda: sk.rand_matmul_auto(torch.zeros(n1, n2), SEED, r,
                                           P_procs=4, grid=grid)):
        with pytest.raises(ValueError, match=f"^{msg}$"):
            fn()


def test_communicating_needs_omega_rows_to_split_over_the_grid():
    """Each of the P ranks draws n2/P rows of Omega: n2 = 6 on (4, 1, 1)
    does not split."""
    g = sk.GridGroups((4, 1, 1), 0, (0, 0, 0))
    with pytest.raises(ValueError, match=re.escape(
            "shape (16,6,r=8) not divisible by grid (4,1,1)")):
        sk.rand_matmul_communicating(torch.zeros(4, 6), SEED, R, g)


def test_input_block_refuses_an_uneven_split():
    g = sk.GridGroups((3, 1, 1), 0, (0, 0, 0))
    with pytest.raises(ValueError, match="not divisible by grid"):
        sk.input_block(torch.zeros(16, 48), g)


@pytest.mark.parametrize("kind", ["countsketch", "rowsample"])
def test_sparse_kinds_are_not_ported(kind):
    g = sk.GridGroups((1, 1, 1), 0, (0, 0, 0))
    A = torch.zeros(4, 8)
    for fn in (lambda: sk.rand_matmul(A, SEED, 4, g, kind=kind),
               lambda: sk.rand_matmul_communicating(A, SEED, 4, g,
                                                    kind=kind),
               lambda: sk.rand_matmul_auto(A, SEED, 4, P_procs=1,
                                           kind=kind)):
        with pytest.raises(NotImplementedError,
                           match="sparse bodies are deferred"):
            fn()


def test_plan_grid_needs_the_planner():
    """``grid="plan"`` and ``plan=`` run the planner's choice (on a world
    of four: ``tests/test_torch_planner.py``); what is no runnable Alg.-1
    plan is refused with the port's messages, before any group is made."""
    A = torch.zeros(N1, N2)
    with pytest.raises(TypeError, match="must be a repro_torch.plan.Plan"):
        sk.rand_matmul_auto(A, SEED, R, P_procs=WORLD, plan=object())
    bad = plan_sketch(7, 7, 3, P=WORLD, machine=PRESETS["cpu"])
    for kw in ({"grid": "plan"}, {"plan": bad}):
        with pytest.raises(ValueError, match="analytic-only"):
            sk.rand_matmul_auto(torch.zeros(7, 7), SEED, 3, P_procs=WORLD,
                                **kw)
    one = plan_sketch(N1, N2, R, P=1, machine=PRESETS["cpu"])
    assert one.variant == "cuda_fused"
    with pytest.raises(ValueError, match="call plan.execute instead"):
        sk.rand_matmul_auto(A, SEED, R, P_procs=WORLD, plan=one)
