"""The two-grid Alg. 2 of the port (``repro_torch.core.nystrom``:
``nystrom_two_grid``, ``nystrom_two_grid_fused``, their second stages,
``nystrom_general``, ``nystrom_auto(variant="bound_driven")``, and the
counted ``parallel.collectives.redistribute``) on a gloo world of 4 CPU
processes, against the reference.

One world is spawned for the whole module (``tests/torch_dist_helper.py``
``two_grid_worker`` runs every case and returns each rank's blocks, their
gathers and the words it received); the reference's own two-grid
functions run once on 4 fake XLA devices.  Inputs are numpy from a seed,
S = X·Xᵀ/n, at (n, r) = (64, 16) and (64, 2) (regime 2: r < P, where the
1-D variants cannot run).  Held to:

  * JAX ``nystrom_reference`` and the reference's ``nystrom_two_grid``,
    ``nystrom_two_grid_fused``, ``nystrom_second_stage_two_grid(_fused)``,
    ``nystrom_general`` and ``nystrom_auto`` on the fake devices: B within
    max-abs 1e-4 and C within 1e-3 (the 1-D Alg. 2's tolerances; the
    reference's own two-grid bitwise tests are red);
  * per-rank words received exactly: Alg. 1's words on p, this rank's
    Redistribute term (its q-block less what it held; the maximum over
    ranks is the reference's ``fused_redistribute_words``), the q2
    all-gather and the q1 reduce-scatter — also where p == q but the
    layouts differ, which the reference prices at 0;
  * bitwise: the Redistribute as a layout move, the fused forms against
    the plain ones, and the 1-D variants' own pairs ((P,1,1) to (1,1,P)
    and to (P,1,1));
  * the reference's argument and divisibility messages.
"""
import itertools
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
from repro.core import grid as jgrid
from repro.core import nystrom as jnys
from repro.plan import model as jmodel
from repro_torch.core import grid as tgrid
from repro_torch.core import nystrom as nys
from repro_torch.core.grid import alg1_bandwidth_words
from repro_torch.kernels.local import sketch_t_block
from repro_torch.plan import model as tmodel
from torch_dist_helper import run_workers, two_grid_worker

WORLD = 4
SEED = 5
SALT = 3
KINDS = ["normal", "uniform", "rademacher"]
TOL_B, TOL_C = 1e-4, 1e-3
SHAPES = {"n64_r16": (64, 16), "n64_r2": (64, 2)}
PAIRS = {
    "n64_r16": [((4, 1, 1), (1, 1, 4)), ((4, 1, 1), (1, 2, 2)),
                ((4, 1, 1), (2, 1, 2)), ((2, 2, 1), (4, 1, 1)),
                ((1, 2, 2), (2, 2, 1)), ((2, 1, 2), (1, 4, 1)),
                ((1, 2, 2), (1, 2, 2)), ((4, 1, 1), (4, 1, 1))],
    # regime 2: q must be (2, 1, 2), the only q-grid that splits r = 2
    "n64_r2": [((4, 1, 1), (2, 1, 2)), ((2, 2, 1), (2, 1, 2)),
               ((1, 2, 2), (2, 1, 2))],
}
RUNS = [(name, p, q) for name, pairs in PAIRS.items() for p, q in pairs]
STAGE = {"n64_r16": [((4, 1, 1), (1, 2, 2)), ((4, 1, 1), (2, 1, 2)),
                     ((4, 1, 1), (1, 1, 4)), ((2, 2, 1), (1, 4, 1))],
         "n64_r2": [((4, 1, 1), (2, 1, 2))]}
STAGE_RUNS = [(name, p, q, fused) for name, pairs in STAGE.items()
              for p, q in pairs for fused in (False, True)]
# nystrom_general on a (2, 2, 1) grid, its axes permuted
GENERAL = [("n64_r16", (2, 2, 1), perm)
           for perm in ((2, 1, 0), (1, 0, 2), (0, 2, 1))]
SUBGRID = ("n64_r16", (2, 1, 1), (1, 1, 2))     # ranks 2 and 3 hold none
LAYOUT = ((64, 16), [((2, 1, 2), (1, 4, 1)), ((4, 1, 1), (1, 2, 2)),
                     ((4, 1, 1), (2, 1, 2)), ((1, 2, 2), (1, 2, 2)),
                     ((2, 2, 1), (4, 1, 1))])
# refused inside the world (the checks that need this rank's block), as
# (entry point, A or B shape, r, p, q or q_perm)
ERRORS = {
    "two_grid-not_square": ("two_grid", (64, 32), 16, (4, 1, 1),
                            (1, 1, 4)),
    "two_grid-not_executable": ("two_grid", (64, 64), 6, (4, 1, 1),
                                (1, 1, 4)),
    "two_grid_fused-not_square": ("two_grid_fused", (64, 32), 16,
                                  (4, 1, 1), (1, 1, 4)),
    "two_grid_fused-not_executable": ("two_grid_fused", (64, 64), 6,
                                      (4, 1, 1), (1, 2, 2)),
    "stage-B_not_n_by_r": ("stage", (64, 8), 16, (4, 1, 1), (1, 1, 4)),
    "stage-q_does_not_divide": ("stage", (64, 6), 6, (4, 1, 1), (1, 1, 4)),
    "stage_fused-B_not_n_by_r": ("stage_fused", (64, 8), 16, (4, 1, 1),
                                 (1, 2, 2)),
    "stage_fused-q_does_not_divide": ("stage_fused", (64, 6), 6,
                                      (4, 1, 1), (1, 2, 2)),
    "general-q_does_not_divide": ("general", (64, 64), 6, (2, 2, 1),
                                  (2, 1, 0)),
}


def _sym(n, seed):
    X = np.random.default_rng(seed).standard_normal((n, n))
    return (X @ X.T / n).astype(np.float32)


def _key(*parts):
    return "_".join("".join(map(str, x)) if isinstance(x, tuple) else str(x)
                    for x in parts)


@pytest.fixture(scope="module")
def cases():
    S = _sym(64, 1)
    return {name: (S, r) for name, (_, r) in SHAPES.items()}


@pytest.fixture(scope="module")
def stage_inputs():
    rng = np.random.default_rng(3)
    return {name: rng.standard_normal(SHAPES[name]).astype(np.float32)
            for name in STAGE}


@pytest.fixture(scope="module")
def ranks(cases, stage_inputs):
    """Every case on one world of 4 gloo processes, spawned once."""
    spec = {"seed": SEED, "kinds": KINDS, "cases": cases, "pairs": PAIRS,
            "stage": {name: (stage_inputs[name], SHAPES[name][1], SALT,
                             pairs) for name, pairs in STAGE.items()},
            "general": GENERAL, "subgrid": SUBGRID, "layout": LAYOUT,
            "errors": ERRORS}
    return run_workers(two_grid_worker, WORLD, spec)


@pytest.fixture(scope="module")
def jax_fake_devices(cases, stage_inputs):
    """The reference's two-grid functions on 4 fake XLA devices, once:
    ``nystrom_two_grid`` on every run and kind, ``nystrom_two_grid_fused``
    on every run, both second stages, ``nystrom_general``,
    ``nystrom_auto(variant="bound_driven")`` and ``nystrom_general``'s
    divisibility message."""
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="two_grid_ref_"))
    np.save(tmp / "S.npy", cases["n64_r16"][0])
    for name, B in stage_inputs.items():
        np.save(tmp / f"stageB_{name}.npy", B)
    code = f"""
import json
import jax, numpy as np
from repro.core import (make_grid_mesh, nystrom_auto, nystrom_general,
                        nystrom_second_stage_two_grid,
                        nystrom_second_stage_two_grid_fused,
                        nystrom_two_grid, nystrom_two_grid_fused)
assert len(jax.devices()) == 4
d = {str(tmp)!r}
S = np.load(d + "/S.npy")
key = lambda *parts: "_".join("".join(map(str, x)) if isinstance(x, tuple)
                              else str(x) for x in parts)
def save(k, B, C):
    np.save(d + "/" + k + "_B.npy", np.asarray(B))
    np.save(d + "/" + k + "_C.npy", np.asarray(C))
shapes = {SHAPES!r}
meta = {{"auto": {{}}}}
for name, pairs in {PAIRS!r}.items():
    r = shapes[name][1]
    for p, q in pairs:
        for kind in {KINDS!r}:
            save(key("tg", name, p, q, kind),
                 *nystrom_two_grid(S, {SEED}, r, p=p, q=q, kind=kind))
        save(key("fused", name, p, q),
             *nystrom_two_grid_fused(S, {SEED}, r, p=p, q=q))
    B, C, mesh_q, variant = nystrom_auto(S, {SEED}, r,
                                         variant="bound_driven")
    save(key("auto", name), B, C)
    meta["auto"][name] = [variant, [mesh_q.shape[a] for a in
                                    ("q1", "q2", "q3")]]
for name, pairs in {STAGE!r}.items():
    r = shapes[name][1]
    Bin = np.load(d + "/stageB_" + name + ".npy")
    for p, q in pairs:
        save(key("stage", name, p, q, False),
             *nystrom_second_stage_two_grid(Bin, {SEED}, r, q,
                                            salt={SALT}))
        save(key("stage", name, p, q, True),
             *nystrom_second_stage_two_grid_fused(Bin, {SEED}, r, q, p=p,
                                                  salt={SALT}))
axes = ("p1", "p2", "p3")
for name, p, perm in {GENERAL!r}:
    mesh = make_grid_mesh(*p)
    save(key("general", name, p, perm),
         *nystrom_general(S, {SEED}, shapes[name][1], mesh,
                          q_axes=tuple(axes[a] for a in perm)))
try:
    nystrom_general(S, {SEED}, 6, make_grid_mesh(2, 2, 1),
                    q_axes=("p3", "p2", "p1"))
except ValueError as e:
    meta["general_message"] = str(e)
json.dump(meta, open(d + "/meta.json", "w"))
print("OK")
"""
    run_distributed(code, ndev=WORLD, timeout=600)
    out = json.loads((tmp / "meta.json").read_text())
    for f in tmp.glob("*_B.npy"):
        k = f.name[:-len("_B.npy")]
        out[k] = (np.load(f), np.load(tmp / f"{k}_C.npy"))
    for f in tmp.iterdir():
        os.remove(f)
    tmp.rmdir()
    return out


def _reference(cases, name, kind="normal"):
    S, r = cases[name]
    B, C = jnys.nystrom_reference(jnp.asarray(S), SEED, r, kind)
    return np.asarray(B), np.asarray(C)


def _max_abs(a, b):
    return float(np.abs(a - b).max())


def _close(B, C, B_ref, C_ref, what):
    assert B.shape == B_ref.shape and C.shape == C_ref.shape, what
    assert np.isfinite(B).all() and np.isfinite(C).all(), what
    assert _max_abs(B, B_ref) < TOL_B, what
    assert _max_abs(C, C_ref) < TOL_C, what


def _redistribute_terms(n, r, p, q):
    """Each rank's Redistribute words from masks of the matrix: the cells
    of its q-block (rows over q1, columns over (q3, q2)) that its p-block
    (rows over (p1, p2), columns over p3) does not hold."""
    P = int(np.prod(p))
    terms = []
    for d in range(P):
        i, j, k = np.unravel_index(d, p)
        iq, jq, kq = np.unravel_index(d, q)
        rows_p = np.arange(n) // (n // (p[0] * p[1])) == i * p[1] + j
        cols_p = np.arange(r) // (r // p[2]) == k
        rows_q = np.arange(n) // (n // q[0]) == iq
        cols_q = np.arange(r) // (r // (q[1] * q[2])) == kq * q[1] + jq
        held = np.outer(rows_p, cols_p)
        want = np.outer(rows_q, cols_q)
        terms.append(int(want.sum() - (want & held).sum()))
    return terms


def _words_by_kind(n, r, p, q, rank, stage1=True):
    """What ``COMM`` must hold on ``rank`` after one two-grid run (after
    its second stage alone when ``stage1`` is False)."""
    p1, p2, p3 = p
    q1, q2, q3 = q
    ag = (q2 - 1) * n * r // (q1 * q3 * q2)
    rs = (q1 - 1) * r * r // (q2 * q3 * q1)
    if stage1:
        ag += (p3 - 1) * n * n // (p1 * p2 * p3)
        rs += (p2 - 1) * n * r // (p1 * p3 * p2)
    redist = _redistribute_terms(n, r, p, q)[rank]
    return {"all_gather": ag, "reduce_scatter": rs, "all_reduce": 0,
            "all_to_all": 0, "redistribute": redist}


def _calls(p, q, n, r):
    """Calls of each collective in one two-grid run."""
    moves = any(_redistribute_terms(n, r, p, q))
    return {"all_gather": (p[2] > 1) + (q[1] > 1),
            "reduce_scatter": (p[1] > 1) + (q[0] > 1), "all_reduce": 0,
            "all_to_all": 0, "redistribute": int(moves)}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,p,q", RUNS, ids=[_key(*c) for c in RUNS])
def test_two_grid_matches_jax_reference(ranks, cases, name, p, q, kind):
    B_ref, C_ref = _reference(cases, name, kind)
    first = ranks[0]["two_grid"][(name, p, q, kind)]
    for rank, res in enumerate(ranks):
        got = res["two_grid"][(name, p, q, kind)]
        _close(got["B_full"], got["C_full"], B_ref, C_ref, (rank, p, q))
        # every rank gathers the same bits
        np.testing.assert_array_equal(got["B_full"], first["B_full"])
        np.testing.assert_array_equal(got["C_full"], first["C_full"])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,p,q", RUNS, ids=[_key(*c) for c in RUNS])
def test_two_grid_matches_jax_two_grid_on_fake_devices(
        ranks, jax_fake_devices, name, p, q, kind):
    B_ref, C_ref = jax_fake_devices[_key("tg", name, p, q, kind)]
    for rank, res in enumerate(ranks):
        got = res["two_grid"][(name, p, q, kind)]
        _close(got["B_full"], got["C_full"], B_ref, C_ref, (rank, p, q))


@pytest.mark.parametrize("name,p,q", RUNS, ids=[_key(*c) for c in RUNS])
def test_fused_is_the_two_grid_program(ranks, jax_fake_devices, name, p, q):
    """Both grids share one rank order, so the fused form runs the same
    program: its blocks are ``nystrom_two_grid``'s bitwise, with the same
    words; and within tolerance of the reference's fused program."""
    B_ref, C_ref = jax_fake_devices[_key("fused", name, p, q)]
    for rank, res in enumerate(ranks):
        fused = res["fused"][(name, p, q)]
        plain = res["two_grid"][(name, p, q, "normal")]
        np.testing.assert_array_equal(fused["B"], plain["B"])
        np.testing.assert_array_equal(fused["C"], plain["C"])
        assert fused["words"] == plain["words"]
        _close(fused["B_full"], fused["C_full"], B_ref, C_ref, rank)


@pytest.mark.parametrize("name,p,q", RUNS, ids=[_key(*c) for c in RUNS])
def test_blocks_are_the_q_layouts(ranks, name, p, q):
    """B comes out P(q1, (q3, q2)) and C P((q2, q1), q3): each rank's block
    is its ``two_grid_block`` of the gathered result, bitwise, at the
    q-grid's row-major coordinates."""
    n, r = SHAPES[name]
    q1, q2, q3 = q
    for rank, res in enumerate(ranks):
        got = res["two_grid"][(name, p, q, "normal")]
        assert got["q"] == q
        assert got["coords"] == tuple(int(c) for c in np.unravel_index(rank,
                                                                       q))
        assert got["B"].shape == (n // q1, r // (q2 * q3))
        assert got["C"].shape == (r // (q1 * q2), r // q3)
        g = nys.GridGroups(q, rank, got["coords"])
        for part in "BC":
            np.testing.assert_array_equal(
                got[part], nys.two_grid_block(
                    torch.from_numpy(got[f"{part}_full"]), g, part).numpy())


@pytest.mark.parametrize("name,p,q", RUNS, ids=[_key(*c) for c in RUNS])
def test_words_received_are_exact(ranks, name, p, q):
    """Per rank and kind: Alg. 1's words on p, this rank's Redistribute
    term, (1 - 1/q2)·n·r/(q1·q3) and (1 - 1/q1)·r²/(q2·q3).  The
    Redistribute's maximum over ranks is the reference's
    ``fused_redistribute_words`` (and the port's); at most the formula's
    n·r/P when p != q; where p == q with other layouts ((1,2,2)) B moves
    all the same, which the reference's formula prices at 0."""
    n, r = SHAPES[name]
    P = WORLD
    terms = _redistribute_terms(n, r, p, q)
    assert max(terms) == jmodel.fused_redistribute_words(n, r, p, q)
    assert max(terms) == tmodel.fused_redistribute_words(n, r, p, q)
    if p != q:
        assert max(terms) <= n * r / P
    elif p == (1, 2, 2):
        assert jmodel.redistribute_words(n, r, p, q) == 0 < max(terms)
    for rank, res in enumerate(ranks):
        for kind in KINDS:
            words = res["two_grid"][(name, p, q, kind)]["words"]
            want = _words_by_kind(n, r, p, q, rank)
            assert {k: v["words"] for k, v in words.items()} == want, (
                rank, kind)
            assert {k: v["calls"] for k, v in words.items()} == _calls(
                p, q, n, r)
            assert sum(want.values()) == (
                alg1_bandwidth_words(n, n, r, *p) + terms[rank]
                + (1 - 1 / q[1]) * n * r / (q[0] * q[2])
                + (1 - 1 / q[0]) * r * r / (q[1] * q[2]))


def test_redistribute_terms_differ_by_rank():
    """At (64, 16), (2,1,2) -> (1,4,1): ranks 0 and 3 already hold half
    of their q-block."""
    assert _redistribute_terms(64, 16, (2, 1, 2), (1, 4, 1)) == [
        128, 256, 256, 128]


@pytest.mark.parametrize("name", ["n64_r16"])
@pytest.mark.parametrize("variant,q", [("redist", (1, 1, 4)),
                                       ("no_redist", (4, 1, 1))])
def test_one_d_pairs_are_the_one_d_variants_bitwise(ranks, name, variant,
                                                    q):
    """(P,1,1) -> (1,1,P) is Redist and (P,1,1) -> (P,1,1) No-Redist: the
    same ``sketch_fwd`` call, the same layout move and the same
    ``sketch_t`` call, so both blocks are the 1-D variant's bitwise."""
    for res in ranks:
        got = res["two_grid"][(name, (4, 1, 1), q, "normal")]
        B, C = res["one_d"][(name, variant)]
        np.testing.assert_array_equal(got["B"], B)
        np.testing.assert_array_equal(got["C"], C)


@pytest.mark.parametrize("name,p,q,fused", STAGE_RUNS,
                         ids=[_key(*c) for c in STAGE_RUNS])
def test_second_stage_alone_with_a_salt(ranks, jax_fake_devices,
                                        stage_inputs, name, p, q, fused):
    """Either second stage fed B's p-layout blocks (the streamed
    finalize's form, ``salt`` 3) gives B's q-layout bitwise (a layout
    move), C within 1e-4 of the port's one-device ``sketch_t_block`` under
    the salt, and the reference's second stage within tolerance."""
    B_in = stage_inputs[name]
    r = SHAPES[name][1]
    Bt = torch.from_numpy(B_in)
    C_one = sketch_t_block(Bt, SEED, r, salt=SALT).numpy()
    assert _max_abs(C_one, sketch_t_block(Bt, SEED, r).numpy()) > 1e-2
    B_ref, C_ref = jax_fake_devices[_key("stage", name, p, q, fused)]
    for rank, res in enumerate(ranks):
        got = res["stage"][(name, p, q, fused)]
        np.testing.assert_array_equal(got["B_full"], B_in)
        assert _max_abs(got["C_full"], C_one) < TOL_B
        _close(got["B_full"], got["C_full"], B_ref, C_ref, rank)
        words = {k: v["words"] for k, v in got["words"].items()}
        assert words == _words_by_kind(*B_in.shape, p, q, rank,
                                       stage1=False), rank


@pytest.mark.parametrize("name,p,perm", GENERAL,
                         ids=[_key(*c) for c in GENERAL])
def test_general_matches_reference(ranks, jax_fake_devices, cases, name, p,
                                   perm):
    """q-axis m is p-axis perm[m] of a (2, 2, 1) grid: the rank at
    p-coordinates c has q-coordinates c[perm]; its blocks are the
    q-layouts at those coordinates, within tolerance of the reference's
    ``nystrom_general`` and of ``nystrom_reference``."""
    B_ref, C_ref = jax_fake_devices[_key("general", name, p, perm)]
    B_one, C_one = _reference(cases, name)
    q = tuple(p[a] for a in perm)
    for rank, res in enumerate(ranks):
        got = res["general"][(name, p, perm)]
        c = np.unravel_index(rank, p)
        assert got["coords"] == tuple(int(c[a]) for a in perm)
        assert got["q"] == q
        _close(got["B_full"], got["C_full"], B_ref, C_ref, rank)
        _close(got["B_full"], got["C_full"], B_one, C_one, rank)
        g = nys.GridGroups(q, rank, got["coords"])
        for part in "BC":
            np.testing.assert_array_equal(
                got[part], nys.two_grid_block(
                    torch.from_numpy(got[f"{part}_full"]), g, part).numpy())


@pytest.mark.parametrize("name", list(SHAPES))
def test_auto_bound_driven_takes_the_reference_pair(ranks, jax_fake_devices,
                                                    name):
    """``nystrom_auto(variant="bound_driven")`` runs the pair both
    packages' ``select_two_grid_executable`` give ((4,1,1) -> (1,1,4) at
    r = 16, the regime-2 (4,1,1) -> (2,1,2) at r = 2), on the reference's
    q-grid, and its blocks are that pair's fused run, bitwise."""
    n, r = SHAPES[name]
    p, q, _ = tgrid.select_two_grid_executable(n, r, WORLD)
    assert (p, q) == jgrid.select_two_grid_executable(n, r, WORLD)[:2]
    assert (p, q) == {"n64_r16": ((4, 1, 1), (1, 1, 4)),
                      "n64_r2": ((4, 1, 1), (2, 1, 2))}[name]
    variant, qshape = jax_fake_devices["auto"][name]
    assert (variant, tuple(qshape)) == ("bound_driven", q)
    B_ref, C_ref = jax_fake_devices[_key("auto", name)]
    for rank, res in enumerate(ranks):
        variant, got = res["auto"][name]
        assert variant == "bound_driven" and got["q"] == q
        fused = res["fused"][(name, p, q)]
        np.testing.assert_array_equal(got["B"], fused["B"])
        np.testing.assert_array_equal(got["C"], fused["C"])
        assert got["words"] == fused["words"]
        _close(got["B_full"], got["C_full"], B_ref, C_ref, rank)


@pytest.mark.parametrize("fused", [False, True], ids=["two_grid", "fused"])
def test_ranks_past_a_smaller_grid_hold_no_block(ranks, cases, fused):
    name, p, q = SUBGRID
    n, r = SHAPES[name]
    B_ref, C_ref = _reference(cases, name)
    for rank, res in enumerate(ranks):
        got = res["sub"][fused]
        total = sum(w["words"] for w in got["words"].values())
        if rank >= 2:
            assert got["coords"] is None and got["B"] is None
            assert got["C"] is None and total == 0
            continue
        assert got["coords"] == (0, 0, rank)
        _close(got["B_full"], got["C_full"], B_ref, C_ref, rank)
        assert total == _redistribute_terms(n, r, p, q)[rank] == (
            n * r // 4)


@pytest.mark.parametrize("p,q", LAYOUT[1], ids=[_key(*c) for c in LAYOUT[1]])
def test_redistribute_is_a_layout_move(ranks, p, q):
    """B[a, b] = a·r + b in the p-layout: every rank receives exactly its
    q-block, counts its q-block less what it held, and makes one call (no
    call and the block itself where no rank's block changes)."""
    n, r = LAYOUT[0]
    full = np.arange(n * r, dtype=np.float32).reshape(n, r)
    terms = _redistribute_terms(n, r, p, q)
    for rank, res in enumerate(ranks):
        got, words, coords = res["layout"][(p, q)]
        g = nys.GridGroups(q, rank, coords)
        np.testing.assert_array_equal(
            got, nys.two_grid_block(torch.from_numpy(full), g, "B").numpy())
        assert words["redistribute"] == {"calls": int(any(terms)),
                                         "words": terms[rank]}


def _reference_error(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except ValueError as e:
        return ("ValueError", str(e))
    raise AssertionError("the reference did not refuse")


_REF_CALLS = {
    "two_grid": jnys.nystrom_two_grid, "two_grid_fused":
    jnys.nystrom_two_grid_fused, "stage": jnys.nystrom_second_stage_two_grid,
    "stage_fused": jnys.nystrom_second_stage_two_grid_fused}


@pytest.mark.parametrize("key", list(ERRORS))
def test_refused_with_the_reference_message(ranks, jax_fake_devices, key):
    """Checks that need this rank's block run after the grids are made
    (every rank makes them), with the reference's message, on every
    rank."""
    fn, shape, r, p, q = ERRORS[key]
    x = jnp.zeros(shape)
    if fn == "general":
        want = ("ValueError", jax_fake_devices["general_message"])
    elif fn.startswith("stage"):
        want = _reference_error(_REF_CALLS[fn], x, SEED, r, q)
    else:
        want = _reference_error(_REF_CALLS[fn], x, SEED, r, p=p, q=q)
    for res in ranks:
        assert res["errors"][key] == want


# refused before any group is made, on one process: (entry point, kwargs)
EARLY = [("two_grid", {"p": None, "q": (1, 1, 4)}),
         ("two_grid_fused", {"p": (4, 1, 1), "q": None}),
         ("two_grid", {"p": (4, 1, 1), "q": (1, 1, 2)}),
         ("two_grid_fused", {"p": (2, 1, 1), "q": (1, 2, 2)})]


@pytest.mark.parametrize("fn,kw", EARLY,
                         ids=[f"{f}-{i}" for i, (f, _) in enumerate(EARLY)])
def test_argument_checks_keep_the_reference_message(fn, kw):
    want = _reference_error(_REF_CALLS[fn], jnp.zeros((64, 64)), SEED, 16,
                            **kw)
    port = {"two_grid": nys.nystrom_two_grid,
            "two_grid_fused": nys.nystrom_two_grid_fused}[fn]
    with pytest.raises(ValueError, match=f"^{re.escape(want[1])}$"):
        port(torch.zeros(16, 64), SEED, 16, **kw)


@pytest.mark.parametrize("kind", ["countsketch", "rowsample"])
def test_two_grid_sparse_kinds_are_not_ported(kind):
    A = torch.zeros(16, 64)
    g = nys.GridGroups((4, 1, 1), 0, (0, 0, 0))
    for fn in (lambda: nys.nystrom_two_grid(A, SEED, 16, p=(4, 1, 1),
                                            q=(1, 1, 4), kind=kind),
               lambda: nys.nystrom_two_grid_fused(A, SEED, 16, p=(4, 1, 1),
                                                  q=(1, 1, 4), kind=kind),
               lambda: nys.nystrom_second_stage_two_grid(
                   A, SEED, 16, (1, 1, 4), kind=kind),
               lambda: nys.nystrom_second_stage_two_grid_fused(
                   A, SEED, 16, (1, 1, 4), kind=kind),
               lambda: nys.nystrom_general(A, SEED, 16, g, kind=kind),
               lambda: nys.nystrom_auto(torch.zeros(64, 64), SEED, 16,
                                        variant="bound_driven",
                                        P_procs=WORLD, kind=kind)):
        with pytest.raises(NotImplementedError,
                           match="sparse bodies are deferred"):
            fn()


def test_bound_driven_refuses_a_shape_no_pair_divides():
    """The reference's message, before any group is made."""
    want = _reference_error(jnys.nystrom_auto, jnp.zeros((63, 63)), SEED, 16,
                            variant="bound_driven", devices=[None] * WORLD)
    with pytest.raises(ValueError, match=f"^{re.escape(want[1])}$"):
        nys.nystrom_auto(torch.zeros(63, 63), SEED, 16,
                         variant="bound_driven", P_procs=WORLD)


def test_q_perm_must_permute_the_axes():
    g = nys.GridGroups((2, 2, 1), 0, (0, 0, 0))
    with pytest.raises(ValueError, match="q_perm must permute"):
        nys.nystrom_general(torch.zeros(32, 64), SEED, 16, g,
                            q_perm=(0, 0, 1))


# an (8, 8) matrix on two q-grids: (row0, col0) of each rank's B block
# (rows over q1, columns over (q3, q2)) and C block (rows over (q2, q1),
# columns over q3), written out by hand
BLOCKS = {
    (1, 2, 2): {"B": [(0, 0), (0, 4), (0, 2), (0, 6)],
                "C": [(0, 0), (0, 4), (4, 0), (4, 4)]},
    (2, 2, 1): {"B": [(0, 0), (0, 4), (4, 0), (4, 4)],
                "C": [(0, 0), (4, 0), (2, 0), (6, 0)]},
}


@pytest.mark.parametrize("part", ["B", "C"])
@pytest.mark.parametrize("q", list(BLOCKS), ids=str)
def test_two_grid_block_layouts(q, part):
    X = torch.arange(64.0).reshape(8, 8)
    q1, q2, q3 = q
    rows, cols = ((8 // q1, 8 // (q2 * q3)) if part == "B"
                  else (8 // (q1 * q2), 8 // q3))
    for rank, c in enumerate(itertools.product(*(range(x) for x in q))):
        g = nys.GridGroups(q, rank, c)
        r0, c0 = BLOCKS[q][part][rank]
        assert torch.equal(nys.two_grid_block(X, g, part),
                           X[r0:r0 + rows, c0:c0 + cols])


def test_two_grid_block_names_its_part():
    g = nys.GridGroups((1, 2, 2), 0, (0, 0, 0))
    with pytest.raises(ValueError, match="part must be 'B' or 'C'"):
        nys.two_grid_block(torch.zeros(8, 8), g, "D")
