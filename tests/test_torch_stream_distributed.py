"""The port's distributed streaming (``repro_torch.stream.distributed``:
``ShardedStreamingSketch``, ``corange_update``, ``nystrom_finalize``;
``SketchService(mesh=...)`` and ``make_sketch_service(grid=...)``; the
counted ``parallel.collectives.all_reduce``; ``plan.model.
stream_update_cost``) on a gloo world of 4 CPU processes, against the
reference.

One world is spawned for the whole module (``tests/torch_dist_helper.py``
``stream_dist_worker`` runs every case and returns each rank's blocks,
their gathers and the words it received per call); the reference's
``ShardedStreamingSketch``, ``SketchService(mesh=...)`` and streamed
Nystrom finalize run once on 4 fake XLA devices with the ``jnp`` backend,
at its own test shapes (n1 = 16, n2 = 48, r = 8; the 64² symmetric
stream at r = 16).  Inputs are numpy from a seed.  Held to:

  * the reference: Y and W within max-abs 1e-4 and C within 1e-3 on
    (4,1,1), (2,2,1), (1,2,2) and (2,1,2), through ``update`` and
    ``update_rows``, and the Nystrom pair against ``nystrom_reference``;
  * the port's own bitwise claims: row-disjoint streamed updates equal the
    one-shot ``rand_matmul`` blocks, ``update_rows`` equals ``update`` on
    Y, ragged out-of-order slabs too, p1-aligned slabs keep W bitwise, a
    checkpoint restored on another grid, the finalize from the streamed Y
    equal to the second stage on the one-shot blocks, a grid service's
    eviction and restore;
  * per-rank words received exactly: ``stream_update_cost`` (the
    reference's words) per slab, Alg. 1 plus the co-range all-reduce per
    full-shape update, 0 on (4,1,1)'s slabs;
  * the reference's error messages.
"""
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
from repro.core import nystrom as jnys
from repro.plan import model as jmodel
from repro_torch.core import grid as tgrid
from repro_torch.core.grid import alg1_bandwidth_words
from repro_torch.core.sketch import GridGroups
from repro_torch.parallel import collectives as col
from repro_torch.plan import model as tmodel
from repro_torch.plan import plan_stream
from repro_torch.serve import make_sketch_service
from repro_torch.stream import (ShardedStreamingSketch, SketchService,
                                StreamConfig, nystrom_finalize)
from torch_dist_helper import run_workers, stream_dist_worker

WORLD = 4
SEED = 7
N1, N2, R = 16, 48, 8
L = min(2 * R + 1, N1)
GRIDS = [(4, 1, 1), (2, 2, 1), (1, 2, 2), (2, 1, 2)]
SLABS = [(0, 4), (4, 12), (12, 16)]
RAGGED = [(12, 16), (0, 7), (7, 12)]
ALIGNED = [(i, i + N1 // WORLD) for i in range(0, N1, N1 // WORLD)]
RESTORE_GRIDS = [(2, 2, 1), (1, 2, 2)]
SALT = ((2, 2, 1), 2, 5)
S_N, S_R, S_SEED = 64, 16, 5
HALVES = [(0, 32), (32, 64)]
VARIANTS = ["auto", "no_redist", "redist", "bound_driven"]
SERVICE_SEEDS = [5, 77]
TOL_Y, TOL_C = 1e-4, 1e-3
MODES = ["update", "update_rows"]


def _key(*parts):
    return "_".join("".join(map(str, x)) if isinstance(x, tuple) else str(x)
                    for x in parts)


@pytest.fixture(scope="module")
def inputs():
    A = np.random.default_rng(1).standard_normal((N1, N2)).astype(np.float32)
    X = np.random.default_rng(4).standard_normal((S_N, 8))
    return A, (X @ X.T).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Every case on one world of 4 gloo processes, spawned once."""
    A, S = inputs
    spec = {"seed": SEED, "A": A, "r": R, "grids": GRIDS, "slabs": SLABS,
            "ragged": RAGGED, "aligned": ALIGNED,
            "ckdir": str(tmp_path_factory.mktemp("stream_ckpt")),
            "restore_grids": RESTORE_GRIDS, "salt": SALT, "S": S,
            "s_seed": S_SEED, "s_r": S_R, "halves": HALVES,
            "variants": VARIANTS, "service_seeds": SERVICE_SEEDS}
    return run_workers(stream_dist_worker, WORLD, spec)


@pytest.fixture(scope="module")
def jax_fake_devices(inputs):
    """The reference's distributed streams on 4 fake XLA devices, once:
    ``ShardedStreamingSketch`` on every grid through ``update`` and
    ``update_rows``, the salted stream, the streamed Nystrom finalize's
    four variants, a grid ``SketchService`` and the messages of its
    refusals."""
    A, S = inputs
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="stream_dist_ref_"))
    np.save(tmp / "A.npy", A)
    np.save(tmp / "S.npy", S)
    code = f"""
import json
import jax, jax.numpy as jnp, numpy as np
from repro.core import make_grid_mesh
from repro.stream import ShardedStreamingSketch, SketchService, StreamConfig
assert len(jax.devices()) == 4
d = {str(tmp)!r}
A, S = np.load(d + "/A.npy"), np.load(d + "/S.npy")
key = lambda *parts: "_".join("".join(map(str, x)) if isinstance(x, tuple)
                              else str(x) for x in parts)
def save(k, **arrays):
    for name, x in arrays.items():
        np.save(d + "/" + k + "_" + name + ".npy", np.asarray(x))
cfg = StreamConfig(n1={N1}, n2={N2}, r={R}, seed={SEED})
for grid in {GRIDS!r}:
    mesh = make_grid_mesh(*grid)
    full = ShardedStreamingSketch(cfg, mesh, backend="jnp")
    rows = ShardedStreamingSketch(cfg, mesh, backend="jnp")
    for i0, i1 in {SLABS!r}:
        full.update(jnp.zeros(A.shape).at[i0:i1].set(A[i0:i1]))
        rows.update_rows(i0, A[i0:i1])
    save(key("update", grid), Y=full.sketch, W=full.corange_sketch)
    save(key("update_rows", grid), Y=rows.sketch, W=rows.corange_sketch)
grid, om, psi = {SALT!r}
salted = ShardedStreamingSketch(
    StreamConfig(n1={N1}, n2={N2}, r={R}, seed={SEED}, omega_salt=om,
                 psi_salt=psi), make_grid_mesh(*grid), backend="jnp")
salted.update(A)
save("salt", Y=salted.sketch, W=salted.corange_sketch)
cfg_s = StreamConfig(n1={S_N}, n2={S_N}, r={S_R}, seed={S_SEED},
                     corange=False)
mesh = make_grid_mesh({WORLD}, 1, 1)
st = ShardedStreamingSketch(cfg_s, mesh, backend="jnp")
for i0, i1 in {HALVES!r}:
    st.update(jnp.zeros(S.shape).at[i0:i1].set(S[i0:i1]))
for variant in {VARIANTS!r}:
    B, C = st.nystrom(variant)
    save(key("finalize", variant), B=B, C=C)
svc = SketchService(mesh=mesh, backend="jnp")
sids = [svc.open(StreamConfig(n1={S_N}, n2={S_N}, r={S_R}, seed=s))
        for s in {SERVICE_SEEDS!r}]
for sid in sids:
    svc.update(sid, S)
B, C = svc.nystrom(sids[0], variant="redist")
save("service", B=B, C=C, Y0=svc.sketch(sids[0]), Y1=svc.sketch(sids[1]))
msgs = {{}}
def refused(name, fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        msgs[name] = [type(e).__name__, str(e)]
refused("not_divisible", lambda: ShardedStreamingSketch(
    StreamConfig(n1=18, n2={N2}, r={R}), mesh, backend="jnp"))
refused("finalize_grid", lambda: ShardedStreamingSketch(
    cfg_s, make_grid_mesh(2, 2, 1), backend="jnp").nystrom())
refused("finalize_square", lambda: ShardedStreamingSketch(
    cfg, mesh, backend="jnp").nystrom())
refused("row0", lambda: svc.update(sids[0], S, row0=0))
refused("update_batch", lambda: svc.update_batch(sids, S[None], row0=0))
refused("update_ragged", lambda: svc.update_ragged([(sids[0], S[:4], 0)]))
json.dump(msgs, open(d + "/msgs.json", "w"))
print("OK")
"""
    run_distributed(code, ndev=WORLD, timeout=600)
    out = {"msgs": json.loads((tmp / "msgs.json").read_text())}
    for f in tmp.glob("*.npy"):
        out[f.name[:-len(".npy")]] = np.load(f)
    for f in tmp.iterdir():
        os.remove(f)
    tmp.rmdir()
    return out


def _max_abs(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.isfinite(a).all()
    return float(np.abs(a - b).max())


def _alg1_corange_words(grid):
    """Words a rank receives in one full-shape update: Alg. 1's, plus the
    co-range all-reduce over p1 (the reference's audit formula)."""
    p1, p2, p3 = grid
    return (alg1_bandwidth_words(N1, N2, R, *grid)
            + 2.0 * (1.0 - 1.0 / p1) * L * N2 / (p2 * p3))


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_stream_matches_reference(ranks, jax_fake_devices, grid, mode):
    Y_ref = jax_fake_devices[_key(mode, grid, "Y")]
    W_ref = jax_fake_devices[_key(mode, grid, "W")]
    for rank, res in enumerate(ranks):
        Y, W = res["grid"][grid]["full" if mode == "update" else "rows"]
        assert _max_abs(Y, Y_ref) < TOL_Y, (rank, grid, mode)
        assert _max_abs(W, W_ref) < TOL_Y, (rank, grid, mode)
        assert res["grid"][grid]["num_updates"] == (len(SLABS),) * 2


def test_salt_is_honored(ranks, jax_fake_devices):
    Y_ref, W_ref = jax_fake_devices["salt_Y"], jax_fake_devices["salt_W"]
    unsalted = jax_fake_devices[_key("update", SALT[0], "Y")]
    for res in ranks:
        Y, W = res["salt"]
        assert _max_abs(Y, Y_ref) < TOL_Y and _max_abs(W, W_ref) < TOL_Y
        assert not np.allclose(Y, unsalted, atol=1e-3)


@pytest.mark.parametrize("variant", VARIANTS)
def test_finalize_matches_reference(ranks, jax_fake_devices, inputs,
                                    variant):
    B_ref, C_ref = jax_fake_devices[_key("finalize", variant, "B")], \
        jax_fake_devices[_key("finalize", variant, "C")]
    B_one, C_one = (np.asarray(x) for x in jnys.nystrom_reference(
        jnp.asarray(inputs[1]), S_SEED, S_R))
    for rank, res in enumerate(ranks):
        got = res["finalize"][variant]
        for ref in ((B_ref, C_ref), (B_one, C_one)):
            assert _max_abs(got["B"], ref[0]) < TOL_Y, (rank, variant)
            assert _max_abs(got["C"], ref[1]) < TOL_C, (rank, variant)


def test_grid_service_matches_reference(ranks, jax_fake_devices):
    ref = jax_fake_devices
    for res in ranks:
        svc = res["service"]
        assert _max_abs(svc["B"], ref["service_B"]) < TOL_Y
        assert _max_abs(svc["C"], ref["service_C"]) < TOL_C
    Y0 = np.concatenate([res["service"]["Y_blocks"][0] for res in ranks])
    Y1 = np.concatenate([res["service"]["Y_blocks"][1] for res in ranks])
    assert _max_abs(Y0, ref["service_Y0"]) < TOL_Y
    assert _max_abs(Y1, ref["service_Y1"]) < TOL_Y


# ---------------------------------------------------------------------------
# the port's bitwise claims
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_streamed_equals_one_shot_alg1(ranks, grid):
    """Row-disjoint full-shape updates give this rank's one-shot
    ``rand_matmul`` block, bitwise."""
    for rank, res in enumerate(ranks):
        got = res["grid"][grid]
        assert np.array_equal(got["Y_full"], got["oneshot"]), (rank, grid)


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_update_rows_equals_update_on_Y(ranks, grid):
    for rank, res in enumerate(ranks):
        got = res["grid"][grid]
        assert np.array_equal(got["Y_rows"], got["Y_full"]), (rank, grid)
        assert np.array_equal(got["rows"][0], got["full"][0]), (rank, grid)


def test_ragged_out_of_order_slabs_equal_one_shot(ranks):
    for rank, res in enumerate(ranks):
        assert np.array_equal(*res["ragged"]), rank


def test_p1_aligned_slabs_keep_W_bitwise(ranks):
    for rank, res in enumerate(ranks):
        (Yf, Wf), (Yr, Wr) = res["aligned"]
        assert np.array_equal(Yf, Yr) and np.array_equal(Wf, Wr), rank


@pytest.mark.parametrize("grid", RESTORE_GRIDS, ids=str)
def test_save_on_one_grid_restore_on_another(ranks, grid):
    for rank, res in enumerate(ranks):
        (Y, W), num_updates, cfg = res["restore"][grid]
        Ys, Ws = res["restore"]["saved"]
        assert np.array_equal(Y, Ys) and np.array_equal(W, Ws), rank
        assert num_updates == len(RAGGED)
        assert cfg == StreamConfig(n1=N1, n2=N2, r=R, seed=SEED)
        assert res["restore"]["path"].endswith(f"step_{len(RAGGED):08d}")
    assert (pathlib.Path(ranks[0]["restore"]["path"])
            / "manifest.json").exists()


@pytest.mark.parametrize("variant", VARIANTS)
def test_finalize_of_streamed_Y_equals_one_shot_blocks(ranks, variant):
    """The streamed Y is the one-shot ``rand_matmul`` block, so every
    second stage gives the same bits from either."""
    for rank, res in enumerate(ranks):
        assert res["finalize"]["Y_bitwise_oneshot"], rank
        assert res["finalize"][variant]["bitwise_oneshot"], (rank, variant)


def test_grid_service_eviction_is_bitwise(ranks):
    for rank, res in enumerate(ranks):
        svc = res["service"]
        assert svc["evicted"] == 1, rank
        assert svc["restored_bitwise"], rank
        assert svc["nystrom_bitwise"], rank
        assert svc["dist_updates"] == len(SERVICE_SEEDS)
        assert svc["stats"] == {"streams": 2, "resident": 1, "evicted": 1,
                                "updates": 2, "lane_batches": 0}
        np.testing.assert_array_equal(svc["low"], svc["low_direct"])


# ---------------------------------------------------------------------------
# words received
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_slab_words_equal_stream_update_cost(ranks, grid):
    p1, p2, p3 = grid
    for rank, res in enumerate(ranks):
        for (i0, i1), words in zip(SLABS, res["grid"][grid]["words_rows"]):
            k = i1 - i0
            want = tmodel.stream_update_cost(k, N2, R, L, grid=grid).words
            assert want == jmodel.stream_update_cost(k, N2, R, L,
                                                     grid=grid).words
            assert sum(w["words"] for w in words.values()) == want, rank
            assert words["all_gather"]["words"] == (p3 - 1) * k * N2 // (
                p2 * p3)
            assert words["all_reduce"]["words"] == 2 * (p2 - 1) * k * R // (
                p2 * p3)
            assert words["all_reduce"]["calls"] == int(p2 > 1)
    if grid == (WORLD, 1, 1):
        assert all(sum(w["words"] for w in words.values()) == 0
                   for res in ranks
                   for words in res["grid"][grid]["words_rows"])


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_update_words_equal_alg1_plus_corange(ranks, grid):
    p1 = grid[0]
    for rank, res in enumerate(ranks):
        for words in res["grid"][grid]["words_full"]:
            assert (sum(w["words"] for w in words.values())
                    == _alg1_corange_words(grid)), rank
            assert words["all_reduce"]["calls"] == int(p1 > 1)


@pytest.mark.parametrize("variant", VARIANTS)
def test_finalize_words_are_the_second_stages(ranks, variant):
    P = WORLD
    one_d = {"no_redist": (P - 1) * S_R * S_R // P,
             "redist": (P - 1) * S_N * S_R // P ** 2}
    for rank, res in enumerate(ranks):
        words = res["finalize"][variant]["words"]
        total = sum(w["words"] for w in words.values())
        if variant == "bound_driven":
            q = tgrid.select_two_grid_executable(S_N, S_R, P,
                                                 p=(P, 1, 1))[1]
            assert total <= tmodel.alg2_fused_cost(S_N, S_R, (P, 1, 1),
                                                   q).words, rank
        else:
            want = one_d["no_redist" if variant == "auto" else variant]
            assert total == want, (rank, variant)


def test_grid_service_words_are_alg1_plus_corange(ranks):
    grid = (WORLD, 1, 1)
    l = 2 * S_R + 1
    for res in ranks:
        for words in res["service"]["words"]:
            total = sum(w["words"] for w in words.values())
            assert total == (alg1_bandwidth_words(S_N, S_N, S_R, *grid)
                             + 2.0 * (1.0 - 1.0 / WORLD) * l * S_N)


def test_all_reduce_sums_the_fiber(ranks):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    want = WORLD * x + 100.0 * sum(range(WORLD))
    for res in ranks:
        got, words = res["all_reduce"]
        np.testing.assert_array_equal(got, want)
        assert words["all_reduce"] == {"calls": 1,
                                       "words": 2 * (WORLD - 1) * 6 // WORLD}


def test_all_reduce_of_one_rank_moves_nothing():
    col.reset_comm()
    x = torch.ones(3)
    assert col.all_reduce(x, None, 4) is x
    assert col.all_reduce(x, object(), 1) is x
    assert col.comm_words() == 0 and col.COMM["all_reduce"]["calls"] == 0


@pytest.mark.parametrize("corange", [True, False])
@pytest.mark.parametrize("k", [1, 7, 4096])
@pytest.mark.parametrize(
    "grid", [g for P in (1, 4, 8) for g in tgrid.factorizations_3d(P)],
    ids=str)
def test_stream_update_cost_matches_reference(grid, k, corange):
    """``words`` and ``messages`` are the reference's exactly;
    ``hbm_words`` prices the port's scratches and split-K work buffers
    (``sketch_fwd_plan``, ``sketch_t_plan``; not the reference's)."""
    n2, r, l = 32768, 512, 1025
    got = tmodel.stream_update_cost(k, n2, r, l, grid=grid, corange=corange)
    ref = jmodel.stream_update_cost(k, n2, r, l, grid=grid, corange=corange)
    assert got.words == ref.words and got.messages == ref.messages
    assert got.flops == ref.flops
    p1, p2, p3 = grid
    from repro_torch.kernels.sketch_matmul import (sketch_fwd_plan,
                                                   sketch_t_plan)
    fwd = sketch_fwd_plan(k, r // p3, n2 // p2)
    want = (k * n2 / p2
            + 2.0 * (fwd["scratch_bytes"] + fwd["work_bytes"]) / 4
            + 4.0 * k * r / p3)
    if corange:
        wt = sketch_t_plan(l, n2 // (p2 * p3), k)
        want += (k * n2 / (p2 * p3)
                 + 2.0 * (wt["scratch_bytes"] + wt["work_bytes"]) / 4
                 + 2.0 * l * n2 / (p2 * p3))
    # r/p3 <= 128 splits sketch_fwd over K: a work buffer is priced
    assert (fwd["work_bytes"] > 0) == (p3 >= 4)
    assert got.hbm_words == want


# ---------------------------------------------------------------------------
# refusals (no world needed: each raises before any collective)
# ---------------------------------------------------------------------------

def _fake(shape):
    return GridGroups(shape, 0, (0, 0, 0))


def _message(jax_fake_devices, name):
    kind, msg = jax_fake_devices["msgs"][name]
    return {"ValueError": ValueError,
            "NotImplementedError": NotImplementedError}[kind], msg


def _svc():
    return SketchService(mesh=_fake((WORLD, 1, 1)), device="cpu")


def _open(svc):
    return svc.open(StreamConfig(n1=S_N, n2=S_N, r=S_R, seed=5))


def _row0():
    svc = _svc()
    svc.update(_open(svc), np.zeros((S_N, S_N), np.float32), row0=0)


def _batch():
    svc = _svc()
    svc.update_batch([_open(svc)], np.zeros((1, S_N, S_N), np.float32),
                     row0=0)


def _ragged():
    svc = _svc()
    svc.update_ragged([(_open(svc), np.zeros((4, S_N), np.float32), 0)])


REFUSALS = {
    "not_divisible": lambda: ShardedStreamingSketch(
        StreamConfig(n1=18, n2=N2, r=R), _fake((WORLD, 1, 1)),
        device="cpu"),
    "finalize_grid": lambda: nystrom_finalize(
        torch.zeros(32, S_R), StreamConfig(n1=S_N, n2=S_N, r=S_R),
        _fake((2, 2, 1))),
    "finalize_square": lambda: ShardedStreamingSketch(
        StreamConfig(n1=N1, n2=N2, r=R), _fake((WORLD, 1, 1)),
        device="cpu").nystrom(),
    "row0": _row0,
    "update_batch": _batch,
    "update_ragged": _ragged,
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_carry_the_reference_message(jax_fake_devices, name):
    exc, msg = _message(jax_fake_devices, name)
    with pytest.raises(exc, match=f"^{re.escape(msg)}$"):
        REFUSALS[name]()


@pytest.mark.parametrize("kind", ["countsketch", "rowsample"])
def test_sparse_kinds_are_refused(kind):
    cfg = StreamConfig(n1=N1, n2=N2, r=R, kind=kind)
    for fn in (lambda: ShardedStreamingSketch(cfg, _fake((WORLD, 1, 1)),
                                              device="cpu"),
               lambda: _svc().open(cfg)):
        with pytest.raises(NotImplementedError,
                           match="sparse bodies are deferred"):
            fn()


def test_a_plan_in_place_of_the_grid_needs_the_planner():
    """A plan's grid places a sharded stream or a grid service (on a world
    of four: ``tests/test_torch_planner.py``).  Here, with no world: an
    object that only looks like a plan is refused, a plan with no grid
    carries none, ``grid="auto"`` needs the stream shape, and a
    single-device plan gives a local-mode service."""
    class Plan:
        grid = (WORLD, 1, 1)
    cfg = StreamConfig(n1=N1, n2=N2, r=R)
    for fn in (lambda: ShardedStreamingSketch(cfg, Plan(), device="cpu"),
               lambda: SketchService(mesh=Plan(), device="cpu"),
               lambda: make_sketch_service(plan=Plan(), device="cpu")):
        with pytest.raises(TypeError, match="repro_torch.plan.Plan"):
            fn()
    with pytest.raises(TypeError, match="GridGroups"):
        ShardedStreamingSketch(cfg, object(), device="cpu")
    one = plan_stream(N1, N2, R, P=1, machine=tmodel.PRESETS["cpu"])
    assert one.grid is None
    for fn in (lambda: ShardedStreamingSketch(cfg, one, device="cpu"),
               lambda: SketchService(mesh=one, device="cpu")):
        with pytest.raises(ValueError,
                           match="^plan 'stream_local' carries no processor "
                                 "grid$"):
            fn()
    with pytest.raises(ValueError, match=re.escape(
            'grid="auto" needs the dominant stream shape: shape=(n1, n2, '
            'r)')):
        make_sketch_service(grid="auto", device="cpu")
    for svc in (make_sketch_service(plan=one, device="cpu"),
                make_sketch_service(grid="auto", shape=(N1, N2, R),
                                    device="cpu")):
        assert svc.mesh is None and svc.device.type == "cpu"


def test_a_rank_past_the_grid_is_refused():
    g = GridGroups((2, 1, 1), 3, None)
    with pytest.raises(ValueError, match="past the grid"):
        ShardedStreamingSketch(StreamConfig(n1=N1, n2=N2, r=R), g,
                               device="cpu")


def test_sharded_stream_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedStreamingSketch(StreamConfig(n1=N1, n2=N2, r=R),
                               _fake((WORLD, 1, 1)))
