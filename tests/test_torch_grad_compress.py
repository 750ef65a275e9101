"""The port's sketched gradient exchange and its planner against the
reference (repro.parallel.grad_compress, repro.plan).

  * Plan: per-leaf decisions, names and ``exchange_words`` equal the
    reference's for the full gemma2-2b shapes at P = 1 (nothing
    compresses: both exchanges move 0 words) and P = 8 (12 leaves).
  * One worker: ``compress_and_allreduce`` against the reference inside a
    one-device ``shard_map``.
  * Two workers: two gloo processes on the CPU against the reference
    under ``jax.vmap(..., axis_name="dp")``, whose ``pmean`` means over the
    mapped axis; the words each worker counts equal
    ``comm_words_compressed``.

Tolerance: 1e-5 relative Frobenius for g_hat and e' (Omega is bitwise the
same on both sides; the products and the thin QR sum in other orders, and
QR's Householder signs agree, LAPACK on both sides; measured about 1e-6).
A leaf given the key of its neighbour, or of the next step, draws another
Omega and misses by O(1): that case must fail the same tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_config
from repro.core.compat import shard_map
from repro.models import transformer as jtf
from repro.parallel import grad_compress as jgc
from repro.plan import PRESETS as JPRESETS
from repro.plan import plan_train_compression as jplan
from repro_torch.configs import get_config
from repro_torch.models import lm_init
from repro_torch.parallel import grad_compress as tgc
from repro_torch.plan import PRESETS as TPRESETS
from repro_torch.plan import explain_train_compression, plan_train_compression

from torch_dist_helper import exchange_worker, run_workers

RANK, STEP, TOL = 3, 5, 1e-5
SHAPES = {"b": (9,), "v": (3, 11, 7), "w": (17, 9), "x": (2, 3)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _inputs(world: int, seed: int = 0):
    """Per-worker grads and nonzero error buffers (numpy), and the plan's
    decisions at P = 8 (x, 2x3, stays raw: r·(m+n) >= m·n)."""
    g = np.random.default_rng(seed)
    shapes = {k: jax.ShapeDtypeStruct(s, jnp.float32)
              for k, s in SHAPES.items()}
    dec = jplan(shapes, rank=RANK, P=8).decision_tree()
    grads, fbs = [], []
    for _ in range(world):
        grads.append({k: g.standard_normal(s).astype(np.float32)
                      for k, s in SHAPES.items()})
        fbs.append({k: (0.25 * g.standard_normal(s).astype(np.float32)
                        if dec[k] else np.zeros((), np.float32))
                    for k, s in SHAPES.items()})
    return grads, fbs, dec


def _reference_one(grads, fb, dec):
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))

    def body(g, e):
        return jgc.compress_and_allreduce(
            g, e, step=jnp.int32(STEP), rank=RANK, axis_name="data",
            decisions=dec, backend="jnp")
    specs = jax.tree_util.tree_map(lambda _: P(), (grads, fb))
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=specs, out_specs=specs,
                          check_vma=False))
    out = f(jax.tree_util.tree_map(jnp.asarray, grads),
            jax.tree_util.tree_map(jnp.asarray, fb))
    return jax.device_get(out)


def _port(grads, fb, dec):
    g = {k: torch.from_numpy(v.copy()) for k, v in grads.items()}
    e = {k: torch.from_numpy(np.array(v)) for k, v in fb.items()}
    tgc.compress_and_allreduce(g, e, step=STEP, rank=RANK, decisions=dec)
    return ({k: v.numpy() for k, v in g.items()},
            {k: v.numpy() for k, v in e.items()})


@pytest.fixture(scope="module")
def one_worker():
    """Inputs of one worker and the reference's (g_hat, e') for them."""
    grads, fbs, dec = _inputs(1)
    return grads[0], fbs[0], dec, _reference_one(grads[0], fbs[0], dec)


def _worst(got, want) -> float:
    return max(_rel(got[i][k], want[i][k]) for i in range(2) for k in SHAPES)


@pytest.fixture(scope="module")
def gemma_full_shapes():
    jshapes = jax.eval_shape(lambda k: jtf.lm_init(k, jax_config("gemma2-2b")),
                             jax.random.key(0))
    return jshapes, lm_init(0, get_config("gemma2-2b"), device="meta")


@pytest.mark.parametrize("world,n_compressed", [(1, 0), (8, 12)])
def test_plan_matches_reference_full_gemma(gemma_full_shapes, world,
                                           n_compressed):
    jshapes, tshapes = gemma_full_shapes
    want = jplan(jshapes, rank=8, P=world)
    got = plan_train_compression(tshapes, rank=8, P=world)
    assert got.n_compressed == want.n_compressed == n_compressed
    assert got.exchange_words == want.exchange_words
    assert got.raw_words == want.raw_words
    for d, w in zip(got.decisions, want.decisions, strict=True):
        assert (d.name, d.shape, d.m, d.n, d.r_eff, d.compress) == \
            (w.name, w.shape, w.m, w.n, w.r_eff, w.compress)
        assert d.words == w.words
    if world == 8:
        assert got.exchange_words == 7_099_456
        assert got.raw_words == 2_614_341_888
        words = tgc.comm_words_compressed(tshapes, 8, got.decision_tree())
        assert words == got.exchange_words
        assert tgc.comm_words_exact(tshapes) == got.raw_words
    assert "totals" in explain_train_compression(got)
    # the seconds objective, on the cpu entry (the reference's numbers):
    # the reference's decisions and notes, the words unchanged, each leaf
    # compressed iff its sketched seconds are the fewer
    jsec = jplan(jshapes, rank=8, P=world, objective="seconds",
                 machine=JPRESETS["cpu"])
    sec = plan_train_compression(tshapes, rank=8, P=world,
                                 objective="seconds",
                                 machine=TPRESETS["cpu"])
    assert (sec.objective, sec.dtype, sec.kind, sec.machine) == \
        ("seconds", "float32", "normal", "cpu")
    assert sec.n_compressed == jsec.n_compressed == 0
    assert sec.lower_bound_words == sec.exchange_words == sec.raw_words
    for d, w in zip(sec.decisions, jsec.decisions, strict=True):
        assert (d.name, d.compress, d.note) == (w.name, w.compress, w.note)
        assert (d.raw_cost.words, d.comp_cost.words) == \
            (w.raw_cost.words, w.comp_cost.words)
        assert d.compress == (d.comp_seconds < d.raw_seconds)
        if world > 1:
            assert d.raw_seconds == w.raw_seconds
    assert "sketch s" in explain_train_compression(sec)


def test_exchange_one_worker_matches_reference(one_worker):
    grads, fb, dec, want = one_worker
    got = _port(grads, fb, dec)
    for i in range(2):
        for k in SHAPES:
            assert _rel(got[i][k], want[i][k]) <= TOL, (i, k)
    assert np.array_equal(got[1]["x"], fb["x"])          # raw: untouched


@pytest.mark.parametrize("mutation", ["leaf+1", "step+1"])
def test_exchange_tolerance_catches_a_wrong_omega_key(monkeypatch, mutation,
                                                      one_worker):
    grads, fb, dec, want = one_worker
    right = tgc.leaf_seed
    if mutation == "leaf+1":
        monkeypatch.setattr(tgc, "leaf_seed",
                            lambda idx, step: right(idx + 1, step))
    else:
        monkeypatch.setattr(tgc, "leaf_seed",
                            lambda idx, step: right(idx, step + 1))
    got = _port(grads, fb, dec)
    assert _worst(got, want) > 100 * TOL


def test_exchange_two_workers_gloo_matches_reference_vmap():
    grads, fbs, dec = _inputs(2, seed=1)

    def body(g, e):
        return jgc.compress_and_allreduce(
            g, e, step=jnp.int32(STEP), rank=RANK, axis_name="dp",
            decisions=dec, backend="jnp")
    stack = lambda trees: {k: jnp.stack([t[k] for t in trees])  # noqa: E731
                           for k in SHAPES}
    jg, je = jax.device_get(jax.jit(jax.vmap(body, axis_name="dp"))(
        stack(grads), stack(fbs)))
    res = run_workers(exchange_worker, 2, grads, fbs,
                      {k: bool(v) for k, v in dec.items()}, RANK, STEP)
    tshapes = {k: torch.empty(s) for k, s in SHAPES.items()}
    words = tgc.comm_words_compressed(tshapes, RANK, dec)
    for w, (g_hat, e_new, counted) in enumerate(res):
        assert counted == words
        for k in SHAPES:
            assert _rel(g_hat[k], jg[k][w]) <= TOL, (w, k)
            assert _rel(e_new[k], je[k][w]) <= TOL, (w, k)
    # the mean estimate is the same on both workers, the residuals differ
    for k in SHAPES:
        np.testing.assert_array_equal(res[0][0][k], res[1][0][k])


def test_reshard_error_fb_keeps_the_worker_mean():
    g = np.random.default_rng(2)
    fb = {"w": torch.from_numpy(g.standard_normal((4, 5, 3)).astype(
        np.float32))}
    for world_to in (1, 2, 8, 3):
        out = tgc.reshard_error_fb(fb, 4, world_to)
        mean = out["w"] if world_to == 1 else out["w"].mean(0)
        torch.testing.assert_close(mean, fb["w"].mean(0))
    assert tgc.reshard_error_fb(fb, 4, 4) is fb
