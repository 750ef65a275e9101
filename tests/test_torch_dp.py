"""Data-parallel training of the port across ranks, against the reference.

Four gloo processes on the CPU run ``make_dp_compressed_step`` on reduced
gemma2-2b, each from its worker's slice of the reference's fresh state (the
reference's own checkpoint, read by ``convert.train_state_from_checkpoint``),
on the same three global batches of 8 x 16 tokens (2 rows a worker) and
under the plan priced for P = 4.  The reference runs its step at world 4
on four fake XLA devices in a subprocess.  Compared, with the tolerances of
tests/test_torch_train.py (which says what bounds each):

  * the three losses to 1e-5 relative;
  * every worker's error buffer after step 1 to 1e-5 relative Frobenius;
  * each leaf's total update after 3 steps to 1e-3 relative Frobenius.

A mutation case gives one compressed leaf the key of leaf idx + 1 on ONE
rank: that rank's sketch enters every worker's mean, and the same
comparison must fail.  Also: the four replicas' params are bitwise equal
after every step; each rank counts ``comm_words_compressed`` words a step
(``comm_words_exact`` under an all-raw plan), plus the loss's one word;
the legacy ``min_dim`` heuristic against the reference's; the launcher at
two ranks.
"""
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as jtf
from repro.parallel import grad_compress as jgc
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_checkpoint
from repro_torch.models import lm_init, param_leaves
from repro_torch.parallel import grad_compress as tgc

from torch_dist_helper import ReferenceDP, dp_train_worker, run_workers

ARCH, RANK, WORLD, STEPS, B, S = "gemma2-2b", 4, 4, 3, 8, 16
TOL, TOL_UPDATE = 1e-5, 1e-3
MUTATED_LEAF = 0                      # blocks.attn.wk, compressed at P = 4
RUN = {"steps": STEPS, "learning_rate": 1e-3, "warmup_steps": 1,
       "grad_compress_rank": RANK}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _batches(n):
    toks = np.random.default_rng(11).integers(
        0, 256, (n, B, S + 1)).astype(np.int32)
    return toks[:, :, :-1].copy(), toks[:, :, 1:].copy()


@pytest.fixture(scope="module")
def work():
    with tempfile.TemporaryDirectory(prefix="torch_dp_") as d:
        yield d


@pytest.fixture(scope="module")
def job(work):
    """The reference's run, started in the background."""
    tokens, labels = _batches(STEPS)
    job = ReferenceDP(work, {"arch": ARCH, "seed": 3, "world": WORLD,
                             "steps": STEPS, "run": RUN}, tokens, labels)
    yield job
    if job.proc.poll() is None:
        job.proc.kill()


@pytest.fixture(scope="module")
def ranks(job):
    """The port's four ranks, the sketched run and the mutated one, while
    the reference compiles."""
    tokens, labels = _batches(STEPS)
    spec = {"arch": ARCH, "run": RUN, "plan_P": WORLD, "steps": STEPS,
            "start": job.wait_start(), "tokens": tokens, "labels": labels}
    return (run_workers(dp_train_worker, WORLD, spec),
            run_workers(dp_train_worker, WORLD,
                        dict(spec, mutate_rank=2, mutate_leaf=MUTATED_LEAF)))


@pytest.fixture(scope="module")
def port(ranks):
    return ranks[0]


@pytest.fixture(scope="module")
def mutated(ranks):
    return ranks[1]


@pytest.fixture(scope="module")
def reference(job, ranks):
    """The reference's run as numpy, and its start params (``start.<n>``)
    from the checkpoint it saved."""
    out = job.result()
    st = train_state_from_checkpoint(job.wait_start(), worker=0,
                                     device="cpu")
    out.update({f"start.{n}": t.detach().float().numpy()
                for n, t in param_leaves(st.params)})
    return out


def _errors(reference, res):
    last = STEPS - 1
    start = {n: reference[f"start.{n}"] for n in res[0]["params"][last]}
    return {
        "loss": max(abs(res[0]["loss"][i] - float(reference[f"loss.{i}"]))
                    / abs(float(reference[f"loss.{i}"]))
                    for i in range(STEPS)),
        "fb1": max(_rel(r["fb"][0][n], reference[f"fb.0.{n}"][w])
                   for w, r in enumerate(res) for n in r["fb"][0]),
        "update": max(_rel(res[0]["params"][last][n] - start[n],
                           reference[f"params.{last}.{n}"] - start[n])
                      for n in start),
    }


LIMITS = {"loss": TOL, "fb1": TOL, "update": TOL_UPDATE}


def test_four_workers_match_the_reference(reference, port):
    err = _errors(reference, port)
    for k, lim in LIMITS.items():
        assert err[k] <= lim, (k, err)
    # the workers' residuals differ, so each kept its own buffer
    assert not np.array_equal(port[0]["fb"][0]["embed"],
                              port[1]["fb"][0]["embed"])


def test_one_rank_with_a_wrong_omega_key_fails_the_comparison(reference,
                                                              mutated):
    err = _errors(reference, mutated)
    for k in ("fb1", "update"):
        assert err[k] > 10 * LIMITS[k], (k, err)


@pytest.mark.parametrize("which", ["sketched", "mutated"])
def test_replicas_stay_bitwise_identical(port, mutated, which):
    res = port if which == "sketched" else mutated
    for i in range(STEPS):
        for r in res[1:]:
            for n, x in res[0]["params"][i].items():
                assert np.array_equal(x, r["params"][i][n]), (i, n)
    for r in res[1:]:
        for n, x in res[0]["raw_params"].items():
            assert np.array_equal(x, r["raw_params"][n]), n


def test_each_rank_counts_the_planned_words(port):
    shapes = lm_init(0, get_config(ARCH).reduced(), device="meta")
    dec = port[0]["decisions"]
    assert any(dec) and not all(dec)
    tree = _unflatten(shapes, dec)
    words = tgc.comm_words_compressed(shapes, RANK, tree)
    assert words < tgc.comm_words_exact(shapes)
    for r in port:
        assert r["decisions"] == dec
        # the exchange's words and the loss's one word
        assert all(w == words + 1 for w in r["words"].values()), r["words"]
        assert r["raw_words"] == tgc.comm_words_exact(shapes) + 1


def _unflatten(shapes, flags):
    from repro_torch.models.api import unflatten_like
    return unflatten_like(shapes, list(flags))


@pytest.fixture(scope="module")
def gemma_shapes():
    jcfg = jax_config(ARCH)
    return {
        "reduced": (jax.eval_shape(lambda k: jtf.lm_init(k, jcfg.reduced()),
                                   jax.random.key(0)),
                    lm_init(0, get_config(ARCH).reduced(), device="meta")),
        "full": (jax.eval_shape(lambda k: jtf.lm_init(k, jcfg),
                                jax.random.key(0)),
                 lm_init(0, get_config(ARCH), device="meta"))}


@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("min_dim", [1, 16, 1024])
def test_min_dim_heuristic_matches_reference(gemma_shapes, size, min_dim):
    jshapes, tshapes = gemma_shapes[size]
    want = jgc._decision_flags(jax.tree_util.tree_leaves(jshapes), min_dim,
                               None)
    got = tgc._flags(tshapes, None, min_dim)
    assert got == want
    assert tgc.comm_words_compressed(tshapes, 8, min_dim=min_dim) == \
        jgc.comm_words_compressed(jshapes, 8, min_dim=min_dim)
    # the error buffers follow the same flags, and so does init_state
    fb = tgc.init_error_fb(tshapes, min_dim=min_dim)
    jfb = jax.eval_shape(lambda: jgc.init_error_fb(jshapes, 8, min_dim))
    assert [tuple(t.shape) for _, t in param_leaves(fb)] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(jfb)]


@pytest.mark.parametrize("case", ["neither", "wrong_length"])
def test_min_dim_errors_match_reference(gemma_shapes, case):
    jshapes, tshapes = gemma_shapes["reduced"]
    jflat = jax.tree_util.tree_leaves(jshapes)
    dec = None if case == "neither" else {"embed": True}
    with pytest.raises(ValueError) as want:
        jgc._decision_flags(jflat, None, dec)
    with pytest.raises(ValueError) as got:
        tgc.comm_words_compressed(tshapes, 8, dec)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="need either|decisions has"):
        tgc.init_error_fb(tshapes, dec)


def test_init_state_without_decisions_uses_min_dim():
    from repro_torch.configs import RunConfig
    from repro_torch.models import get_api
    from repro_torch.train import init_state
    cfg = get_config(ARCH).reduced()
    for min_dim, n in ((64, 6), (100, 2), (1024, 0)):
        run = RunConfig(grad_compress_rank=4, grad_compress_min_dim=min_dim)
        st = init_state(get_api(cfg), cfg, run, 0, "cpu")
        full = [n for n, t in param_leaves(st.error_fb) if t.dim()]
        assert len(full) == n, full
    assert RunConfig().grad_compress_min_dim == 1024


def test_launcher_trains_on_two_ranks(tmp_path):
    env = dict(os.environ, WORLD_SIZE="2", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(os.path.dirname(__file__), "..", "src"),
                    os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", "gemma2-2b", "--steps", "12", "--batch", "4",
           "--seq", "16", "--grad-compress", "4", "--ckpt-every", "6",
           "--ckpt-dir", str(tmp_path / "ckpt"), "--init-method",
           f"file://{tmp_path / 'store'}"]
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r),
                                            LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert "TrainCompressionPlan rank=4 P=2" in outs[0][0]
    assert "12 steps, 0 restarts, 2 checkpoints" in outs[0][0]
    assert outs[1][0] == ""                  # rank 0 alone prints
    step = tmp_path / "ckpt" / "step_00000012"
    assert sorted(p.name for p in step.iterdir()) == [
        "error_fb.rank0.pt", "error_fb.rank1.pt", "manifest.json",
        "tensors.pt"]


@pytest.mark.parametrize("chunk", [1, 97, 1 << 26])
def test_adamw_slices_change_no_bit(monkeypatch, chunk):
    """AdamW takes a big leaf a slice at a time (so four replicas of
    gemma2-2b's embedding fit one card); the arithmetic is elementwise, so
    every slicing gives the same bits."""
    from repro_torch.optim import adamw
    g = torch.Generator().manual_seed(4)
    params = {"a": torch.randn(300, 37, generator=g),
              "b": torch.randn(5, generator=g).bfloat16()}
    grads = [{k: torch.randn(v.shape, generator=g).to(v.dtype)
              for k, v in params.items()} for _ in range(3)]
    out = []
    for c in (None, chunk):
        if c is not None:
            monkeypatch.setattr(adamw, "CHUNK", c)
        p = {k: v.clone() for k, v in params.items()}
        st = adamw.init(p)
        for gr in grads:
            adamw.update(gr, st, p, 1e-3)
        out.append((p, st))
    (p0, s0), (p1, s1) = out
    for k in params:
        for x, y in ((p0, p1), (s0.m, s1.m), (s0.v, s1.v)):
            assert torch.equal(x[k], y[k]), k
