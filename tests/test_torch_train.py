"""The port's training path against the reference: three steps of
``make_dp_compressed_step`` on reduced gemma2-2b from one state, the
train loop, and the launcher.

Both packages start from the reference's fresh state (carried with
``convert.train_state_from_jax``; the reference's one-device error
buffers are stacked with ``stack_fb``, which its ``shard_map`` needs), see
the same three numpy batches and use the plan priced for 8 workers (at one
worker nothing compresses).  Compared, with what bounds each:

  * the exchange of step 1 on the model's own gradients: g_hat and e' to
    1e-5 relative Frobenius (the tolerance of the exchange alone,
    tests/test_torch_grad_compress.py; the gradients agree to about 1e-6,
    tests/test_torch_models.py);
  * the three losses to 1e-5 relative;
  * the error buffers after step 1 to 1e-5 relative Frobenius;
  * the parameters after 3 steps: each leaf's total update (params minus
    the start) to 1e-3 relative Frobenius.  AdamW's first steps move each
    element by about ``lr·sign(g)``, so an element whose g_hat sits within
    rounding of 0 may move the other way; 1e-3 leaves room for a few such
    elements among the 100k, and none for a wrong Omega.

The mutation cases give ONE compressed leaf the key of leaf idx + 1, or of
step + 1: its Omega, g_hat, e' and update change at O(1), and the same
comparison must fail.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_config
from repro.configs.base import RunConfig as JaxRunConfig
from repro.core.compat import shard_map
from repro.models import get_api as jax_api
from repro.parallel import grad_compress as jgc
from repro.plan import plan_train_compression as jplan
from repro.train.step import init_state as jinit_state
from repro.train.step import make_dp_compressed_step as jstep
from repro_torch.checkpoint import ckpt
from repro_torch.configs import RunConfig, get_config
from repro_torch.convert import train_state_from_jax
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels.sketch_matmul import KernelLaunchError
from repro_torch.models import get_api, param_leaves
from repro_torch.parallel import grad_compress as tgc
from repro_torch.plan import plan_train_compression
from repro_torch.train import (init_state, make_dp_compressed_step,
                               make_train_step, train_loop)

ARCH, RANK, STEPS, B, S = "gemma2-2b", 4, 3, 4, 16
TOL, TOL_UPDATE = 1e-5, 1e-3
MUTATED_LEAF = 0                      # blocks.attn.wk, compressed at P = 8


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _names(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(k, "key", k)) for k in p): np.asarray(x)
            for p, x in flat}


def _batches():
    g = np.random.default_rng(11)
    out = []
    for _ in range(STEPS):
        toks = g.integers(0, 256, (B, S + 1)).astype(np.int32)
        out.append((toks[:, :-1], toks[:, 1:].copy()))
    return out


def _runs():
    kw = dict(steps=STEPS, learning_rate=1e-3, warmup_steps=1,
              grad_compress_rank=RANK)
    return JaxRunConfig(grad_compress_backend="jnp", **kw), RunConfig(**kw)


@pytest.fixture(scope="module")
def reference():
    """The reference's start state, its three steps, and the exchange of
    step 1 on the start params' gradients, all as numpy."""
    cfg = jax_config(ARCH).reduced()
    api = jax_api(cfg)
    jrun, _ = _runs()
    shapes = jax.eval_shape(lambda k: api.init(k, cfg), jax.random.key(3))
    plan = jplan(shapes, rank=RANK, P=8)
    dec = plan.decision_tree()
    state = jinit_state(api, cfg, jrun, jax.random.key(3), decisions=dec)
    state = state.replace(error_fb=jgc.stack_fb(state.error_fb))
    start = jax.device_get(state)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))

    # step 1's exchange, alone
    b0 = {"tokens": jnp.asarray(_batches()[0][0]),
          "labels": jnp.asarray(_batches()[0][1])}
    grads = jax.jit(jax.grad(lambda p: api.loss(p, cfg, b0)))(state.params)
    fb = jgc.local_fb(state.error_fb)

    def body(g, e):
        return jgc.compress_and_allreduce(
            g, e, step=jnp.int32(0), rank=RANK, axis_name="data",
            decisions=dec, backend="jnp")
    specs = jax.tree_util.tree_map(lambda _: P(), (grads, fb))
    g_hat, e_new = jax.jit(shard_map(body, mesh=mesh, in_specs=specs,
                                     out_specs=specs, check_vma=False))(
        grads, fb)

    step = jstep(api, cfg, jrun, mesh, plan=plan)
    losses, fb1 = [], None
    for i, (toks, labels) in enumerate(_batches()):
        state, met = step(state, {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(labels)})
        losses.append(float(met["loss"]))
        if i == 0:
            fb1 = _names(jgc.local_fb(state.error_fb))
    return {"start": start, "losses": losses, "fb1": fb1,
            "params3": _names(state.params), "start_params":
            _names(start.params), "g_hat": _names(g_hat),
            "e_new": _names(e_new)}


def _port_steps(reference, mutation, monkeypatch):
    if mutation is not None:
        right = tgc.leaf_seed

        def wrong(idx, step):
            if idx != MUTATED_LEAF:
                return right(idx, step)
            return right(idx + 1, step) if mutation == "leaf+1" \
                else right(idx, step + 1)
        monkeypatch.setattr(tgc, "leaf_seed", wrong)
    cfg = get_config(ARCH).reduced()
    api = get_api(cfg)
    _, run = _runs()
    state = train_state_from_jax(reference["start"], worker=0, device="cpu")
    plan = plan_train_compression(state.params, rank=RANK, P=8)
    assert plan.n_compressed > 0

    # step 1's exchange, alone, on a copy of the start state
    st = train_state_from_jax(reference["start"], worker=0, device="cpu")
    toks, labels = _batches()[0]
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    loss = api.loss(st.params, cfg, batch)
    leaves = param_leaves(st.params)
    grads = dict(zip([n for n, _ in leaves], torch.autograd.grad(
        loss, [t for _, t in leaves])))
    from repro_torch.models.api import unflatten_like
    gtree = unflatten_like(st.params, list(grads.values()))
    tgc.compress_and_allreduce(gtree, st.error_fb, step=0, rank=RANK,
                               decisions=plan.decision_tree())
    g_hat = {n: t.numpy() for n, t in param_leaves(gtree)}
    e_new = {n: t.numpy() for n, t in param_leaves(st.error_fb)}

    step = make_dp_compressed_step(api, cfg, run, plan=plan)
    losses, fb1 = [], None
    for i, (toks, labels) in enumerate(_batches()):
        state, met = step(state, {"tokens": torch.from_numpy(toks).long(),
                                  "labels": torch.from_numpy(labels).long()})
        losses.append(met["loss"])
        if i == 0:
            fb1 = {n: t.clone().numpy()
                   for n, t in param_leaves(state.error_fb)}
    params3 = {n: t.detach().float().numpy()
               for n, t in param_leaves(state.params)}
    return g_hat, e_new, losses, fb1, params3


def _errors(reference, got):
    g_hat, e_new, losses, fb1, params3 = got
    start = reference["start_params"]
    return {
        "g_hat": max(_rel(g_hat[n], reference["g_hat"][n]) for n in g_hat),
        "e_new": max(_rel(e_new[n], reference["e_new"][n]) for n in e_new),
        "loss": max(abs(a - b) / abs(b)
                    for a, b in zip(losses, reference["losses"])),
        "fb1": max(_rel(fb1[n], reference["fb1"][n]) for n in fb1),
        "update": max(_rel(params3[n] - start[n],
                           reference["params3"][n] - start[n])
                      for n in params3),
    }


LIMITS = {"g_hat": TOL, "e_new": TOL, "loss": TOL, "fb1": TOL,
          "update": TOL_UPDATE}


def test_three_compressed_steps_match_reference(reference, monkeypatch):
    err = _errors(reference, _port_steps(reference, None, monkeypatch))
    for k, lim in LIMITS.items():
        assert err[k] <= lim, (k, err)
    # the port's own loss moved, and the buffers carry a residual
    assert any(np.abs(v).max() > 0 for v in reference["fb1"].values())


@pytest.mark.parametrize("mutation", ["leaf+1", "step+1"])
def test_wrong_omega_key_fails_the_comparison(reference, monkeypatch,
                                              mutation):
    err = _errors(reference, _port_steps(reference, mutation, monkeypatch))
    for k in ("g_hat", "e_new", "fb1", "update"):
        assert err[k] > 10 * LIMITS[k], (k, err)


def test_train_loop_lowers_the_loss(tmp_path):
    cfg = get_config("llama3-8b").reduced()
    api = get_api(cfg)
    run = RunConfig(steps=40, learning_rate=3e-3, warmup_steps=5,
                    checkpoint_every=20, checkpoint_dir=str(tmp_path),
                    grad_compress_rank=4)
    plan = plan_train_compression(api.init(0, cfg, "meta"), rank=4, P=8)
    state = init_state(api, cfg, run, 0, "cpu",
                       decisions=plan.decision_tree())
    calls = []

    def fail_once(step):
        if step == 25 and not calls:
            calls.append(step)
            raise RuntimeError("injected node failure")
    res = train_loop(make_dp_compressed_step(api, cfg, run, plan=plan), state,
                     DataConfig(cfg.vocab, 32, 4, seed=1), run, device="cpu",
                     failure_injector=fail_once)
    assert res.restarts == 1 and res.checkpoints == [20, 40]
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])
    assert res.state.step == 40


def _loop(tmp_path, steps, checkpoint_every):
    cfg = get_config("llama3-8b").reduced()
    api = get_api(cfg)
    run = RunConfig(steps=steps, learning_rate=3e-3, warmup_steps=1,
                    checkpoint_every=checkpoint_every,
                    checkpoint_dir=str(tmp_path), grad_compress_rank=4)
    plan = plan_train_compression(api.init(0, cfg, "meta"), rank=4, P=8)
    state = init_state(api, cfg, run, 0, "cpu",
                       decisions=plan.decision_tree())

    def go():
        return train_loop(make_dp_compressed_step(api, cfg, run, plan=plan),
                          state, DataConfig(cfg.vocab, 16, 4, seed=1), run,
                          device="cpu")
    return go, 3 * plan.n_compressed


def _fail_inside_exchange(monkeypatch, per_step, at_step, exc):
    """``gemm_block`` raises ``exc`` once, at step ``at_step``'s fourth
    call: after the first compressed leaf's exchange has written its
    gradient and error buffer in place, before the others and AdamW."""
    right, calls = tgc.gemm_block, [0]

    def faulty(*args, **kw):
        calls[0] += 1
        if calls[0] == per_step * at_step + 4:
            raise exc("injected fault inside the exchange")
        return right(*args, **kw)
    monkeypatch.setattr(tgc, "gemm_block", faulty)


@pytest.mark.parametrize("exc,checkpoint_every",
                         [(RuntimeError, 0), (KernelLaunchError, 1)])
def test_failure_inside_a_step_is_not_replayed(tmp_path, monkeypatch, exc,
                                               checkpoint_every):
    """The step updates the state in place, so a failure inside it leaves
    the state half updated: with no checkpoint the loop must raise rather
    than train on.  A refused kernel launch raises at once, even with a
    checkpoint to fall back to."""
    go, per_step = _loop(tmp_path, 3, checkpoint_every)
    _fail_inside_exchange(monkeypatch, per_step, 1, exc)
    with pytest.raises(exc, match="injected fault"):
        go()


def test_failure_inside_a_step_restores_the_checkpoint_bitwise(
        tmp_path, monkeypatch):
    """A failure inside step 3, after checkpoint 2, restores checkpoint 2
    over the half-updated state and replays steps 2 and 3: the end state
    equals an unbroken run's bit for bit."""
    go, _ = _loop(tmp_path / "clean", 4, 2)
    want = go()
    go, per_step = _loop(tmp_path / "broken", 4, 2)
    _fail_inside_exchange(monkeypatch, per_step, 3, RuntimeError)
    got = go()
    assert got.restarts == 1 and want.restarts == 0
    assert got.losses == want.losses[:3] + want.losses[2:]
    assert got.state.step == want.state.step == 4
    assert got.state.opt.count == want.state.opt.count
    for tree in ("params", "error_fb"):
        for (n, x), (_, y) in zip(param_leaves(getattr(got.state, tree)),
                                  param_leaves(getattr(want.state, tree))):
            assert torch.equal(x, y), (tree, n)
    for tree in ("m", "v"):
        for (n, x), (_, y) in zip(param_leaves(getattr(got.state.opt, tree)),
                                  param_leaves(getattr(want.state.opt,
                                                       tree))):
            assert torch.equal(x, y), (tree, n)


def test_nonfinite_loss_leaves_the_state_untouched():
    cfg = get_config("llama3-8b").reduced()
    api = get_api(cfg)
    run = RunConfig(steps=2)
    state = init_state(api, cfg, run, 0, "cpu")
    before = {n: t.detach().clone() for n, t in param_leaves(state.params)}
    step = make_train_step(api, cfg, run)
    batch = {"tokens": torch.zeros(2, 8, dtype=torch.long),
             "labels": torch.full((2, 8), -100, dtype=torch.long)}
    with torch.no_grad():
        state.params["embed"][0] = float("nan")
        before["embed"][0] = float("nan")
    batch["labels"][0, 0] = 1
    state, met = step(state, batch)
    assert not np.isfinite(met["loss"]) and state.step == 0
    for n, t in param_leaves(state.params):
        assert torch.equal(t.detach().nan_to_num(), before[n].nan_to_num())


def test_launcher_runs_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "gemma2-2b", "--steps", "12", "--batch", "4", "--seq",
         "16", "--grad-compress", "4", "--ckpt-every", "6", "--ckpt-dir",
         str(tmp_path)], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "TrainCompressionPlan rank=4 P=1" in out.stdout
    assert "12 steps, 0 restarts, 2 checkpoints" in out.stdout


def test_checkpoint_round_trip_skips_a_torn_step(tmp_path):
    cfg = get_config("llama3-8b").reduced()
    api = get_api(cfg)
    run = RunConfig(grad_compress_rank=4)
    plan = plan_train_compression(api.init(0, cfg, "meta"), rank=4, P=8)
    a = init_state(api, cfg, run, 0, "cpu", decisions=plan.decision_tree())
    with torch.no_grad():
        a.error_fb["embed"].fill_(0.5)
    a.step, a.opt.count = 7, 7
    ckpt.save(str(tmp_path), 7, a, extra={"data": {"step": 7, "seed": 0}})
    torn = tmp_path / "step_00000009"
    torn.mkdir()
    (torn / "manifest.json").write_text("{")
    assert ckpt.latest_step(str(tmp_path)) == 7
    b = init_state(api, cfg, run, 1, "cpu", decisions=plan.decision_tree())
    b, step, extra = ckpt.restore(str(tmp_path), b)
    assert step == 7 and b.step == 7 and b.opt.count == 7
    assert extra == {"data": {"step": 7, "seed": 0}}
    for tree in ("params", "error_fb"):
        for (n, x), (_, y) in zip(param_leaves(getattr(a, tree)),
                                  param_leaves(getattr(b, tree))):
            assert torch.equal(x, y), n


def test_accumulated_step_matches_the_whole_batch_step():
    """Two micro-batches of equal size (no pad labels) average to the
    whole batch's mean loss and gradient: one AdamW step moves the params
    alike.  Loss to 1e-5 relative; each leaf's update to 1e-4 relative
    Frobenius, since an update of about lr = 1e-3 is read as the difference
    of two f32 params of about 0.1, whose ulp is already 1e-5 of it."""
    cfg = get_config("llama3-8b").reduced()
    api = get_api(cfg)
    run = RunConfig(steps=4, learning_rate=1e-3, warmup_steps=1)
    toks, labels = _batches()[0]
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    out = {}
    for accum in (1, 2):
        st = init_state(api, cfg, run, 5, "cpu")
        start = {n: t.detach().clone() for n, t in param_leaves(st.params)}
        st, met = make_train_step(api, cfg, run, accum_steps=accum)(st,
                                                                    batch)
        out[accum] = (met["loss"], {n: t.detach() - start[n]
                                    for n, t in param_leaves(st.params)})
    assert abs(out[1][0] - out[2][0]) <= 1e-5 * abs(out[1][0])
    for n, d in out[1][1].items():
        assert _rel(out[2][1][n].numpy(), d.numpy()) <= 1e-4, n
