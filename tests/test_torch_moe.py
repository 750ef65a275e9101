"""The port's MoE (``models/ffn.py`` ``moe`` / ``moe_init``, the LM's MoE
branch, serving and training) against the reference's, on reduced
granite-moe-1b-a400m and dbrx-132b (2 layers, 4 experts, top-2, float32).

The reference's params are carried across with ``convert.params_from_jax``
and every input is drawn with numpy.  What is compared, with its bound:

  * routes, exactly: each token's top-k experts (``jax.lax.top_k``'s,
    read as the reference's own ``moe`` calls it) and the keep mask (an
    assignment's slot, the count of earlier assignments to its expert in
    token-major then k order, below the capacity).  A flipped route or
    drop moves a token's output by O(1), so no tolerance hides one;
  * ``moe``'s output and aux loss to 1e-5 relative, the gradients of x and
    of every MoE leaf to 1e-5 relative Frobenius, in float32 (sums taken
    in other orders; about 1e-7 here).  In bfloat16 the expert products
    and the combine round to bf16 on both sides, by other kernels: 2e-2
    relative Frobenius, a few bf16 ulps (2**-8 each), and the routes,
    computed in f32 from the same bf16 inputs, still exactly;
  * ``lm_loss`` to 1e-5 relative and every gradient leaf to 1e-5 relative
    Frobenius (tests/test_torch_models.py's bounds), the aux term in;
  * decode and prefill logits and caches to 1e-5 relative Frobenius
    against the reference's (tests/test_torch_serve_lm.py's bounds), and
    to 2e-3 against the teacher-forced forward (the reference's own bound
    in tests/test_models.py) where nothing drops (capacity factor 8.0);
  * ``BatchedServer``'s greedy tokens and the planner's decisions exactly;
  * three compressed training steps to tests/test_torch_train.py's limits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from repro.configs import get_config as jax_config
from repro.configs.base import RunConfig as JaxRunConfig
from repro.models import api as japi
from repro.models import ffn as jffn
from repro.models import transformer as jtf
from repro.models.common import softcap as jsoftcap
from repro.parallel import grad_compress as jgc
from repro.plan import plan_train_compression as jplan
from repro.serve import engine as jengine
from repro.train.step import init_state as jinit_state
from repro.train.step import make_dp_compressed_step as jstep
from repro_torch.configs import RunConfig, get_config
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.models import (count_active_params, count_params_split,
                                get_api, lm_hidden, lm_init, lm_loss,
                                param_leaves)
from repro_torch.models import ffn as tffn
from repro_torch.models import transformer as ttf
from repro_torch.plan import plan_train_compression
from repro_torch.serve import engine as tengine
from repro_torch.train import make_dp_compressed_step

ARCHS = ("granite-moe-1b-a400m", "dbrx-132b")
B, S = 2, 16
TOL, TOL_BF16, TOL_FORWARD = 1e-5, 2e-2, 2e-3


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(".".join(str(getattr(k, "key", k)) for k in path), leaf)
            for path, leaf in flat]


def _keep(gate_idx: np.ndarray, E: int, cap: int) -> np.ndarray:
    """The capacity rule written as a loop: token-major, then k; every
    assignment takes a slot of its expert, kept or not."""
    seen = np.zeros(E, np.int64)
    keep = np.zeros(gate_idx.shape, bool)
    for n in range(gate_idx.shape[0]):
        for j in range(gate_idx.shape[1]):
            e = gate_idx[n, j]
            keep[n, j] = seen[e] < cap
            seen[e] += 1
    return keep


def _reference_routes(monkeypatch, jp, x, **kw):
    """The reference's ``moe`` on ``x``, and the (N, k) experts its own
    ``jax.lax.top_k`` call picked."""
    seen = []
    top_k = jax.lax.top_k

    def spy(operand, k):
        out = top_k(operand, k)
        seen.append(out)
        return out
    monkeypatch.setattr(jax.lax, "top_k", spy)
    y = jffn.moe(jp, x, **kw)
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    return y, np.asarray(seen[0][1])


def _moe_inputs(dtype):
    """One reduced granite MoE layer's params (reference, port) and a
    (4, 16, d) input that leans toward one direction, so that at capacity
    factor 1.25 a fair share of assignments drops."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jffn.moe_init(jax.random.key(4), d, f, E, jdt)
    tp = tffn.MoEParams(**params_from_jax(jax.device_get(jp._asdict()),
                                          device="cpu"))
    g = np.random.default_rng(5)
    x = (g.standard_normal((4, 16, d))
         + 1.5 * g.standard_normal(d)).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return cfg, jp, tp, xj, xt


# -- (1) the MoE layer ---------------------------------------------------------

@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_moe_matches_reference(monkeypatch, dispatch, capacity_factor):
    cfg, jp, tp, xj, xt = _moe_inputs("float32")
    kw = dict(top_k=cfg.top_k, capacity_factor=capacity_factor,
              dispatch=dispatch)
    (jy, jaux), jidx = _reference_routes(monkeypatch, jp, xj,
                                         return_aux=True, **kw)
    N, E = xt.shape[0] * xt.shape[1], cfg.n_experts
    r = tffn.moe_routes(tp, xt.reshape(N, -1), top_k=cfg.top_k,
                        capacity_factor=capacity_factor)
    assert r.cap == max(1, int(capacity_factor * cfg.top_k * N / E))
    assert np.array_equal(r.gate_idx.numpy(), jidx)
    want_keep = _keep(jidx, E, r.cap)
    assert np.array_equal(r.keep.numpy(), want_keep)
    assert (~want_keep).sum() >= (10 if capacity_factor == 1.25 else 0)
    assert want_keep.all() == (capacity_factor == 8.0)

    # a weighted sum of y plus the aux loss, so every output element and
    # the router's aux path carry gradient
    wts = np.random.default_rng(6).standard_normal(xt.shape).astype(
        np.float32)

    def jloss(p, x):
        y, aux = jffn.moe(p, x, return_aux=True, **kw)
        return jnp.sum(y * wts) + aux
    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, xj)
    x = xt.clone().requires_grad_(True)
    y, aux = tffn.moe(tp, x, return_aux=True, **kw)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert _rel(_np(y), np.asarray(jy)) <= TOL
    assert abs(float(aux) - float(jaux)) <= TOL * abs(float(jaux))
    grads = torch.autograd.grad((y * torch.from_numpy(wts)).sum() + aux,
                                [x, *tp])
    assert _rel(grads[0].numpy(), jgx) <= TOL
    for name, g in zip(tffn.MoEParams._fields, grads[1:]):
        assert _rel(g.numpy(), getattr(jg, name)) <= TOL, name


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_moe_bf16_matches_reference(monkeypatch, dispatch):
    """The reference's scatter form cannot run in bf16 on the CPU (XLA's
    CPU backend refuses its batched bf16 x bf16 = f32 expert einsums), so
    the port's scatter form is held to the reference's einsum form: the
    same function, whose combine rounds once instead of k + 1 times."""
    cfg, jp, tp, xj, xt = _moe_inputs("bfloat16")
    assert tp.router.dtype == torch.float32 and tp.w_gate.dtype == \
        torch.bfloat16
    kw = dict(top_k=cfg.top_k, capacity_factor=1.25)
    jy, jidx = _reference_routes(monkeypatch, jp, xj, dispatch="einsum",
                                 **kw)
    N = xt.shape[0] * xt.shape[1]
    r = tffn.moe_routes(tp, xt.reshape(N, -1), **kw)
    assert np.array_equal(r.gate_idx.numpy(), jidx)
    assert np.array_equal(r.keep.numpy(), _keep(jidx, cfg.n_experts, r.cap))
    assert not r.keep.all()
    y = tffn.moe(tp, xt, dispatch=dispatch, **kw)
    assert y.dtype == torch.bfloat16
    assert _rel(_np(y), np.asarray(jy.astype(jnp.float32))) <= TOL_BF16


def test_dispatch_forms_agree_and_drop_the_same_assignments():
    cfg, _, tp, _, xt = _moe_inputs("float32")
    N = xt.shape[0] * xt.shape[1]
    r = tffn.moe_routes(tp, xt.reshape(N, -1), top_k=cfg.top_k)
    disp, _ = tffn.einsum_dispatch_matrix(r, torch.float32)
    kept = torch.zeros(N, cfg.n_experts)
    kept[torch.arange(N)[:, None], r.gate_idx] = r.keep.float()
    assert torch.equal(disp.sum(-1), kept)
    # one token per (expert, slot)
    assert disp.sum(0).max() == 1
    y = {d: tffn.moe(tp, xt, top_k=cfg.top_k, dispatch=d)
         for d in ("scatter", "einsum")}
    assert _rel(_np(y["einsum"]), _np(y["scatter"])) <= TOL
    with pytest.raises(ValueError, match="dispatch"):
        tffn.moe(tp, xt, top_k=cfg.top_k, dispatch="dense")


def test_moe_init_scales_and_dtypes():
    gen = torch.Generator().manual_seed(0)
    p = tffn.moe_init(gen, 256, 64, 8, torch.bfloat16, "cpu", layers=3)
    assert p.router.dtype == torch.float32
    assert p.router.shape == (3, 256, 8)
    assert {t.dtype for t in p[1:]} == {torch.bfloat16}
    assert (p.w_gate.shape, p.w_up.shape, p.w_down.shape) == (
        (3, 8, 256, 64), (3, 8, 256, 64), (3, 8, 64, 256))
    for t, scale in ((p.router, 1 / 16), (p.w_gate, 1 / 16),
                     (p.w_up, 1 / 16), (p.w_down, 1 / 8)):
        assert abs(float(t.float().std()) / scale - 1) < 0.05
    # each expert its own draw
    assert not torch.equal(p.w_gate[0, 0], p.w_gate[0, 1])
    meta = tffn.moe_init(None, 6144, 10752, 16, torch.bfloat16, "meta",
                         layers=8)
    assert meta.w_gate.device.type == "meta"


# -- (2) the LM's loss and gradients -------------------------------------------

_MODELS = {}


def _model(arch: str, **overrides):
    """(reference cfg, port cfg, reference params, port params, tokens
    (B, S) int32), built once per configuration."""
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _MODELS:
        jcfg = jax_config(arch).reduced(**overrides)
        cfg = get_config(arch).reduced(**overrides)
        jparams = jtf.lm_init(jax.random.key(0), jcfg)
        params = params_from_jax(jax.device_get(jparams), device="cpu")
        toks = np.random.default_rng(1).integers(
            0, cfg.vocab, (B, S)).astype(np.int32)
        _MODELS[key] = (jcfg, cfg, jparams, params, toks)
    return _MODELS[key]


@pytest.mark.parametrize("arch,dispatch", [
    ("granite-moe-1b-a400m", "scatter"), ("granite-moe-1b-a400m", "einsum"),
    ("dbrx-132b", "scatter")])
def test_lm_loss_and_grads_match_reference(arch, dispatch):
    jcfg, cfg, jparams, params, toks = _model(arch, moe_dispatch=dispatch)
    labels = np.roll(toks, -1, axis=1)
    labels[0, -3:] = -100
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jcfg, jbatch)))(jparams)
    jaux = jax.jit(lambda p: jtf.lm_hidden(p, jcfg, jbatch["tokens"])[1])(
        jparams)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    _, aux = lm_hidden(params, cfg, batch["tokens"])
    assert float(aux) > 0
    assert abs(float(aux) - float(jaux)) <= TOL * float(jaux)
    loss = lm_loss(params, cfg, batch)
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    leaves = param_leaves(params)
    want = dict(_jax_leaves(jgrads))
    assert [n for n, _ in leaves] == list(want)
    assert "blocks.moe.router" in want and "blocks.ffn.w_up" not in want
    for (name, _), g in zip(leaves, torch.autograd.grad(
            loss, [t for _, t in leaves])):
        assert _rel(g.numpy(), want[name]) <= TOL, name


# -- (3)-(5) serving -------------------------------------------------------------

_JSTEPS = {}


def _jstep(jcfg):
    if jcfg not in _JSTEPS:
        _JSTEPS[jcfg] = jax.jit(
            lambda p, t, c, pos: jtf.decode_step(p, jcfg, t, c, pos))
    return _JSTEPS[jcfg]


def _forward_logits(jparams, jcfg, toks):
    h, _ = jtf.lm_hidden(jparams, jcfg, jnp.asarray(toks), remat=False)
    W = jparams["embed"] if jcfg.tie_embeddings else jparams["lm_head"]
    return np.asarray(jsoftcap(jnp.einsum("bsd,vd->bsv", h, W),
                               jcfg.final_softcap))


def _check_caches(got, want):
    assert len(got) == len(want)
    for l, (g, w) in enumerate(zip(got, want)):
        for kv in ("k", "v"):
            assert _rel(_np(g[kv]), np.asarray(w[kv])) <= TOL, (l, kv)


def _decode_both(jcfg, cfg, jparams, params, toks, t0, t1, jcache, cache):
    step = _jstep(jcfg)
    for t in range(t0, t1):
        jl, jcache = step(jparams, jnp.asarray(toks[:, t:t + 1]), jcache,
                          jnp.int32(t))
        tl, cache = ttf.decode_step(params, cfg,
                                    torch.from_numpy(toks[:, t:t + 1]).long(),
                                    cache, t)
        yield t, tl, np.asarray(jl), jcache, cache


def _counting_drops(monkeypatch):
    """Wrap the port's router: the assignments it drops, call by call."""
    drops, routes = [], tffn.moe_routes

    def spy(*a, **kw):
        r = routes(*a, **kw)
        drops.append(int((~r.keep).sum()))
        return r
    monkeypatch.setattr(tffn, "moe_routes", spy)
    return drops


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_where_nothing_drops(arch, monkeypatch):
    jcfg, cfg, jparams, params, toks = _model(arch, capacity_factor=8.0)
    ref = _forward_logits(jparams, jcfg, toks)
    drops = _counting_drops(monkeypatch)
    cache = ttf.init_cache(cfg, B, S, device="cpu")
    jcache = jtf.init_cache(jcfg, B, S)
    for t, tl, jl, jcache, cache in _decode_both(
            jcfg, cfg, jparams, params, toks, 0, S, jcache, cache):
        assert _rel(_np(tl), jl) <= TOL, t
        assert _rel(_np(tl)[:, 0], ref[:, t]) <= TOL_FORWARD, t
    assert len(drops) == S * cfg.n_layers and not any(drops)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_where_decode_drops(arch, monkeypatch):
    """At the published capacity factor a decode step's capacity is that
    of its B tokens: cap = int(1.25 · 2 · 2 / 4) = 1, so two tokens that
    pick one expert drop the second assignment, on both sides."""
    jcfg, cfg, jparams, params, toks = _model(arch)
    assert cfg.capacity_factor == 1.25
    drops = _counting_drops(monkeypatch)
    cache = ttf.init_cache(cfg, B, S, device="cpu")
    jcache = jtf.init_cache(jcfg, B, S)
    for t, tl, jl, jcache, cache in _decode_both(
            jcfg, cfg, jparams, params, toks, 0, S, jcache, cache):
        assert _rel(_np(tl), jl) <= TOL, t
    _check_caches(cache, jcache)
    assert sum(drops) >= 8, drops


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(arch):
    jcfg, cfg, jparams, params, toks = _model(arch)
    half = S // 2
    jl, jcache = jtf.prefill(jparams, jcfg, jnp.asarray(toks[:, :half]),
                             remat=False, max_len=S)
    tl, cache = tengine.serve_prefill(
        params, cfg, {"tokens": torch.from_numpy(toks[:, :half]).long()},
        max_len=S)
    assert tuple(tl.shape) == (B, 1, cfg.vocab)
    assert _rel(_np(tl), np.asarray(jl)) <= TOL
    _check_caches(cache, jcache)
    for t, tl, jl, jcache, cache in _decode_both(
            jcfg, cfg, jparams, params, toks, half, S, jcache, cache):
        assert _rel(_np(tl), jl) <= TOL, t
    _check_caches(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_server_matches_reference(arch):
    """5 requests on 2 slots: the idle rows route token 0 beside the
    advancing one and share the step's capacity, in both packages."""
    jcfg, cfg, jparams, params, _ = _model(arch)

    def serve(engine, p, c):
        server = engine.BatchedServer(p, c, slots=2, max_len=32, eos=-1)
        reqs = [engine.Request(rid=i, prompt=[1 + i, 2, 3], max_new=4)
                for i in range(5)]
        for r in reqs:
            server.submit(r)
        server.run()
        return reqs

    got = serve(tengine, params, cfg)
    want = serve(jengine, jparams, jcfg)
    assert [r.out for r in got] == [r.out for r in want]
    assert all(r.done and len(r.out) == 4 for r in got)


# -- (6) the full configs, (7) the plan ------------------------------------------

@pytest.mark.parametrize("arch,total", [("granite-moe-1b-a400m",
                                         1_334_628_352),
                                        ("dbrx-132b", 131_596_523_520)])
def test_full_leaves_and_counts_match_reference(arch, total):
    jcfg, cfg = jax_config(arch), get_config(arch)
    assert dataclasses.asdict(cfg) == {
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cfg)}
    shapes = jax.eval_shape(lambda k: jtf.lm_init(k, jcfg),
                            jax.random.key(0))
    want = [(n, tuple(s.shape), str(s.dtype)) for n, s in _jax_leaves(shapes)]
    params = lm_init(0, cfg, device="meta")
    got = [(n, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for n, t in param_leaves(params)]
    assert got == want
    assert dict((n, d) for n, _, d in got)["blocks.moe.router"] == "float32"
    assert sum(int(np.prod(s)) for _, s, _ in got) == total
    assert count_params_split(cfg) == japi.count_params_split(jcfg, shapes)
    assert count_params_split(cfg)[0] == total
    assert count_active_params(cfg) == japi.count_active_params(
        jcfg, shapes) < total


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_decisions_match_reference(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    shapes = jax.eval_shape(lambda k: jtf.lm_init(k, jcfg),
                            jax.random.key(0))
    want = jplan(shapes, rank=8, P=8)
    got = plan_train_compression(lm_init(0, cfg, device="meta"), rank=8,
                                 P=8)
    assert [(d.name, d.shape, d.compress) for d in got.decisions] == [
        (d.name, tuple(d.shape), d.compress) for d in want.decisions]
    assert got.exchange_words == want.exchange_words
    if arch == "granite-moe-1b-a400m":
        assert got.n_compressed == 11
        assert [d.name for d in got.decisions if not d.compress] == [
            "ln_final.scale"]


def test_params_from_jax_keeps_the_router_in_float32():
    jcfg = jax_config("granite-moe-1b-a400m").reduced(dtype="bfloat16")
    jparams = jax.device_get(jtf.lm_init(jax.random.key(2), jcfg))
    params = params_from_jax(jparams, device="cpu")
    for (name, t), (_, want) in zip(param_leaves(params),
                                    _jax_leaves(jparams)):
        assert str(t.dtype).replace("torch.", "") == str(want.dtype), name
        assert np.array_equal(_np(t), np.asarray(want, np.float32)), name
        assert t.requires_grad
    assert params["blocks"]["moe"]["router"].dtype == torch.float32
    assert params["blocks"]["moe"]["w_up"].dtype == torch.bfloat16


# -- (8) compressed training ---------------------------------------------------

RANK, STEPS = 2, 3       # at rank 2 the f32 router (128 x 4) compresses too


def test_three_compressed_steps_match_reference():
    """As tests/test_torch_train.py for gemma2-2b: the losses and the error
    buffers after step 1 to 1e-5, each leaf's update after three steps to
    1e-3 relative Frobenius (AdamW's first steps move an element by about
    lr·sign(g))."""
    arch = "granite-moe-1b-a400m"
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    kw = dict(steps=STEPS, learning_rate=1e-3, warmup_steps=1,
              grad_compress_rank=RANK)
    jrun, run = JaxRunConfig(grad_compress_backend="jnp", **kw), \
        RunConfig(**kw)
    api = japi.get_api(jcfg)
    shapes = jax.eval_shape(lambda k: api.init(k, jcfg), jax.random.key(3))
    plan = jplan(shapes, rank=RANK, P=8)
    state = jinit_state(api, jcfg, jrun, jax.random.key(3),
                        decisions=plan.decision_tree())
    state = state.replace(error_fb=jgc.stack_fb(state.error_fb))
    start = jax.device_get(state)
    # on the mesh already, as the step returns it: one compilation, not two
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    state = jax.device_put(state, NamedSharding(mesh, PartitionSpec()))
    g = np.random.default_rng(11)
    batches = [g.integers(0, cfg.vocab, (4, S + 1)).astype(np.int32)
               for _ in range(STEPS)]

    jrun_step = jstep(api, jcfg, jrun, mesh, plan=plan)
    jlosses = []
    for i, toks in enumerate(batches):
        state, met = jrun_step(state, {"tokens": jnp.asarray(toks[:, :-1]),
                                       "labels": jnp.asarray(toks[:, 1:])})
        jlosses.append(float(met["loss"]))
        if i == 0:
            jfb1 = dict(_jax_leaves(jgc.local_fb(state.error_fb)))
    jparams3 = dict(_jax_leaves(state.params))

    tstate = train_state_from_jax(start, worker=0, device="cpu")
    tplan = plan_train_compression(tstate.params, rank=RANK, P=8)
    assert [d.compress for d in tplan.decisions] == [
        d.compress for d in plan.decisions]
    compressed = {d.name for d in tplan.decisions if d.compress}
    assert "blocks.moe.router" in compressed
    assert "blocks.moe.w_gate" in compressed
    start_params = {n: _np(t).copy() for n, t in param_leaves(tstate.params)}
    step = make_dp_compressed_step(get_api(cfg), cfg, run, plan=tplan)
    for i, toks in enumerate(batches):
        tstate, met = step(tstate, {
            "tokens": torch.from_numpy(toks[:, :-1]).long(),
            "labels": torch.from_numpy(toks[:, 1:]).long()})
        assert abs(met["loss"] - jlosses[i]) <= TOL * abs(jlosses[i]), i
        if i == 0:
            for n, e in param_leaves(tstate.error_fb):
                if n in compressed:
                    assert np.abs(jfb1[n]).max() > 0, n
                assert _rel(e.numpy(), jfb1[n]) <= TOL, n
    for n, t in param_leaves(tstate.params):
        assert _rel(_np(t) - start_params[n],
                    np.asarray(jparams3[n]) - start_params[n]) <= 1e-3, n
    assert tstate.params["blocks"]["moe"]["router"].dtype == torch.float32


# -- the launchers ---------------------------------------------------------------

def test_launchers_take_the_moe_configs(capsys, tmp_path):
    from repro_torch.launch import serve, train
    server = serve.main(["--workload", "lm", "--device", "cpu", "--arch",
                         "dbrx-132b", "--requests", "3", "--slots", "2",
                         "--max-new", "4", "--max-len", "16"])
    assert server.cfg.n_experts == 4 and server.cfg.family == "moe"
    assert "tokens/s" in capsys.readouterr().out
    res = train.main(["--device", "cpu", "--arch", "granite-moe-1b-a400m",
                      "--steps", "16", "--batch", "4", "--seq", "16",
                      "--lr", "1e-2", "--ckpt-every", "0", "--ckpt-dir",
                      str(tmp_path)])
    assert len(res.losses) == 16
    assert "family=moe" in capsys.readouterr().out
