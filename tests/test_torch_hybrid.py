"""The port's hybrid LM (``models/zamba.py``: a Mamba-2 backbone and one
shared attention+FFN block) and Nyström landmark attention
(``models/attention.py`` ``nystrom_attention``, also the dense LM's
``use_nystrom`` branch) against the reference's, on reduced zamba2-1.2b
(5 layers, the shared block after every 2, so after layers 2 and 4 but not
after the last one: ``n_layers % every != 0``; float32).

The reference's params are carried across with ``convert.params_from_jax``
and every input is drawn with numpy.  Bounds, as in tests/test_torch_ssm.py:
float32 results to 1e-5 relative Frobenius (loss, every gradient leaf,
decode logits, SSM states and KV caches step by step, prefill logits,
Nyström attention); decode against the teacher-forced forward to 5e-3, the
reference's own bound; ``BatchedServer``'s tokens and the planner's
decisions exactly; three compressed training steps to
tests/test_torch_train.py's limits.
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
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.models import zamba as jz
from repro.parallel import grad_compress as jgc
from repro.plan import plan_train_compression as jplan
from repro.serve import engine as jengine
from repro.train.step import init_state as jinit_state
from repro.train.step import make_dp_compressed_step as jstep
from repro_torch.configs import RunConfig, get_config
from repro_torch.convert import (cache_from_jax, params_from_jax,
                                 train_state_from_jax)
from repro_torch.models import (count_params_split, get_api, lm_hidden,
                                param_leaves)
from repro_torch.models import attention as tattn
from repro_torch.models import zamba as tz
from repro_torch.plan import plan_train_compression
from repro_torch.serve import engine as tengine
from repro_torch.train import make_dp_compressed_step

ARCH = "zamba2-1.2b"
B, S = 2, 16
TOL, TOL_FORWARD = 1e-5, 5e-3


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), leaf)
            for path, leaf in flat]


def _model(arch: str = ARCH, **overrides):
    jcfg = jax_config(arch).reduced(**overrides)
    cfg = get_config(arch).reduced(**overrides)
    jparams = jax.device_get(japi.get_api(jcfg).init(jax.random.key(0),
                                                     jcfg))
    params = params_from_jax(jparams, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S + 1))
    return jcfg, cfg, jparams, params, toks


# -- (1) configs, leaves, caches ----------------------------------------------

def test_full_leaves_and_count_match_reference():
    jcfg, cfg = jax_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(cfg) == {
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cfg)}
    shapes = jax.eval_shape(lambda k: jz.hybrid_init(k, jcfg),
                            jax.random.key(0))
    want = [(n, tuple(s.shape), str(s.dtype)) for n, s in _jax_leaves(shapes)]
    params = get_api(cfg).init(0, cfg, "meta")
    got = [(n, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for n, t in param_leaves(params)]
    assert got == want
    dtypes = dict((n, d) for n, _, d in got)
    assert all(dtypes[f"blocks.mamba.{k}"] == "float32"
               for k in ("A_log", "D", "dt_bias"))
    assert dtypes["blocks.mamba.in_proj"] == "bfloat16"
    assert sum(int(np.prod(s)) for _, s, _ in got) == 1_170_473_856
    assert count_params_split(cfg) == japi.count_params_split(jcfg, shapes)
    assert count_params_split(cfg) == (1_170_473_856, 0)


@pytest.mark.parametrize("reduced,batch,max_len", [(True, 2, 16),
                                                   (False, 4, 1280)])
def test_init_cache_matches_reference(reduced, batch, max_len):
    jcfg, cfg = jax_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want = jax.eval_shape(lambda: jz.hybrid_init_cache(jcfg, batch, max_len))
    got = get_api(cfg).init_cache(cfg, batch, max_len, device="meta")
    assert tz._n_shared_applications(cfg) == jz._n_shared_applications(
        jcfg) == (2 if reduced else 6)
    spec = (lambda t: (tuple(t.shape),
                       str(t.dtype).replace("torch.", "")))
    assert [(n, spec(t)) for n, t in _cache_leaves(got)] == [
        (n, (tuple(s.shape), str(s.dtype))) for n, s in _jax_leaves(want)]
    assert isinstance(got["shared"], list)


def _cache_leaves(cache):
    out = [("conv", cache["conv"])]
    for i, e in enumerate(cache["shared"]):
        out += [(f"shared.{i}.k", e["k"]), (f"shared.{i}.v", e["v"])]
    return out + [("ssm", cache["ssm"])]


# -- (2) loss and gradients ---------------------------------------------------

def test_loss_and_gradients_match_reference():
    jcfg, cfg, jparams, params, toks = _model()
    assert cfg.n_layers == 5 and cfg.shared_attn_every == 2
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jz.hybrid_loss(p, jcfg, jb)))(jparams)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    leaves = [t for _, t in param_leaves(params)]
    loss = tz.hybrid_loss(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(jl)) <= TOL * abs(float(jl))
    for (name, _), g, (_, want) in zip(param_leaves(params), grads,
                                       _jax_leaves(jg)):
        assert _rel(_np(g), want) <= TOL, name
    assert tz.hybrid_loss(params, cfg, batch, remat=False).item() == \
        loss.item()


# -- (3) serving --------------------------------------------------------------

def _check_cache(cache, jcache, tol=TOL):
    assert len(cache["shared"]) == len(jcache["shared"])
    for name, t in _cache_leaves(cache):
        want = jcache
        for part in name.split("."):
            want = want[int(part)] if part.isdigit() else want[part]
        assert _rel(_np(t), want) <= tol, name


def test_decode_matches_reference_and_forward():
    jcfg, cfg, jparams, params, toks = _model()
    with torch.inference_mode():
        h = tz.hybrid_hidden(params, cfg, torch.from_numpy(toks[:, :S]),
                             remat=False)
        ref = _np(h @ params["lm_head"].T)
    api, japi_ = get_api(cfg), japi.get_api(jcfg)
    cache = api.init_cache(cfg, B, S, device="cpu")
    jcache = japi_.init_cache(jcfg, B, S)
    step = jax.jit(lambda p, t, c, pos: japi_.decode_step(p, jcfg, t, c, pos))
    for t in range(S):
        jl, jcache = step(jparams, jnp.asarray(toks[:, t:t + 1]), jcache,
                          jnp.int32(t))
        entries = list(cache["shared"])
        tl, cache2 = api.decode_step(params, cfg,
                                     torch.from_numpy(toks[:, t:t + 1]),
                                     cache, t)
        assert cache2 is cache and all(        # written in place
            a is b for a, b in zip(entries, cache["shared"]))
        assert _rel(_np(tl), jl) <= TOL, t
        np.testing.assert_allclose(_np(tl)[:, 0], ref[:, t],
                                   rtol=TOL_FORWARD, atol=TOL_FORWARD)
        _check_cache(cache, jcache)
        if t == 5:
            # carried across mid-sequence, the list of KV caches included
            carried = cache_from_jax(jax.device_get(jcache), device="cpu")
            _check_cache(carried, jcache, tol=0.0)


def test_serve_prefill_matches_reference():
    jcfg, cfg, jparams, params, toks = _model()
    jl, jcache = jengine.serve_prefill(jparams, jcfg,
                                       {"tokens": jnp.asarray(toks[:, :S])})
    tl, cache = tengine.serve_prefill(
        params, cfg, {"tokens": torch.from_numpy(toks[:, :S])})
    assert jcache is None and cache is None
    assert tuple(tl.shape) == (B, 1, cfg.vocab)
    assert _rel(_np(tl), jl) <= TOL


def test_batched_server_matches_reference():
    jcfg, cfg, jparams, params, _ = _model()

    def serve(engine, params, cfg):
        server = engine.BatchedServer(params, cfg, slots=2, max_len=32,
                                      eos=-1)
        reqs = [engine.Request(rid=i, prompt=[1, 2 + i], max_new=4)
                for i in range(3)]
        for r in reqs:
            server.submit(r)
        server.run()
        return reqs

    got = serve(tengine, params, cfg)
    want = serve(jengine, jparams, jcfg)
    assert [r.out for r in got] == [r.out for r in want]
    assert all(r.done and len(r.out) == 4 for r in got)


# -- (4) Nyström landmark attention -------------------------------------------

@pytest.mark.parametrize("Hq,Hk,m", [(4, 4, 4), (4, 2, 8), (2, 1, 16)])
def test_nystrom_attention_matches_reference(Hq, Hk, m):
    g = np.random.default_rng(m)
    d, D = 32, 8
    w = {n: (g.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("wq", (d, Hq * D)), ("wk", (d, Hk * D)),
                      ("wv", (d, Hk * D)), ("wo", (Hq * D, d)))}
    x = g.standard_normal((B, 32, d)).astype(np.float32)
    kw = dict(n_heads=Hq, n_kv_heads=Hk, head_dim=D, n_landmarks=m)
    jy = jattn.nystrom_attention(
        jattn.AttnParams(**{n: jnp.asarray(a) for n, a in w.items()}),
        jnp.asarray(x), **kw)
    ty = tattn.nystrom_attention(
        tattn.AttnParams(**{n: torch.from_numpy(a) for n, a in w.items()}),
        torch.from_numpy(x), **kw)
    assert tuple(ty.shape) == (B, 32, d)
    assert _rel(_np(ty), jy) <= TOL


def test_hybrid_nystrom_branch_matches_reference(monkeypatch):
    """``nystrom_attn_above`` lowered to the prompt's length: each of the
    two applications of the shared block attends through Nyström."""
    jcfg, cfg, jparams, params, toks = _model(nystrom_attn_above=S)
    calls = []
    real = tz.nystrom_attention
    monkeypatch.setattr(tz, "nystrom_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jh = jz.hybrid_hidden(jparams, jcfg, jnp.asarray(toks[:, :S]),
                          remat=False)
    with torch.inference_mode():
        h = tz.hybrid_hidden(params, cfg, torch.from_numpy(toks[:, :S]))
        h_short = tz.hybrid_hidden(params, cfg,
                                   torch.from_numpy(toks[:, :S // 2]))
    assert len(calls) == 2                      # not at S // 2
    assert _rel(_np(h), jh) <= TOL
    jshort = jz.hybrid_hidden(jparams, jcfg, jnp.asarray(toks[:, :S // 2]),
                              remat=False)
    assert _rel(_np(h_short), jshort) <= TOL


def test_dense_lm_nystrom_branch_matches_reference():
    jcfg = jax_config("llama3-8b").reduced(nystrom_attn_above=S)
    cfg = get_config("llama3-8b").reduced(nystrom_attn_above=S)
    jparams = jax.device_get(jtf.lm_init(jax.random.key(0), jcfg))
    params = params_from_jax(jparams, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, S))
    jh, _ = jtf.lm_hidden(jparams, jcfg, jnp.asarray(toks), remat=False)
    h, _ = lm_hidden(params, cfg, torch.from_numpy(toks))
    assert _rel(_np(h), jh) <= TOL


# -- (5) the plan and compressed training -------------------------------------

def test_plan_decisions_match_reference():
    jcfg, cfg = jax_config(ARCH), get_config(ARCH)
    shapes = jax.eval_shape(lambda k: jz.hybrid_init(k, jcfg),
                            jax.random.key(0))
    want = jplan(shapes, rank=8, P=8)
    got = plan_train_compression(get_api(cfg).init(0, cfg, "meta"), rank=8,
                                 P=8)
    assert [(d.name, d.shape, d.compress) for d in got.decisions] == [
        (d.name, tuple(d.shape), d.compress) for d in want.decisions]
    assert got.exchange_words == want.exchange_words
    compressed = {d.name for d in got.decisions if d.compress}
    assert "blocks.mamba.in_proj" in compressed
    assert "shared.attn.wq" in compressed


RANK, STEPS = 2, 3


def test_three_compressed_steps_match_reference():
    """As tests/test_torch_moe.py for granite: the losses and the error
    buffers after step 1 to 1e-5, each leaf's update after three steps to
    1e-3 relative Frobenius (AdamW's first steps move an element by about
    lr·sign(g)).

    One exception, the embedding's rows that no batch touches.  Their
    exact gradient is 0 and so is the exact sketched one, but the QR's
    first r rows of P̂ (Householder's pivots) hold rounding noise there
    (about 1e-9 of the leaf, on either side), which AdamW's
    g / (|g| + 1e-8) turns into a good fraction of lr, differently on each
    side.  Those rows are held instead to be noise on both sides: their
    error buffer after step 1 (minus the sketched gradient) below 1e-6 of
    the buffer's largest entry."""
    jcfg, cfg = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
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
    assert "blocks.mamba.in_proj" in compressed
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
            tstate_fb1 = {"embed": tstate.error_fb["embed"].clone()}
    touched = np.zeros(cfg.vocab, bool)
    for toks in batches:
        touched[toks[:, :-1]] = True
    e = _np(tstate_fb1["embed"])
    for fb in (e, np.asarray(jfb1["embed"])):
        assert np.abs(fb[~touched]).max() <= 1e-6 * np.abs(fb).max()
    for n, t in param_leaves(tstate.params):
        rows = touched if n == "embed" else slice(None)
        assert _rel((_np(t) - start_params[n])[rows],
                    (np.asarray(jparams3[n]) - start_params[n])[rows]) \
            <= 1e-3, n
    m = tstate.params["blocks"]["mamba"]
    assert all(m[k].dtype == torch.float32 for k in ("A_log", "D",
                                                     "dt_bias"))


# -- (6) the launchers --------------------------------------------------------

def test_launchers_take_zamba2(capsys, tmp_path):
    from repro_torch.launch import serve, train
    server = serve.main(["--workload", "lm", "--device", "cpu", "--arch",
                         ARCH, "--requests", "3", "--slots", "2",
                         "--max-new", "4", "--max-len", "16"])
    assert server.cfg.family == "hybrid"
    assert len(server.cache["shared"]) == 2
    assert "tokens/s" in capsys.readouterr().out
    res = train.main(["--device", "cpu", "--arch", ARCH, "--steps", "12",
                      "--batch", "4", "--seq", "16", "--lr", "1e-2",
                      "--ckpt-every", "0", "--ckpt-dir", str(tmp_path),
                      "--grad-compress", "2"])
    assert len(res.losses) == 12
    assert "family=hybrid" in capsys.readouterr().out
