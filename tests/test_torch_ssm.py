"""The port's state-space layers (``models/ssm.py``) and the falcon-mamba
LM (``models/mamba_lm.py``) against the reference's, on reduced
falcon-mamba-7b and zamba2-1.2b (d_model 64, d_inner 128, ssm_state 8,
dt_rank 8, 4 SSM heads, chunk 8, float32).

The reference's params are carried across with ``convert.params_from_jax``
and every input is drawn with numpy.  What is compared, with its bound:

  * float32 results to 1e-5 relative Frobenius (sums taken in other
    orders; about 1e-7 here): the causal convolution, the odd/even scan
    against ``jax.lax.associative_scan``, ``mamba1`` / ``mamba2`` with
    their carried states, the LM's loss and every gradient leaf, decode
    logits and states step by step, ``serve_prefill``'s logits;
  * the bf16 convolution to 2**-7: both sides round each product and sum
    to bf16, through other kernels (a bf16 ulp is 2**-8 relative);
  * decode against the teacher-forced forward to 5e-3, the reference's own
    bound (tests/test_models.py);
  * ``BatchedServer``'s greedy tokens and the planner's decisions exactly;
  * Mamba-2's masked decay: the port masks the exponent before the exp,
    the reference the exp after it.  Where the reference's gradient is
    finite the two gradients agree to 1e-5; where a masked exponent passes
    f32's 88.7 the reference's gradient is NaN (0 · inf) and the port's is
    finite, with the same loss.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import api as japi
from repro.models import mamba_lm as jml
from repro.models import ssm as jssm
from repro.serve import engine as jengine
from repro_torch.configs import get_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import count_params_split, get_api, param_leaves
from repro_torch.models import mamba_lm as tml
from repro_torch.models import ssm as tssm
from repro_torch.serve import engine as tengine

B, S = 2, 16
TOL, TOL_BF16, TOL_FORWARD = 1e-5, 2.0 ** -7, 5e-3


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(".".join(str(getattr(k, "key", k)) for k in path), leaf)
            for path, leaf in flat]


def _layer_params(arch: str, seed: int = 0):
    """One reduced Mamba layer's params, (config, reference, port)."""
    cfg = jax_config(arch).reduced()
    key = jax.random.key(seed)
    if cfg.mamba_version == 1:
        jp = jssm.mamba1_init(key, cfg.d_model, cfg.d_inner, cfg.ssm_state,
                              cfg.dt_rank, cfg.d_conv, jnp.float32)
        tp = tssm.Mamba1Params(**params_from_jax(
            jax.device_get(jp._asdict()), device="cpu"))
    else:
        jp = jssm.mamba2_init(key, cfg.d_model, cfg.d_inner, cfg.ssm_state,
                              cfg.ssm_heads, cfg.d_conv, jnp.float32)
        tp = tssm.Mamba2Params(**params_from_jax(
            jax.device_get(jp._asdict()), device="cpu"))
    return cfg, jp, tp


def _kw(cfg) -> dict:
    if cfg.mamba_version == 1:
        return dict(d_state=cfg.ssm_state, dt_rank=cfg.dt_rank)
    return dict(d_state=cfg.ssm_state, n_heads=cfg.ssm_heads)


def _layer_fns(cfg):
    if cfg.mamba_version == 1:
        return jssm.mamba1, tssm.mamba1
    return jssm.mamba2, tssm.mamba2


# -- (1) the causal convolution -----------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(dtype, with_state):
    g = np.random.default_rng(0)
    K, C, n = 4, 24, 11
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x, w, b = (jnp.asarray(g.standard_normal(s), jdt)
               for s in ((B, n, C), (K, C), (C,)))
    st = (jnp.asarray(g.standard_normal((B, K - 1, C)), jdt)
          if with_state else None)
    jy, jst = jssm.causal_conv1d(x, w, b, st)
    conv = (lambda a: _t(a.astype(jnp.float32)).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32))
    ty, tst = tssm.causal_conv1d(conv(x), conv(w), conv(b),
                                 None if st is None else conv(st))
    assert ty.dtype == (torch.bfloat16 if dtype == "bfloat16"
                        else torch.float32)
    tol = TOL_BF16 if dtype == "bfloat16" else TOL
    assert _rel(_np(ty), np.asarray(jy, np.float32)) <= tol
    # the new state is the last K-1 inputs (state included), exactly
    assert np.array_equal(_np(tst), np.asarray(jst, np.float32))


# -- (2) the scan inside a chunk ----------------------------------------------

@pytest.mark.parametrize("c", [1, 6, 8, 13])
def test_associative_scan_matches_jax(c):
    g = np.random.default_rng(c)
    a = np.exp(-g.uniform(0.0, 0.5, (B, c, 5, 3))).astype(np.float32)
    bx = g.standard_normal((B, c, 5, 3)).astype(np.float32)

    def comb(p, q):
        return p[0] * q[0], q[0] * p[1] + q[1]
    ja, jb = jax.lax.associative_scan(comb, (jnp.asarray(a), jnp.asarray(bx)),
                                      axis=1)
    ta, tb = tssm.associative_scan(torch.from_numpy(a), torch.from_numpy(bx))
    assert tuple(ta.shape) == tuple(tb.shape) == a.shape
    assert _rel(_np(ta), ja) <= TOL and _rel(_np(tb), jb) <= TOL
    # and the recurrence itself, written as a loop
    h, want = np.zeros_like(bx[:, 0]), []
    for t in range(c):
        h = a[:, t] * h + bx[:, t]
        want.append(h)
    assert _rel(_np(tb), np.stack(want, 1)) <= TOL


# -- (3) mamba1 and mamba2 ----------------------------------------------------

@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
@pytest.mark.parametrize("n", [8, 24])          # one chunk of 8; three
def test_mamba_layer_matches_reference(arch, n):
    cfg, jp, tp = _layer_params(arch)
    jfn, tfn = _layer_fns(cfg)
    g = np.random.default_rng(n)
    x = g.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    kw = dict(_kw(cfg), chunk=cfg.ssm_chunk, return_state=True)
    jy, jconv, jssm_state = jfn(jp, jnp.asarray(x), **kw)
    ty, tconv, tssm_state = tfn(tp, torch.from_numpy(x), **kw)
    assert _rel(_np(ty), jy) <= TOL
    assert np.array_equal(_np(tconv), np.asarray(jconv))
    assert tssm_state.dtype == torch.float32
    assert _rel(_np(tssm_state), jssm_state) <= TOL
    # carried on: the states of the first call continue the sequence
    x2 = g.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
    jy2, _, jh2 = jfn(jp, jnp.asarray(x2), conv_state=jconv,
                      ssm_state=jssm_state, **kw)
    ty2, _, th2 = tfn(tp, torch.from_numpy(x2), conv_state=tconv,
                      ssm_state=tssm_state, **kw)
    assert _rel(_np(ty2), jy2) <= TOL and _rel(_np(th2), jh2) <= TOL


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_mamba_layer_gradients_match_reference(arch):
    cfg, jp, tp = _layer_params(arch, seed=1)
    jfn, tfn = _layer_fns(cfg)
    g = np.random.default_rng(2)
    x = g.standard_normal((B, 16, cfg.d_model)).astype(np.float32)
    kw = dict(_kw(cfg), chunk=cfg.ssm_chunk)
    jl, (jgp, jgx) = jax.value_and_grad(
        lambda p, x: jnp.sum(jnp.sin(jfn(p, x, **kw))), argnums=(0, 1))(
        jp, jnp.asarray(x))
    tp = type(tp)(*(t.detach().requires_grad_(True) for t in tp))
    tx = torch.from_numpy(x).requires_grad_(True)
    tl = torch.sin(tfn(tp, tx, **kw)).sum()
    grads = torch.autograd.grad(tl, [tx, *tp])
    assert abs(tl.item() - float(jl)) <= TOL * abs(float(jl))
    assert _rel(_np(grads[0]), jgx) <= TOL
    for name, gt in zip(tp._fields, grads[1:]):
        assert _rel(_np(gt), getattr(jgp, name)) <= TOL, name


# -- (4) Mamba-2's masked decay -----------------------------------------------

def _mamba2_grads(dt_bias: float):
    cfg, jp, tp = _layer_params("zamba2-1.2b", seed=3)
    jp = jp._replace(dt_bias=jnp.full_like(jp.dt_bias, dt_bias))
    tp = tssm.Mamba2Params(**{k: (torch.full_like(v, dt_bias)
                                  if k == "dt_bias" else v.detach())
                              for k, v in tp._asdict().items()})
    g = np.random.default_rng(4)
    x = g.standard_normal((B, 16, cfg.d_model)).astype(np.float32)
    kw = dict(_kw(cfg), chunk=cfg.ssm_chunk)
    jl, jg = jax.value_and_grad(
        lambda x: jnp.sum(jnp.sin(jssm.mamba2(jp, x, **kw))))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tl = torch.sin(tssm.mamba2(tp, tx, **kw)).sum()
    (tg,) = torch.autograd.grad(tl, [tx])
    # the largest masked exponent, cum_t - cum_s for t < s, in any chunk
    dt = np.log1p(np.exp(dt_bias))
    A = np.exp(np.asarray(jp.A_log)).max()
    return float(jl), tl.item(), np.asarray(jg), _np(tg), \
        dt * A * (cfg.ssm_chunk - 1)


def test_masked_decay_gradient_matches_reference_where_finite():
    jl, tl, jg, tg, top = _mamba2_grads(-4.6)
    assert top < 88.7                       # no masked exp overflows
    assert np.isfinite(jg).all()
    assert abs(tl - jl) <= TOL * abs(jl)
    assert _rel(tg, jg) <= TOL


def test_masked_decay_stays_finite_where_the_reference_is_nan():
    jl, tl, jg, tg, top = _mamba2_grads(5.0)
    assert top > 88.7                       # a masked exp overflows f32
    assert np.isnan(jg).any()               # the reference: 0 * inf
    assert np.isfinite(tg).all()
    assert math.isfinite(tl) and abs(tl - jl) <= TOL * abs(jl)
    # the forward values of the decay are the reference's, entry for entry
    cum = torch.cumsum(torch.from_numpy(np.random.default_rng(5).uniform(
        -30.0, 0.0, (B, 8, 4)).astype(np.float32)), dim=1)
    mask = torch.ones(8, 8, dtype=torch.bool).tril()
    want = torch.where(mask[None, :, :, None],
                       torch.exp(cum[:, :, None] - cum[:, None]), 0.0)
    assert torch.equal(tssm.masked_decay(cum, mask), want)


# -- (5) the falcon-mamba LM --------------------------------------------------

ARCH = "falcon-mamba-7b"


def _model(arch: str = ARCH, **overrides):
    jcfg = jax_config(arch).reduced(**overrides)
    cfg = get_config(arch).reduced(**overrides)
    jparams = jax.device_get(japi.get_api(jcfg).init(jax.random.key(0),
                                                     jcfg))
    params = params_from_jax(jparams, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S + 1))
    return jcfg, cfg, jparams, params, toks


def test_full_leaves_and_count_match_reference():
    jcfg, cfg = jax_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(cfg) == {
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cfg)}
    shapes = jax.eval_shape(lambda k: jml.mamba_lm_init(k, jcfg),
                            jax.random.key(0))
    want = [(n, tuple(s.shape), str(s.dtype)) for n, s in _jax_leaves(shapes)]
    params = get_api(cfg).init(0, cfg, "meta")
    got = [(n, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for n, t in param_leaves(params)]
    assert got == want
    for name in ("A_log", "D", "dt_bias"):
        assert dict((n, d) for n, _, d in got)[
            f"blocks.mamba.{name}"] == "float32"
    assert sum(int(np.prod(s)) for _, s, _ in got) == 7_272_665_088
    assert count_params_split(cfg) == japi.count_params_split(jcfg, shapes)
    assert count_params_split(cfg) == (7_272_665_088, 0)


def test_reduced_config_matches_reference():
    for arch in (ARCH, "zamba2-1.2b", "llama3-8b", "granite-moe-1b-a400m"):
        jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
        assert dataclasses.asdict(cfg) == {
            f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cfg)}


def test_params_from_jax_keeps_each_leaf_dtype():
    jcfg = jax_config(ARCH).reduced(dtype="bfloat16")
    jparams = jax.device_get(jml.mamba_lm_init(jax.random.key(2), jcfg))
    params = params_from_jax(jparams, device="cpu")
    for (name, t), (_, want) in zip(param_leaves(params),
                                    _jax_leaves(jparams)):
        assert str(t.dtype).replace("torch.", "") == str(want.dtype), name
        assert np.array_equal(_np(t), np.asarray(want, np.float32)), name
    m = params["blocks"]["mamba"]
    assert all(m[k].dtype == torch.float32 for k in ("A_log", "D",
                                                     "dt_bias"))
    assert m["in_proj"].dtype == torch.bfloat16


def test_loss_and_gradients_match_reference():
    jcfg, cfg, jparams, params, toks = _model()
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jml.mamba_lm_loss(p, jcfg, jb)))(jparams)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    leaves = [t for _, t in param_leaves(params)]
    loss = tml.mamba_lm_loss(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(jl)) <= TOL * abs(float(jl))
    for (name, _), g, (_, want) in zip(param_leaves(params), grads,
                                       _jax_leaves(jg)):
        assert _rel(_np(g), want) <= TOL, name
    # remat changes nothing but memory
    loss2 = tml.mamba_lm_loss(params, cfg, batch, remat=False)
    assert loss2.item() == loss.item()


def _decode_both(jcfg, cfg, jparams, params, toks, steps):
    """Yields ``(t, port logits, reference logits, port cache, reference
    cache)`` after each of ``steps`` decode steps from empty states."""
    japi_ = japi.get_api(jcfg)
    api = get_api(cfg)
    jcache = japi_.init_cache(jcfg, B, S)
    cache = api.init_cache(cfg, B, S, device="cpu")
    jstep = jax.jit(lambda p, t, c, pos: japi_.decode_step(p, jcfg, t, c,
                                                           pos))
    for t in range(steps):
        jl, jcache = jstep(jparams, jnp.asarray(toks[:, t:t + 1]), jcache,
                           jnp.int32(t))
        tl, cache2 = api.decode_step(params, cfg,
                                     torch.from_numpy(toks[:, t:t + 1]),
                                     cache, t)
        assert cache2 is cache                  # written in place
        yield t, tl, jl, cache, jcache


def test_decode_matches_reference_and_forward():
    jcfg, cfg, jparams, params, toks = _model()
    with torch.inference_mode():
        h = tml.mamba_lm_hidden(params, cfg, torch.from_numpy(toks[:, :S]),
                                remat=False)
        ref = _np(h @ params["lm_head"].T)
    cache = get_api(cfg).init_cache(cfg, B, S, device="cpu")
    assert cache["conv"].dtype == torch.float32 and \
        tuple(cache["ssm"].shape) == (cfg.n_layers, B, cfg.d_inner,
                                      cfg.ssm_state)
    for t, tl, jl, cache, jcache in _decode_both(jcfg, cfg, jparams, params,
                                                 toks, S):
        assert _rel(_np(tl), jl) <= TOL, t
        np.testing.assert_allclose(_np(tl)[:, 0], ref[:, t],
                                   rtol=TOL_FORWARD, atol=TOL_FORWARD)
        for k in ("conv", "ssm"):
            assert _rel(_np(cache[k]), jcache[k]) <= TOL, (t, k)


def test_decode_continues_a_reference_state():
    """``cache_from_jax`` carries the reference's decode state across
    mid-sequence; both continue alike."""
    jcfg, cfg, jparams, params, toks = _model()
    steps = list(_decode_both(jcfg, cfg, jparams, params, toks, 4))
    jcache = steps[-1][-1]
    cache = cache_from_jax(jax.device_get(jcache), device="cpu")
    jl, _ = japi.get_api(jcfg).decode_step(jparams, jcfg,
                                           jnp.asarray(toks[:, 4:5]), jcache,
                                           jnp.int32(4))
    tl, _ = get_api(cfg).decode_step(params, cfg,
                                     torch.from_numpy(toks[:, 4:5]), cache, 4)
    assert _rel(_np(tl), jl) <= TOL


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
    """tests/test_system.py's serving run: 3 requests on 2 slots; every
    step advances every row's state, as in the reference."""
    jcfg, cfg, jparams, params, _ = _model(n_layers=2)

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


def test_plan_decisions_match_reference():
    from repro.plan import plan_train_compression as jplan
    from repro_torch.plan import plan_train_compression
    jcfg, cfg = jax_config(ARCH), get_config(ARCH)
    shapes = jax.eval_shape(lambda k: jml.mamba_lm_init(k, jcfg),
                            jax.random.key(0))
    want = jplan(shapes, rank=8, P=8)
    got = plan_train_compression(get_api(cfg).init(0, cfg, "meta"), rank=8,
                                 P=8)
    assert [(d.name, d.shape, d.compress) for d in got.decisions] == [
        (d.name, tuple(d.shape), d.compress) for d in want.decisions]
    assert got.exchange_words == want.exchange_words


def test_launchers_take_falcon_mamba(capsys, tmp_path):
    from repro_torch.launch import serve, train
    server = serve.main(["--workload", "lm", "--device", "cpu", "--arch",
                         ARCH, "--requests", "3", "--slots", "2",
                         "--max-new", "4", "--max-len", "16"])
    assert server.cfg.family == "ssm"
    assert "tokens/s" in capsys.readouterr().out
    res = train.main(["--device", "cpu", "--arch", ARCH, "--steps", "12",
                      "--batch", "4", "--seq", "16", "--lr", "1e-2",
                      "--ckpt-every", "0", "--ckpt-dir", str(tmp_path)])
    assert len(res.losses) == 12
    assert "family=ssm" in capsys.readouterr().out
