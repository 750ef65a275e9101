"""The port's LM serving path (dense family) against the reference:
``attention_decode``, ``init_cache`` / ``cache_specs``, ``decode_step``,
``prefill``, the engine's ``BatchedServer`` and ``serve_prefill``, and
the launcher's ``--workload lm``.

The reference's params (``lm_init`` at key 0) are carried across with
``convert.params_from_jax``; tokens are drawn with numpy (seed 1) at the
reference's own test sizes, B = 2 and S = 16, on reduced configs in
float32.  Tolerances, each a relative Frobenius norm:

  * 1e-5 for ``attention_decode`` (y and both caches) and for each decode
    step's logits and every cache against the reference's own decode,
    prefill and prefill-then-decode: both sides compute in float32 with
    sums taken in other orders (about 1e-7 here); a wrong slot, mask,
    rope position or ring roll moves them by O(1);
  * 2e-3 against the reference's teacher-forced forward pass (the
    reference's own bound in ``tests/test_models.py``: the forward stores
    nothing in bf16 at f32, but sums its chunked softmax in another order);
  * exact for shapes, dtypes, the ring's slot of each position, and the
    greedy tokens of ``BatchedServer`` (its argmax over logits that agree
    to 1e-5).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.models.common import softcap as jsoftcap
from repro.serve import engine as jengine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.obs import trace as ttrace
from repro_torch.serve import engine as tengine

B, S = 2, 16
TOL, TOL_FORWARD = 1e-5, 2e-3


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


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


_JSTEPS = {}


def _jstep(jcfg):
    if jcfg not in _JSTEPS:
        _JSTEPS[jcfg] = jax.jit(
            lambda p, t, c, pos: jtf.decode_step(p, jcfg, t, c, pos))
    return _JSTEPS[jcfg]


def _forward_logits(jparams, jcfg, toks):
    """The reference's teacher-forced logits (B, S, V)."""
    h, _ = jtf.lm_hidden(jparams, jcfg, jnp.asarray(toks), remat=False)
    W = jparams["embed"] if jcfg.tie_embeddings else jparams["lm_head"]
    return np.asarray(jsoftcap(jnp.einsum("bsd,vd->bsv", h, W),
                               jcfg.final_softcap))


def _check_caches(got, want, tol=TOL):
    assert len(got) == len(want)
    for l, (g, w) in enumerate(zip(got, want)):
        for kv in ("k", "v"):
            assert tuple(g[kv].shape) == tuple(w[kv].shape), (l, kv)
            err = _rel(_np(g[kv]), np.asarray(w[kv]))
            assert err <= tol, (l, kv, err)


def _decode_both(jcfg, cfg, jparams, params, toks, t0, t1, jcache, cache):
    """Decode positions t0..t1-1 teacher-forced on both sides; yields
    (t, port logits, reference logits) and leaves the caches advanced."""
    step = _jstep(jcfg)
    for t in range(t0, t1):
        jl, jcache = step(jparams, jnp.asarray(toks[:, t:t + 1]), jcache,
                          jnp.int32(t))
        tl, cache = ttf.decode_step(params, cfg,
                                    torch.from_numpy(toks[:, t:t + 1]).long(),
                                    cache, t)
        yield t, tl, np.asarray(jl), jcache, cache


# -- attention_decode ---------------------------------------------------------

@pytest.mark.parametrize("window,T,positions", [
    (None, 12, (0, 5, 11)),            # a full cache: slot == position
    (6, 6, (3, 6, 13)),                # a ring: slot == position mod 6
])
def test_attention_decode_matches_reference(window, T, positions):
    g = np.random.default_rng(0)
    d, Hq, Hk, D = 32, 4, 2, 8
    w = {n: (g.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("wq", (d, Hq * D)), ("wk", (d, Hk * D)),
                      ("wv", (d, Hk * D)), ("wo", (Hq * D, d)))}
    kw = dict(n_heads=Hq, n_kv_heads=Hk, head_dim=D, window=window,
              attn_softcap=5.0, rope_theta=1e4)
    jk = jnp.asarray(g.standard_normal((B, T, Hk, D)).astype(np.float32))
    jv = jnp.asarray(g.standard_normal((B, T, Hk, D)).astype(np.float32))
    tk, tv = torch.from_numpy(np.array(jk)), torch.from_numpy(np.array(jv))
    jp = jattn.AttnParams(**{n: jnp.asarray(a) for n, a in w.items()})
    tp = tattn.AttnParams(**{n: torch.from_numpy(a) for n, a in w.items()})
    for pos in positions:
        x = g.standard_normal((B, 1, d)).astype(np.float32)
        jy, jk, jv = jattn.attention_decode(jp, jnp.asarray(x), jk, jv,
                                            jnp.int32(pos), **kw)
        ty, tk2, tv2 = tattn.attention_decode(tp, torch.from_numpy(x), tk,
                                              tv, pos, **kw)
        assert tk2 is tk and tv2 is tv           # written in place
        assert _rel(_np(ty), np.asarray(jy)) <= TOL, pos
        assert _rel(_np(tk), np.asarray(jk)) <= TOL, pos
        assert _rel(_np(tv), np.asarray(jv)) <= TOL, pos


# -- init_cache / cache_specs ---------------------------------------------------

@pytest.mark.parametrize("arch,reduced,batch,max_len", [
    ("gemma2-2b", False, 4, 1280), ("gemma2-2b", False, 1, 8192),
    ("h2o-danube-3-4b", False, 2, 512), ("llama3-8b", True, 2, 16),
    ("gemma2-2b", True, 3, 5)])
def test_init_cache_and_cache_specs_match_reference(arch, reduced, batch,
                                                    max_len):
    jcfg, cfg = jax_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want = [{kv: (tuple(c[kv].shape), str(c[kv].dtype)) for kv in c}
            for c in jtf.cache_specs(jcfg, batch, max_len)]
    specs = ttf.cache_specs(cfg, batch, max_len)
    got = [{kv: (tuple(c[kv].shape), str(c[kv].dtype).replace("torch.", ""))
            for kv in c} for c in specs]
    assert got == want
    assert all(c[kv].device.type == "meta" for c in specs for kv in c)
    if reduced:
        caches = ttf.init_cache(cfg, batch, max_len, device="cpu")
        assert [{kv: (tuple(c[kv].shape),
                      str(c[kv].dtype).replace("torch.", "")) for kv in c}
                for c in caches] == want
        assert all(not c[kv].any() for c in caches for kv in c)


def test_model_api_fields_follow_the_reference():
    assert [f.name for f in dataclasses.fields(tapi.ModelAPI)] == [
        f.name for f in dataclasses.fields(japi.ModelAPI)]
    api = tapi.get_api(get_config("gemma2-2b"))
    assert (api.init_cache, api.decode_step, api.prefill) == (
        ttf.init_cache, ttf.decode_step, ttf.prefill)


# -- decode_step ----------------------------------------------------------------

@pytest.mark.parametrize("arch,overrides", [
    ("llama3-8b", {}), ("gemma2-2b", {}),
    ("h2o-danube-3-4b", {"window": 6})])    # the ring path
def test_decode_step_matches_reference(arch, overrides):
    jcfg, cfg, jparams, params, toks = _model(arch, **overrides)
    ref = _forward_logits(jparams, jcfg, toks)
    jcache = jtf.init_cache(jcfg, B, S)
    cache = ttf.init_cache(cfg, B, S, device="cpu")
    if overrides.get("window"):
        assert cache[0]["k"].shape[1] == 6          # ring length = window
    for t, tl, jl, jcache, cache in _decode_both(
            jcfg, cfg, jparams, params, toks, 0, S, jcache, cache):
        assert tuple(tl.shape) == (B, 1, cfg.vocab)
        assert _rel(_np(tl), jl) <= TOL, t
        assert _rel(_np(tl)[:, 0], ref[:, t]) <= TOL_FORWARD, t
    _check_caches(cache, jcache)


def test_decode_clamps_past_max_len():
    """A full cache written past its end: the reference's
    ``dynamic_update_slice`` clamps the slot to T - 1 (BatchedServer's
    prompt replay can get there); the port mirrors it and does not
    raise."""
    jcfg, cfg, jparams, params, toks = _model("llama3-8b")
    T = 6
    jcache = jtf.init_cache(jcfg, B, T)
    cache = ttf.init_cache(cfg, B, T, device="cpu")
    for t, tl, jl, jcache, cache in _decode_both(
            jcfg, cfg, jparams, params, toks, 0, T + 4, jcache, cache):
        assert _rel(_np(tl), jl) <= TOL, t
    _check_caches(cache, jcache)


# -- prefill ----------------------------------------------------------------------

@pytest.mark.parametrize("arch,overrides,max_len", [
    ("llama3-8b", {}, 20),                        # full: padded to max_len
    ("gemma2-2b", {}, 20),                        # ring of 8 and full of 20
    ("h2o-danube-3-4b", {"window": 6}, 16)])      # every layer a ring of 6
def test_prefill_matches_reference(arch, overrides, max_len):
    jcfg, cfg, jparams, params, toks = _model(arch, **overrides)
    jl, jcache = jtf.prefill(jparams, jcfg, jnp.asarray(toks), remat=False,
                             max_len=max_len)
    tl, cache = ttf.prefill(params, cfg, torch.from_numpy(toks).long(),
                            max_len=max_len)
    assert tuple(tl.shape) == (B, 1, cfg.vocab)
    assert _rel(_np(tl), np.asarray(jl)) <= TOL
    _check_caches(cache, jcache)
    # the layout, exact: layer 0's rotated K of position p sits at slot p
    # (full) or p mod L (ring), and a full cache's tail is zero
    layers = ttf.unbind_layers(params["blocks"])
    with torch.inference_mode():
        h0 = ttf._embed_tokens(params, cfg, torch.from_numpy(toks).long())
        _, k0, _ = ttf._block_apply(cfg, ttf.layer_slice(layers, 0), h0,
                                    cfg.layer_windows(S)[0],
                                    torch.arange(S), 1024, return_kv=True)
    L = cache[0]["k"].shape[1]
    assert L == min(cfg.layer_windows(S)[0], max_len)
    for p in range(max(0, S - L), S):
        assert torch.equal(cache[0]["k"][:, p % L], k0[:, p]), p
    if L > S:
        assert not cache[0]["k"][:, S:].any()


@pytest.mark.parametrize("arch,overrides,half", [
    ("llama3-8b", {}, S // 2),
    ("h2o-danube-3-4b", {"window": 6}, 9)])     # ring hand-off, 9 % 6 != 0
def test_prefill_then_decode_matches_reference(arch, overrides, half):
    jcfg, cfg, jparams, params, toks = _model(arch, **overrides)
    ref = _forward_logits(jparams, jcfg, toks)
    jl, jcache = jtf.prefill(jparams, jcfg, jnp.asarray(toks[:, :half]),
                             remat=False, max_len=S)
    tl, cache = tengine.serve_prefill(
        params, cfg, {"tokens": torch.from_numpy(toks[:, :half]).long()},
        max_len=S)
    assert _rel(_np(tl), np.asarray(jl)) <= TOL
    assert _rel(_np(tl)[:, 0], ref[:, half - 1]) <= TOL_FORWARD
    for t, tl, jl, jcache, cache in _decode_both(
            jcfg, cfg, jparams, params, toks, half, S, jcache, cache):
        assert _rel(_np(tl), jl) <= TOL, t
        assert _rel(_np(tl)[:, 0], ref[:, t]) <= TOL_FORWARD, t
    _check_caches(cache, jcache)


def test_serve_prefill_names_item_11_for_other_families():
    _, cfg, _, params, toks = _model("llama3-8b")
    batch = {"tokens": torch.from_numpy(toks).long()}
    for other in (dataclasses.replace(cfg, family="encdec"),
                  dataclasses.replace(cfg, family="vlm")):
        with pytest.raises(NotImplementedError, match="item 11"):
            tengine.serve_prefill(params, other, batch)


# -- BatchedServer ------------------------------------------------------------------

@pytest.mark.parametrize("arch,overrides,slots,max_len,prompts,max_new", [
    # tests/test_substrate.py: continuous batching (5 requests > 2 slots)
    ("llama3-8b", dict(n_layers=2, d_model=32, d_ff=64, vocab=64,
                       head_dim=8), 2, 32,
     [[1 + i, 2, 3] for i in range(5)], 4),
    # tests/test_substrate.py: greedy decode, one slot
    ("gemma2-2b", dict(n_layers=2), 1, 16, [[3, 1, 4]], 5)])
def test_batched_server_matches_reference(arch, overrides, slots, max_len,
                                          prompts, max_new):
    jcfg = jax_config(arch).reduced(**overrides)
    cfg = get_config(arch).reduced(**overrides)
    jparams = japi.get_api(jcfg).init(jax.random.key(0), jcfg)
    params = params_from_jax(jax.device_get(jparams), device="cpu")

    def serve(engine, p, c):
        server = engine.BatchedServer(p, c, slots=slots, max_len=max_len,
                                      eos=-1)
        reqs = [engine.Request(rid=i, prompt=list(pr), max_new=max_new)
                for i, pr in enumerate(prompts)]
        for r in reqs:
            server.submit(r)
        server.run()
        return reqs

    tracer = ttrace.install_tracer()
    try:
        got = serve(tengine, params, cfg)
    finally:
        ttrace.uninstall_tracer()
    want = serve(jengine, jparams, jcfg)
    assert [r.out for r in got] == [r.out for r in want]
    assert all(r.done and len(r.out) == max_new for r in got)
    names = [sp.name for sp in tracer.spans]
    assert names.count("serve.prefill") == len(prompts)
    assert "serve.step" in names


# -- the launcher ---------------------------------------------------------------

def test_serve_launcher_lm_workload_on_the_cpu():
    from repro_torch.launch import serve
    assert serve.build_parser().parse_args([]).workload == "sketch"
    args = serve.build_parser().parse_args(["--workload", "lm"])
    assert (args.arch, args.requests, args.slots, args.max_new,
            args.max_len, args.full) == ("llama3-8b", 6, 4, 16, 128, False)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--workload",
         "lm", "--device", "cpu", "--arch", "gemma2-2b", "--requests", "3",
         "--slots", "2", "--max-new", "4"],
        capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[serve] 3 requests on 2 slots" in out.stdout
    assert "12 tokens" in out.stdout


# -- the roofline's counts of a decode step -------------------------------------

def test_decode_step_counts_the_same_work_inside_inference_mode():
    """``decode_step`` runs under ``torch.inference_mode``, where composite
    ops (matmul, einsum) reach ``counting()``'s dispatch mode whole: they
    are counted as what they decompose into, so a step counts the FLOPs
    and bytes of the same step run with autograd's dispatch (exactly)."""
    from repro_torch.roofline.counts import counting
    _, cfg, _, params, toks = _model("gemma2-2b")
    tok = torch.from_numpy(toks[:, :1]).long()
    caches = [ttf.init_cache(cfg, B, S, device="cpu") for _ in range(2)]
    with counting() as inside:
        ttf.decode_step(params, cfg, tok, caches[0], 3)
    with torch.no_grad(), counting() as outside:
        ttf.decode_step.__wrapped__(params, cfg, tok, caches[1], 3)
    assert inside.flops > 0
    assert (inside.flops, inside.flops_by_dtype, inside.hbm_bytes) == (
        outside.flops, outside.flops_by_dtype, outside.hbm_bytes)
