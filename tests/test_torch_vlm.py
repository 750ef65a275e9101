"""The port's VLM (the projector branch of ``models/transformer.py``, the
``vlm`` family of ``models/api.py`` and ``serve/engine.py``), the data
pipeline's frontends, ``count_params`` and every architecture's
``reduced()``, against the reference's.

The reference's params of reduced internvl2-26b (2 layers, d_model 64,
``frontend_dim`` 32, 8 frontend tokens, float32) are carried across with
``convert.params_from_jax`` and every input is drawn with numpy.  Bounds,
those of tests/test_torch_serve_lm.py: 1e-5 relative Frobenius against the
reference (hidden states, loss, every gradient leaf, prefill and decode
logits, caches), 2e-3 against the teacher-forced forward; the leaves of the
FULL model (on ``meta`` against ``jax.eval_shape``), the configs, the
plan's decisions and ``BatchedServer``'s tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig
from repro.data import pipeline as jpipe
from repro.models import api as japi
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.plan import plan_train_compression as jplan
from repro.serve import engine as jengine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data import DataConfig, data_config_for, make_batch
from repro_torch.models import (count_params, count_params_split, get_api,
                                lm_hidden, param_leaves)
from repro_torch.models import api as tapi
from repro_torch.models import transformer as ttf
from repro_torch.plan import plan_train_compression
from repro_torch.serve import engine as tengine

ARCH = "internvl2-26b"
B, S = 2, 16
TOL, TOL_FORWARD = 1e-5, 2e-3


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


_MODEL = {}


def _model():
    """(reference cfg, port cfg, reference params, port params, tokens
    (B, S + 1), frontend features (B, nf, frontend_dim) f32)."""
    if not _MODEL:
        jcfg, cfg = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
        jparams = jax.device_get(jtf.lm_init(jax.random.key(0), jcfg))
        params = params_from_jax(jparams, device="cpu")
        g = np.random.default_rng(1)
        toks = g.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
        feats = g.standard_normal((B, cfg.num_frontend_tokens,
                                   cfg.frontend_dim)).astype(np.float32)
        _MODEL["m"] = (jcfg, cfg, jparams, params, toks, feats)
    return _MODEL["m"]


# -- (1) configs, leaves, counts ----------------------------------------------

def test_full_leaves_and_count_match_reference():
    jcfg, cfg = jax_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(cfg) == {
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cfg)}
    shapes = jax.eval_shape(lambda k: jtf.lm_init(k, jcfg),
                            jax.random.key(0))
    want = [(n, tuple(s.shape), str(s.dtype)) for n, s in _jax_leaves(shapes)]
    params = get_api(cfg).init(0, cfg, "meta")
    got = [(n, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for n, t in param_leaves(params)]
    assert got == want
    assert dict((n, s) for n, s, _ in got)["projector.w"] == (3200, 6144)
    assert count_params(params) == jcommon.count_params(shapes) == \
        19_880_927_232
    assert count_params_split(cfg) == japi.count_params_split(jcfg, shapes)


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_reduced_config_matches_reference(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    for j, t in ((jcfg, cfg), (jcfg.reduced(), cfg.reduced())):
        assert dataclasses.asdict(t) == {
            f.name: getattr(j, f.name) for f in dataclasses.fields(t)}
    assert get_api(cfg.reduced()) is tapi._FAMILIES[cfg.family]


def test_count_params_matches_reference():
    for arch in ("whisper-tiny", "zamba2-1.2b", ARCH, "granite-moe-1b-a400m"):
        jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
        jparams = japi.get_api(jcfg).init(jax.random.key(0), jcfg)
        params = get_api(cfg).init(0, cfg, "meta")
        assert count_params(params) == jcommon.count_params(jparams), arch
        assert count_params(params) == count_params_split(cfg)[0], arch
    assert count_params([torch.zeros(2, 3), {"a": torch.zeros(4)}]) == 10


def test_get_api_takes_all_six_families():
    fams = {get_config(a).family for a in JAX_ARCH_IDS}
    assert fams == {"dense", "moe", "ssm", "hybrid", "encdec", "vlm"}
    for arch in JAX_ARCH_IDS:
        cfg = get_config(arch)
        assert get_api(cfg).init.__name__ == \
            japi.get_api(jax_config(arch)).init.__name__, arch
    with pytest.raises(KeyError, match="unknown family"):
        get_api(dataclasses.replace(get_config(ARCH), family="audio-lm"))


def test_plan_decisions_match_reference():
    jcfg, cfg = jax_config(ARCH), get_config(ARCH)
    shapes = jax.eval_shape(lambda k: jtf.lm_init(k, jcfg),
                            jax.random.key(0))
    want = jplan(shapes, rank=8, P=8)
    got = plan_train_compression(get_api(cfg).init(0, cfg, "meta"), rank=8,
                                 P=8)
    assert [(d.name, d.shape, d.compress) for d in got.decisions] == [
        (d.name, tuple(d.shape), d.compress) for d in want.decisions]
    assert got.exchange_words == want.exchange_words
    compressed = {d.name for d in got.decisions if d.compress}
    assert {"projector.w", "embed", "lm_head"} <= compressed


# -- (2) forward, loss and gradients ------------------------------------------

def test_lm_hidden_with_frontend_matches_reference():
    jcfg, cfg, jparams, params, toks, feats = _model()
    jh, _ = jtf.lm_hidden(jparams, jcfg, jnp.asarray(toks[:, :S]),
                          frontend_feats=jnp.asarray(feats), remat=False)
    with torch.no_grad():
        h, _ = lm_hidden(params, cfg, torch.from_numpy(toks[:, :S]).long(),
                         frontend_feats=torch.from_numpy(feats), remat=False)
        plain, _ = lm_hidden(params, cfg,
                             torch.from_numpy(toks[:, :S]).long(),
                             remat=False)
    nf = cfg.num_frontend_tokens
    assert tuple(h.shape) == (B, nf + S, cfg.d_model)
    assert _rel(_np(h), jh) <= TOL
    # the text tokens attend over the frontend's: their states differ
    assert _rel(_np(h[:, nf:]), _np(plain)) > 1e-2


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_gradients_with_frontend_match_reference(remat):
    jcfg, cfg, jparams, params, toks, feats = _model()
    labels = toks[:, 1:].copy()
    labels[1, -2:] = -100
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(labels),
          "frontend_feats": jnp.asarray(feats)}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: japi.get_api(jcfg).loss(p, jcfg, jb, remat=remat)))(
        jparams)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
             "labels": torch.from_numpy(labels).long(),
             "frontend_feats": torch.from_numpy(feats)}
    leaves = [t for _, t in param_leaves(params)]
    loss = get_api(cfg).loss(params, cfg, batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(jl)) <= TOL * abs(float(jl))
    for (name, _), g, (jname, want) in zip(param_leaves(params), grads,
                                           _jax_leaves(jg)):
        assert name == jname
        assert np.abs(want).max() > 0, name
        assert _rel(g.numpy(), want) <= TOL, name


# -- (3) serving --------------------------------------------------------------

def test_serve_prefill_matches_reference():
    jcfg, cfg, jparams, params, toks, feats = _model()
    jl, jcache = jengine.serve_prefill(
        jparams, jcfg, {"tokens": jnp.asarray(toks[:, :S]),
                        "frontend_feats": jnp.asarray(feats)})
    tl, cache = tengine.serve_prefill(
        params, cfg, {"tokens": torch.from_numpy(toks[:, :S]).long(),
                      "frontend_feats": torch.from_numpy(feats)})
    assert jcache is None and cache is None
    assert tuple(tl.shape) == (B, 1, cfg.vocab)
    assert _rel(_np(tl), jl) <= TOL
    # without features: the text alone, as the reference's
    jl, _ = jengine.serve_prefill(jparams, jcfg,
                                  {"tokens": jnp.asarray(toks[:, :S])})
    tl, _ = tengine.serve_prefill(
        params, cfg, {"tokens": torch.from_numpy(toks[:, :S]).long()})
    assert _rel(_np(tl), jl) <= TOL


def test_text_prefill_and_decode_match_reference():
    """The VLM's serving cache covers the text tokens: ``prefill`` of half
    the prompt, then teacher-forced decode steps, each against the
    reference's and against the text-only forward."""
    jcfg, cfg, jparams, params, toks, _ = _model()
    api, japi_ = get_api(cfg), japi.get_api(jcfg)
    half = S // 2
    h, _ = jtf.lm_hidden(jparams, jcfg, jnp.asarray(toks[:, :S]),
                         remat=False)
    ref = np.asarray(jnp.einsum("bsd,vd->bsv", h, jparams["lm_head"]))
    jl, jcache = japi_.prefill(jparams, jcfg, jnp.asarray(toks[:, :half]),
                               remat=False, max_len=S)
    tl, cache = api.prefill(params, cfg,
                            torch.from_numpy(toks[:, :half]).long(),
                            max_len=S)
    assert _rel(_np(tl), jl) <= TOL
    step = jax.jit(lambda p, t, c, pos: japi_.decode_step(p, jcfg, t, c,
                                                          pos))
    for t in range(half, S):
        jl, jcache = step(jparams, jnp.asarray(toks[:, t:t + 1]), jcache,
                          jnp.int32(t))
        tl, cache = api.decode_step(
            params, cfg, torch.from_numpy(toks[:, t:t + 1]).long(), cache, t)
        assert _rel(_np(tl), jl) <= TOL, t
        np.testing.assert_allclose(_np(tl)[:, 0], ref[:, t],
                                   rtol=TOL_FORWARD, atol=TOL_FORWARD)
    for l, (c, jc) in enumerate(zip(cache, jcache)):
        for kv in ("k", "v"):
            assert _rel(_np(c[kv]), jc[kv]) <= TOL, (l, kv)


def test_batched_server_matches_reference():
    jcfg, cfg, jparams, params, _, _ = _model()
    prompts = [[1 + i, 2, 3] for i in range(3)]

    def serve(engine, p, c):
        server = engine.BatchedServer(p, c, slots=2, max_len=16, eos=-1)
        reqs = [engine.Request(rid=i, prompt=list(pr), max_new=4)
                for i, pr in enumerate(prompts)]
        for r in reqs:
            server.submit(r)
        server.run()
        return reqs

    got = serve(tengine, params, cfg)
    want = serve(jengine, jparams, jcfg)
    assert [r.out for r in got] == [r.out for r in want]
    assert all(r.done and len(r.out) == 4 for r in got)


# -- (4) the data pipeline's frontends ----------------------------------------

@pytest.mark.parametrize("arch", ["whisper-tiny", ARCH, "llama3-8b"])
def test_data_config_for_matches_reference(arch):
    shape = ShapeConfig("train_small", 64, 4, "train")
    for cfg_of in (jax_config, lambda a: jax_config(a).reduced()):
        jcfg = cfg_of(arch)
        cfg = get_config(arch) if cfg_of is jax_config \
            else get_config(arch).reduced()
        want = dataclasses.asdict(jpipe.data_config_for(jcfg, shape, seed=3))
        assert dataclasses.asdict(data_config_for(cfg, shape, seed=3)) == \
            want
    if arch == ARCH:
        assert want["seq_len"] == 64 - 8 and want["frontend"] == "vision"


@pytest.mark.parametrize("arch,key,shape", [
    ("whisper-tiny", "frames", (4, 16, 64)),
    (ARCH, "frontend_feats", (4, 8, 32))])
def test_make_batch_adds_the_frontend(arch, key, shape):
    cfg = get_config(arch).reduced()
    dc = data_config_for(cfg, ShapeConfig("s", 24, 4, "train"), seed=5)
    b = make_batch(dc, 7)
    text = 24 - (cfg.num_frontend_tokens if cfg.family == "vlm" else 0)
    assert sorted(b) == sorted(["tokens", "labels", key])
    assert tuple(b[key].shape) == shape and b[key].dtype == torch.float32
    assert tuple(b["tokens"].shape) == (4, text)
    assert b["tokens"].dtype == b["labels"].dtype == torch.int64
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert abs(float(b[key].std()) - 1.0) < 0.1
    # a pure function of (seed, step): again the same, another step not
    again, other = make_batch(dc, 7), make_batch(dc, 8)
    assert all(torch.equal(b[k], again[k]) for k in b)
    assert not torch.equal(b[key], other[key])
    assert not torch.equal(b[key], make_batch(
        dataclasses.replace(dc, seed=6), 7)[key])
    # the features are drawn after the tokens: the tokens are those of a
    # batch without a frontend
    plain = make_batch(DataConfig(dc.vocab, dc.seq_len, dc.global_batch,
                                  seed=5), 7)
    assert torch.equal(plain["tokens"], b["tokens"])
    assert sorted(plain) == ["labels", "tokens"]


# -- (5) the launchers --------------------------------------------------------

def test_launchers_take_internvl2(capsys, tmp_path):
    from repro_torch.launch import serve, train
    server = serve.main(["--workload", "lm", "--device", "cpu", "--arch",
                         ARCH, "--requests", "3", "--slots", "2",
                         "--max-new", "4", "--max-len", "16"])
    assert server.cfg.family == "vlm"
    assert "tokens/s" in capsys.readouterr().out
    res = train.main(["--device", "cpu", "--arch", ARCH, "--steps", "12",
                      "--batch", "4", "--seq", "16", "--lr", "1e-2",
                      "--ckpt-every", "0", "--ckpt-dir", str(tmp_path),
                      "--grad-compress", "2"])
    assert len(res.losses) == 12
    assert "family=vlm" in capsys.readouterr().out


def test_vlm_transformer_refuses_other_families():
    cfg = get_config("whisper-tiny").reduced()
    with pytest.raises(ValueError, match="elsewhere"):
        ttf.lm_init(0, cfg, "meta")
