"""The port's dense LM (repro_torch.models) against the reference.

The same params (carried with ``convert.params_from_jax``) and the same
numpy batch go through ``repro.models.transformer.lm_loss`` under
``jax.value_and_grad`` and through the port's ``lm_loss`` with autograd,
for reduced gemma2-2b (local/global windows, softcaps, post-norms, tied
embeddings, GeGLU) and reduced llama3-8b (SwiGLU, untied head).

Tolerance: the loss to 1e-5 relative, every gradient leaf to 1e-5
relative Frobenius.  Both sides compute in float32 with sums taken in
other orders (XLA's fused CPU loops vs torch's), through two layers and a
chunked softmax cross entropy; a sign, scale or mask error moves these by
orders of magnitude more.  The attention core is also held on its own
with several KV chunks, a window and a softcap, in float32 (1e-5) and in
bfloat16 (its scores are stored in bf16 on both sides; 2e-2 relative,
about four bf16 ulps).

The leaf order and shapes of the FULL gemma2-2b are compared without
allocating: the port builds its params on the ``meta`` device, the
reference through ``jax.eval_shape``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import lm_init, lm_loss, param_leaves

B, S = 2, 24


def _batch(vocab: int, seed: int = 3):
    g = np.random.default_rng(seed)
    toks = g.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, -3:] = -100                         # pad labels are skipped
    return toks[:, :-1], labels


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(".".join(str(getattr(k, "key", k)) for k in path), leaf)
            for path, leaf in flat]


@pytest.fixture(scope="module", params=["gemma2-2b", "llama3-8b"])
def reference(request):
    """(arch, JAX params as numpy, batch, JAX loss, JAX grads by name)."""
    arch = request.param
    cfg = jax_config(arch).reduced()
    params = jtf.lm_init(jax.random.key(1), cfg)
    toks, labels = _batch(cfg.vocab)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, cfg, batch)))(params)
    return (arch, jax.device_get(params), (toks, labels), float(loss),
            {n: np.asarray(g) for n, g in _jax_leaves(grads)})


def test_lm_loss_and_grads_match_reference(reference):
    arch, jparams, (toks, labels), jloss, jgrads = reference
    cfg = get_config(arch).reduced()
    params = params_from_jax(jparams, device="cpu")
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    loss = lm_loss(params, cfg, batch)
    leaves = param_leaves(params)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    assert abs(float(loss.detach()) - jloss) <= 1e-5 * abs(jloss)
    assert [n for n, _ in leaves] == list(jgrads)
    for (name, _), g in zip(leaves, grads):
        err = _rel(g.numpy(), jgrads[name])
        assert err <= 1e-5, (arch, name, err)


def test_lm_loss_without_remat_is_the_same_function(reference):
    arch, jparams, (toks, labels), jloss, _ = reference
    cfg = get_config(arch).reduced()
    params = params_from_jax(jparams, device="cpu")
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    with torch.no_grad():
        a = lm_loss(params, cfg, batch, remat=False)
    b = lm_loss(params, cfg, batch, remat=True)
    assert float(a) == float(b.detach())


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_chunked_attention_matches_reference(dtype, tol):
    g = np.random.default_rng(0)
    Bq, Sq, Hk, G, D = 2, 20, 2, 2, 8
    q = g.standard_normal((Bq, Sq, Hk, G, D)).astype(np.float32)
    k = g.standard_normal((Bq, Sq, Hk, D)).astype(np.float32)
    v = g.standard_normal((Bq, Sq, Hk, D)).astype(np.float32)
    pos = np.arange(Sq, dtype=np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    kw = dict(causal=True, window=6, attn_softcap=5.0, kv_chunk=8)
    want = jattn.chunked_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(pos), jnp.asarray(pos), **kw)
    got = tattn.chunked_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), torch.from_numpy(pos).long(),
        torch.from_numpy(pos).long(), **kw)
    assert got.dtype == tdt
    assert _rel(got.float().numpy(),
                np.asarray(want.astype(jnp.float32))) <= tol


def test_param_leaves_order_and_shapes_match_reference_full_gemma():
    jcfg = jax_config("gemma2-2b")
    shapes = jax.eval_shape(lambda k: jtf.lm_init(k, jcfg),
                            jax.random.key(0))
    want = [(n, tuple(s.shape), str(s.dtype)) for n, s in _jax_leaves(shapes)]
    params = lm_init(0, get_config("gemma2-2b"), device="meta")
    got = [(n, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for n, t in param_leaves(params)]
    assert got == want
    assert [n for n, _, _ in got][:3] == ["blocks.attn.wk",
                                          "blocks.attn.wo", "blocks.attn.wq"]
    assert sum(int(np.prod(s)) for _, s, _ in got) == 2_614_341_888


def test_other_families_name_their_roadmap_item():
    for arch in ("whisper-tiny", "internvl2-26b"):
        with pytest.raises(NotImplementedError, match="item 11"):
            get_config(arch)
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    # the MoE family is ported (tests/test_torch_moe.py)
    assert get_config("dbrx-132b").family == "moe"
    assert get_config("granite-moe-1b-a400m").n_experts == 32
    # so are the SSM and hybrid families (tests/test_torch_ssm.py,
    # tests/test_torch_hybrid.py)
    assert get_config("falcon-mamba-7b").family == "ssm"
    assert get_config("zamba2-1.2b").family == "hybrid"

