"""The port's dense GEMM (K5's plain version) against the reference.

``repro_torch.kernels.local.gemm_block`` on CPU tensors against
``repro.kernels.local.gemm_block`` with ``backend="jnp"`` and with
``backend="pallas", interpret=True`` (the Pallas kernel in interpret
mode): alpha in {1, -1, 0.5}, with and without ``acc``, A given as a
transposed view (the exchange's P̂ᵀ), shapes ragged against the Pallas
tiles, and blocks that split K so the Pallas kernel sums over several
grid steps.

Tolerance: 1e-6 relative Frobenius against the jnp body (the same f32
product, ``* alpha``, ``acc +`` association) and 16·sqrt(K)·2**-24
against the Pallas kernel (its K loop sums in tile order, another order of
the same f32 terms).  The card's kernel is held to this plain version in
tests/test_torch_cuda.py and chip_smoke.py phase 9.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import local as jlocal
from repro_torch.kernels.local import _gemm_block_torch, gemm_block

SHAPES = [(17, 9, 5), (8, 300, 37), (130, 8, 70)]     # (M, K, N)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _case(M, K, N, seed=0):
    g = np.random.default_rng(seed)
    return (g.standard_normal((M, K)).astype(np.float32),
            g.standard_normal((K, N)).astype(np.float32),
            g.standard_normal((M, N)).astype(np.float32))


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("alpha", [1.0, -1.0, 0.5])
@pytest.mark.parametrize("use_acc", [False, True])
@pytest.mark.parametrize("transposed", [False, True])
def test_gemm_block_matches_reference(M, K, N, alpha, use_acc, transposed):
    A, B, acc = _case(M, K, N)
    jacc = jnp.asarray(acc) if use_acc else None
    want_jnp = jlocal.gemm_block(jnp.asarray(A), jnp.asarray(B), alpha=alpha,
                                 acc=jacc, backend="jnp")
    want_pl = jlocal.gemm_block(jnp.asarray(A), jnp.asarray(B), alpha=alpha,
                                acc=jacc, backend="pallas", interpret=True,
                                blocks=(8, 128, 128))
    tA = (torch.from_numpy(A.T.copy()).T if transposed
          else torch.from_numpy(A.copy()))
    tacc = torch.from_numpy(acc.copy()) if use_acc else None
    got = gemm_block(tA, torch.from_numpy(B.copy()), alpha=alpha, acc=tacc)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    if use_acc:
        assert got.data_ptr() == tacc.data_ptr()        # in place
    assert _rel(got.numpy(), want_jnp) <= 1e-6
    assert _rel(got.numpy(), want_pl) <= 16 * K ** 0.5 * 2.0 ** -24


def test_gemm_block_out_and_dtype():
    A, B, acc = _case(6, 4, 3, seed=1)
    want = jlocal.gemm_block(jnp.asarray(A), jnp.asarray(B), alpha=-1.0,
                             acc=jnp.asarray(acc), out_dtype=jnp.bfloat16,
                             backend="jnp")
    out = torch.empty(6, 3, dtype=torch.bfloat16)
    got = gemm_block(torch.from_numpy(A), torch.from_numpy(B), alpha=-1.0,
                     acc=torch.from_numpy(acc).to(torch.bfloat16),
                     out_dtype=torch.bfloat16, out=out)
    assert got is out
    ref = _gemm_block_torch(torch.from_numpy(A), torch.from_numpy(B), -1.0,
                            torch.from_numpy(acc).to(torch.bfloat16),
                            torch.bfloat16)
    assert torch.equal(got, ref)
    assert _rel(got.float().numpy(),
                np.asarray(want.astype(jnp.float32))) <= 2.0 ** -8
    with pytest.raises(ValueError):
        gemm_block(torch.from_numpy(A), torch.from_numpy(B),
                   acc=torch.zeros(5, 3))
