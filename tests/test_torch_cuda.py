"""The CUDA kernels of repro_torch against their plain torch versions.

These run only where there is a CUDA card and ``nvcc`` (they skip
elsewhere); the module imports no jax so that it runs on a machine with
the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: Omega draws are bitwise.  GEMM results are held to
``rtol=1e-5`` and ``atol=1e-5·max|ref|`` in float32 (the kernel and
``torch.matmul`` sum in different orders); bfloat16 outputs to one
bfloat16 ulp (both round the same f32 value, which may sit on either side
of a rounding boundary).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.sketch import _omega_tile_torch, omega_tile
from repro_torch.kernels import (LAUNCHES, reset_launches, sketch_block,
                                 sketch_t_block)
from repro_torch.kernels.local import (_sketch_block_torch,
                                       _sketch_t_block_torch)
from repro_torch.stream import StreamConfig, StreamingSketch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref):
    got = got.float().cpu().numpy()
    ref = ref.float().cpu().numpy()
    atol = 1e-5 * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol)


def _within_bf16_ulp(got, ref):
    got = got.float().cpu().numpy()
    ref = ref.float().cpu().numpy()
    mag = np.maximum(np.abs(got), np.abs(ref))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got - ref) <= ulp)


@pytest.mark.parametrize("kind", ["normal", "uniform", "rademacher"])
@pytest.mark.parametrize("row0,col0", [(0, 0), (2 ** 32 - 7, 5)])
def test_gen_omega_bitwise(dev, kind, row0, col0):
    got = omega_tile(2 ** 40 + 3, row0, col0, 37, 19, kind, salt=2,
                     device=dev)
    ref = _omega_tile_torch(3, 2 ** 8, row0, col0, 37, 19, kind, 2, None,
                            None, dev)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("kind", ["normal", "rademacher"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_acc", [False, True])
def test_sketch_kernels_match_plain(dev, kind, dt, use_acc):
    g = torch.Generator(device=dev).manual_seed(1)
    m, k, cols = 133, 70, 45                 # ragged against every tile
    A = torch.randn(m, k, generator=g, device=dev).to(dt)
    kw = dict(row0=11, col0=3, kind=kind, salt=1, scale=0.5)
    for kernel, plain, X, shape in (
            (sketch_block, _sketch_block_torch, A, (m, cols)),
            (sketch_t_block, _sketch_t_block_torch, A, (cols, k))):
        acc = (torch.randn(*shape, generator=g, device=dev).to(dt)
               if use_acc else None)
        ref = plain(X, 77, cols, acc=acc, **kw)
        got = kernel(X, 77, cols, acc=None if acc is None else acc.clone(),
                     **kw)
        (_close if dt == torch.float32 else _within_bf16_ulp)(got, ref)


def test_stream_launches_kernels_and_rows_are_bitwise(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    A = torch.randn(96, 80, generator=g, device=dev)
    cfg = StreamConfig(96, 80, r=24, seed=9)
    reset_launches()
    st = StreamingSketch(cfg)
    for r0 in range(0, 96, 40):
        st.update_rows(r0, A[r0:r0 + 40])
    assert LAUNCHES["sketch_fwd"] == 3 and LAUNCHES["sketch_t"] == 3
    one_shot = sketch_block(A, 9, 24)
    assert torch.equal(st.Y, one_shot)
    _close(st.W, _sketch_t_block_torch(A, 9, cfg.sketch_l, salt=1))
