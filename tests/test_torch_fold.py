"""repro_torch's row-slab fold (K4's plain version) against the reference.

``_fold_rows_torch`` and ``fold_rows_block(device CPU)`` against
``repro.kernels.local._fold_rows_jnp`` and against the reference's Pallas
kernel in interpret mode (``fold_rows_block(backend="pallas",
interpret=True)``), on one lane and on ``jax.vmap`` over lanes, masked and
unmasked, with resident -0.0 rows, NaN rows in d's dead tail and starts
outside ``[0, m + k]``, in float32 and bfloat16.

Tolerance: none.  The fold is one add per element and a select, so every
result is held bitwise (compared as raw bits, so -0.0 != +0.0).  The card
holds its kernel to the same plain version bitwise
(tests/test_torch_cuda.py, chip_smoke.py phase 6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro.kernels import local as jlocal
from repro_torch.kernels.local import _fold_rows_torch, fold_rows_block

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
M, K, C = 12, 5, 7


def _bits(x) -> np.ndarray:
    """Raw bits of a JAX array or torch tensor (f32 or bf16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.view(torch.int32).numpy()
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _case(seed: int, dt: str, lanes=None, nan_rows=0):
    """(y, d) in both packages: y has -0.0 in every other row, d's last
    ``nan_rows`` rows are NaN."""
    gen = np.random.default_rng(seed)
    shape_y = (M, C) if lanes is None else (lanes, M, C)
    shape_d = (K, C) if lanes is None else (lanes, K, C)
    y = gen.standard_normal(shape_y).astype(np.float32)
    y[..., ::2, :] = -0.0
    d = gen.standard_normal(shape_d).astype(np.float32)
    if nan_rows:
        d[..., K - nan_rows:, :] = np.nan
    jdt, tdt = DTYPES[dt]
    return ((jnp.asarray(y).astype(jdt), jnp.asarray(d).astype(jdt)),
            (torch.from_numpy(y.copy()).to(tdt),
             torch.from_numpy(d.copy()).to(tdt)))


# starts: inside the frame, at its edges, and outside [0, m + k] (clamped)
STARTS = [M - 3, M, M + K, 0, 3, M + K + 4, -6, 100]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("start", STARTS)
def test_fold_one_lane_bitwise_vs_jnp_and_pallas(dt, masked, start):
    (jy, jd), (ty, td) = _case(start + 7, dt, nan_rows=2 if masked else 0)
    nvalid = K - 2 if masked else None
    want = jlocal._fold_rows_jnp(jy, jd, start, nvalid=nvalid)
    pallas = jlocal.fold_rows_block(jy, jd, start, backend="pallas",
                                    interpret=True, nvalid=nvalid)
    got = _fold_rows_torch(ty, td, start, nvalid)
    assert got.dtype == ty.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(pallas))
    # the in-place entry point writes the same bits into y
    y = ty.clone()
    assert fold_rows_block(y, td, start, nvalid) is y
    np.testing.assert_array_equal(_bits(y), _bits(want))


def test_fold_signed_zero_semantics():
    """The three places where the reference is easy to get wrong: the
    unmasked fold turns a -0.0 y into +0.0 everywhere (it adds +0.0 from
    the frame), the masked fold leaves every dead row's -0.0 alone, and a
    start beyond m + k is clamped for the window but not for the mask."""
    y = torch.full((4, 3), -0.0)
    d = torch.ones((2, 3))
    unmasked = _fold_rows_torch(y, d, 100)
    assert not torch.signbit(unmasked).any()
    masked = _fold_rows_torch(y, d, 100, nvalid=2)
    assert torch.signbit(masked).all()
    # start = m - 1: y row 1 reads d row 0, rows 0 and 2..3 stay dead
    live = _fold_rows_torch(y, d, 3, nvalid=1)
    assert torch.equal(live[1], torch.ones(3))
    assert torch.signbit(live[[0, 2, 3]]).all()


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("masked", [False, True])
def test_fold_lanes_bitwise_vs_vmap(dt, masked):
    lanes = 6
    (jy, jd), (ty, td) = _case(11, dt, lanes=lanes,
                               nan_rows=1 if masked else 0)
    starts = np.array([M - 2, M + 1, -3, M + K + 9, 0, M], np.int32)
    nvalid = np.array([K - 1, 2, K - 1, 3, 1, 0], np.int32)
    if masked:
        want = jax.vmap(lambda y, d, s, n: jlocal._fold_rows_jnp(
            y, d, s, nvalid=n))(jy, jd, jnp.asarray(starts),
                                jnp.asarray(nvalid))
        pallas = jax.vmap(lambda y, d, s, n: jlocal.fold_rows_block(
            y, d, s, backend="pallas", interpret=True, nvalid=n))(
                jy, jd, jnp.asarray(starts), jnp.asarray(nvalid))
    else:
        want = jax.vmap(jlocal._fold_rows_jnp)(jy, jd, jnp.asarray(starts))
        pallas = jax.vmap(lambda y, d, s: jlocal.fold_rows_block(
            y, d, s, backend="pallas", interpret=True))(
                jy, jd, jnp.asarray(starts))
    nv = nvalid.tolist() if masked else None
    got = _fold_rows_torch(ty, td, starts.tolist(), nv)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(pallas))
    # the lane form of the in-place entry point: separate lane tensors
    ys = [ty[i].clone() for i in range(lanes)]
    fold_rows_block(ys, td, starts.tolist(), nv)
    np.testing.assert_array_equal(_bits(torch.stack(ys)), _bits(want))


def test_fold_mixed_dtype_rounds_once_like_pallas():
    """A bfloat16 y with an f32 d (the service's ragged fold) adds in f32
    and rounds once into y's dtype — the reference's Pallas body, whose
    output has y's dtype."""
    gen = np.random.default_rng(3)
    y = gen.standard_normal((M, C)).astype(np.float32)
    d = gen.standard_normal((K, C)).astype(np.float32)
    jy = jnp.asarray(y).astype(jnp.bfloat16)
    pallas = jlocal.fold_rows_block(jy, jnp.asarray(d), M - 1,
                                    backend="pallas", interpret=True,
                                    nvalid=K - 1)
    got = _fold_rows_torch(torch.from_numpy(y).to(torch.bfloat16),
                           torch.from_numpy(d), M - 1, K - 1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(pallas))


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2 ** 16), start=st.integers(-4, M + K + 4),
       nvalid=st.integers(-1, K + 2))
def test_fold_property_bitwise_vs_jnp(seed, start, nvalid):
    (jy, jd), (ty, td) = _case(seed, "f32", nan_rows=0)
    want = jlocal._fold_rows_jnp(jy, jd, start, nvalid=nvalid)
    got = _fold_rows_torch(ty, td, start, nvalid)
    np.testing.assert_array_equal(_bits(got), _bits(want))
