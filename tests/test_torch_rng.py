"""repro_torch's Omega draws against the JAX reference's, bitwise.

Every draw is integer arithmetic plus one correctly rounded int->float
convert, so the port must reproduce the reference bit for bit: all five
kinds, seeds above 2**32, salts, offsets at the uint32 wrap, and any tile
decomposition.  The sparse apply sums in a different order than the
reference's scatter, so it is held to float32 tolerance.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import rng as jrng
from repro.core import sketch as jsketch
from repro_torch.core import rng, sketch

KINDS = ["normal", "uniform", "rademacher", "countsketch", "rowsample"]
WRAP = 2 ** 32 - 6          # a tile starting here wraps the uint32 counter


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def test_philox_known_answer_vectors():
    """Random123 kat_vectors for philox4x32-10."""
    cases = [
        ((0, 0, 0, 0), (0, 0),
         [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
         [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]),
    ]
    for counter, key, want in cases:
        assert [int(x) for x in rng.philox_4x32(counter, key)] == want


def test_mulhilo32_matches_python_ints():
    gen = np.random.default_rng(0)
    a = np.concatenate([gen.integers(0, 2 ** 32, 4000, dtype=np.int64),
                        [0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF]])
    b = np.concatenate([gen.integers(0, 2 ** 32, 4000, dtype=np.int64),
                        [0xFFFFFFFF, 0xFFFFFFFF, 0xFFFF, 0x10000,
                         0xFFFFFFFF]])
    hi, lo = rng._mulhilo32(torch.from_numpy(a), torch.from_numpy(b))
    prod = [int(x) * int(y) for x, y in zip(a, b)]
    assert hi.tolist() == [p >> 32 for p in prod]
    assert lo.tolist() == [p & 0xFFFFFFFF for p in prod]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 123, 2 ** 40 + 7, 2 ** 63 - 1])
@pytest.mark.parametrize("row0,col0,salt", [(0, 0, 0), (17, 5, 1),
                                            (WRAP, WRAP + 2, 3)])
def test_omega_tile_bitwise(kind, seed, row0, col0, salt):
    kw = dict(salt=salt, r_total=40, n_total=77)
    want = jsketch.omega_tile(seed, row0, col0, 13, 9, kind, **kw)
    got = sketch.omega_tile(seed, row0, col0, 13, 9, kind, device="cpu",
                            **kw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("grid", ["uniform", "normal"])
def test_rng_grids_bitwise(grid):
    j = getattr(jrng, f"philox_{grid}_grid")
    t = getattr(rng, f"philox_{grid}_grid")
    want = j(jnp.uint32(5), jnp.uint32(0xDEADBEEF), jnp.uint32(WRAP),
             jnp.uint32(3), 11, 10, salt=2)
    got = t(5, 0xDEADBEEF, WRAP, 3, 11, 10, salt=2, device="cpu")
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_philox_omega_full_matches_reference():
    want = jrng.philox_omega_full(2 ** 33 + 5, 20, 6, salt=1)
    got = rng.philox_omega_full(2 ** 33 + 5, 20, 6, salt=1, device="cpu")
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("kind", KINDS)
def test_tile_decomposition_invariance(kind):
    """Four quadrants drawn independently reassemble the full tile."""
    kw = dict(r_total=30, n_total=50, device="cpu")
    rows, cols, r0, c0, rh, ch = 21, 17, WRAP - 9, 4, 10, 7
    full = sketch.omega_tile(11, r0, c0, rows, cols, kind, **kw)
    q = [[sketch.omega_tile(11, r0 + i0, c0 + j0, h, w, kind, **kw)
          for j0, w in ((0, ch), (ch, cols - ch))]
         for i0, h in ((0, rh), (rh, rows - rh))]
    assert torch.equal(torch.cat([torch.cat(row, 1) for row in q], 0), full)


def test_seed_keys_forms():
    assert sketch.seed_keys(2 ** 40 + 9) == (9, 2 ** 8)
    assert sketch.seed_keys(np.uint64(2 ** 33)) == (0, 2)
    for pair in (np.array([7, 3], np.uint32), torch.tensor([7, 3])):
        assert sketch.seed_keys(pair) == (7, 3)
    assert sketch.seed_keys(np.uint32(5).reshape(())) == (5, 0)
    assert sketch.seed_keys(torch.tensor(5)) == (5, 0)
    for s in (2 ** 40 + 9, jnp.asarray([7, 3], jnp.uint32),
              jnp.asarray(5, jnp.uint32)):
        want = tuple(int(k) for k in jsketch.seed_keys(s))
        assert sketch.seed_keys(np.asarray(s) if not isinstance(s, int)
                                else s) == want
    with pytest.raises(ValueError):
        sketch.seed_keys(np.zeros((3,)))


def test_kind_validation():
    with pytest.raises(ValueError, match="valid kinds"):
        sketch.omega_tile(0, 0, 0, 2, 2, "gaussian", device="cpu")


@pytest.mark.parametrize("kind", ["countsketch", "rowsample"])
def test_sparse_omega_rows_and_map_bitwise(kind):
    g = np.array([0, 5, 5, 2 ** 32 - 1, 1000, 3], np.uint32)
    jb, jv = jsketch.sparse_omega_rows(99, jnp.asarray(g), 16, kind,
                                       salt=1, n_total=64)
    tb, tv = sketch.sparse_omega_rows(99, torch.from_numpy(g.astype(
        np.int64)), 16, kind, salt=1, n_total=64)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    jb, jv = jsketch.sparse_omega_map(99, 40, 16, kind, row0=WRAP,
                                      n_total=64)
    tb, tv = sketch.sparse_omega_map(99, 40, 16, kind, row0=WRAP,
                                     n_total=64, device="cpu")
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))


@pytest.mark.parametrize("kind", ["countsketch", "rowsample"])
def test_sketch_sparse_apply_matches_reference(kind):
    A = np.random.default_rng(3).standard_normal((12, 70)).astype(
        np.float32)
    want = np.asarray(jsketch.sketch_sparse_apply(jnp.asarray(A), 5, 8,
                                                  kind, salt=2))
    got = sketch.sketch_sparse_apply(torch.from_numpy(A), 5, 8, kind,
                                     salt=2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    dense = A @ sketch.omega_tile(5, 0, 0, 70, 8, kind, salt=2,
                                  device="cpu").numpy()
    np.testing.assert_allclose(got, dense, rtol=1e-5,
                               atol=1e-5 * np.abs(dense).max())


@pytest.mark.parametrize("kind", ["normal", "rademacher"])
def test_sketch_reference_matches(kind):
    A = np.random.default_rng(4).standard_normal((9, 33)).astype(np.float32)
    want = np.asarray(jsketch.sketch_reference(jnp.asarray(A), 8, 6, kind,
                                               scale=0.25))
    got = sketch.sketch_reference(torch.from_numpy(A), 8, 6, kind,
                                  scale=0.25).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_omega_tile_needs_cuda_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        sketch.omega_tile(0, 0, 0, 4, 4)
