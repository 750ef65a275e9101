"""repro_torch's one-device stream and Nystrom path against the reference.

The port's ``StreamingSketch(device="cpu")`` against the reference's
``StreamingSketch(backend="xla")`` on the same numpy inputs, the stream
handed over mid-way from the reference to the port, and the Nystrom and
one-pass reconstructions.

Tolerances: Y, W and the Nystrom pair are f32 GEMM results, held to
``rtol=1e-5``, ``atol=1e-5·max|ref|`` (summation order).  The
reconstructions go through QR, SVD and eigh of two libraries, whose f32
factors agree to about 1e-6 relative on these well-separated spectra;
they are held to ``atol=1e-4·max|ref|``, compared as the matrices
``Q·X`` and ``Ã`` (the factors themselves are defined only up to sign).
"""
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import nystrom as jnys
from repro.stream import reconstruct as jrec
from repro.stream import state as jstate
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.core import nystrom
from repro_torch.stream import (StreamConfig, StreamingSketch,
                                one_pass_reconstruct, reconstruction_error)

N1, N2, R = 256, 192, 16


def _close(got, want, rel=1e-5):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _low_rank(n1, n2, rank, seed, noise=1e-3):
    gen = np.random.default_rng(seed)
    A = (gen.standard_normal((n1, rank)) @ gen.standard_normal((rank, n2))
         + noise * gen.standard_normal((n1, n2)))
    return A.astype(np.float32)


def _pair(cfg_kw):
    return (jstate.StreamingSketch(jstate.StreamConfig(**cfg_kw),
                                   backend="xla"),
            StreamingSketch(StreamConfig(**cfg_kw), device="cpu"))


@pytest.mark.parametrize("kind", ["normal", "rademacher", "countsketch",
                                  "rowsample"])
@pytest.mark.parametrize("mode", ["rows", "cols", "update"])
def test_stream_updates_match_reference(kind, mode):
    A = _low_rank(N1, N2, 6, seed=1)
    js, ts = _pair(dict(n1=N1, n2=N2, r=R, seed=2 ** 34 + 5, kind=kind))
    if mode == "rows":
        for r0, r1 in ((0, 100), (100, 101), (101, 256)):
            js.update_rows(r0, jnp.asarray(A[r0:r1]))
            ts.update_rows(r0, torch.from_numpy(A[r0:r1]))
    elif mode == "cols":
        for c0, c1 in ((0, 70), (70, 192)):
            js.update_cols(c0, jnp.asarray(A[:, c0:c1]))
            ts.update_cols(c0, torch.from_numpy(A[:, c0:c1]))
    else:
        js.update(jnp.asarray(A))
        ts.update(torch.from_numpy(A))
        js.update(jnp.asarray(0.5 * A))
        ts.update(torch.from_numpy(0.5 * A))
    assert ts.num_updates == js.num_updates
    _close(ts.sketch.numpy(), js.sketch)
    _close(ts.corange_sketch.numpy(), js.corange_sketch)


def test_rows_stream_equals_one_shot_plain():
    """Row slabs of any height reproduce the port's one-shot sketch."""
    from repro_torch.kernels import sketch_block
    A = torch.from_numpy(_low_rank(N1, N2, 6, seed=3))
    st = StreamingSketch(StreamConfig(N1, N2, r=R, seed=4), device="cpu")
    for r0 in range(0, N1, 64):
        st.update_rows(r0, A[r0:r0 + 64])
    _close(st.Y.numpy(), sketch_block(A, 4, R).numpy())


def test_nystrom_and_reconstruct_match_reference():
    gen = np.random.default_rng(5)
    G = gen.standard_normal((N2, 32)).astype(np.float32)
    A = (G @ G.T + 1e-2 * np.eye(N2)).astype(np.float32)
    js, ts = _pair(dict(n1=N2, n2=N2, r=R, seed=11))
    js.update_rows(0, jnp.asarray(A))
    ts.update_rows(0, torch.from_numpy(A))
    (jB, jC), (tB, tC) = js.nystrom(), ts.nystrom()
    _close(tB.numpy(), jB)
    _close(tC.numpy(), jC)
    tA = torch.from_numpy(A)
    rB, rC = nystrom.nystrom_reference(tA, 11, R)
    _close(rB.numpy(), tB.numpy())
    _close(rC.numpy(), tC.numpy())
    _close(nystrom.reconstruct(tB, tC).numpy(),
           jnys.reconstruct(jB, jC), rel=1e-4)
    np.testing.assert_allclose(float(nystrom.relative_error(tA, tB, tC)),
                               float(jnys.relative_error(jnp.asarray(A),
                                                         jB, jC)),
                               rtol=1e-3)


@pytest.mark.parametrize("rank", [None, 6])
def test_one_pass_reconstruct_matches_reference(rank):
    A = _low_rank(N1, N2, 6, seed=7)
    js, ts = _pair(dict(n1=N1, n2=N2, r=R, seed=8))
    js.update_rows(0, jnp.asarray(A))
    ts.update_rows(0, torch.from_numpy(A))
    jl = js.reconstruct(rank=rank)
    tl = ts.reconstruct(rank=rank)
    assert tl.rank == jl.rank
    _close(tl.matrix().numpy(), jl.matrix(), rel=1e-4)
    err_t = float(reconstruction_error(torch.from_numpy(A), tl))
    err_j = float(jrec.reconstruction_error(jnp.asarray(A), jl))
    assert err_t < 1e-2 and abs(err_t - err_j) < 1e-4
    again = one_pass_reconstruct(ts.Y, ts.W, ts.cfg, rank=rank)
    assert torch.equal(again.matrix(), tl.matrix())


def test_handover_from_reference_mid_stream():
    """The reference streams the first half of the rows, the port the
    second; the result matches the reference streaming all of them."""
    A = _low_rank(N1, N2, 6, seed=9)
    kw = dict(n1=N1, n2=N2, r=R, seed=2 ** 33 + 2, kind="uniform")
    whole = jstate.StreamingSketch(jstate.StreamConfig(**kw), backend="xla")
    half = jstate.StreamingSketch(jstate.StreamConfig(**kw), backend="xla")
    for r0 in range(0, N1, 32):
        whole.update_rows(r0, jnp.asarray(A[r0:r0 + 32]))
        if r0 < N1 // 2:
            half.update_rows(r0, jnp.asarray(A[r0:r0 + 32]))
    st = convert.stream_from_jax(half.cfg.to_json_dict(),
                                 np.asarray(half.Y), np.asarray(half.W),
                                 half.num_updates, device="cpu")
    for r0 in range(N1 // 2, N1, 32):
        st.update_rows(r0, torch.from_numpy(A[r0:r0 + 32]))
    assert st.num_updates == whole.num_updates
    _close(st.Y.numpy(), whole.Y)
    _close(st.W.numpy(), whole.W)
    cfg_json, Y, W, n = convert.stream_to_numpy(st)
    assert cfg_json == whole.cfg.to_json_dict() and n == st.num_updates
    back = jstate.StreamConfig.from_json_dict(cfg_json)
    assert back == whole.cfg
    np.testing.assert_array_equal(Y, st.Y.numpy())
    np.testing.assert_array_equal(W, st.W.numpy())
    with pytest.raises(ValueError, match="shape"):
        convert.stream_from_jax(cfg_json, Y[:5], W, n, device="cpu")


def test_stream_config_contract():
    cfg = StreamConfig(10, 8, r=3, seed=1, kind="countsketch",
                       dtype=torch.bfloat16)
    assert StreamConfig.from_json_dict(cfg.to_json_dict()) == cfg
    assert cfg.sketch_l == 7
    for bad in (dict(kind="gaussian"), dict(r=0),
                dict(omega_salt=1, psi_salt=1)):
        with pytest.raises(ValueError):
            StreamingSketch(StreamConfig(10, 8, **{"r": 3, **bad}),
                            device="cpu")
    st = StreamingSketch(StreamConfig(10, 8, r=3), device="cpu")
    with pytest.raises(ValueError, match="outside"):
        st.update_rows(8, torch.zeros(3, 8))
    with pytest.raises(ValueError, match="square"):
        st.nystrom()


def test_stream_needs_cuda_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        StreamingSketch(StreamConfig(8, 8, r=2))


@pytest.mark.parametrize("kind", ["normal", "countsketch"])
@pytest.mark.parametrize("corange", [True, False])
def test_save_restore_continues_bitwise(tmp_path, kind, corange):
    """A stream saved mid-way and restored finishes with the bits of one
    that never stopped (the sketch state plus the seed is the stream)."""
    A = _low_rank(N1, N2, 6, seed=11)
    cfg = StreamConfig(n1=N1, n2=N2, r=R, seed=2 ** 33 + 9, kind=kind,
                       corange=corange)
    whole = StreamingSketch(cfg, device="cpu")
    first = StreamingSketch(cfg, device="cpu")
    for r0 in range(0, N1, 64):
        whole.update_rows(r0, torch.from_numpy(A[r0:r0 + 64]))
        if r0 < N1 // 2:
            first.update_rows(r0, torch.from_numpy(A[r0:r0 + 64]))
    path = first.save(str(tmp_path))
    assert path.endswith(f"step_{first.num_updates:08d}")
    extra, step = ckpt.load_extra(str(tmp_path))
    assert step == first.num_updates and extra["layout"] == "local"
    assert StreamConfig.from_json_dict(extra["config"]) == cfg
    st = StreamingSketch.restore(str(tmp_path), device="cpu")
    assert st.cfg == cfg and st.num_updates == first.num_updates
    assert torch.equal(st.Y, first.Y)
    assert (st.W is None) == (not corange)
    for r0 in range(N1 // 2, N1, 64):
        st.update_rows(r0, torch.from_numpy(A[r0:r0 + 64]))
    assert st.num_updates == whole.num_updates
    assert torch.equal(st.Y, whole.Y)
    if corange:
        assert torch.equal(st.W, whole.W)


def test_checkpoint_tree_form(tmp_path):
    """The named-tensor form: whole tensors on the CPU, ``extra`` read
    alone, the newest ``keep`` steps kept, and a tree is not a train
    state."""
    d = str(tmp_path)
    for step in (1, 2, 3):
        ckpt.save(d, step, {"Y": torch.full((2, 3), float(step)),
                            "W": torch.arange(4.0)[1:]},
                  extra={"n": step}, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]
    assert ckpt.latest_step(d) == 3
    assert ckpt.load_extra(d) == ({"n": 3}, 3)
    tree, step, extra = ckpt.restore_tree(d, 2)
    assert step == 2 and extra == {"n": 2}
    assert torch.equal(tree["Y"], torch.full((2, 3), 2.0))
    assert torch.equal(tree["W"], torch.arange(4.0)[1:])
    with pytest.raises(ValueError, match="restore_tree"):
        ckpt.restore(d, object())
    with pytest.raises(FileNotFoundError):
        ckpt.load_extra(str(tmp_path / "none"))
