"""Rank-safe DP checkpoints, the elastic resume of DP training, and reading
the reference's checkpoints.

  * DP checkpoints at world 2 (two gloo processes, reduced llama3-8b): the
    save -> restore round trip gives each worker its own buffers bitwise;
    a step missing one rank file is torn; a fault inside the exchange on
    every rank at the same step resumes bitwise like the run that never
    failed.
  * 4 -> 2 (four gloo processes, reduced gemma2-2b from the reference's
    start state): 2 steps at world 4, the DP checkpoint, ``remesh`` onto
    2 workers (ranks 2-3 stand by), ``elastic_restore``: params and
    moments bitwise what was saved, each buffer bitwise ``reshard_error_fb``
    of the saved stack; then 2 steps at world 2 on the same global batches
    against the reference doing the same (its ``elastic_restore``,
    ``reshard_error_fb(fb, 4, 2)``, its step on a 2-device mesh): losses
    and buffers after the first step at 1e-5, each leaf's update over the
    two steps at 1e-3 (tests/test_torch_train.py says what bounds each).
  * ``rescale_accum`` equals the reference's; ``tp`` > 1 is item 11.
  * The reference's ``ckpt.save`` of a TrainState (bf16 params, a world-4
    stacked ``error_fb``) read by ``train_state_from_checkpoint`` equals
    ``train_state_from_jax`` of the same state, bitwise, for every worker;
    a torn reference step raises.
"""
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jax_config
from repro.configs.base import RunConfig as JaxRunConfig
from repro.launch import elastic as jelastic
from repro.models import get_api as jax_api
from repro.plan import plan_train_compression as jplan
from repro.train.step import init_state as jinit_state
from repro_torch.checkpoint import ckpt
from repro_torch.convert import (train_state_from_checkpoint,
                                 train_state_from_jax)
from repro_torch.launch import elastic
from repro_torch.models import param_leaves
from repro_torch.parallel.grad_compress import reshard_error_fb

from torch_dist_helper import (ReferenceDP, dp_ckpt_worker,
                               elastic_train_worker, run_workers)

ARCH, RANK, WORLD, TO, STEPS, AFTER, B, S = "gemma2-2b", 4, 4, 2, 2, 2, 8, 16
TOL, TOL_UPDATE = 1e-5, 1e-3
RUN = {"steps": STEPS + AFTER, "learning_rate": 1e-3, "warmup_steps": 1,
       "grad_compress_rank": RANK}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# -- DP checkpoints at world 2 -----------------------------------------------

@pytest.fixture(scope="module")
def dp_ckpt(reference_job):
    """The world-2 cases (the 4 -> 2 reference compiles meanwhile)."""
    with tempfile.TemporaryDirectory(prefix="torch_dp_ckpt_") as d:
        dirs = {k: os.path.join(d, k) for k in ("a", "b", "clean", "broken")}
        yield run_workers(dp_ckpt_worker, 2, {"dirs": dirs})


def test_dp_checkpoint_restores_each_workers_own_buffers(dp_ckpt):
    for r in dp_ckpt:
        a = r["a"]
        assert a["same"] and a["step"] == (7, 7, 7)
        assert a["extra"] == {"data": {"step": 7, "seed": 0}}
        assert a["files"] == ["error_fb.rank0.pt", "error_fb.rank1.pt",
                              "manifest.json", "tensors.pt"]
        assert "launch.elastic.elastic_restore" in r["one_worker_error"]
    assert not np.array_equal(dp_ckpt[0]["a"]["fb"]["embed"],
                              dp_ckpt[1]["a"]["fb"]["embed"])


def test_dp_step_missing_a_rank_file_is_torn(dp_ckpt):
    for r in dp_ckpt:
        assert r["b"]["latest"] == 2 and r["b"]["torn"] == [3]
        assert "torn" in r["b"]["error"]


def test_crash_on_every_rank_resumes_bitwise(dp_ckpt):
    for r in dp_ckpt:
        c = r["c"]
        assert c["restarts"] == (1, 0)
        got, want = c["losses"]
        assert got == want[:3] + want[2:]
        assert c["steps"] == (4, 4, 4, 4)
        assert c["checkpoints"] == ([2, 4], [2, 4])
        assert c["same"] and c["fb_nonzero"]


# -- elastic resume, 4 -> 2 ---------------------------------------------------

def _batches():
    toks = np.random.default_rng(12).integers(
        0, 256, (STEPS + AFTER, B, S + 1)).astype(np.int32)
    return toks[:, :, :-1].copy(), toks[:, :, 1:].copy()


@pytest.fixture(scope="module")
def reference_job():
    """The reference's 4 -> 2 run, started in the background."""
    with tempfile.TemporaryDirectory(prefix="torch_elastic_") as work:
        tokens, labels = _batches()
        job = ReferenceDP(work, {"arch": ARCH, "seed": 5, "world": WORLD,
                                 "steps": STEPS, "resume_world": TO,
                                 "steps_after": AFTER, "run": RUN},
                          tokens, labels)
        try:
            yield job
        finally:
            if job.proc.poll() is None:
                job.proc.kill()


@pytest.fixture(scope="module")
def resumed(reference_job):
    """The port's four ranks, the reference's run, and the port's saved
    buffers re-laid by ``reshard_error_fb`` from the whole stack."""
    tokens, labels = _batches()
    path = os.path.join(reference_job.work, "port_ckpt")
    port = run_workers(elastic_train_worker, WORLD, {
        "arch": ARCH, "run": RUN, "plan_P": WORLD, "steps": STEPS,
        "steps_after": AFTER, "resume_world": TO,
        "start": reference_job.wait_start(), "ckpt": path, "tokens": tokens,
        "labels": labels})
    ref = reference_job.result()
    manifest, _, _, step_dir = ckpt.load_train_step(path)
    files = [ckpt.load_rank(step_dir, manifest, k) for k in range(WORLD)]
    stack = {n[len("error_fb."):]: torch.stack([f[n] for f in files])
             for n in manifest["rank_names"]}
    want = reshard_error_fb(stack, WORLD, TO)
    return port, ref, {n: t.numpy() for n, t in want.items()}, manifest


def test_elastic_restore_is_bitwise_the_checkpoint(resumed):
    port, _, want, manifest = resumed
    assert manifest["world"] == WORLD
    assert [r["standby"] for r in port] == [False, False, True, True]
    for k, r in enumerate(port[:TO]):
        assert r["restored_step"] == (STEPS, STEPS, STEPS)
        for n, x in port[0]["saved"].items():
            assert np.array_equal(r["restored"][n], x), (k, n)
        for n, x in r["restored_fb"].items():
            assert np.array_equal(x, want[n][k]), (k, n)
    # the shrunk buffers are means of two workers' residuals
    assert not np.array_equal(port[0]["restored_fb"]["embed"],
                              port[0]["fb"][STEPS - 1]["embed"])


def test_resumed_steps_match_the_reference(resumed):
    port, ref, _, _ = resumed
    first, last = STEPS, STEPS + AFTER - 1
    for r in port[:TO]:
        assert list(r["loss"]) == list(port[0]["loss"])
    err = {
        "loss": max(abs(port[0]["loss"][i] - float(ref[f"loss.{i}"]))
                    / abs(float(ref[f"loss.{i}"]))
                    for i in range(STEPS + AFTER)),
        "fb": max(_rel(r["fb"][first][n], ref[f"fb.{first}.{n}"][k])
                  for k, r in enumerate(port[:TO]) for n in r["fb"][first]),
        "update": max(_rel(port[0]["params"][last][n]
                           - port[0]["restored"][f"params.{n}"],
                           ref[f"params.{last}.{n}"] - ref[f"restored.{n}"])
                      for n in port[0]["params"][last]),
    }
    assert err["loss"] <= TOL and err["fb"] <= TOL, err
    assert err["update"] <= TOL_UPDATE, err
    # the replicas of the smaller world stay bitwise identical
    for n, x in port[0]["params"][last].items():
        assert np.array_equal(x, port[1]["params"][last][n]), n


@pytest.mark.parametrize("world_from,world_to", [(4, 2), (4, 1), (8, 2),
                                                 (2, 4), (1, 3), (3, 2),
                                                 (6, 4), (2, 2)])
def test_each_workers_buffer_is_its_slice_of_reshard_error_fb(world_from,
                                                              world_to):
    """``elastic_restore`` reads only the saved workers a new worker needs
    and gets, bitwise, its slice of ``reshard_error_fb`` of the stack."""
    g = torch.Generator().manual_seed(9)
    full = torch.randn((world_from, 5, 3), generator=g)
    files = [{"x": full[k].clone()} for k in range(world_from)]
    want = reshard_error_fb({"x": full if world_from > 1 else full[0]},
                            world_from, world_to)["x"]
    for me in range(world_to):
        read = []

        def load(k):
            read.append(k)
            return files[k]
        got = elastic._my_buffer(load, world_from, world_to, me, "x", "cpu")
        assert torch.equal(got, want if world_to == 1 else want[me]), me
        if world_from % world_to == 0:
            g_ = world_from // world_to
            assert sorted(read) == list(range(me * g_, (me + 1) * g_))


@pytest.mark.parametrize("global_batch", [8, 96, 128, 129])
@pytest.mark.parametrize("per_device,dp", [(1, 1), (4, 2), (4, 8), (3, 5),
                                           (64, 4)])
def test_rescale_accum_matches_reference(global_batch, per_device, dp):
    assert elastic.rescale_accum(global_batch, per_device, dp) == \
        jelastic.rescale_accum(global_batch, per_device, dp)


def test_remesh_refuses_tensor_parallelism():
    with pytest.raises(NotImplementedError, match="item 11"):
        elastic.remesh(range(4), dp=2, tp=2)


# -- the reference's checkpoints ---------------------------------------------

@pytest.fixture(scope="module")
def reference_ckpt():
    """A TrainState the reference saved with its own ``ckpt.save``: bf16
    params, nonzero moments and a stacked world-4 ``error_fb``."""
    cfg = jax_config(ARCH).reduced()
    api = jax_api(cfg)
    key = jax.random.key(7)
    shapes = jax.eval_shape(lambda k: api.init(k, cfg), key)
    dec = jplan(shapes, rank=RANK, P=WORLD).decision_tree()
    st = jinit_state(api, cfg, JaxRunConfig(grad_compress_rank=RANK), key,
                     world=WORLD, decisions=dec)
    g = np.random.default_rng(8)

    def rand(x, dtype=jnp.float32):
        return jnp.asarray(g.standard_normal(x.shape), dtype)
    tm = jax.tree_util.tree_map
    st = st.replace(
        params=tm(lambda x: rand(x, jnp.bfloat16), st.params),
        opt=st.opt._replace(m=tm(rand, st.opt.m),
                            v=tm(lambda x: jnp.abs(rand(x)), st.opt.v),
                            count=jnp.int32(9)),
        error_fb=tm(rand, st.error_fb), step=jnp.int32(9))
    with tempfile.TemporaryDirectory(prefix="jax_ckpt_") as d:
        jckpt.save(d, 9, st)
        yield d, jax.device_get(st)


@pytest.mark.parametrize("worker", range(WORLD))
def test_reference_checkpoint_reads_like_the_state(reference_ckpt, worker):
    d, host = reference_ckpt
    got = train_state_from_checkpoint(d, worker=worker, device="cpu")
    want = train_state_from_jax(host, worker=worker, device="cpu")
    assert got.step == want.step == 9 and got.opt.count == 9
    for tree in ("params", "error_fb", "opt.m", "opt.v"):
        obj_g, obj_w = got, want
        for attr in tree.split("."):
            obj_g, obj_w = getattr(obj_g, attr), getattr(obj_w, attr)
        for (n, x), (_, y) in zip(param_leaves(obj_g), param_leaves(obj_w),
                                  strict=True):
            assert x.dtype == y.dtype and torch.equal(x, y), (tree, n)
    assert got.params["embed"].dtype == torch.bfloat16
    assert got.params["embed"].requires_grad


def test_torn_reference_checkpoint_raises(reference_ckpt, tmp_path):
    d, _ = reference_ckpt
    dst = tmp_path / "ck"
    shutil.copytree(d, dst)
    shutil.copytree(dst / "step_00000009", dst / "step_00000011")
    os.remove(dst / "step_00000011" / "arrays.npz")
    # the newest complete step is read, the torn one refused
    assert train_state_from_checkpoint(str(dst), worker=0,
                                       device="cpu").step == 9
    with pytest.raises(ckpt.TornCheckpointError, match="torn"):
        train_state_from_checkpoint(str(dst), step=11, worker=0,
                                    device="cpu")
