"""The live reshard of sharded streams (``repro_torch.stream.elastic``) on
four gloo ranks of the CPU, spawned once for the module
(``torch_dist_helper.elastic_worker``).

Held: a co-range stream shrunk (4,1,1) -> (2,1,1) mid-stream and grown
back is bitwise, Y and W, the stream that never moved (every grid of the
sequence gives a slab the same sums; W's replicas over p1 move once
each); one hop on each pinned pair is a layout move (the gathered Y and W
bitwise before and after) whose words each rank receives are pinned, equal
to its ``COMM`` delta, to ``elastic.rank_words`` and to the ledger site's
measured and predicted words (drift 0), their maximum
``plan.model.stream_reshard_words`` (the reference's formula); a grid
service moves its evicted stream too, from host memory and from disk, and
ranks past a smaller grid keep a standby service; grid-mode ingest queues
whose windows differ between ranks give bitwise the direct updates.
"""
import numpy as np
import pytest

from repro.plan import model as jmodel
from repro_torch.plan import model as tmodel
from repro_torch.stream import StreamConfig
from torch_dist_helper import elastic_worker, run_workers

WORLD = 4
N1, N2, R = 64, 32, 8
CFG = dict(n1=N1, n2=N2, r=R, seed=3)
# words each rank receives, Y and W together (l = 17)
PAIRS = {
    ((4, 1, 1), (1, 2, 2)): [64, 64, 64, 64],
    # the Y layouts coincide and every rank holds W whole: nothing moves
    ((4, 1, 1), (2, 2, 1)): [0, 0, 0, 0],
    # both Y axes re-split; W's column blocks halve
    ((2, 1, 2), (1, 1, 4)): [64, 264, 264, 64],
}

# Y's layout is the same on (4,1,1) and (2,2,1): only W's call is made
CALLS = {pair: 1 if pair == ((4, 1, 1), (2, 2, 1)) else 2 for pair in PAIRS}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(0)
    spec = {
        "cfg": CFG,
        "slabs": [(i * 16, rng.standard_normal((16, N2)).astype("float32"))
                  for i in range(4)],
        "A": rng.standard_normal((N1, N2)).astype("float32"),
        "pairs": list(PAIRS),
        "spill_dir": str(tmp_path_factory.mktemp("spill")),
        "traffic": [(s, rng.standard_normal((N1, N2)).astype("float32"))
                    for s in (0, 0, 1, 0, 2, 1, 2, 2)]}
    return run_workers(elastic_worker, WORLD, spec)


def test_shrink_and_grow_is_bitwise_the_stream_that_never_moved(ranks):
    for res in ranks:
        got = res["shrink_grow"]
        assert got["Y"] and got["W"]
        assert got["num_updates"] == (4, 4)


def test_ranks_past_the_smaller_grid_stand_by(ranks):
    for rank, res in enumerate(ranks):
        shrunk = res["shrink_grow"]["shrunk"]
        assert shrunk["num_updates"] == 2
        assert shrunk["standby"] == (rank >= 2)
        if rank >= 2:
            assert shrunk["error"] == (
                f"sketch: rank {rank} is past the grid (2, 1, 1) and holds "
                f"no block (a standby stream after a reshard)")


@pytest.mark.parametrize("pair", list(PAIRS), ids=str)
def test_hop_words_are_pinned_and_the_ledger_drift_is_zero(ranks, pair):
    old, new = pair
    want = PAIRS[pair]
    cfg = StreamConfig(**CFG)
    for rank, res in enumerate(ranks):
        got = res["pairs"][pair]
        assert got["bitwise"]
        assert got["words"]["redistribute"]["words"] == want[rank]
        # one all-to-all an accumulator whose layout changes
        assert got["words"]["redistribute"]["calls"] == CALLS[pair]
        assert sum(v["words"] for v in got["words"].values()) == want[rank]
        assert got["rank_words"] == want[rank]
        led = got["ledger"]
        assert led["calls"] == 1
        assert led["measured"] == led["predicted"] == led["floor"] == \
            want[rank]
        assert led["drift"] == 0.0
    kw = dict(l=cfg.sketch_l, n2=N2, corange=True)
    assert max(want) == tmodel.stream_reshard_words(N1, R, old, new, **kw) \
        == jmodel.stream_reshard_words(N1, R, old, new, **kw)


@pytest.mark.parametrize("spill", [False, True], ids=["host", "disk"])
def test_service_reshard_moves_its_evicted_stream(ranks, spill):
    for rank, res in enumerate(ranks):
        got = res["service"][spill]
        assert got["evicted"] == 1 and got["spilled"] == spill
        assert got["moved"] == (1, 1)
        assert got["bitwise"] == (True, True, True)
        assert got["standby"] == (rank >= 2)
        if rank >= 2:
            assert "past the grid (2, 1, 1)" in got["error"]
        assert got["updates"] == 3


def test_grid_queues_with_different_windows_are_bitwise(ranks):
    for res in ranks:
        assert res["queue"]["applied"] == 8 and res["queue"]["bitwise"]
    # window 1 on rank 0: a round a request; ranks 1 and 3 held their
    # workers while submitting, so their windows of 2 and 4 fused requests
    # of different streams: the ranks' rounds differed
    assert ranks[0]["queue"]["rounds"] == 8
    assert min(ranks[1]["queue"]["rounds"], ranks[3]["queue"]["rounds"]) < 8
