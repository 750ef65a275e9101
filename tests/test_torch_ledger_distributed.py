"""The port's comm-ledger sites on one world of four gloo processes, against
the reference's HLO audit of the same calls on 4 fake XLA devices.

Calls (``torch_dist_helper.ledger_worker``, spawned once; the reference
once through ``dist_helper.run_distributed``): ``ShardedStreamingSketch.
update`` on (4,1,1), (2,2,1), (1,2,2) with and without the co-range,
``update_rows`` of one slab on each, a grid service's ``update`` on
(4,1,1) and (2,2,1), and the fused two-grid pair p = (4,1,1),
q = (1,1,4); the port also runs the fused second stage and a stale
decision drill for ``revalidate_autotune``.

Held to:

  * on every rank, each measured site's words equal the rank's ``COMM``
    delta around the call, by kind;
  * the port's words equal its closed form (the words a rank receives:
    ``(1 - 1/g)`` of the gathered or scattered tensor, a ring's
    ``2(1 - 1/g)`` for an all-reduce, a Redistribute's destination less
    what the rank held), and its drift is 0 on every site;
  * the reference's HLO words equal their closed form (each collective's
    per-device operand);
  * where the two conventions coincide (an all-gather or an all-reduce
    over a group of 2) the words are equal; they differ for a
    reduce-scatter, for any group of 4 and for the all-to-all;
  * the same calls leave the same site names and call counts;
  * the co-range delta and the slab's zero drift, as in the reference;
  * ``train.dp_compressed_step`` at world 2: drift 0, the reference's
    ``exchange_words + 1``.
"""
import json
import tempfile

import numpy as np
import pytest

from dist_helper import run_distributed
from torch_dist_helper import dp_step_ledger_worker, ledger_worker, run_workers

WORLD = 4
SEED, N1, N2, R, K = 3, 16, 64, 8, 4
S_N, S_R = 64, 16
GRIDS = [(4, 1, 1), (2, 2, 1), (1, 2, 2)]
SERVICE_GRIDS = [(4, 1, 1), (2, 2, 1)]
P_GRID, Q_GRID = (4, 1, 1), (1, 1, 4)
L = min(2 * R + 1, N1)              # StreamConfig's default sketch_l
#: the port's kinds under the reference's HLO names
HLO = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
       "all_reduce": "all-reduce", "redistribute": "all-to-all"}

TAGS = ([("update", g, c) for c in (False, True) for g in GRIDS]
        + [("update_rows", g) for g in GRIDS]
        + [("service", g) for g in SERVICE_GRIDS]
        + [("fused", P_GRID, Q_GRID)])
NAME = {"update": "stream.update", "update_rows": "stream.update_rows",
        "service": "service.update[dist]", "fused": "nystrom.two_grid_fused",
        "stage2_fused": "nystrom.stage2_two_grid_fused"}


def _inputs():
    rng = np.random.default_rng(SEED)
    H = rng.standard_normal((N1, N2)).astype(np.float32)
    G = rng.standard_normal((S_N, S_N)).astype(np.float32)
    return H, (G @ G.T).astype(np.float32)


def _key(tag) -> str:
    return "-".join(str(x) for x in tag).replace(" ", "")


def _forms(tag):
    """(the port's words by kind, the reference's HLO words by kind) of one
    call: each package's closed form."""
    what, grid = tag[0], tag[1]
    p1, p2, p3 = grid
    port, ref = {}, {}
    if what == "fused":
        P = p1 * p2 * p3
        return ({"redistribute": (1 - 1 / P) * S_N * S_R / P},
                {"all-to-all": S_N * S_R / P})
    if what == "update_rows":
        if p3 > 1:
            port["all_gather"] = (1 - 1 / p3) * K * N2 / p2
            ref["all-gather"] = K * N2 / (p2 * p3)
        if p2 > 1:
            port["all_reduce"] = 2 * (1 - 1 / p2) * K * R / p3
            ref["all-reduce"] = K * R / p3
        return port, ref
    corange = tag[2] if what == "update" else True
    if p3 > 1:
        port["all_gather"] = (1 - 1 / p3) * N1 * N2 / (p1 * p2)
        ref["all-gather"] = N1 * N2 / (p1 * p2 * p3)
    if p2 > 1:
        port["reduce_scatter"] = (1 - 1 / p2) * N1 * R / (p1 * p3)
        ref["reduce-scatter"] = N1 * R / (p1 * p3)
    if corange and p1 > 1:
        port["all_reduce"] = 2 * (1 - 1 / p1) * L * N2 / (p2 * p3)
        ref["all-reduce"] = L * N2 / (p2 * p3)
    return port, ref


def _group(kind, tag) -> int:
    """The group size of one collective kind of a call."""
    p1, p2, p3 = tag[1]
    if kind == "all_gather":
        return p3
    if kind == "reduce_scatter":
        return p2
    if kind == "all_reduce":
        return p2 if tag[0] == "update_rows" else p1
    return p1 * p2 * p3


@pytest.fixture(scope="module")
def port():
    H, S = _inputs()
    spec = dict(seed=SEED, H=H, r=R, k=K, grids=GRIDS,
                service_grids=SERVICE_GRIDS, S=S, s_r=S_R, p=P_GRID,
                q=Q_GRID, drill_grid=(2, 2, 1), dir=tempfile.mkdtemp())
    return run_workers(ledger_worker, WORLD, spec)


_REF = """
import json, numpy as np, jax.numpy as jnp
from repro import obs
from repro.core.sketch import make_grid_mesh
from repro.core.nystrom import nystrom_two_grid_fused
from repro.stream.distributed import ShardedStreamingSketch
from repro.stream.service import SketchService
from repro.stream.state import StreamConfig
spec = json.loads(SPEC)
H = jnp.asarray(np.asarray(spec["H"], np.float32))
S = jnp.asarray(np.asarray(spec["S"], np.float32))
n1, n2 = H.shape
seed, r = spec["seed"], spec["r"]
_, ledger, _ = obs.install_observability()
out = []
def take(tag):
    for s in ledger.sites():
        cb = s.collectives()
        out.append({"tag": tag, "name": s.name, "calls": s.calls,
                    "by_kind": {k: v / s.itemsize
                                for k, v in cb.by_kind.items()},
                    "words": s.measured_words_per_call,
                    "redistribute": cb.redistribute_total / s.itemsize,
                    "drift": s.drift, "bound_fraction": s.bound_fraction})
    ledger.clear()
for corange in (False, True):
    cfg = StreamConfig(n1=n1, n2=n2, r=r, seed=seed, corange=corange)
    for grid in spec["grids"]:
        st = ShardedStreamingSketch(cfg, make_grid_mesh(*grid))
        st.update(H)
        take(["update", grid, corange])
cfg = StreamConfig(n1=n1, n2=n2, r=r, seed=seed, corange=True)
for grid in spec["grids"]:
    st = ShardedStreamingSketch(cfg, make_grid_mesh(*grid))
    st.update_rows(0, H[:spec["k"]])
    take(["update_rows", grid])
for grid in spec["service_grids"]:
    svc = SketchService(mesh=make_grid_mesh(*grid))
    sid = svc.open(cfg)
    svc.update(sid, H)
    take(["service", grid])
nystrom_two_grid_fused(S, seed, spec["s_r"], p=tuple(spec["p"]),
                       q=tuple(spec["q"]))
take(["fused", spec["p"], spec["q"]])
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    H, S = _inputs()
    spec = dict(seed=SEED, H=H.tolist(), r=R, k=K, grids=GRIDS,
                service_grids=SERVICE_GRIDS, S=S.tolist(), s_r=S_R,
                p=P_GRID, q=Q_GRID)
    out = run_distributed(f"SPEC = {json.dumps(spec)!r}\n" + _REF,
                          ndev=WORLD, timeout=600)
    rows = json.loads(out.split("RESULT ", 1)[1])
    by_tag = {}
    for row in rows:
        tag = tuple(tuple(x) if isinstance(x, list) else x
                    for x in row["tag"])
        by_tag.setdefault(tag, []).append(row)
    return by_tag


def _port_rows(port, tag):
    """Each rank's rows of one call."""
    return [[c for c in res["calls"] if c["tag"] == tag] for res in port]


@pytest.mark.parametrize("tag", TAGS, ids=_key)
def test_sites_measure_the_rank_comm_delta(port, tag):
    for rank, rows in enumerate(_port_rows(port, tag)):
        assert [c["name"] for c in rows] == [NAME[tag[0]]], (rank, rows)
        c = rows[0]
        assert c["calls"] == 1
        assert c["by_kind"] == c["comm"], (rank, c)
        assert c["words"] == sum(c["comm"].values()), (rank, c)


@pytest.mark.parametrize("tag", TAGS + [("stage2_fused", P_GRID, Q_GRID)],
                         ids=_key)
def test_port_words_are_its_closed_form_at_zero_drift(port, tag):
    want = _forms(("fused",) + tag[1:] if tag[0] == "stage2_fused"
                  else tag)[0]
    for rank, rows in enumerate(_port_rows(port, tag)):
        c = rows[0]
        assert c["by_kind"] == want, (rank, c)
        assert c["pred"] == sum(want.values()), (rank, c)
        assert c["drift"] == 0.0, (rank, c)


@pytest.mark.parametrize("tag", TAGS, ids=_key)
def test_reference_hlo_words_are_their_closed_form(ref, tag):
    rows = ref[tag]
    assert [r["name"] for r in rows] == [NAME[tag[0]]]
    assert rows[0]["by_kind"] == _forms(tag)[1]


@pytest.mark.parametrize("tag", TAGS, ids=_key)
def test_conventions_coincide_only_for_groups_of_two(port, ref, tag):
    """An all-gather or an all-reduce over a group of 2: the words a rank
    receives equal the per-device operand.  Any other collective: each
    package's closed form (held above), and the two differ."""
    port_form, ref_form = _forms(tag)
    got = ref[tag][0]["by_kind"]
    for rows in _port_rows(port, tag):
        mine = rows[0]["by_kind"]
        assert len(mine) == len(got)
        for kind, words in mine.items():
            if kind in ("all_gather", "all_reduce") and _group(kind,
                                                               tag) == 2:
                assert words == got[HLO[kind]], (kind, mine, got)
            else:
                assert words != got[HLO[kind]], (kind, mine, got)
                assert (words, got[HLO[kind]]) == (port_form[kind],
                                                   ref_form[HLO[kind]])


def test_same_site_names_and_call_counts_in_both_packages(port, ref):
    for tag in TAGS:
        want = sorted((r["name"], r["calls"]) for r in ref[tag])
        for rows in _port_rows(port, tag):
            assert sorted((c["name"], c["calls"]) for c in rows) == want, \
                tag


def test_corange_delta_and_row_slab_drift(port, ref):
    """The co-range all-reduce adds ``2(1 - 1/p1)·l·n2/(p2·p3)`` words a
    rank on (2,2,1) (the reference's operand ``l·n2/(p2·p3)``, equal at
    p1 = 2); a slab's drift is 0 on every grid, in both packages."""
    grid = (2, 2, 1)
    co, no = ("update", grid, True), ("update", grid, False)
    for res in port:
        words = {c["tag"]: c["words"] for c in res["calls"]}
        assert words[co] - words[no] == 2 * (1 - 1 / 2) * L * N2 / 2
    assert (ref[co][0]["words"] - ref[no][0]["words"]) == L * N2 / 2
    for grid in GRIDS:
        tag = ("update_rows", grid)
        assert ref[tag][0]["drift"] == 0.0
        for rows in _port_rows(port, tag):
            assert rows[0]["drift"] == 0.0


def test_regime_one_moves_nothing_at_the_bound(port, ref):
    tag = ("update", (4, 1, 1), False)
    assert (ref[tag][0]["words"], ref[tag][0]["drift"],
            ref[tag][0]["bound_fraction"]) == (0.0, 0.0, 1.0)
    for rows in _port_rows(port, tag):
        c = rows[0]
        assert (c["words"], c["drift"], c["bound_fraction"],
                c["comm"]) == (0.0, 0.0, 1.0, {})


def test_fused_pair_moves_only_the_redistribute(port, ref):
    tag = ("fused", P_GRID, Q_GRID)
    r = ref[tag][0]
    assert r["redistribute"] == r["words"] == S_N * S_R / WORLD
    for rows in _port_rows(port, tag):
        c = rows[0]
        assert c["redistribute"] == c["words"] == \
            (1 - 1 / WORLD) * S_N * S_R / WORLD


def test_stale_decision_drill_pops_only_the_flagged_key(port):
    for res in port:
        assert [name for name, _ in res["flags"]] == ["drill.stale"]
        assert res["popped"] == ["k/stale"]
        assert res["again"] == []
        assert res["left"] == ["k/fine", "k/other"]


def test_honesty_report_lists_every_site(port):
    lines = port[0]["report"].splitlines()
    assert lines[0].split() == ["site", "calls", "pred_words", "meas_words",
                                "thm_floor", "bound_frac", "drift", "wall_s"]
    for name in set(NAME.values()) | {"drill.stale", "drill.fine"}:
        assert any(ln.startswith(name) for ln in lines[2:]), name


def test_dp_compressed_step_world_two_has_zero_drift():
    """Two gloo workers, one step of reduced gemma2-2b with the exchange
    priced at world 2: the site measures ``grad_compress.COMM``'s words,
    the plan's exchange words plus the loss scalar, and they are the
    reference plan's."""
    import jax
    from repro.configs import get_config as jax_config
    from repro.models import get_api as jax_api
    from repro.plan import plan_train_compression as jplan

    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, 256, (4, 17)).astype(np.int32)
    res = run_workers(dp_step_ledger_worker, 2,
                      dict(rank=4, tokens=toks[:, :-1].copy(),
                           labels=toks[:, 1:].copy()))
    cfg = jax_config("gemma2-2b").reduced()
    shapes = jax.eval_shape(lambda k: jax_api(cfg).init(k, cfg),
                            jax.random.key(0))
    want = jplan(shapes, rank=4, P=2).exchange_words + 1.0
    for r in res:
        assert r["n_compressed"] > 0
        assert r["calls"] == 1
        assert r["measured"] == r["comm"] == r["exchange_words"] + 1 == want
        assert r["by_kind"] == {"allreduce_mean": want}
        assert (r["pred"], r["floor"]) == (want, want)
        assert (r["drift"], r["bound_fraction"]) == (0.0, 1.0)
