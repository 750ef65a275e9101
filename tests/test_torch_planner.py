"""The port's planner (``repro_torch.plan``: ``plan_sketch``,
``plan_nystrom``, ``plan_stream``, ``Plan.execute``, ``explain``,
``regime_sweep``, the seconds objective of ``plan_train_compression``)
against the reference's ``repro.plan``, on the CPU.

Held to:

  * the reference, exactly, on its ``cpu`` machine entry (which the port
    keeps number for number): every candidate's variant, grid, q-grid,
    words, messages and FLOPs, and the plan's bound and regime, on the
    cases of ``tests/test_plan.py`` and more; the chosen variant, grid,
    q-grid and words at P > 1 on those cases.  They are not the same
    wherever P > 1: a Nyström plan's device-memory words price the port's
    bodies, and at q = (1, 1, P) the second stage's ``sketch_t`` draws a
    K × ceil4(m) Omega scratch, which makes the fused candidate
    memory-bound, so the port picks ``alg2_no_redist`` where the
    reference picks ``alg2_bound_driven_fused`` (the ``f1`` cases pin
    three such shapes; ``plan/planner.py``, "What differs").  Variant
    names go through ``NAMES``;
    the reference's second (Pallas) pricing of each distributed variant
    has no counterpart in the port and is left out;
  * at P = 1 the port's own rule, since its device-memory words price
    its own bodies: the executable candidate with the fewest (seconds,
    device-memory words, words), a tie going to the one listed first
    (``cuda_fused`` before ``local_torch``);
  * the reference's invariants as properties: never below the Theorem
    2/3 bound, the closed forms exact, regime 1 on (P, 1, 1), the grid of
    ``select_matmul_grid`` where it is executable;
  * ``Plan.execute`` on one device bitwise the call it names, and within
    ``TOL`` (relative Frobenius) of the reference's ``execute``;
  * on one world of four gloo processes, spawned once
    (``torch_dist_helper.planner_worker``): every distributed variant's
    ``execute``, ``rand_matmul_auto(grid="plan")``,
    ``nystrom_auto(variant="plan")`` / ``plan=``, a sharded stream and a
    grid service placed by a plan, and ``make_sketch_service(grid=
    "auto")``, each bitwise the explicit call, with the words a rank
    receives equal to the explicit call's and at most the plan's.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import nystrom_reference as j_nystrom_reference
from repro.core import sketch_reference as j_sketch_reference
from repro.plan import PRESETS as JPRESETS
from repro.plan import explain as j_explain
from repro.plan import plan_nystrom as j_plan_nystrom
from repro.plan import plan_sketch as j_plan_sketch
from repro.plan import plan_stream as j_plan_stream
from repro.plan import plan_train_compression as j_plan_train
from repro.plan import regime_sweep as j_regime_sweep
from repro_torch.core import nystrom as nys
from repro_torch.core import sketch as sk
from repro_torch.core.grid import (alg1_bandwidth_words, alg2_bandwidth_words,
                                   factorizations_3d, select_matmul_grid)
from repro_torch.core.lower_bounds import (matmul_lower_bound,
                                           nystrom_lower_bound)
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs_trace
from repro_torch.plan import (H100_GLOO, PRESETS, bound_report, explain,
                              explain_train_compression, nystrom_crossover_P,
                              plan_nystrom, plan_sketch, plan_stream,
                              plan_train_compression, regime_sweep,
                              sketch_zero_comm_limit)
from repro_torch.plan import model as M
from repro_torch.plan.planner import _alg1_executable
from repro_torch.stream import SparseRows, StreamConfig, StreamingSketch
from torch_dist_helper import planner_worker, run_workers

CPU, JCPU = PRESETS["cpu"], JPRESETS["cpu"]
H100 = PRESETS[H100_GLOO]
#: the port's variant names that differ from the reference's
NAMES = {"local_torch": "local_xla", "cuda_fused": "pallas_fused"}
TOL = 1e-5
WORLD = 4
SEED = 3

SKETCH_CASES = [
    (64, 256, 16, 32), (16, 1024, 8, 64), (256, 64, 16, 4096),
    (64, 512, 16, 2), (64, 512, 16, 8), (64, 512, 16, 64), (7, 7, 3, 4),
    (16, 48, 8, 4), (2, 48, 8, 4), (4096, 4096, 256, 8),
    (4096, 4096, 256, 65536), (32768, 32768, 512, 4), (64, 256, 16, 1),
    (32, 48, 8, 1), (64, 4096, 32, 1), (4096, 4096, 256, 1)]
NYSTROM_CASES = [
    (4096, 256, 4), (4096, 256, 8), (4096, 256, 16), (49152, 4096, 4),
    (49152, 4096, 64), (30, 7, 8), (64, 16, 4), (64, 8, 16), (64, 2, 4),
    (256, 16, 64), (32768, 512, 4), (64, 16, 1), (32768, 512, 1)]
STREAM_CASES = [
    (64, 256, 16, 1, 16), (64, 256, 16, 8, 16), (16, 48, 8, 4, 4),
    (2, 48, 8, 4, 1), (32768, 32768, 512, 1, 4096),
    (32768, 32768, 512, 4, 4096), (4096, 4096, 256, 65536, None)]
FORCED = ["no_redist", "redist", "bound_driven", "bound_driven_fused"]


def _cands(plan, ref: bool) -> dict:
    """Candidates by (reference name, grid, q_grid); the reference's
    second pricing of a distributed variant (its ``pallas`` body) is left
    out."""
    out = {}
    for c in plan.candidates:
        if ref and c.backend == "pallas" and c.variant != "pallas_fused":
            continue
        name = c.variant if ref else NAMES.get(c.variant, c.variant)
        out[(name, c.grid, c.q_grid)] = c
    return out


def _port_rule(plan):
    """The port's one-card choice, recomputed: the first executable
    candidate, in listed order, with the fewest (seconds, device-memory
    words, words)."""
    ex = [c for c in plan.candidates if c.executable]
    return min(ex, key=lambda c: (c.seconds, c.cost.hbm_words,
                                  c.cost.words))


def _match(j, t) -> None:
    jc, tc = _cands(j, True), _cands(t, False)
    assert set(jc) == set(tc)
    for k, c in jc.items():
        d = tc[k]
        assert (d.cost.words, d.cost.messages, d.cost.flops) == \
            (c.cost.words, c.cost.messages, c.cost.flops), k
        if k[0] != "pallas_fused":
            assert d.executable == c.executable, k
    assert (t.task, t.dims, t.n_procs, t.dtype, t.machine) == \
        (j.task, j.dims, j.n_procs, j.dtype, j.machine)
    assert (t.lower_bound_words, t.regime) == \
        (j.lower_bound_words, j.regime)
    assert (t.chunk_rows, t.corange, t.sketch_l) == \
        (j.chunk_rows, j.corange, j.sketch_l)
    if t.n_procs > 1:
        assert (t.variant, t.grid, t.q_grid, t.kind, t.executable) == \
            (j.variant, j.grid, j.q_grid, j.kind, j.executable)
        assert (t.predicted_words, t.predicted_flops) == \
            (j.predicted_words, j.predicted_flops)
    else:
        chosen = _port_rule(t)
        assert (t.variant, t.predicted_seconds) == \
            (chosen.variant, chosen.seconds)


# ---------------------------------------------------------------------------
# planning, exactly the reference's on the cpu entry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nnz", [None, 100], ids=["dense", "nnz100"])
@pytest.mark.parametrize("n1,n2,r,P", SKETCH_CASES)
def test_plan_sketch_matches_reference(n1, n2, r, P, nnz):
    _match(j_plan_sketch(n1, n2, r, P=P, machine=JCPU, nnz=nnz),
           plan_sketch(n1, n2, r, P=P, machine=CPU, nnz=nnz))


@pytest.mark.parametrize("n,r,P", NYSTROM_CASES)
def test_plan_nystrom_matches_reference(n, r, P):
    _match(j_plan_nystrom(n, r, P=P, machine=JCPU),
           plan_nystrom(n, r, P=P, machine=CPU))


@pytest.mark.parametrize("variant", FORCED)
@pytest.mark.parametrize("n,r,P", [(4096, 256, 8), (64, 2, 4)])
def test_plan_nystrom_forced_matches_reference(n, r, P, variant):
    _match(j_plan_nystrom(n, r, P=P, machine=JCPU, variant=variant),
           plan_nystrom(n, r, P=P, machine=CPU, variant=variant))


@pytest.mark.parametrize("nnz", [None, 1000], ids=["dense", "nnz1000"])
@pytest.mark.parametrize("corange", [False, True], ids=["y", "yw"])
@pytest.mark.parametrize("n1,n2,r,P,k", STREAM_CASES)
def test_plan_stream_matches_reference(n1, n2, r, P, k, corange, nnz):
    _match(j_plan_stream(n1, n2, r, P=P, chunk_rows=k, corange=corange,
                         machine=JCPU, nnz=nnz),
           plan_stream(n1, n2, r, P=P, chunk_rows=k, corange=corange,
                       machine=CPU, nnz=nnz))


def test_sparse_kind_substitution_and_notes_match_reference():
    """A dense kind on a sparse A is run as CountSketch where the sparse
    candidate wins, with the reference's note; the loser is told why."""
    for args, kw in (((64, 4096, 16), {"nnz": 50}),
                     ((64, 4096, 16), {"nnz": 50, "kind": "rowsample"}),
                     ((64, 256, 16), {"nnz": 16000})):
        j = j_plan_sketch(*args, P=1, machine=JCPU, **kw)
        t = plan_sketch(*args, P=1, machine=CPU, **kw)
        jn = {c.variant: c.note for c in j.candidates}
        tn = {c.variant: c.note for c in t.candidates}
        assert tn["local_sparse"] == jn["local_sparse"]
        if t.variant == "local_sparse":
            assert j.variant == "local_sparse" and t.kind == j.kind
    t = plan_sketch(64, 4096, 16, P=1, machine=CPU, nnz=50)
    assert (t.variant, t.kind) == ("local_sparse", "countsketch")
    assert "substitutes countsketch for requested 'normal'" in \
        {c.variant: c.note for c in t.candidates}["local_sparse"]


def test_one_card_rule():
    """At P = 1 the two one-card variants are priced by the port's own
    costs; a tie goes to the kernel (listed first), a split ``sketch_fwd``
    (an f32 work buffer) loses the tie on device-memory words, and a
    sparse kind has no kernel."""
    tie = plan_sketch(64, 256, 16, P=1, machine=CPU)
    assert [c.variant for c in tie.candidates] == ["cuda_fused",
                                                   "local_torch"]
    fused, plain = tie.candidates
    assert fused.cost == M.local_cost(64, 256, 16)
    assert plain.cost == M.local_torch_cost(64, 256, 16)
    assert (fused.seconds, fused.cost.hbm_words) == \
        (plain.seconds, plain.cost.hbm_words)
    assert tie.variant == "cuda_fused"
    split = plan_sketch(64, 4096, 32, P=1, machine=CPU)
    assert split.variant == "local_torch"
    assert split.candidates[1].cost.hbm_words > \
        split.candidates[0].cost.hbm_words
    sparse = plan_sketch(64, 256, 16, P=1, machine=CPU, kind="countsketch")
    fused = next(c for c in sparse.candidates if c.variant == "cuda_fused")
    assert sparse.variant == "local_torch" and not fused.executable
    assert fused.note == "the kernels draw normal, uniform, rademacher only"
    nys_plan = plan_nystrom(64, 16, P=1, machine=CPU)
    assert {c.variant: c.cost for c in nys_plan.candidates} == {
        "cuda_fused": M.nystrom_local_cost(64, 16),
        "local_torch": M.nystrom_local_torch_cost(64, 16)}


def test_h100_entry_plans_at_full_width():
    """On the H100 entry, at A = 32768², r = 512: one card ties the two
    sketch bodies at their FLOPs (2·n1·n2·r / 67 TFLOP/s) and takes the
    kernel; four ranks take (4, 1, 1) at 0 words for Alg. 1 and the
    stream, and no_redist at (1 - 1/4)·r² words for Nyström."""
    one = plan_sketch(32768, 32768, 512, P=1, machine=H100)
    assert one.variant == "cuda_fused"
    assert one.predicted_seconds == 2.0 * 32768 * 32768 * 512 / 67e12
    assert len({c.seconds for c in one.candidates}) == 1
    assert plan_nystrom(32768, 512, P=1, machine=H100).machine == H100_GLOO
    four = plan_sketch(32768, 32768, 512, P=4, machine=H100)
    assert (four.variant, four.grid, four.predicted_words) == \
        ("alg1", (4, 1, 1), 0.0)
    nys4 = plan_nystrom(32768, 512, P=4, machine=H100)
    assert (nys4.variant, nys4.grid, nys4.predicted_words) == \
        ("alg2_no_redist", (4, 1, 1), 196608.0)
    st4 = plan_stream(32768, 32768, 512, P=4, chunk_rows=4096, l=1025,
                      corange=True, machine=H100)
    assert (st4.variant, st4.grid, st4.predicted_words) == \
        ("stream_sharded", (4, 1, 1), 0.0)


def test_plan_defaults_and_dtype():
    """``P=None`` is the world size (1 without a process group),
    ``machine=None`` is ``probe_machine()`` (the cpu entry here), and the
    dtype is a torch dtype or its name."""
    plan = plan_sketch(64, 256, 16)
    assert (plan.n_procs, plan.machine, plan.dtype) == (1, "cpu", "float32")
    for dt in (torch.bfloat16, "bfloat16"):
        bf = plan_sketch(64, 256, 16, P=8, dtype=dt, machine=CPU)
        assert bf.dtype == "bfloat16"
        assert bf.predicted_seconds == j_plan_sketch(
            64, 256, 16, P=8, dtype=jnp.bfloat16,
            machine=JCPU).predicted_seconds
    assert plan_sketch(64, 256, 16, dtype="float", P=1).dtype == "float32"
    with pytest.raises(ValueError, match="unknown dtype"):
        plan_sketch(64, 256, 16, dtype="float7")
    with pytest.raises(ValueError, match="unknown variant"):
        plan_nystrom(64, 16, P=4, variant="two_grid")
    with pytest.raises(ValueError, match="needs P > 1"):
        plan_nystrom(64, 16, P=1, variant="redist")


# ---------------------------------------------------------------------------
# the reference's invariants, as properties
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(n1e=st.integers(0, 6), n2e=st.integers(2, 8),
       re_=st.integers(0, 5), Pe=st.integers(0, 9))
def test_plan_sketch_never_below_bound(n1e, n2e, re_, Pe):
    n1, n2, r, P = 2 ** n1e, 2 ** n2e, 2 ** re_, 2 ** Pe
    if r >= n2 or P > n1 * n2 * r:
        return
    plan = plan_sketch(n1, n2, r, P=P, machine=CPU)
    lb = matmul_lower_bound(n1, n2, r, P)
    assert plan.lower_bound_words == lb
    assert plan.predicted_words >= lb - 1e-9, (plan.variant, plan.grid)
    assert plan.bound_gap_words >= -1e-9
    for c in plan.candidates:
        if c.variant != "alg1_communicating":
            assert c.cost.words >= lb - 1e-9, c


@settings(max_examples=40, deadline=None)
@given(ne=st.integers(4, 9), re_=st.integers(1, 6), Pe=st.integers(0, 8))
def test_plan_nystrom_never_below_bound(ne, re_, Pe):
    n, r, P = 2 ** ne, 2 ** re_, 2 ** Pe
    if r >= n:
        return
    plan = plan_nystrom(n, r, P=P, machine=CPU)
    lb = nystrom_lower_bound(n, r, P)
    assert plan.lower_bound_words == lb
    assert plan.predicted_words >= lb - 1e-9, (plan.variant, plan.grid)
    for c in plan.candidates:
        if c.executable:
            assert c.cost.words >= lb - 1e-9, (c.variant, c.grid, c.q_grid)


@pytest.mark.parametrize("n1,n2,r,P", [(64, 256, 16, 32), (16, 1024, 8, 64),
                                       (256, 64, 16, 4096)])
def test_alg1_choice_is_the_closed_form_on_the_selected_grid(n1, n2, r, P):
    """In each Theorem-2 regime the winner's words are the closed form on
    its grid; the grid is ``select_matmul_grid``'s where that grid runs,
    else the min-words executable factorization."""
    plan = plan_sketch(n1, n2, r, P=P, machine=CPU)
    g = select_matmul_grid(n1, n2, r, P)
    assert (plan.variant, plan.regime, plan.executable) == \
        ("alg1", g.regime, True)
    assert _alg1_executable(n1, n2, r, plan.grid)
    assert plan.predicted_words == alg1_bandwidth_words(n1, n2, r,
                                                        *plan.grid)
    if _alg1_executable(n1, n2, r, g.shape):
        assert plan.grid == g.shape
        assert plan.predicted_words == pytest.approx(
            matmul_lower_bound(n1, n2, r, P), abs=1e-9)
    else:
        assert plan.predicted_words == min(
            alg1_bandwidth_words(n1, n2, r, *c) for c in factorizations_3d(P)
            if _alg1_executable(n1, n2, r, c))


def test_regime_one_is_the_zero_communication_grid():
    for P in (2, 8, 32, 64):
        plan = plan_sketch(64, 512, 16, P=P, machine=CPU)
        assert (plan.regime, plan.grid, plan.predicted_words,
                plan.lower_bound_words) == (1, (P, 1, 1), 0.0, 0.0)
        assert plan.bound_ratio == 1.0
    assert sketch_zero_comm_limit(64) == 64


def test_nystrom_closed_forms_and_crossover():
    for P in (4, 8, 16):
        plan = plan_nystrom(4096, 256, P=P, machine=CPU)
        assert plan.predicted_words == alg2_bandwidth_words(
            4096, 256, plan.grid, plan.q_grid)
    n, r = 49152, 4096
    below = plan_nystrom(n, r, P=4, machine=CPU)
    above = plan_nystrom(n, r, P=64, machine=CPU)
    assert below.variant == "alg2_no_redist"
    assert (above.variant, above.grid, above.q_grid) == \
        ("alg2_bound_driven_fused", (64, 1, 1), (1, 1, 64))
    assert above.predicted_words == M.alg2_fused_cost(
        n, r, (64, 1, 1), (1, 1, 64)).words
    assert above.predicted_words < alg2_bandwidth_words(
        n, r, (64, 1, 1), (1, 1, 64))
    assert nystrom_crossover_P(n, r) == 14


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------

def _report_lines(text: str) -> list:
    """The lines of ``explain`` that both reports print alike: header,
    bound, chosen, predicted words, the regime or crossover line and the
    analytic-only note."""
    keep = ("Plan[", "  Theorem", "  chosen:", "          predicted",
            "  zero-communication", "  redist/no_redist", "  NOTE")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


@pytest.mark.parametrize("make,args", [
    ("sketch", (16, 1024, 8, 64)), ("sketch", (7, 7, 3, 4)),
    ("sketch", (64, 256, 16, 1)), ("nystrom", (4096, 256, 8)),
    ("nystrom", (49152, 4096, 64)), ("nystrom", (64, 2, 4)),
    ("stream", (64, 256, 16, 8))])
def test_explain_matches_reference(make, args):
    jfn, tfn = {"sketch": (j_plan_sketch, plan_sketch),
                "nystrom": (j_plan_nystrom, plan_nystrom),
                "stream": (j_plan_stream, plan_stream)}[make]
    *dims, P = args
    j, t = jfn(*dims, P=P, machine=JCPU), tfn(*dims, P=P, machine=CPU)
    want, got = _report_lines(j_explain(j)), _report_lines(explain(t))
    if P == 1:           # the chosen variant is the port's own
        want = [ln for ln in want if not ln.startswith("  chosen:")]
        got = [ln for ln in got if not ln.startswith("  chosen:")]
    assert got == want
    text = explain(t)
    assert "candidates (best first; * = chosen):" in text
    assert sum(ln.startswith("   * ") for ln in text.splitlines()) == \
        (1 if t.executable else 0)
    rep = bound_report(t)
    assert (rep.regime, rep.words_lower_bound) == (t.regime,
                                                   t.lower_bound_words)


def test_explain_names_the_body_and_the_redistribute():
    text = explain(plan_sketch(64, 256, 16, P=1, machine=CPU))
    assert "Omega drawn once a call into a device-memory scratch" in text
    assert "VMEM" not in text
    forced = dataclasses.replace(plan_sketch(64, 256, 16, P=1, machine=CPU),
                                 variant="local_torch")
    assert "written to device memory by gen_omega" in explain(forced)
    fused = plan_nystrom(49152, 4096, P=64, machine=CPU)
    assert re.search(r"Redistribute of B p->q \(§5.2\) as one all-to-all: "
                     r"\S+ words/proc", explain(fused))
    assert "alg1_communicating" in explain(
        plan_sketch(16, 1024, 8, P=64, machine=CPU))


def test_regime_sweep_matches_reference():
    for jfn, tfn, dims, Ps in (
            (j_plan_sketch, plan_sketch, (4096, 4096, 256), [8, 64, 65536]),
            (j_plan_nystrom, plan_nystrom, (4096, 256), [4, 8, 16, 64])):
        assert regime_sweep(tfn, dims, Ps, machine=CPU) == \
            j_regime_sweep(jfn, dims, Ps, machine=JCPU)
    table = regime_sweep(plan_sketch, (4096, 4096, 256), [1, 8, 65536],
                         machine=CPU)
    lines = table.splitlines()
    assert len(lines) == 5 and "variant" in lines[0]
    assert "cuda_fused" in lines[2]


def test_seconds_objective_matches_reference():
    """Words, decisions and notes of both objectives as the reference's on
    the cpu entry; on the H100 entry the port's own rule."""
    shapes = {"a": (512, 64), "b": (64, 64), "c": (8,), "d": (3, 4, 16),
              "e": (4096, 4096)}
    jtree = {k: jax.ShapeDtypeStruct(s, jnp.float32)
             for k, s in shapes.items()}
    ttree = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    for objective in ("words", "seconds"):
        want = j_plan_train(jtree, rank=8, P=8, objective=objective,
                            machine=JCPU)
        got = plan_train_compression(ttree, rank=8, P=8, objective=objective,
                                     machine=CPU)
        assert got.n_compressed == want.n_compressed
        for d, w in zip(got.decisions, want.decisions, strict=True):
            assert (d.name, d.compress, d.note, d.words, d.raw_seconds) == \
                (w.name, w.compress, w.note, w.words, w.raw_seconds)
        text = explain_train_compression(got)
        assert f"objective={objective}" in text and "sketch s" in text
    h = plan_train_compression(ttree, rank=8, P=8, objective="seconds",
                               machine=H100)
    assert h.machine == H100_GLOO
    for d in h.decisions:
        assert d.compress == (d.r_eff > 0 and d.comp_seconds < d.raw_seconds)
    with pytest.raises(ValueError, match="unknown objective"):
        plan_train_compression(ttree, rank=8, P=8, objective="joules")


# ---------------------------------------------------------------------------
# Plan.execute on one device
# ---------------------------------------------------------------------------

def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def mats():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((32, 48)).astype(np.float32)
    X = rng.standard_normal((48, 6))
    S = (X @ X.T).astype(np.float32)
    sp = A * (rng.random(A.shape) < 0.1)
    return A, S, sp.astype(np.float32)


@pytest.mark.parametrize("variant", ["cuda_fused", "local_torch"])
def test_execute_sketch_bitwise_and_against_reference(mats, variant):
    A, _, _ = mats
    plan = dataclasses.replace(plan_sketch(32, 48, 8, P=1, machine=CPU),
                               variant=variant)
    At = torch.from_numpy(A.copy())
    B = plan.execute(At, seed=SEED, device="cpu")
    direct = (ops.sketch_matmul(At, seed=SEED, r=8) if variant == "cuda_fused"
              else sk.sketch_reference(At, SEED, 8))
    assert torch.equal(B, direct)
    want = j_plan_sketch(32, 48, 8, P=1, machine=JCPU).execute(
        A.copy(), seed=SEED)
    assert _rel(B, want) <= TOL
    assert _rel(B, j_sketch_reference(A.copy(), SEED, 8)) <= TOL


def test_execute_local_sparse(mats):
    _, _, sp = mats
    plan = plan_sketch(32, 48, 8, P=1, machine=CPU, nnz=int((sp != 0).sum()))
    assert (plan.variant, plan.kind) == ("local_sparse", "countsketch")
    B = plan.execute(torch.from_numpy(sp.copy()), seed=SEED, device="cpu")
    assert torch.equal(B, sk.sketch_sparse_apply(
        torch.from_numpy(sp.copy()), SEED, 8, kind="countsketch"))
    want = j_plan_sketch(32, 48, 8, P=1, machine=JCPU,
                         nnz=int((sp != 0).sum())).execute(sp.copy(),
                                                           seed=SEED)
    assert _rel(B, want) <= TOL


@pytest.mark.parametrize("variant", ["cuda_fused", "local_torch"])
def test_execute_nystrom_bitwise_and_against_reference(mats, variant):
    _, S, _ = mats
    plan = dataclasses.replace(plan_nystrom(48, 8, P=1, machine=CPU),
                               variant=variant)
    St = torch.from_numpy(S.copy())
    B, C = plan.execute(St, seed=SEED, device="cpu")
    B0, C0 = (ops.nystrom_fused(St, seed=SEED, r=8)
              if variant == "cuda_fused"
              else nys.nystrom_reference(St, SEED, 8))
    assert torch.equal(B, B0) and torch.equal(C, C0)
    jB, jC = j_plan_nystrom(48, 8, P=1, machine=JCPU).execute(S.copy(),
                                                               seed=SEED)
    assert _rel(B, jB) <= TOL and _rel(C, jC) <= TOL
    jB, jC = j_nystrom_reference(S.copy(), SEED, 8)
    assert _rel(C, jC) <= TOL


@pytest.mark.parametrize("variant", ["stream_local", "stream_sparse"])
@pytest.mark.parametrize("corange", [False, True], ids=["y", "yw"])
def test_execute_stream_bitwise_and_against_reference(mats, variant,
                                                      corange):
    A, _, sp = mats
    M_ = sp if variant == "stream_sparse" else A
    plan = dataclasses.replace(
        plan_stream(32, 48, 8, P=1, chunk_rows=8, corange=corange,
                    machine=CPU), variant=variant)
    st = plan.execute(torch.from_numpy(M_.copy()), seed=SEED, device="cpu")
    ref = StreamingSketch(StreamConfig(n1=32, n2=48, r=8, seed=SEED,
                                       corange=corange), device="cpu")
    for row0 in range(0, 32, 8):
        slab = torch.from_numpy(M_[row0:row0 + 8].copy())
        if variant == "stream_sparse":
            ref.update_rows_sparse(row0, SparseRows.from_dense(slab))
        else:
            ref.update_rows(row0, slab)
    assert torch.equal(st.sketch, ref.sketch)
    assert (st.corange_sketch is None) == (not corange)
    if corange:
        assert torch.equal(st.corange_sketch, ref.corange_sketch)
    jplan = dataclasses.replace(
        j_plan_stream(32, 48, 8, P=1, chunk_rows=8, corange=corange,
                      machine=JCPU), variant=variant)
    jst = jplan.execute(M_.copy(), seed=SEED)
    assert _rel(st.sketch, jst.sketch) <= TOL
    if corange:
        assert _rel(st.corange_sketch, jst.corange_sketch) <= TOL
        st.reconstruct(rank=4)


def test_execute_span_and_refusals(mats):
    A, _, _ = mats
    tracer = obs_trace.install_tracer()
    try:
        plan_sketch(32, 48, 8, P=1, machine=CPU).execute(
            torch.from_numpy(A.copy()), seed=SEED, device="cpu")
        spans = [s for s in tracer.spans if s.name == "plan.execute"]
    finally:
        obs_trace.uninstall_tracer()
    assert len(spans) == 1 and spans[0].cat == "plan"
    assert spans[0].args == {"task": "sketch", "variant": "cuda_fused",
                             "dims": [32, 48, 8], "P": 1}
    bad = plan_sketch(7, 7, 3, P=4, machine=CPU)
    with pytest.raises(ValueError, match=re.escape(
            "plan alg1 for dims=(7, 7, 3), P=4 is analytic-only (no "
            "executable grid divides the shape); pad the shape or change "
            "P")):
        bad.execute(np.zeros((7, 7), np.float32), device="cpu")
    four = plan_sketch(32, 48, 8, P=4, machine=CPU)
    with pytest.raises(ValueError, match="needs the default process group"):
        four.execute(torch.from_numpy(A.copy()), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            plan_sketch(32, 48, 8, P=1, machine=CPU).execute(
                torch.from_numpy(A.copy()))


# ---------------------------------------------------------------------------
# distributed: one world of four gloo processes, spawned once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dist_inputs():
    rng = np.random.default_rng(7)
    A = rng.standard_normal((16, 48)).astype(np.float32)
    X = rng.standard_normal((64, 8))
    return A, (X @ X.T).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(dist_inputs):
    A, S = dist_inputs
    spec = {"seed": SEED,
            "sketch": {"r1": (A, 8), "r2": (A[:2].copy(), 8)},
            "S": S, "s_r": 16, "nystrom_variants": FORCED + ["auto"],
            "stream": {"r1": (A, 8, 4), "r2": (A[:2].copy(), 8, 1)},
            "service": (A, 8)}
    return run_workers(planner_worker, WORLD, spec)


@pytest.mark.parametrize("case", ["r1", "r2"])
def test_distributed_sketch_plans(ranks, dist_inputs, case):
    A, _ = dist_inputs
    M_ = A if case == "r1" else A[:2]
    plan = plan_sketch(*M_.shape, 8, P=WORLD, machine=CPU)
    want = j_sketch_reference(M_.copy(), SEED, 8)
    for res in (r["sketch"][case] for r in ranks):
        assert res["plan"] == (plan.variant, plan.grid, None,
                               plan.predicted_words)
        assert res["auto_grid"] == plan.grid
        assert res["bitwise"] == (True, True)
        w_exec, w_ref, w_auto, w_expl = res["words"]
        assert w_exec == w_ref == w_auto == w_expl == plan.predicted_words
        assert _rel(res["B"], want) <= TOL
    assert plan.grid == ((4, 1, 1) if case == "r1" else (2, 1, 2))
    if case == "r2":
        assert plan.predicted_words > 0


@pytest.mark.parametrize("variant", FORCED + ["auto"])
def test_distributed_nystrom_plans(ranks, dist_inputs, variant):
    _, S = dist_inputs
    plan = plan_nystrom(64, 16, P=WORLD, machine=CPU, variant=variant)
    jB, jC = j_nystrom_reference(S.copy(), SEED, 16)
    name = {"alg2_no_redist": "no_redist", "alg2_redist": "redist"}.get(
        plan.variant, "bound_driven")
    for res in (r["nystrom"][variant] for r in ranks):
        assert res["plan"] == (plan.variant, plan.grid, plan.q_grid,
                               plan.predicted_words)
        assert res["auto_variant"] == name
        assert res["bitwise"] == (True, True)
        w_exec, w_ref, w_auto, w_expl = res["words"]
        assert w_exec == w_ref == w_auto == w_expl
        assert 0 < w_exec <= plan.predicted_words
        assert _rel(res["B"], jB) <= TOL and _rel(res["C"], jC) <= 1e-4
    if variant == "no_redist":
        assert ranks[0]["nystrom"][variant]["words"][0] == \
            plan.predicted_words == (1 - 1 / WORLD) * 16 * 16
    if variant == "auto":
        assert plan.variant == "alg2_no_redist"
        got, B, C, words = ranks[0]["nystrom_plan"]
        assert got == "no_redist" and words == plan.predicted_words
        assert np.array_equal(
            B, ranks[0]["nystrom"]["no_redist"]["B"][:16])


@pytest.mark.parametrize("case", ["r1", "r2"])
def test_distributed_stream_plans(ranks, dist_inputs, case):
    A, _ = dist_inputs
    M_, k = (A, 4) if case == "r1" else (A[:2], 1)
    plan = plan_stream(*M_.shape, 8, P=WORLD, chunk_rows=k, corange=True,
                       machine=CPU)
    ref = StreamingSketch(StreamConfig(n1=M_.shape[0], n2=48, r=8,
                                       seed=SEED), device="cpu")
    ref.update(torch.from_numpy(M_.copy()))
    for res in (r["stream"][case] for r in ranks):
        assert res["plan"] == ("stream_sharded", plan.grid, None,
                               plan.predicted_words)
        assert res["bitwise"] == (True, True, True)
        w_exec, w_ref = res["words"]
        assert w_exec == w_ref == plan.predicted_words
        assert _rel(res["Y"], ref.sketch) <= TOL
        assert _rel(res["W"], ref.corange_sketch) <= TOL
    assert (plan.predicted_words > 0) == (case == "r2")


def test_distributed_make_sketch_service_auto(ranks):
    for res in (r["service"] for r in ranks):
        assert res["grid"] == res["ref_grid"] == (WORLD, 1, 1)
        assert res["bitwise"]
        assert res["words"][0] == res["words"][1]


# ---------------------------------------------------------------------------
# where the P > 1 Nyström pick departs from the reference's
# ---------------------------------------------------------------------------

#: (n, r, P, the reference's pick's words, the port's pick's words)
F1_CASES = [(256, 128, 32, 992, 15872), (4096, 256, 256, 4080, 65280),
            (8192, 4096, 4096, 8190, 16773120)]


@pytest.mark.parametrize("n,r,P,ref_words,port_words", F1_CASES,
                         ids=["f1-256-128-32", "f1-4096-256-256",
                              "f1-8192-4096-4096"])
def test_nystrom_pick_departs_where_the_sketch_t_scratch_is_priced(
        n, r, P, ref_words, port_words):
    """The reference picks the fused pair on q = (1, 1, P); the port
    prices that candidate at the same words, messages and FLOPs, but its
    ``sketch_t`` draws the whole K × ceil4(m) Omega slab of the thin
    (r, r/P) output into a scratch, so the candidate is memory-bound and
    slower than ``alg2_no_redist``, which the port picks although it moves
    more words.  A ``sketch_t`` with no scratch for thin outputs would
    move these picks back; such a change updates this test's body under
    the same ids."""
    j = j_plan_nystrom(n, r, P=P, machine=JCPU)
    t = plan_nystrom(n, r, P=P, machine=CPU)
    assert (j.variant, j.grid, j.q_grid) == (
        "alg2_bound_driven_fused", (P, 1, 1), (1, 1, P))
    assert (t.variant, t.grid, t.q_grid) == (
        "alg2_no_redist", (P, 1, 1), (P, 1, 1))
    assert (j.predicted_words, t.predicted_words) == (ref_words, port_words)
    assert t.executable and j.executable
    fused = _cands(t, False)[("alg2_bound_driven_fused", (P, 1, 1),
                              (1, 1, P))]
    jfused = _cands(j, True)[("alg2_bound_driven_fused", (P, 1, 1),
                              (1, 1, P))]
    assert (fused.cost.words, fused.cost.messages, fused.cost.flops) == (
        jfused.cost.words, jfused.cost.messages, jfused.cost.flops)
    assert fused.cost.words == ref_words and fused.executable
    assert fused.cost.bottleneck(CPU) == "memory"
    assert fused.seconds > t.predicted_seconds
    assert fused.cost.hbm_words > jfused.cost.hbm_words
    # the scratch: the K × ceil4(m) slab of stage 2's (r, r/P) output
    from repro_torch.kernels.sketch_matmul import sketch_t_plan
    plan = sketch_t_plan(r, r // P, n)
    assert plan["scratch_bytes"] == 4 * n * (-(-r // 4) * 4)


def test_sketch_t_scratch_of_a_thin_output_is_the_whole_slab():
    """``sketch_t_plan(4096, 1, 65536)``: a 4096 × 1 output draws a
    1,073,741,824-byte Omega scratch (F1's reason at n = 65536)."""
    from repro_torch.kernels.sketch_matmul import sketch_t_plan
    assert sketch_t_plan(4096, 1, 65536)["scratch_bytes"] == 1073741824
