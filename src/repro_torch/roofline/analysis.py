"""Three-term roofline of the port's calls on the card (the reference's
``roofline/analysis.py``):

    compute term    = sum over dtypes of FLOPs / (chips * peak FLOP/s of it)
    memory term     = device bytes     / (chips * hbm_bw)
    collective term = collective bytes / (chips * link_bw)

The reference prices a compiled TPU program's HLO.  The port has no
compiled executable, so its counts are those of :mod:`.counts`, taken as
a call runs (:func:`analyze_call`, :func:`analyze_counts`), or those of a
``plan.model`` :class:`Cost` (:func:`analyze_cost`: the analytic
roofline, the role of the reference's ahead-of-time analysis).

The rates are the card's, never a TPU's (:data:`H100`,
:func:`h100_rates`); each :class:`RooflineTerms` names the rates it was
priced on (``peak_flops``, ``hbm_bw``, ``link_bw``).  ``link_bw`` is the
H100 entry's ``byte_bw``: the fit of four gloo ranks that share one card
and stage their words through host memory (``plan/h100_sweep.json``),
not NVLink.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import asdict, dataclass, field
from typing import Dict, Mapping, Optional, Sequence, Union

import torch

from .counts import WORD_BYTES, WorkCounts, counting, sum_counts

#: The card the port's rooflines are priced for, as ``nvidia-smi
#: --query-gpu=name,power.limit --format=csv,noheader`` prints it, and its
#: dense bf16 tensor-core peak (NVIDIA's H100 SXM datasheet, at 700 W).
#: Its float32 rate (outside the tensor cores: the port's kernels, and
#: torch's f32 GEMMs with TF32 off), its device-memory rate and its link
#: rate are those of ``plan.model``'s entry named here.
H100 = {"card": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0,
        "machine": "h100_gloo_1card", "bfloat16_flops": 989.4e12}


@dataclass(frozen=True)
class Rates:
    """What a roofline is priced on: peak FLOP/s by the dtype a
    contraction runs in, device-memory and link bytes/s, and the card
    they belong to."""
    card: str
    power_limit_w: float
    peak_flops: Mapping[str, float]
    hbm_bw: float
    link_bw: float

    def peak(self, dtype: str) -> float:
        if dtype not in self.peak_flops:
            raise ValueError(f"no {dtype} peak for {self.card} (it has "
                             f"{', '.join(self.peak_flops)})")
        return self.peak_flops[dtype]


def h100_rates() -> Rates:
    """:data:`H100`'s rates."""
    # plan.model is imported here, not at the top: the kernels' dispatch
    # imports this package, and plan imports the kernels.
    from repro_torch.plan.model import PRESETS
    m = PRESETS[H100["machine"]]
    return Rates(card=H100["card"], power_limit_w=H100["power_limit_w"],
                 peak_flops={"float32": m.flop_rate,
                             "bfloat16": H100["bfloat16_flops"]},
                 hbm_bw=m.hbm_bw, link_bw=m.byte_bw)


@dataclass
class RooflineTerms:
    """The reference's fields, names and properties.  ``hlo_flops`` and
    ``hlo_bytes`` keep the reference's names for the counted FLOPs and
    device bytes (fleet totals); ``raw_flops`` / ``raw_bytes`` (its
    uncorrected ``cost_analysis``) have no counterpart and stay None.
    ``peak_flops``, ``hbm_bw`` and ``link_bw`` are the rates the terms
    were priced on; ``peak_flops`` is the peak of the dtype that holds
    most of the counted FLOPs (float32 when none is counted)."""
    name: str
    chips: int
    # global (fleet) quantities
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    # derived times (seconds)
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    # usefulness
    model_flops: Optional[float] = None
    useful_ratio: Optional[float] = None
    raw_flops: Optional[float] = None
    raw_bytes: Optional[float] = None
    # extras
    per_device_peak_memory: Optional[float] = None
    collective_counts: Dict[str, int] = field(default_factory=dict)
    collective_by_kind: Dict[str, float] = field(default_factory=dict)
    notes: str = ""
    # the rates it was priced on
    peak_flops: Optional[float] = None
    hbm_bw: Optional[float] = None
    link_bw: Optional[float] = None

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the step that is *useful* compute at peak, under the
        max-of-terms execution model: (model_flops/peak/chips) / t_bound."""
        if not self.model_flops or self.t_bound <= 0:
            return 0.0
        if not self.peak_flops:
            raise ValueError(f"{self.name}: roofline_fraction needs the "
                             f"peak_flops the terms were priced on")
        ideal = self.model_flops / (self.chips * self.peak_flops)
        return ideal / self.t_bound

    def to_dict(self):
        d = asdict(self)
        d["t_bound"] = self.t_bound
        d["roofline_fraction"] = self.roofline_fraction
        return d


def analyze_counts(name: str, counts: Union[WorkCounts,
                                            Sequence[WorkCounts]],
                   chips: int, model_flops: Optional[float] = None,
                   machine: Optional[Rates] = None,
                   notes: str = "") -> RooflineTerms:
    """Roofline terms of counted work (the reference's
    ``analyze_compiled``).  ``counts`` is one :class:`WorkCounts` a rank
    (``chips`` of them, summed for the fleet), or one rank's standing for
    every rank (multiplied by ``chips``, as the reference multiplies its
    per-device program).  As the reference's, ``collective_counts`` are a
    device's (the most calls of a kind on any rank) and every other
    quantity the fleet's.  ``machine`` defaults to :func:`h100_rates`."""
    rates = machine or h100_rates()
    if isinstance(counts, WorkCounts):
        counts = [counts] * chips
    if len(counts) != chips:
        raise ValueError(f"{name}: {len(counts)} ranks' counts for "
                         f"{chips} chips")
    c = sum_counts(counts)
    t_c = sum(f / (chips * rates.peak(d))
              for d, f in c.flops_by_dtype.items())
    t_m = c.hbm_bytes / (chips * rates.hbm_bw)
    t_l = c.collective_bytes / (chips * rates.link_bw)
    terms = {"compute": t_c, "memory": t_m, "collective": t_l}
    top = max(c.flops_by_dtype, key=c.flops_by_dtype.get, default="float32")
    return RooflineTerms(
        name=name, chips=chips,
        hlo_flops=c.flops, hlo_bytes=c.hbm_bytes,
        collective_bytes=c.collective_bytes,
        t_compute=t_c, t_memory=t_m, t_collective=t_l,
        bottleneck=max(terms, key=terms.get),
        model_flops=model_flops,
        useful_ratio=(model_flops / c.flops) if (model_flops and c.flops)
        else None,
        collective_counts={k: max(r.collective_counts.get(k, 0)
                                  for r in counts)
                           for k in c.collective_counts},
        collective_by_kind=dict(c.collective_by_kind),
        notes=notes, peak_flops=rates.peak(top), hbm_bw=rates.hbm_bw,
        link_bw=rates.link_bw)


def analyze_call(name: str, fn, *, chips: int = 1,
                 model_flops: Optional[float] = None,
                 machine: Optional[Rates] = None,
                 device=None) -> RooflineTerms:
    """Run ``fn()`` once to warm it, then once under :func:`counting`, and
    price what it counted.  ``device=None`` means the card and raises
    without one (``device="cpu"`` to count on the CPU); on the card each
    call ends in a synchronize and ``per_device_peak_memory`` is the
    call's ``max_memory_allocated``.  With ``chips > 1`` every rank of a
    ``chips``-rank default process group calls it: the ranks' counts are
    gathered and summed, and every rank gets the fleet's terms."""
    from repro_torch.core.rng import resolve_device
    device = resolve_device(device)
    cuda = device.type == "cuda"
    fn()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    with counting() as counts:
        fn()
        if cuda:
            torch.cuda.synchronize(device)
    peak = float(torch.cuda.max_memory_allocated(device)) if cuda else None
    if chips > 1:
        import torch.distributed as dist
        if not dist.is_initialized() or dist.get_world_size() != chips:
            raise ValueError(f"{name}: chips={chips} needs a default "
                             f"process group of {chips} ranks")
        every = [None] * chips
        dist.all_gather_object(every, (dataclasses.asdict(counts), peak))
        counts = [WorkCounts(**c) for c, _ in every]
        peak = max(p for _, p in every) if cuda else None
    terms = analyze_counts(name, counts, chips, model_flops, machine)
    terms.per_device_peak_memory = peak
    return terms


def analyze_cost(name: str, cost, chips: int = 1,
                 model_flops: Optional[float] = None,
                 machine: Optional[Rates] = None,
                 notes: str = "") -> RooflineTerms:
    """The analytic roofline of a ``plan.model`` :class:`Cost` (one
    processor's words, FLOPs and device-memory words; the port's bodies
    compute in f32): a rank's counts standing for every rank."""
    counts = WorkCounts(
        flops=float(cost.flops),
        flops_by_dtype={"float32": float(cost.flops)} if cost.flops else {},
        hbm_bytes=float(cost.hbm_words) * WORD_BYTES,
        collective_bytes=float(cost.words) * WORD_BYTES)
    return analyze_counts(name, counts, chips, model_flops, machine, notes)


def format_table(rows, keys=("name", "chips", "hlo_flops", "hlo_bytes",
                             "collective_bytes", "t_compute", "t_memory",
                             "t_collective", "bottleneck", "useful_ratio",
                             "roofline_fraction")) -> str:
    def fmt(v):
        if isinstance(v, float):
            return f"{v:.3e}" if (abs(v) >= 1e4 or 0 < abs(v) < 1e-3) else f"{v:.4f}"
        return str(v)
    dicts = [r.to_dict() if hasattr(r, "to_dict") else dict(r) for r in rows]
    widths = {k: max(len(k), *(len(fmt(d.get(k, ""))) for d in dicts))
              for k in keys}
    head = " | ".join(k.ljust(widths[k]) for k in keys)
    sep = "-+-".join("-" * widths[k] for k in keys)
    body = "\n".join(" | ".join(fmt(d.get(k, "")).ljust(widths[k]) for k in keys)
                     for d in dicts)
    return f"{head}\n{sep}\n{body}"


def save_json(rows, path: str):
    data = [r.to_dict() if hasattr(r, "to_dict") else dict(r) for r in rows]
    with open(path, "w") as f:
        json.dump(data, f, indent=2, default=str)
