"""Shape-lattice admission for the serving daemon: the reference's
module, copied (pure Python, integers on shapes).  On the card a new
shape in a warm process costs nothing measurable, so what the lattice
buys the port is a bounded, pre-warmed key set and the record of the
grid's decision, not a saved compile; the reference's account follows.

Round 20 (the reference):

`exec_key` binds the exact padded frame shape (serving/excache.py), so
real traffic with arbitrary image sizes fragments the executable cache
into unbounded cardinality and every never-seen size pays a
multi-second XLA compile.  This module bounds the key space by the
LATTICE instead of by traffic: incoming frames are canonicalized onto
a small geometric grid of bucket shapes — edge-padded up to the
smallest bucket that contains them at ingest, cropped back to the
client's shape at demux (the batch runner's mesh-padding trim idiom
from round 12, applied per request) — so every client size inside the
lattice's bounds lands on one of `len(rungs)^2 x len(channels)`
executables, all of which warmup precompiles before the port announce.

Geometry: one rung ladder shared by both axes.  Rungs start at
`min_side` and grow by `growth` (ceil), with the top rung clamped to
exactly `max_side`; `bucket_for(h, w)` rounds each axis up to its
smallest rung independently, so a 100x30 frame pays a 100-class rung
on H and a 30-class rung on W rather than a square superset.

Bypass rule (stated, not hidden): a frame with EITHER axis above the
top rung leaves the lattice entirely and takes the round-13 exact-key
path — an honest cache miss with its own compile, booked under the
`path="bypass"` admission counter, never a silent crop or a refused
request.  Frames below `min_side` (down to 1x1) pad UP to the bottom
rung: the lattice's floor is also the daemon's degenerate-frame
armor.  Session traffic (video) bypasses the lattice by design — a
stream's carried NNF state is sized to its true frame shape and its
executables are keyed at the batch-1 grain.

Semantics contract (the honest version): synthesis is
shape-dependent — PatchMatch propagation is global and the PRNG
streams are shape-keyed — so for an off-bucket frame the engine runs
on the PADDED canvas and the client receives the crop of that padded
synthesis.  That output is bit-identical to what the unbucketed
daemon would serve for the same frame edge-padded client-side
(`crop(serve(pad(F))) == lattice(F)`, the check_lattice.py sentinel),
and deterministic/replay-safe (journal replay re-buckets the raw
manifest under the same lattice config and reproduces the bytes) —
but it is NOT the pixel-exact answer of an exact-shape run.  Frames
exactly ON a bucket shape are untouched and bit-identical to the
lattice-off path.

Bucket choice is a priced trade, not a default: coarser growth means
fewer executables (less warmup compile, smaller cache residency) but
more pad waste on every request; finer growth inverts it.
`plan_lattice` makes the trade a planner-style recorded decision
(parallel/plan2d.py's idiom): enumerate candidate growth factors,
price each as `n_buckets x compile-unit + expected-waste x waste
penalty`, choose deterministically, and record the chosen candidate
plus every rejected alternative so `/serving` and the LATTICE
artifact show why THIS grid and what it beat.  An explicit
`--lattice MIN:MAX:GROWTH` skips the planner (source="override",
nothing rejected — the operator decided).

All arithmetic is host-side integers on shapes; the lattice never
touches a device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

# The warmup manifest's own floor (excache.load_warmup_manifest):
# a lattice rung below it could not be precompiled through the
# manifest path, so the lattice refuses to exist there.
MIN_RUNG = 8

# Growth factors the planner prices when --lattice gives no explicit
# one.  Deterministic enumeration order; ties break toward the FIRST
# (coarsest) candidate.
PLAN_GROWTHS = (2.0, 1.5, 1.3, 1.2)

# Score model constants (plan2d's _DELEAN_PENALTY discipline: modeled,
# not measured — their job is ordinal).  Each bucket is one warmup
# compile + one resident executable set: 1 unit.  Expected pad waste
# multiplies EVERY request's compute for the lattice's whole lifetime,
# so a unit of waste fraction is priced at many compile-units.
_COMPILE_UNIT = 1.0
_WASTE_PENALTY = 40.0


@dataclasses.dataclass(frozen=True)
class LatticeConfig:
    """The lattice's declared bounds.  `growth` None means the planner
    picks from PLAN_GROWTHS; an explicit value is an override."""

    min_side: int = 32
    max_side: int = 512
    growth: Optional[float] = None
    channels: Tuple[int, ...] = (3,)

    def __post_init__(self):
        if self.min_side < MIN_RUNG:
            raise ValueError(
                f"lattice min_side {self.min_side} < {MIN_RUNG} (the "
                "warmup manifest's shape floor)"
            )
        if self.max_side < self.min_side:
            raise ValueError(
                f"lattice max_side {self.max_side} < min_side "
                f"{self.min_side}"
            )
        if self.growth is not None and not 1.0 < self.growth <= 8.0:
            raise ValueError(
                f"lattice growth {self.growth} not in (1.0, 8.0]"
            )
        if not self.channels or any(
            c not in (1, 3) for c in self.channels
        ):
            raise ValueError(
                f"lattice channels {self.channels!r} must be a "
                "non-empty subset of (1, 3)"
            )


def parse_lattice_spec(spec: Optional[str]) -> Optional[LatticeConfig]:
    """`--lattice` value -> LatticeConfig (None = lattice off).

    Accepted forms:
      off | none | (empty)   lattice disabled
      on | default           default bounds, planner-chosen growth
      MIN:MAX                explicit bounds, planner-chosen growth
      MIN:MAX:GROWTH         fully explicit (planner skipped)
    """
    if spec is None:
        return None
    s = spec.strip().lower()
    if s in ("", "off", "none", "0", "false"):
        return None
    if s in ("on", "default", "auto"):
        return LatticeConfig()
    parts = s.split(":")
    if len(parts) not in (2, 3):
        raise ValueError(
            f"--lattice {spec!r}: expected off|on|MIN:MAX|"
            "MIN:MAX:GROWTH"
        )
    try:
        min_side, max_side = int(parts[0]), int(parts[1])
        growth = float(parts[2]) if len(parts) == 3 else None
    except ValueError:
        raise ValueError(
            f"--lattice {spec!r}: MIN/MAX must be integers, GROWTH a "
            "float"
        ) from None
    return LatticeConfig(
        min_side=min_side, max_side=max_side, growth=growth
    )


def _rungs(min_side: int, max_side: int,
           growth: float) -> Tuple[int, ...]:
    """The geometric ladder, bottom rung `min_side`, each subsequent
    rung ceil(prev x growth) (at least +1 so the ladder always
    climbs), top rung clamped to exactly `max_side`."""
    out = [int(min_side)]
    r = int(min_side)
    while r < max_side:
        r = max(r + 1, int(math.ceil(r * growth)))
        out.append(min(r, int(max_side)))
    return tuple(dict.fromkeys(out))


class ShapeLattice:
    """The admission grid: a resolved rung ladder + bucket lookup."""

    def __init__(self, config: LatticeConfig,
                 growth: Optional[float] = None):
        g = growth if growth is not None else config.growth
        if g is None:
            raise ValueError(
                "ShapeLattice needs a resolved growth (run "
                "plan_lattice, or give LatticeConfig an explicit one)"
            )
        self.config = config
        self.growth = float(g)
        self.rungs: Tuple[int, ...] = _rungs(
            config.min_side, config.max_side, self.growth
        )

    @property
    def top(self) -> int:
        return self.rungs[-1]

    @property
    def size(self) -> int:
        """The exec-key cardinality bound the lattice guarantees for
        in-bounds sessionless traffic."""
        return len(self.rungs) ** 2 * len(self.config.channels)

    def bucket_for(self, h: int, w: int) -> Optional[Tuple[int, int]]:
        """Smallest (bh, bw) rung pair containing (h, w), each axis
        independently; None when either axis exceeds the top rung
        (the bypass verdict — exact-key path)."""
        if h > self.top or w > self.top:
            return None
        bh = next(r for r in self.rungs if r >= h)
        bw = next(r for r in self.rungs if r >= w)
        return bh, bw

    @staticmethod
    def waste_frac(h: int, w: int, bh: int, bw: int) -> float:
        """Fraction of the bucket canvas that is pad, for this frame:
        the per-request price of admission."""
        return 1.0 - (h * w) / float(bh * bw)

    def shapes(self) -> List[Dict[str, int]]:
        """Every bucket as a warmup-manifest entry — the full grid
        (rungs^2 per channel count), which IS the set warmup
        precompiles so a fresh replica is warm for all of them before
        the port announce."""
        return [
            {"height": bh, "width": bw, "channels": c}
            for c in self.config.channels
            for bh in self.rungs
            for bw in self.rungs
        ]

    def snapshot(self) -> Dict[str, Any]:
        return {
            "min_side": self.config.min_side,
            "max_side": self.config.max_side,
            "growth": self.growth,
            "rungs": list(self.rungs),
            "buckets": self.size,
            "channels": list(self.config.channels),
        }


@dataclasses.dataclass(frozen=True)
class LatticeCandidate:
    """One growth factor, priced."""

    growth: float
    rungs: Tuple[int, ...]
    buckets: int               # executables the grid costs (per full grid)
    worst_waste_frac: float    # worst in-bounds single-request pad waste
    expected_waste_frac: float  # uniform-size-mix expected pad waste
    score: float               # buckets x compile + waste x penalty (lower wins)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["rungs"] = list(self.rungs)
        return d


@dataclasses.dataclass(frozen=True)
class LatticePlan:
    """Planner verdict: chosen grid + the full rejected field (the
    plan2d recorded-decision idiom, applied to bucket geometry)."""

    lattice: ShapeLattice
    chosen: LatticeCandidate
    rejected: Tuple[LatticeCandidate, ...]
    source: str = "planner"    # "planner" | "override"

    def as_dict(self) -> dict:
        return {
            "source": self.source,
            "lattice": self.lattice.snapshot(),
            "chosen": self.chosen.as_dict(),
            "rejected": [c.as_dict() for c in self.rejected],
            "score_model": {
                "compile_unit": _COMPILE_UNIT,
                "waste_penalty": _WASTE_PENALTY,
            },
        }


def _price(config: LatticeConfig, growth: float) -> LatticeCandidate:
    rungs = _rungs(config.min_side, config.max_side, growth)
    buckets = len(rungs) ** 2 * len(config.channels)
    # Per-axis fill for a frame landing in (r_{k-1}, r_k]: h/r_k.
    # Worst case h = r_{k-1}+1; uniform-mix expectation is the mean of
    # the gap, (r_{k-1}+1+r_k)/2 / r_k.  The below-min region (frames
    # under the bottom rung) is excluded — its waste is set by
    # min_side, identical across growth candidates, so it cannot order
    # them.  A single-rung ladder has no inter-rung gap: fill 1.0.
    worst_fill = 1.0
    mean_fill = 1.0
    if len(rungs) > 1:
        worst_fill = min(
            (lo + 1) / float(hi)
            for lo, hi in zip(rungs, rungs[1:])
        )
        mean_fill = min(
            (lo + 1 + hi) / (2.0 * hi)
            for lo, hi in zip(rungs, rungs[1:])
        )
    worst_waste = 1.0 - worst_fill ** 2
    expected_waste = 1.0 - mean_fill ** 2
    score = buckets * _COMPILE_UNIT + expected_waste * _WASTE_PENALTY
    return LatticeCandidate(
        growth=growth, rungs=rungs, buckets=buckets,
        worst_waste_frac=round(worst_waste, 4),
        expected_waste_frac=round(expected_waste, 4),
        score=round(score, 3),
    )


def plan_lattice(config: LatticeConfig) -> LatticePlan:
    """Resolve a LatticeConfig into a priced, recorded grid choice.

    An explicit `growth` is an override: priced (so the artifact still
    shows its waste/bucket numbers) but never second-guessed, with
    nothing rejected.  Otherwise every PLAN_GROWTHS candidate is
    priced and the lowest score wins (first minimum — enumeration is
    coarsest-first, so exact ties break toward fewer executables)."""
    if config.growth is not None:
        chosen = _price(config, config.growth)
        return LatticePlan(
            ShapeLattice(config), chosen, (), source="override"
        )
    cands = [_price(config, g) for g in PLAN_GROWTHS]
    best = min(cands, key=lambda c: c.score)
    rejected = tuple(c for c in cands if c is not best)
    return LatticePlan(
        ShapeLattice(config, growth=best.growth), best, rejected
    )
