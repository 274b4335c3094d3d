"""The retry engine of the counting path and its fault injection
(counterpart of `repro.core.resilience`).

`RetryPolicy` holds the per-cause caps, growth factors and the total round
budget; `RetryController` holds the state of one call: the call site runs an
attempt, feeds its drop counters to `observe()`, and either replays (the
controller grew the right knob and recorded the round) or returns. A
give-up raises `CapacityExhausted` or `RetryBudgetExceeded` with the
bounded round history.

`FaultPlan` (on `DAKCConfig.faults`) injects one seeded, deterministic
fault at a named site:

- 'route_drop': drop a seeded fraction of a chunk's routed entries,
  charged as routing overflow (a slack-doubling round);
- 'store_drop': drop a seeded fraction of a chunk's store inserts,
  optionally only once the store holds `fill` of its capacity, charged as
  store overflow (a rehash round); streaming receiver only;
- 'hop2_misfit': force the compact hop-2 tile to 1 slot, so the round
  falls back to the padded tile;
- 'update_fail': raise `InjectedFault` from the Nth `KmerCounter.update`
  before anything commits;
- 'ckpt_write': tear a leaf file of `KmerCounter.save` after
  `fail_after` complete leaves and raise `InjectedFault` before the
  checkpoint's rename;
- 'spill_write': tear the spill tier's segment write after `fail_after`
  complete writes and raise `InjectedFault` (nothing enters the
  manifest);
- 'bin_corrupt': flip bytes in a sealed segment of bin `bin` once it is
  committed, so the drain or a query raises `spill.SpillCorrupt`.

A fault that stops firing after `rounds` attempts lets the retry engine
recover the fault-free histogram; a persistent one drives the give-ups.
The masks are a pure function of (seed, site, element index, chunk index)
through the 32-bit avalanche mixer, bit-equal to the JAX package's.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import owner

# Retry causes -- the three overflow disciplines of the counting pipeline.
ROUTE_SLACK = "route-slack"
STORE_REHASH = "store-rehash"
HOP2_FALLBACK = "hop2-padded-fallback"
CAUSES = (ROUTE_SLACK, STORE_REHASH, HOP2_FALLBACK)

# Named fault sites: the first two are masks inside the scan, the rest act
# on the host.
TRACE_SITES = ("route_drop", "store_drop")
SITES = TRACE_SITES + ("hop2_misfit", "update_fail", "ckpt_write",
                       "spill_write", "bin_corrupt")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounds and growth factors of the one retry engine.

    Hashable and frozen: it rides the frozen `DAKCConfig`. Routing slack doubles and gives up once it EXCEEDS `max_slack`; the
    store doubles and gives up once its capacity EXCEEDS
    `store_cap_ceiling`; the compact hop 2 falls back to the padded tile
    at most once (there is no third capacity). `max_rounds` is a total
    replay budget across all causes -- a backstop against pathological
    cause ping-pong, set above any legitimate doubling ladder (a 1-slot
    store reaching the ceiling is ~28 rehash rounds). `max_history` caps
    the retained round history (first round + ring of the most recent
    `max_history - 1`); it bounds payload size only, never the budget.
    """
    max_slack: float = 8.0
    slack_growth: float = 2.0
    store_cap_ceiling: int = 1 << 28
    store_growth: int = 2
    max_rounds: int = 40
    max_history: int = 25

    def __post_init__(self):
        if self.max_slack <= 0 or self.slack_growth <= 1:
            raise ValueError(
                f"need max_slack > 0 and slack_growth > 1, got "
                f"{self.max_slack}/{self.slack_growth}")
        if self.store_cap_ceiling < 1 or self.store_growth < 2:
            raise ValueError(
                f"need store_cap_ceiling >= 1 and store_growth >= 2, got "
                f"{self.store_cap_ceiling}/{self.store_growth}")
        if self.max_rounds < 1:
            raise ValueError(f"max_rounds must be >= 1, got {self.max_rounds}")
        if self.max_history < 2:
            raise ValueError(
                f"max_history must be >= 2 (first + at least one recent "
                f"round), got {self.max_history}")


class RetryRound(NamedTuple):
    """One replayed round, as recorded in error histories and telemetry."""
    round: int                 # 0-based attempt index that overflowed
    causes: Tuple[str, ...]    # which disciplines fired (subset of CAUSES)
    slack: float               # routing slack the round ran at
    store_cap: int             # per-PE store slots the round ran at
    hop2_padded: bool          # whether hop 2 was already on the padded tile
    route_dropped: int
    store_dropped: int
    hop2_dropped: int


class RetryError(RuntimeError):
    """Base of the typed give-up errors; carries the (bounded) round
    history plus the controller's own per-cause replay counts, so a
    caller that escalates instead of dying (the fabsp spill tier) can
    fold the doomed attempt's replays into its lifetime totals."""

    def __init__(self, msg: str, rounds, counts=None):
        super().__init__(msg)
        self.rounds: Tuple[RetryRound, ...] = tuple(rounds)
        self.counts: Dict[str, int] = dict(counts or {})


class CapacityExhausted(RetryError):
    """A per-cause cap was hit (slack past `max_slack` / store past
    `store_cap_ceiling`) while that cause was still dropping entries."""

    def __init__(self, msg: str, cause: str, rounds, counts=None):
        super().__init__(msg, rounds, counts)
        self.cause = cause


class RetryBudgetExceeded(RetryError):
    """The total replay budget (`RetryPolicy.max_rounds`) ran out."""


class RehashInvariantBroken(RetryError):
    """A rehash round dropped live entries -- impossible by construction
    (the grown table is strictly larger than the live-entry count), so
    reaching this means store state corruption, not capacity pressure.
    Raised with the stream's round history and lifetime replay counts
    attached (the same forensic payload as the give-up errors), because
    the history of WHICH rounds grew the store is exactly what debugging
    a broken rehash needs."""

    def __init__(self, msg: str, rounds, counts=None, dropped: int = 0):
        super().__init__(msg, rounds, counts)
        self.dropped = int(dropped)


class InjectedFault(RuntimeError):
    """Raised by the host-side fault sites ('update_fail', 'ckpt_write',
    'spill_write')."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded deterministic fault injection: one named site per plan.

    Hashable and frozen, as it rides the frozen `DAKCConfig`.

    site:       one of `SITES` (see the module docstring).
    seed:       drives the in-trace drop masks.
    chunk:      scan step the in-trace sites fire at (-1: every step).
    frac:       fraction of eligible entries dropped at that step.
    fill:       'store_drop' only: fire only once the store holds at least
                this fraction of its capacity.
    rounds:     how many attempts of one call or batch the fault fires for;
                1 faults the first round only, a large value persists.
    update_n:   'update_fail' only: which `KmerCounter.update` call dies.
    fail_after: 'ckpt_write' / 'spill_write' only: complete leaf or
                segment writes before the torn one.
    bin:        'bin_corrupt' only: the bin whose sealed segment is hit.
    """
    site: str
    seed: int = 0
    chunk: int = 0
    frac: float = 0.5
    fill: float = 0.0
    rounds: int = 1
    update_n: int = 0
    fail_after: int = 0
    bin: int = 0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites are {SITES}")
        if not 0.0 < self.frac <= 1.0:
            raise ValueError(f"frac must be in (0, 1], got {self.frac}")
        if not 0.0 <= self.fill < 1.0:
            raise ValueError(f"fill must be in [0, 1), got {self.fill}")
        if self.rounds < 1 or self.update_n < 0 or self.fail_after < 0 \
                or self.bin < 0:
            raise ValueError(
                "rounds must be >= 1; update_n/fail_after/bin >= 0")

    def fires(self, attempt: int) -> bool:
        """Whether the fault is armed for the given 0-based attempt."""
        return attempt < self.rounds


def active_trace_fault(plan: Optional[FaultPlan],
                       attempt: int) -> Optional[FaultPlan]:
    """The plan, iff it has an in-trace site armed for this attempt."""
    if plan is not None and plan.site in TRACE_SITES and plan.fires(attempt):
        return plan
    return None


# Per-site salts decorrelate the masks of sites sharing one seed.
_SITE_SALT = {"route_drop": 0x9E3779B9, "store_drop": 0x85EBCA6B}


def fault_mask(n: int, plan: FaultPlan, chunk_idx: int,
               device=None) -> torch.Tensor:
    """(n,) bool: the seeded drop mask of an in-trace site at scan step
    `chunk_idx`, all False off the plan's step (unless chunk=-1). Element
    i is hit iff mix32(i ^ salt) < frac * 2**32, in uint32 arithmetic
    carried on int64 as `owner._mix32` does."""
    if plan.chunk >= 0 and chunk_idx != plan.chunk:
        return torch.zeros((n,), dtype=torch.bool, device=device)
    salt = (plan.seed * 0x9E3779B9 + _SITE_SALT[plan.site]) & 0xFFFFFFFF
    idx = torch.arange(n, dtype=torch.int64, device=device)
    thresh = min(int(plan.frac * 4294967296.0), 4294967295)
    return owner._mix32(idx ^ salt) < thresh


class RetryController:
    """State of one retried call (or one `KmerCounter` batch).

    The call site owns the loop; the controller owns the policy arithmetic:

        ctrl = RetryController(policy, slack=cfg.slack, store_cap=cap)
        while True:
            ... run one attempt at (ctrl.slack, ctrl.store_cap,
                ctrl.hop2_padded) ...
            if not ctrl.observe(route_dropped=r, store_dropped=s,
                                hop2_dropped=h):
                break   # clean round: the attempt's result is final

    `observe` returns the tuple of causes that fired (empty = clean),
    after growing the corresponding knobs and recording the round; it
    raises `CapacityExhausted` / `RetryBudgetExceeded` -- with the
    (bounded) history attached -- instead of growing past a cap.

    History is a first-plus-ring structure: the first round ever recorded
    (or seeded via `history=`) is pinned, and the most recent
    `max_history - 1` rounds ride a ring buffer; middle rounds of a long
    ladder age out. `rounds` materializes the retained rounds as a list.
    Seeded history rides into error payloads but never counts against
    `max_rounds` -- only `own_rounds` (rounds recorded by this
    controller) can exhaust the budget.
    """

    def __init__(self, policy: RetryPolicy, *, slack: float, store_cap: int,
                 hop2_padded: bool = True,
                 history: Iterable[RetryRound] = ()):
        self.policy = policy
        self.slack = slack
        self.store_cap = store_cap
        self.hop2_padded = hop2_padded
        self.attempts = 0                      # completed attempts
        self.own_rounds = 0                    # dirty rounds recorded here
        self.counts: Dict[str, int] = {c: 0 for c in CAUSES}
        self._first: Optional[RetryRound] = None
        self._tail = collections.deque(maxlen=policy.max_history - 1)
        for r in history:
            self._record(RetryRound(*r))

    def _record(self, r: RetryRound) -> None:
        if self._first is None:
            self._first = r
        else:
            self._tail.append(r)   # ring: oldest non-first round ages out

    @property
    def rounds(self) -> List[RetryRound]:
        """Retained round history (first + most recent), oldest first."""
        head = [self._first] if self._first is not None else []
        return head + list(self._tail)

    def observe(self, *, route_dropped: int = 0, store_dropped: int = 0,
                hop2_dropped: int = 0) -> Tuple[str, ...]:
        causes = []
        if route_dropped > 0:
            causes.append(ROUTE_SLACK)
        if store_dropped > 0:
            causes.append(STORE_REHASH)
        if hop2_dropped > 0:
            causes.append(HOP2_FALLBACK)
        attempt = self.attempts
        self.attempts += 1
        if not causes:
            return ()
        self._record(RetryRound(
            round=attempt, causes=tuple(causes), slack=self.slack,
            store_cap=self.store_cap, hop2_padded=self.hop2_padded,
            route_dropped=route_dropped, store_dropped=store_dropped,
            hop2_dropped=hop2_dropped))
        self.own_rounds += 1
        if ROUTE_SLACK in causes and self.slack > self.policy.max_slack:
            raise CapacityExhausted(
                f"routing overflow persists at slack {self.slack} "
                f"(> max_slack {self.policy.max_slack}): {route_dropped} "
                f"entries dropped after {self.own_rounds} round(s)",
                ROUTE_SLACK, self.rounds, self.counts)
        if STORE_REHASH in causes \
                and self.store_cap > self.policy.store_cap_ceiling:
            raise CapacityExhausted(
                f"count store still overflows at {self.store_cap} slots "
                f"(> ceiling {self.policy.store_cap_ceiling}): "
                f"{store_dropped} inserts dropped after "
                f"{self.own_rounds} round(s)", STORE_REHASH, self.rounds,
                self.counts)
        if self.own_rounds >= self.policy.max_rounds:
            raise RetryBudgetExceeded(
                f"retry budget exhausted after {self.own_rounds} replayed "
                f"rounds (max_rounds={self.policy.max_rounds}); last causes "
                f"{tuple(causes)}", self.rounds, self.counts)
        for c in causes:
            self.counts[c] += 1
        if STORE_REHASH in causes:
            self.store_cap *= self.policy.store_growth
        if ROUTE_SLACK in causes:
            self.slack *= self.policy.slack_growth
        if HOP2_FALLBACK in causes:
            self.hop2_padded = True
        return tuple(causes)


def rounds_to_json(rounds: Iterable[RetryRound]) -> List[list]:
    """Round history as JSON-serializable lists (checkpoint `extra`)."""
    return [list(r) for r in rounds]


def rounds_from_json(data) -> List[RetryRound]:
    """Inverse of `rounds_to_json` (`causes` back to a tuple)."""
    out = []
    for row in data or []:
        r = RetryRound(*row)
        out.append(r._replace(causes=tuple(r.causes)))
    return out
