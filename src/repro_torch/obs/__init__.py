"""Kernel-launch telemetry: launch journal, spans, counters, plan audit.

The port's own copy of the reference's ``repro.obs`` (stdlib only, the same
public names and record types). Every kernel entry point, the serving
engines, the model's standalone norm and rotation, and the trainer call
into it; the *disabled* path is a guarded no-op: each public recording
function's first action is a plain check of the module-level recorder
stack, and no event object, dict or formatted string is built unless a
recorder is active. ``null_allocations()`` is the tripwire that proves
it: the internal allocation helper bumps it if it ever runs with no active
recorder, so tests can assert the null path allocated nothing.

Usage:

    from repro_torch import obs
    with obs.capture() as cap:
        y = model.forward(params, tokens)
    assert cap.count("gemm_fused") == 4 * layers
    obs.export_chrome_trace(cap, "TRACE_x.json")

Four record types share one Recorder:

- ``LaunchEvent``  -- one per kernel launch made by a Python entry in kernel
  mode (on the CPU the entry runs the kernel's plain version and journals
  it all the same). A CUDA graph's capture and its replays journal
  nothing: the capture launches nothing, and a replay runs no Python.
  ``wall_s`` is filled under ``capture(timing=True)``.
- ``SpanEvent``    -- begin/end wall-clock intervals (``obs.span``).
- counters         -- monotonic floats (``obs.incr``) and running maxima
  (``obs.gauge``), exported flat.
- ``PlanDecision`` -- an autotuner verdict with its losing candidates
  (``repro_torch.core.autotune``: kinds "policy", "fusion", "bwd_route",
  ``cached`` on a memo replay).

Exporters emit Chrome-trace/Perfetto JSON (``traceEvents``) and a flat
counters JSON; ``tools/trace_check.py`` validates both.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any

__all__ = [
    "LaunchEvent", "SpanEvent", "PlanDecision", "Recorder",
    "capture", "enabled", "timing_enabled", "launch", "incr", "gauge",
    "span",
    "plan_decision", "null_allocations", "reset_null_allocations",
    "export_chrome_trace", "export_counters", "chrome_trace_events",
]


# ---------------------------------------------------------------------------
# Event records
# ---------------------------------------------------------------------------

@dataclass
class LaunchEvent:
    """One kernel launch. ``dma_bytes`` is the bytes the launch must move
    (each input read once, each output written once) where the port counts
    them for the kernel's bound, else None; ``flops`` the reference's
    formula; ``wall_s`` is only filled when the capture asked for timing
    (the entry then waits for the device)."""
    op: str                       # journal op kind, e.g. "gemm_fused"
    variant: str = ""             # free-form: "da", "paged", "kernel", ...
    grid: tuple | None = None
    policy: dict | None = None    # a launch plan's description
    chain: str | None = None      # chain-spec summary (epilogue/prologue)
    dma_bytes: int | None = None
    flops: int | None = None
    wall_s: float | None = None
    ts: float = 0.0               # perf_counter seconds at record time

    def to_json(self) -> dict:
        d = {"op": self.op, "ts": self.ts}
        for k in ("variant", "grid", "policy", "chain", "dma_bytes",
                  "flops", "wall_s"):
            v = getattr(self, k)
            if v not in (None, ""):
                d[k] = list(v) if k == "grid" else v
        return d


@dataclass
class SpanEvent:
    name: str
    ts: float                     # begin, perf_counter seconds
    dur: float                    # seconds
    meta: dict | None = None

    def to_json(self) -> dict:
        d = {"name": self.name, "ts": self.ts, "dur": self.dur}
        if self.meta:
            d["meta"] = self.meta
        return d


@dataclass
class PlanDecision:
    """One autotuner verdict, as the reference records them: ``kind``
    "policy", "fusion" or "bwd_route"; ``candidates`` every scored loser
    with its modeled time and bytes; ``cached`` a memo replay."""
    kind: str
    op: str
    shape: tuple
    dtype: str
    chosen: Any
    candidates: list = field(default_factory=list)
    cached: bool = False
    ts: float = 0.0

    def to_json(self) -> dict:
        return {"kind": self.kind, "op": self.op, "shape": list(self.shape),
                "dtype": self.dtype, "chosen": self.chosen,
                "candidates": self.candidates, "cached": self.cached,
                "ts": self.ts}


# ---------------------------------------------------------------------------
# Recorder + module state
# ---------------------------------------------------------------------------

class Recorder:
    """Accumulates events for one ``capture()`` window."""

    def __init__(self, *, timing: bool = False):
        self.timing = timing
        self.launches: list[LaunchEvent] = []
        self.spans: list[SpanEvent] = []
        self.counters: dict[str, float] = {}
        self.plans: list[PlanDecision] = []

    # -- queries ------------------------------------------------------------
    def count(self, op: str | None = None, variant: str | None = None) -> int:
        """Number of journal launches matching ``op`` (and ``variant``)."""
        n = 0
        for e in self.launches:
            if op is not None and e.op != op:
                continue
            if variant is not None and e.variant != variant:
                continue
            n += 1
        return n

    def launch_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.launches:
            out[e.op] = out.get(e.op, 0) + 1
        return out

    def modeled_bytes(self, op: str | None = None) -> int:
        """Sum of the journal's dma_bytes (op-filtered)."""
        return sum(e.dma_bytes or 0 for e in self.launches
                   if op is None or e.op == op)

    def counter(self, name: str) -> float:
        return self.counters.get(name, 0.0)

    def plans_of(self, kind: str) -> list:
        """Plan decisions of one kind ('policy' | 'fusion' | 'bwd_route'),
        in journal order."""
        return [p for p in self.plans if p.kind == kind]

    def summary(self) -> dict:
        """The ``telemetry`` block a bench embeds in BENCH_<key>.json."""
        return {
            "launches": self.launch_counts(),
            "modeled_dma_bytes": {
                op: self.modeled_bytes(op) for op in self.launch_counts()},
            "counters": dict(sorted(self.counters.items())),
            "plan_decisions": len(self.plans),
            "spans": len(self.spans),
        }


class _State(threading.local):
    def __init__(self):
        self.stack: list[Recorder] = []


_STATE = _State()
_LOCK = threading.Lock()
_NULL_ALLOCS = 0          # bumped only if an event is built while disabled
_EPOCH = time.perf_counter()


def _now() -> float:
    return time.perf_counter() - _EPOCH


def enabled() -> bool:
    """True when at least one ``capture()`` window is active (this thread)."""
    return bool(_STATE.stack)


def timing_enabled() -> bool:
    """True when the innermost active capture asked for wall-clock timing
    (kernel entries then wait for the device and fill wall_s)."""
    s = _STATE.stack
    return bool(s) and s[-1].timing


def null_allocations() -> int:
    """How many event objects were built with no recorder active. The
    zero-overhead contract is that this stays 0: every recording helper
    returns before allocating when disabled."""
    return _NULL_ALLOCS


def reset_null_allocations() -> None:
    global _NULL_ALLOCS
    with _LOCK:
        _NULL_ALLOCS = 0


def _record_launch(ev: LaunchEvent) -> None:
    global _NULL_ALLOCS
    s = _STATE.stack
    if not s:                       # tripwire: caller skipped the guard
        with _LOCK:
            _NULL_ALLOCS += 1
        return
    for rec in s:
        rec.launches.append(ev)


# ---------------------------------------------------------------------------
# Recording API (every function's first line is the disabled-path guard)
# ---------------------------------------------------------------------------

def launch(op: str, *, variant: str = "", grid=None, policy=None,
           chain=None, dma_bytes=None, flops=None, wall_s=None) -> None:
    """Journal one kernel launch. ``policy`` may be an object with a
    ``describe()`` (run lazily, only here) or an already-built dict."""
    if not _STATE.stack:
        return
    if policy is not None and not isinstance(policy, dict):
        describe = getattr(policy, "describe", None)
        policy = describe() if describe else {"policy": str(policy)}
    if grid is not None:
        grid = tuple(grid)
    _record_launch(LaunchEvent(op=op, variant=variant, grid=grid,
                               policy=policy, chain=chain,
                               dma_bytes=dma_bytes, flops=flops,
                               wall_s=wall_s, ts=_now()))


def incr(name: str, value: float = 1.0) -> None:
    """Bump a monotonic counter in every active recorder."""
    s = _STATE.stack
    if not s:
        return
    for rec in s:
        rec.counters[name] = rec.counters.get(name, 0.0) + value


def gauge(name: str, value: float) -> None:
    """Record the running max of a value (peak occupancy and friends)."""
    s = _STATE.stack
    if not s:
        return
    for rec in s:
        if value > rec.counters.get(name, float("-inf")):
            rec.counters[name] = value


@contextmanager
def span(name: str, **meta):
    """Wall-clock interval: ``with obs.span("prefill", seq=512): ...``.
    Free when disabled — no timestamps are taken, no dict is built."""
    if not _STATE.stack:
        yield
        return
    t0 = _now()
    try:
        yield
    finally:
        ev = SpanEvent(name=name, ts=t0, dur=_now() - t0,
                       meta=meta or None)
        for rec in _STATE.stack:
            rec.spans.append(ev)


def plan_decision(kind: str, op: str, shape, dtype: str, chosen,
                  candidates=None, cached: bool = False) -> None:
    """Audit one autotuner verdict (``core.autotune``'s selections)."""
    s = _STATE.stack
    if not s:
        return
    ev = PlanDecision(kind=kind, op=op, shape=tuple(shape), dtype=dtype,
                      chosen=chosen, candidates=list(candidates or []),
                      cached=cached, ts=_now())
    for rec in s:
        rec.plans.append(ev)


@contextmanager
def capture(*, timing: bool = False):
    """Activate a fresh Recorder for the dynamic extent of the block and
    yield it. Nested captures each see every event recorded inside them
    (events fan out to the whole stack)."""
    rec = Recorder(timing=timing)
    _STATE.stack.append(rec)
    try:
        yield rec
    finally:
        _STATE.stack.remove(rec)


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

_PID = 1
_TID_LAUNCH = 1   # kernel-launch journal track
_TID_SPAN = 2     # span track


def chrome_trace_events(rec: Recorder) -> list[dict]:
    """Flatten a Recorder into Chrome-trace ``traceEvents`` (Perfetto
    opens these directly). Launches are instant events ('i') unless they
    carry wall time (then complete events 'X'); spans are 'X'; counters
    land as one final 'C' sample per series."""
    events: list[dict] = []
    for e in rec.launches:
        args: dict[str, Any] = {}
        for k in ("variant", "chain", "dma_bytes", "flops"):
            v = getattr(e, k)
            if v not in (None, ""):
                args[k] = v
        if e.grid is not None:
            args["grid"] = list(e.grid)
        if e.policy is not None:
            args["policy"] = e.policy
        base = {"name": e.op, "cat": "launch", "pid": _PID,
                "tid": _TID_LAUNCH, "ts": e.ts * 1e6, "args": args}
        if e.wall_s is not None:
            events.append({**base, "ph": "X", "dur": e.wall_s * 1e6})
        else:
            events.append({**base, "ph": "i", "s": "t"})
    for sp in rec.spans:
        events.append({"name": sp.name, "cat": "span", "ph": "X",
                       "pid": _PID, "tid": _TID_SPAN, "ts": sp.ts * 1e6,
                       "dur": sp.dur * 1e6, "args": sp.meta or {}})
    t_end = max([e.ts for e in rec.launches]
                + [sp.ts + sp.dur for sp in rec.spans] + [0.0])
    for name, value in sorted(rec.counters.items()):
        events.append({"name": name, "cat": "counter", "ph": "C",
                       "pid": _PID, "ts": t_end * 1e6,
                       "args": {"value": value}})
    return events


def export_chrome_trace(rec: Recorder, path) -> str:
    """Write Perfetto-loadable Chrome trace JSON; returns the path."""
    doc = {"traceEvents": chrome_trace_events(rec),
           "displayTimeUnit": "ms",
           "otherData": {"producer": "repro_torch.obs",
                         "plan_decisions": [p.to_json() for p in rec.plans]}}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return str(path)


def export_counters(rec: Recorder, path) -> str:
    """Write the flat counters JSON (stable sorted keys); returns path."""
    doc = {"counters": dict(sorted(rec.counters.items())),
           "launches": rec.launch_counts()}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return str(path)
