"""Per-host page-pool topology for paged serving: the reference's
``ShardedPagedEngine``.

A multi-host deployment does not share one page pool: each host owns a
pool sized to its memory, its own page table and its own batch slots.
:class:`ShardedPagedEngine` models that: N :class:`PagedEngine` hosts
behind one request surface, every one over the same ``params`` (one copy
of the weights, N page pools). Each request is placed on the host with the
most free pages, then the fewest queued requests, then the lowest id (a
deterministic least-loaded rule). Everything after placement is the
single-host engine, so each host's streams and counters are those of a
lone :class:`PagedEngine` fed the requests placed on it, in that order.
No collective runs: the hosts step in turn on one device.
"""
from __future__ import annotations

from repro_torch import obs
from .engine import PagedEngine, Request


class ShardedPagedEngine:
    """Data-axis sharded paged serving: one :class:`PagedEngine` per host.

    ``n_hosts`` is the host count; every other keyword argument goes to
    each host's engine, so the aggregate capacity is ``n_hosts`` times one
    engine's batch slots and pages."""

    def __init__(self, model, params, *, n_hosts: int = 2, **engine_kw):
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        self.n_hosts = n_hosts
        self.hosts = [PagedEngine(model, params, **engine_kw)
                      for _ in range(n_hosts)]
        self.placements: dict[int, int] = {}    # uid -> host id
        self.admissions_by_host = [0] * n_hosts

    def _place(self) -> int:
        """The least-loaded host: most free pages, then fewest queued
        requests, then lowest id."""
        def load(i: int):
            h = self.hosts[i]
            return (-h.alloc.free_pages, len(h.pending), i)
        return min(range(self.n_hosts), key=load)

    def submit(self, req: Request) -> None:
        if req.uid in self.placements:
            raise ValueError(f"request {req.uid} already submitted "
                             f"(host {self.placements[req.uid]})")
        host = self._place()
        self.hosts[host].submit(req)
        self.placements[req.uid] = host
        self.admissions_by_host[host] += 1
        obs.incr("sharded_engine.submitted")

    def step(self) -> bool:
        """Advance every host one step (none is skipped); True while any
        host has work."""
        busy = False
        for h in self.hosts:
            busy = h.step() or busy
        return busy

    @property
    def results(self) -> dict:
        merged: dict = {}
        for h in self.hosts:
            merged.update(h.results)
        return merged

    def run(self) -> dict:
        with obs.span("sharded_engine.run"):
            while self.step():
                pass
        return self.results

    def report(self) -> dict:
        """The hosts' summed counters, the placements and each host's own
        report; the spread of ``admissions_by_host`` is the balance."""
        per_host = [h.report() for h in self.hosts]
        agg = {k: sum(r[k] for r in per_host)
               for k in ("steps", "admissions", "preemptions",
                         "tokens_generated", "completed", "page_pool_size")}
        agg["n_hosts"] = self.n_hosts
        agg["admissions_by_host"] = list(self.admissions_by_host)
        agg["placements"] = dict(self.placements)
        agg["per_host"] = per_host
        return agg
