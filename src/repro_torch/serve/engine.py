"""Serving: the fixed-batch :class:`Engine` with the :class:`RequestQueue`
over it, and the continuous-batching :class:`PagedEngine`.

:class:`Engine` runs one prefill and then one decode step per new token for
a fixed (batch, prompt_len) batch, of a decoder-only LM or, given the
encoder's input in ``extra_batch``, of an encoder-decoder model. :class:`RequestQueue` buckets requests by
padded prompt length and flushes full batches (a forced flush pads the last
batch with copies of its last request, which are not counted or returned).
:class:`PagedEngine` admits, decodes and retires requests one step at a time
over a paged KV cache. Greedy decoding takes the first maximal logit;
temperature sampling draws through a ``torch.Generator``.

Both engines keep their buckets in the reference's LRU (``_lru_get``,
capped by ``max_cached_buckets``, its hits, misses and evictions in
``lru_stats``). Both record the reference's spans, counters and gauge into
``repro_torch.obs`` under its names (``engine.*``), each counter equal to
the engine attribute it mirrors. Each bucket pins its kernel policies when
it is built (``bucket_policies``, as the reference's; ``pretuned=``
installs a measured table first, for the process, and raises where the
table is rejected). A decode bucket is a :class:`DecodeGraph`: on the card
one decode step captured in a CUDA graph over static input buffers,
replayed every step; on the CPU the eager step over the same buffers. Prefill and
chunk buckets hold the eager callable.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import kernels, obs
from repro_torch.configs import DECODER_FAMILIES
from repro_torch.core import autotune
from . import kv_cache as kvc


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, prompt + generated) int32
    prompt_len: int
    steps: int


def _lru_get(lru: collections.OrderedDict, key, build, cap: int,
             stats: dict):
    """Get-or-build with LRU eviction: an evicted entry drops what it
    holds (a captured graph, its buffers, a cache) with it. ``stats`` is
    the engine's {hits, misses, evictions}, mirrored into the ``obs``
    counters ``engine.bucket_lru.*``."""
    entry = lru.get(key)
    if entry is None:
        stats["misses"] += 1
        obs.incr("engine.bucket_lru.misses")
        entry = build()
        lru[key] = entry
        while len(lru) > cap:
            lru.popitem(last=False)
            stats["evictions"] += 1
            obs.incr("engine.bucket_lru.evictions")
    else:
        lru.move_to_end(key)
        stats["hits"] += 1
        obs.incr("engine.bucket_lru.hits")
    return entry


def _over_mesh(model) -> bool:
    """Whether the model was built over a mesh (its MoE blocks run
    collectives, so its decode steps run eagerly)."""
    return getattr(model, "mesh", None) is not None


def _pinning(policies: dict, key, resolve, build):
    """``build`` that first pins ``resolve()`` as the bucket's policies."""
    def pinned():
        policies[key] = resolve()
        return build()
    return pinned


def _decode_policies(model, batch: int, slots: int,
                     q_tokens: int = 1) -> dict:
    """{"attention_decode": policy} of a decode launch over ``slots`` keys
    (the reference's ``resolve_decode_policy``)."""
    from repro_torch.kernels.attention.decode import decode_policy

    cfg = model.cfg
    hkv = cfg.num_kv_heads
    return {"attention_decode": decode_policy(
        batch, hkv, cfg.num_heads // hkv * q_tokens, slots, cfg.head_dim,
        model.device, cfg.compute_dtype, q_tokens)}


class DecodeGraph:
    """One decode bucket: ``step(**buffers) -> logits`` over static input
    buffers that the bucket owns (and the cache or pools the step updates
    in place, at fixed addresses).

    Each call copies its inputs into the buffers. On the card the first
    call runs the step eagerly on a side stream (its result is that call's;
    the warm-up allocates what the kernels allocate at their first call)
    and then captures it in a ``torch.cuda.CUDAGraph``; every later call
    replays the graph and returns its static logits, which the caller
    reads before the next call. A capture that fails raises: there is no
    eager fallback on the card. The kernels count their launches on the
    host, so the capture's counts are taken back and every replay adds
    them. On the CPU every call runs the step eagerly. With ``eager`` (a
    model built over a mesh, whose MoE blocks run collectives) every call
    runs the step eagerly on the card too, counted in ``eager_steps`` and
    the ``obs`` counter "engine.decode_eager". The engines make and call
    their buckets in inference mode, so the buffers are inference tensors:
    call a bucket in that mode.
    """

    def __init__(self, step: Callable, buffers: dict, cache=None, *,
                 eager: bool = False):
        self.step = step
        self.buffers = buffers
        self.cache = cache
        self.eager = eager
        self.eager_steps = 0
        self.graph = None
        self.logits = None
        self.launches: dict = {}
        self.device = next(iter(buffers.values())).device

    def _load(self, inputs: dict) -> None:
        for name, value in inputs.items():
            buf = self.buffers[name]
            if torch.is_tensor(value):
                buf.copy_(value)
            elif np.ndim(value):
                buf.copy_(torch.from_numpy(np.asarray(value)))
            else:
                buf.fill_(value)

    def __call__(self, **inputs):
        self._load(inputs)
        if self.device.type != "cuda":
            return self.step(**self.buffers)
        if self.eager:
            self.eager_steps += 1
            obs.incr("engine.decode_eager")
            return self.step(**self.buffers)
        if self.graph is not None:
            self.graph.replay()
            kernels.replay_launches(self.launches)
            return self.logits
        return self._capture()

    def _capture(self):
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            logits = self.step(**self.buffers)
        current.wait_stream(side)
        logits.record_stream(current)
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        # torch.cuda.graph collects garbage before it begins; a collection
        # during the capture would free earlier tensors that other streams
        # used, whose event queries invalidate the capture
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self.logits = self.step(**self.buffers)
        finally:
            if enabled:
                gc.enable()
        after = kernels.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        kernels.add_launch_counts({k: -n for k, n in self.launches.items()})
        self.graph = graph
        return logits


class Engine:
    """Fixed-batch prefill + decode over a model built by ``build_model``.

    One LRU of buckets under one cap (``max_cached_buckets``), as the
    reference's: (batch, prompt_len) -> the prefill callable and
    ("decode", batch) -> a :class:`DecodeGraph` that owns the batch's
    cache (reused across ``generate`` calls: the reference donates it) and
    its token and position buffers, the position an int64 tensor on the
    device. An encoder-decoder's cache is its whole {"self", "cross"}
    pair: the prefill writes both parts in place, and the captured step
    reads the cross part without writing it. ``lru_stats`` counts the LRU's hits, misses and evictions.

    ``timings`` keeps, per ``generate`` call, the wall-clock seconds of the
    prefill and of the decode loop (each ended by a device synchronise on
    CUDA) with the batch shape, for throughput reports.
    """

    def __init__(self, model, params, *, max_len: int = 4096,
                 max_cached_buckets: int = 8, pretuned=None):
        if pretuned is not None:
            # the measured table (a path or a report dict) before any
            # bucket pins its policies
            autotune.use_pretuned(pretuned, required=True)
        self.model = model
        self.params = params
        self.max_len = max_len
        self.max_cached_buckets = max_cached_buckets
        self._buckets: collections.OrderedDict = collections.OrderedDict()
        self._policies: dict = {}
        self.lru_stats = {"hits": 0, "misses": 0, "evictions": 0}
        self.timings: list = []

    @property
    def bucket_policies(self) -> dict:
        """{key: {op: KernelPolicy}} of the live buckets: (batch,
        prompt_len) for a prefill, ("decode", batch) for a decode step."""
        return {k: self._policies[k] for k in self._buckets}

    def _sync(self):
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def _bucket(self, batch: int, prompt_len: int):
        """The prefill callable of a (batch, prompt_len) bucket."""
        key = (batch, prompt_len)
        return _lru_get(self._buckets, key, _pinning(
            self._policies, key, lambda: autotune.policies_for_model(
                self.model.cfg, batch=batch, seq_len=prompt_len,
                decode_len=self.max_len),
            lambda: self.model.prefill),
            self.max_cached_buckets, self.lru_stats)

    def _decode_fn(self, batch: int) -> DecodeGraph:
        model, params = self.model, self.params

        def build():
            cache = model.init_cache(batch, self.max_len)
            dev = model.device
            buffers = {"token": torch.zeros((batch, 1), dtype=torch.int64,
                                            device=dev),
                       "pos": torch.zeros((1,), dtype=torch.int64,
                                          device=dev)}

            def step(token, pos):
                return model.decode_step(params, token, cache, pos)[1]
            return DecodeGraph(step, buffers, cache,
                               eager=_over_mesh(model))
        key = ("decode", batch)
        return _lru_get(self._buckets, key, _pinning(
            self._policies, key,
            lambda: _decode_policies(model, batch, self.max_len), build),
            self.max_cached_buckets, self.lru_stats)

    @staticmethod
    def _sample(logits, temperature: float, generator):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    @torch.inference_mode()
    def generate(self, prompts, max_new_tokens: int, *,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 extra_batch: Optional[dict] = None) -> GenerationResult:
        """prompts: (B, S) token ids. Greedy (T = 0) or temperature sampling.
        An encoder-decoder model's prefill receives ``dict(extra_batch,
        inputs=prompts)``: ``extra_batch`` carries ``encoder_embeds`` (B,
        encoder_seq, D); a decoder-only LM ignores it, as the reference's
        engine does."""
        dev = self.model.device
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                  device=dev)
        b, s = prompts.shape
        family = self.model.cfg.family
        if family == "encdec":
            if not extra_batch or "encoder_embeds" not in extra_batch:
                raise ValueError(
                    f"{self.model.cfg.name}: an encoder-decoder model needs "
                    "extra_batch={'encoder_embeds': (B, encoder_seq, D)}")
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in extra_batch.items()}
            batch["inputs"] = prompts
        elif family in DECODER_FAMILIES:   # a vlm serves its text backbone
            batch = prompts
        else:
            raise NotImplementedError(
                f"{self.model.cfg.name}: the {family!r} family has no decode "
                "step to generate with")
        if s + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {s} + {max_new_tokens} new tokens "
                             f"exceeds the cache length {self.max_len}")
        if temperature != 0.0 and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        prefill = self._bucket(b, s)
        decode = self._decode_fn(b)
        t0 = time.perf_counter()
        with obs.span("engine.prefill", batch=b, prompt_len=s):
            _, logits = prefill(self.params, batch, decode.cache)
            next_tok = self._sample(logits, temperature, generator)[:, None]
            self._sync()
        t1 = time.perf_counter()
        toks = [prompts]
        with obs.span("engine.decode", batch=b, tokens=max_new_tokens):
            for i in range(max_new_tokens):
                toks.append(next_tok)
                if i == max_new_tokens - 1:
                    break
                logits = decode(token=next_tok, pos=s + i)
                next_tok = self._sample(logits, temperature,
                                        generator)[:, None]
            out = torch.cat(toks, dim=1).to(torch.int32).cpu().numpy()
        t2 = time.perf_counter()
        self.timings.append({"batch": b, "prompt_len": s,
                             "new_tokens": max_new_tokens,
                             "prefill_s": t1 - t0, "decode_s": t2 - t1})
        return GenerationResult(out, s, max_new_tokens)


@dataclasses.dataclass
class Request:
    """One generation request. ``temperature=None`` inherits the engine's
    default (greedy); ``seed`` seeds the sampling generator of the batch it
    joins (the batch's first seeded request wins)."""
    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: Optional[float] = None
    seed: Optional[int] = None


class RequestQueue:
    """Bucket by padded length, flush full batches."""

    def __init__(self, engine: Engine, batch_size: int,
                 buckets=(128, 512, 2048)):
        self.engine = engine
        self.batch_size = batch_size
        self.buckets = sorted(buckets)
        self.pending: dict[int, list[Request]] = {b: [] for b in self.buckets}
        self.results: dict[int, np.ndarray] = {}

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket")

    def submit(self, req: Request) -> None:
        self.pending[self._bucket(len(req.prompt))].append(req)

    @property
    def engine_temperature(self) -> float:
        return getattr(self.engine, "temperature", 0.0)

    def flush(self, *, force: bool = False) -> int:
        """Serve full (or, with ``force``, padded partial) batches. Returns
        the number of real requests served; a resubmitted uid overwrites its
        previous result with a warning."""
        served = 0
        for bucket, reqs in self.pending.items():
            # one batch shares one sampling config: partition by temperature
            by_temp: dict = {}
            for r in reqs:
                t = (r.temperature if r.temperature is not None
                     else self.engine_temperature)
                by_temp.setdefault(t, []).append(r)
            reqs[:] = []
            for temp, treqs in by_temp.items():
                while len(treqs) >= self.batch_size or (force and treqs):
                    group = treqs[: self.batch_size]
                    del treqs[: self.batch_size]
                    served += self._serve_batch(bucket, group, temp)
                reqs.extend(treqs)            # leftovers wait for more
        return served

    def _serve_batch(self, bucket: int, group: list, temperature: float
                     ) -> int:
        n_real = len(group)
        while len(group) < self.batch_size:   # pad the last batch
            group.append(group[-1])
        prompts = np.stack([np.pad(r.prompt, (bucket - len(r.prompt), 0))
                            for r in group])
        max_new = max(r.max_new_tokens for r in group)
        seeds = [r.seed for r in group[:n_real] if r.seed is not None]
        generator = None
        if seeds:
            generator = torch.Generator(
                device=self.engine.model.device).manual_seed(seeds[0])
        result = self.engine.generate(prompts, max_new,
                                      temperature=temperature,
                                      generator=generator)
        for r, row in zip(group[:n_real], result.tokens[:n_real]):
            if r.uid in self.results:
                warnings.warn(f"RequestQueue: duplicate uid {r.uid} — "
                              "overwriting previous result", stacklevel=2)
            self.results[r.uid] = row[bucket - len(r.prompt):]
        return n_real


# ---------------------------------------------------------------------------
# Continuous batching over the paged KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Slot:
    """Host-side record of one active batch slot."""
    req: Request
    n_pages: int                 # pages currently backing the sequence
    generated: list              # sampled token ids (ints)
    next_token: int              # token to feed at the next decode step
    pages: list = dataclasses.field(default_factory=list)
    # next prompt position to prefill; -1 once prefill is complete. A slot
    # mid-prefill is masked out of the shared decode step (its page-table
    # row and length are zeroed for that launch) so decode appends cannot
    # scribble over pages the chunk loop is still filling.
    prefill_cursor: int = -1

    @property
    def prefilling(self) -> bool:
        return self.prefill_cursor >= 0


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _seeded_generator(seed: int, position: int, device) -> torch.Generator:
    """The generator of a seeded request's draw at ``position``: a function
    of (seed, absolute position) only, so the draw does not depend on the
    batchmates, the admission order or a recompute preemption."""
    hi, lo = np.random.SeedSequence([seed, position]).generate_state(
        2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(hi) << 32) | int(lo))


class PagedEngine:
    """Continuous batching over a paged KV cache: one decode launch serves
    every active slot.

    Admission: each :meth:`step` first moves pending requests into free
    batch slots while the allocator can cover their prompt pages; the
    prefill runs at the exact prompt length (padding would contaminate a
    recurrent block's state, which lands in the slot's row). Decode: one
    ``decode_step_paged`` serves every slot, with the page table sliced to
    the power-of-two page count of the longest active sequence. Growth: a
    slot crossing a page boundary gets its next page just in time; if the
    pool is exhausted the youngest stalled slot is preempted (recompute
    policy: its pages are freed and a continuation request rejoins the
    queue front). Retirement: a slot that reaches ``max_new_tokens`` frees
    its pages and its result appears in :attr:`results`.

    Serving fast paths (opt-in; the defaults are the plain engine):

    * ``prefix_cache=True``: full KV pages of completed prompts are kept in
      a refcounted trie; later prompts sharing a page-aligned prefix skip
      its prefill and share the physical pages.
    * ``chunk_tokens=C``: prompts prefill in C-token chunks, one per step,
      interleaved with decode (the mid-prefill slot is masked out of the
      shared decode launch).

    * ``draft_model``, ``draft_params``, ``spec_tokens=k``: greedy
      speculative decoding. Each step is one round for every decode-ready
      slot: the draft runs k single-token steps over its own pools (which
      share the target's page table and lengths), proposing d1 .. d_{k-1}
      (the k-th step only appends d_{k-1}); the target verifies [t0, d1 ..
      d_{k-1}] in one k-token decode step; each slot keeps the longest
      agreeing prefix plus the target's token after it (1 to k tokens a
      round), so the streams are the target's greedy streams. Both models'
      prefills and chunks run at admission. Needs greedy requests, an
      attention-only stack and a draft of the target's vocabulary.

    The page table and lengths are host numpy arrays owned by the engine
    (:attr:`state`), copied once per launch into the decode bucket's static
    buffers. One LRU under one cap (``max_cached_buckets``) holds, as the
    reference's: (batch_slots, page_count) -> a :class:`DecodeGraph` over
    (B, 1) tokens, the (B, page_count) page table and the (B,) lengths;
    ("prefill", S) -> the exact-length prefill; ("chunk", C) -> the chunked
    or suffix prefill; with a draft, ("draft_decode", page_count) -> the
    draft's decode graph over its pools, ("verify", page_count) -> the
    target's graph over (B, k) tokens, and ("draft_prefill", S),
    ("draft_chunk", C) -> the draft's prefills. ``report()`` carries its
    hits, misses and evictions as ``bucket_lru``, and with a draft the
    rounds, proposals, acceptances and tokens a round as ``speculative``.

    ``timings`` accumulates the host seconds of prefill (exact-length and
    chunked, the draft's included) and of decode (steps or speculative
    rounds), each ended by a device synchronise on CUDA, with the prompt
    tokens prefilled and the tokens decoded.
    """

    def __init__(self, model, params, *, batch_slots: int = 4,
                 page_size: int = 64, max_pages_per_seq: int = 8,
                 n_pages: Optional[int] = None, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 max_cached_buckets: int = 8, prefix_cache: bool = False,
                 chunk_tokens: Optional[int] = None,
                 draft_model=None, draft_params=None, spec_tokens: int = 0,
                 pretuned=None):
        if pretuned is not None:
            # the measured table, before the first bucket pins its policies
            autotune.use_pretuned(pretuned, required=True)
        # the fast paths address KV pages by position; a recurrent stack's
        # per-slot state can be neither shared, re-entered nor stepped by k
        attn_only = all(model.cfg.layer_kind(i) in ("attn", "local", "moe")
                        for i in range(model.cfg.num_layers))
        if prefix_cache and not attn_only:
            raise ValueError(
                "prefix caching shares position-addressable KV pages; "
                f"{model.cfg.name} has recurrent layers")
        if chunk_tokens is not None:
            if not attn_only:
                raise ValueError(
                    "chunked prefill re-enters the prompt mid-stream; "
                    f"{model.cfg.name}'s recurrent state cannot")
            if chunk_tokens <= 0 or chunk_tokens % page_size:
                raise ValueError(
                    f"chunk_tokens={chunk_tokens} must be a positive "
                    f"multiple of page_size={page_size}")
        if draft_model is not None:
            if spec_tokens < 2:
                raise ValueError("speculative decoding needs spec_tokens"
                                 " >= 2 (1 draft + 1 correction minimum)")
            if not attn_only:
                raise ValueError("speculative verify needs an attention-"
                                 f"only stack; {model.cfg.name} is hybrid")
            if temperature != 0.0:
                raise ValueError(
                    "speculative decoding acceptance is defined for greedy "
                    "sampling (temperature=0.0) in this engine")
            if draft_model.cfg.vocab_size != model.cfg.vocab_size:
                raise ValueError("draft and target must share a vocabulary")
        self.model = model
        self.params = params
        self.device = model.device
        self.batch_slots = batch_slots
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        # +1: physical page 0 is the reserved null page
        self.n_pages = (n_pages if n_pages is not None
                        else batch_slots * max_pages_per_seq + 1)
        self.temperature = temperature
        self.generator = (generator if generator is not None else
                          torch.Generator(device=self.device).manual_seed(0))
        self.max_cached_buckets = max_cached_buckets
        self._buckets: collections.OrderedDict = collections.OrderedDict()
        self._policies: dict = {}
        self.lru_stats = {"hits": 0, "misses": 0, "evictions": 0}
        self.prefix = kvc.PrefixCache(page_size) if prefix_cache else None
        self.chunk_tokens = chunk_tokens

        self.draft_model = draft_model
        self.draft_params = draft_params
        self.spec_tokens = spec_tokens
        self._spec = draft_model is not None

        self.cache = model.init_paged_cache(batch_slots, self.n_pages,
                                            page_size)
        # the draft's own pools, addressed by the target's page table
        self.draft_cache = (draft_model.init_paged_cache(
            batch_slots, self.n_pages, page_size) if self._spec else None)
        self.alloc = kvc.PageAllocator(self.n_pages)
        self.state = kvc.init_page_state(batch_slots, max_pages_per_seq)
        self.slots: dict[int, _Slot] = {}       # slot id -> active record
        self.pending: collections.deque = collections.deque()
        self.results: dict[int, np.ndarray] = {}
        self.steps = 0
        self.preemptions = 0
        self.preempted_uids: set = set()    # requests preempted at least once
        self.prefix_hit_uids: set = set()   # requests admitted on a trie hit
        self.admissions = 0
        self.prefills = 0               # exact-length prefills
        self.chunks_prefilled = 0       # chunked or suffix prefills
        self.decode_steps = 0           # decode launches
        self.tokens_generated = 0
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        self.spec_participations = 0    # (slot, round) pairs
        self.peak_pages_in_use = 0
        self.timings = {"prefill_s": 0.0, "prefill_tokens": 0,
                        "decode_s": 0.0, "decode_tokens": 0}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _note_occupancy(self) -> None:
        used = self.n_pages - 1 - self.alloc.free_pages
        self.peak_pages_in_use = max(self.peak_pages_in_use, used)
        obs.gauge("engine.peak_pages_in_use", used)

    def _tokens(self, array) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array, np.int64), device=self.device)

    # -- buckets -----------------------------------------------------------
    @property
    def bucket_policies(self) -> dict:
        """{key: {op: KernelPolicy}} of the live buckets, under the
        reference's keys."""
        return {k: self._policies[k] for k in self._buckets}

    def _touch(self, key, build, resolve):
        return _lru_get(self._buckets, key,
                        _pinning(self._policies, key, resolve, build),
                        self.max_cached_buckets, self.lru_stats)

    def _graph(self, key, mp_bucket: int, *, draft: bool = False,
               q_tokens: int = 1) -> DecodeGraph:
        """A :class:`DecodeGraph` of the target's or the draft's paged step
        over its pools (updated in place), behind static (B, q_tokens)
        token, (B, mp_bucket) page-table and (B,) length buffers."""
        model, params, pools = ((self.draft_model, self.draft_params,
                                 self.draft_cache) if draft else
                                (self.model, self.params, self.cache))
        dev, b = self.device, self.batch_slots

        def build():
            buffers = {
                "token": torch.zeros((b, q_tokens), dtype=torch.int64,
                                     device=dev),
                "page_table": torch.zeros((b, mp_bucket), dtype=torch.int32,
                                          device=dev),
                "lengths": torch.zeros((b,), dtype=torch.int32, device=dev)}

            def step(token, page_table, lengths):
                return model.decode_step_paged(params, token, pools,
                                               page_table, lengths)[1]
            return DecodeGraph(step, buffers, eager=_over_mesh(model))
        return self._touch(key, build, lambda: _decode_policies(
            model, b, mp_bucket * self.page_size, q_tokens))

    def _decode_bucket(self, mp_bucket: int, *, draft: bool = False
                       ) -> DecodeGraph:
        """The single-token decode step of a page-count bucket, the
        target's or the draft's, over its pools (updated in place)."""
        key = (("draft_decode", mp_bucket) if draft
               else (self.batch_slots, mp_bucket))
        return self._graph(key, mp_bucket, draft=draft)

    def _verify_bucket(self, mp_bucket: int) -> DecodeGraph:
        """The target's k-token verify step of a page-count bucket: (B, k)
        tokens in, (B, k, V) logits out."""
        return self._graph(("verify", mp_bucket), mp_bucket,
                           q_tokens=self.spec_tokens)

    def _prefill_bucket(self, plen: int, *, draft: bool = False):
        model = self.draft_model if draft else self.model
        return self._touch(
            ("draft_prefill" if draft else "prefill", plen),
            lambda: model.prefill_paged,
            lambda: autotune.policies_for_model(
                model.cfg, batch=1, seq_len=plen,
                decode_len=self.max_pages_per_seq * self.page_size))

    def _chunk_bucket(self, chunk_len: int, *, draft: bool = False):
        model = self.draft_model if draft else self.model
        return self._touch(
            ("draft_chunk" if draft else "chunk", chunk_len),
            lambda: model.prefill_paged_chunk,
            lambda: _decode_policies(
                model, 1, self.max_pages_per_seq * self.page_size,
                chunk_len))

    # -- request lifecycle -------------------------------------------------
    def submit(self, req: Request) -> None:
        total = len(req.prompt) + req.max_new_tokens
        if self._spec:
            # a verify round may overshoot the budget by up to
            # spec_tokens - 1 stale positions before retirement truncates
            total += self.spec_tokens
        cap = min(self.max_pages_per_seq, self.n_pages - 1) * self.page_size
        if total > cap:
            raise ValueError(
                f"request {req.uid}: {total} tokens exceed per-sequence "
                f"capacity {cap} (max_pages_per_seq * page_size)")
        if self._spec and req.temperature not in (None, 0.0):
            raise ValueError(
                f"request {req.uid}: speculative decoding requires greedy "
                "requests (temperature 0.0)")
        self.pending.append(req)

    def _effective_temperature(self, req: Request) -> float:
        return self.temperature if req.temperature is None else req.temperature

    def _sample_slot(self, logits_row, req: Request, position: int) -> int:
        """Sample one token for one sequence. ``position`` is the token's
        absolute sequence position: with the request's seed it seeds the
        draw, so the draw is invariant to batch composition, admission
        order and recompute preemption."""
        t = self._effective_temperature(req)
        if t == 0.0:
            return int(torch.argmax(logits_row))
        gen = (_seeded_generator(req.seed, position, self.device)
               if req.seed is not None else self.generator)
        probs = torch.softmax(logits_row.float() / t, dim=-1)
        return int(torch.multinomial(probs, 1, generator=gen))

    def _match_prefix(self, req: Request) -> list:
        """The trie's pages of the prompt's longest cached prefix (retained
        for the caller), counted as ``engine.prefix.*``."""
        if self.prefix is None:
            return []
        matched = self.prefix.match(req.prompt, self.alloc)
        obs.incr("engine.prefix.lookups")
        if matched:
            obs.incr("engine.prefix.hits")
            obs.incr("engine.prefix.tokens_saved",
                     len(matched) * self.page_size)
        return matched

    def _admit(self) -> int:
        """Move pending requests into free slots; returns how many joined."""
        admitted = 0
        while self.pending:
            free = [s for s in range(self.batch_slots) if s not in self.slots]
            if not free:
                break
            req = self.pending[0]
            plen = len(req.prompt)
            n = kvc.num_pages_needed(plen, self.page_size)
            matched = self._match_prefix(req)
            n_new = n - len(matched)
            if not self.alloc.can_alloc(n_new):
                if self.prefix is not None:
                    self.prefix.evict(self.alloc,
                                      n_new - self.alloc.free_pages)
                if not self.alloc.can_alloc(n_new):
                    if matched:
                        self.alloc.free(matched)    # drop this admission's
                    break                           # refs; wait for retire
            self.pending.popleft()
            if matched:
                self.prefix_hit_uids.add(req.uid)
            slot = free[0]
            pages = matched + self.alloc.alloc(n_new)
            matched_len = len(matched) * self.page_size
            if matched or self.chunk_tokens is not None:
                # suffix/chunked prefill: only positions >= matched_len are
                # computed. Without chunking the whole suffix goes in one
                # padded chunk now; with chunking the slot joins mid-prefill
                # and advances one chunk per step.
                kvc.assign_slot(self.state, slot, pages, matched_len)
                rec = _Slot(req=req, n_pages=n, generated=[], next_token=-1,
                            pages=pages, prefill_cursor=matched_len)
                self.slots[slot] = rec
                if self.chunk_tokens is None:
                    self._advance_prefill(slot, rec)   # completes in one go
            else:
                kvc.assign_slot(self.state, slot, pages, plen)
                prefill = self._prefill_bucket(plen)
                toks = self._tokens(req.prompt)[None, :]
                t0 = time.perf_counter()
                with obs.span("engine.prefill", uid=req.uid,
                              prompt_len=plen):
                    self.cache, logits = prefill(
                        self.params, toks, self.cache,
                        self.state["page_table"][slot], slot, plen)
                if self._spec:
                    # the draft's twin on the same page row
                    self.draft_cache, _ = self._prefill_bucket(
                        plen, draft=True)(
                        self.draft_params, toks, self.draft_cache,
                        self.state["page_table"][slot], slot, plen)
                first = self._sample_slot(logits[0], req, plen)
                self._sync()
                self.timings["prefill_s"] += time.perf_counter() - t0
                self.timings["prefill_tokens"] += plen
                self.prefills += 1
                self.slots[slot] = _Slot(req=req, n_pages=n,
                                         generated=[first], next_token=first,
                                         pages=pages)
                # the first token comes off the prefill logits, not a decode
                # step: count it here so tokens_generated covers every one
                self.tokens_generated += 1
                obs.incr("engine.tokens_generated")
                if self.prefix is not None:
                    self.prefix.insert(req.prompt, pages, self.alloc)
            admitted += 1
            self.admissions += 1
            obs.incr("engine.admissions")
            self._note_occupancy()
        return admitted

    def _advance_prefill(self, slot: int, rec: _Slot) -> None:
        """Run ONE prefill chunk for a mid-prefill slot (the whole padded
        suffix at once when interleaved chunking is off). On the final
        chunk: sample the first token, mark the slot decode-ready, and
        register the prompt's full pages in the prefix trie."""
        req = rec.req
        plen = len(req.prompt)
        start = rec.prefill_cursor
        if self.chunk_tokens is not None:
            c = self.chunk_tokens
        else:
            c = _pow2(kvc.num_pages_needed(plen - start,
                                           self.page_size)) * self.page_size
        end = min(plen, start + c)
        toks = np.zeros((1, c), np.int64)
        toks[0, : end - start] = np.asarray(req.prompt[start:end])
        last = (plen - 1 - start) if end == plen else 0
        chunk = self._chunk_bucket(c)
        toks = self._tokens(toks)
        t0 = time.perf_counter()
        with obs.span("engine.prefill_chunk", uid=req.uid, start=start,
                      chunk=c):
            self.cache, logits = chunk(
                self.params, toks, self.cache,
                self.state["page_table"][slot], start, last)
        if self._spec:
            self.draft_cache, _ = self._chunk_bucket(c, draft=True)(
                self.draft_params, toks, self.draft_cache,
                self.state["page_table"][slot], start, last)
        self.chunks_prefilled += 1
        obs.incr("engine.chunks_prefilled")
        self.state["lengths"][slot] = end
        if end >= plen:
            rec.prefill_cursor = -1
            first = self._sample_slot(logits[0], req, plen)
            rec.generated = [first]
            rec.next_token = first
            self.tokens_generated += 1
            obs.incr("engine.tokens_generated")
            if self.prefix is not None:
                self.prefix.insert(req.prompt, rec.pages, self.alloc)
        else:
            rec.prefill_cursor = end
        self._sync()
        self.timings["prefill_s"] += time.perf_counter() - t0
        self.timings["prefill_tokens"] += end - start

    def _try_grow(self, tokens_ahead: int = 1) -> list:
        """Allocate next pages for slots crossing a page boundary; returns
        the slots whose growth the exhausted pool could not cover.
        ``tokens_ahead`` > 1 (speculative rounds) reserves headroom for the
        whole verify block. Mid-prefill slots already hold every page their
        prompt needs, so they never grow (and never stall)."""
        stalled = []
        lengths = self.state["lengths"]
        for slot in sorted(self.slots):
            rec = self.slots[slot]
            if rec.prefilling:
                continue
            need = int(lengths[slot]) + tokens_ahead
            while need > rec.n_pages * self.page_size:
                if not self.alloc.can_alloc(1) and self.prefix is not None:
                    # cached-but-unreferenced prefix pages are reclaimable
                    self.prefix.evict(self.alloc, 1)
                if self.alloc.can_alloc(1):
                    page = self.alloc.alloc(1)[0]
                    self.state["page_table"][slot, rec.n_pages] = page
                    rec.pages.append(page)
                    rec.n_pages += 1
                else:
                    stalled.append(slot)
                    break
        return stalled

    def _preempt(self, slot: int) -> None:
        """Recompute preemption (the vLLM policy): free the slot's pages and
        requeue a continuation (prompt := prompt + generated so far, budget
        := the remaining tokens) at the front of the queue. Re-admission
        re-prefills the lost KV; retirement rebuilds the full result from
        the continuation's longer prompt, so the output is unchanged.
        Frees drop one reference per page: pages shared with the prefix
        trie (or another sequence) survive with their remaining refs."""
        rec = self.slots[slot]
        self.alloc.free(rec.pages)
        kvc.release_slot(self.state, slot)
        gen = rec.generated[: rec.req.max_new_tokens]
        cont = Request(
            rec.req.uid,
            np.concatenate([np.asarray(rec.req.prompt, np.int32),
                            np.asarray(gen, np.int32)]),
            max(0, rec.req.max_new_tokens - len(gen)),
            temperature=rec.req.temperature,
            seed=rec.req.seed)
        self.pending.appendleft(cont)
        self.preemptions += 1
        obs.incr("engine.preemptions")
        self.preempted_uids.add(rec.req.uid)
        del self.slots[slot]

    def _retire(self, slot: int, rec: _Slot) -> None:
        self.alloc.free(rec.pages)      # per-page ref drop, not a hard free
        kvc.release_slot(self.state, slot)
        gen = rec.generated[: rec.req.max_new_tokens]
        self.results[rec.req.uid] = np.concatenate(
            [np.asarray(rec.req.prompt, np.int32),
             np.asarray(gen, np.int32)])
        del self.slots[slot]

    def _launch_views(self, active: list, mp_bucket: int):
        """(page_table, lengths, act) host arrays for a decode launch.
        Mid-prefill slots are masked out by zeroing their rows: masked rows
        write to the null page and attend to nothing, so a chunk-interleaved
        slot never perturbs the batch it shares a launch with."""
        pt = self.state["page_table"][:, :mp_bucket]
        lens = self.state["lengths"]
        act = np.zeros((self.batch_slots,), np.int32)
        act[active] = 1
        if any(r.prefilling for r in self.slots.values()):
            pt = pt * act[:, None]
            lens = lens * act
        return pt, lens, act

    def _decode_one(self, active: list, mp_bucket: int) -> None:
        """One single-token decode step for every decode-ready slot."""
        decode = self._decode_bucket(mp_bucket)
        pt, lens, act = self._launch_views(active, mp_bucket)
        tokens = np.zeros((self.batch_slots, 1), np.int64)
        for slot in active:
            tokens[slot, 0] = self.slots[slot].next_token
        t0 = time.perf_counter()
        with obs.span("engine.decode_step", active_slots=len(active),
                      mp_bucket=mp_bucket):
            logits = decode(token=tokens, page_table=pt, lengths=lens)
            self.state["lengths"] = self.state["lengths"] + act
            sampled = {}
            greedy = None
            for slot in active:
                rec = self.slots[slot]
                if self._effective_temperature(rec.req) == 0.0:
                    if greedy is None:      # one batched argmax for all
                        greedy = torch.argmax(logits, dim=-1).cpu().numpy()
                    sampled[slot] = int(greedy[slot])
                else:
                    pos = len(rec.req.prompt) + len(rec.generated)
                    sampled[slot] = self._sample_slot(logits[slot], rec.req,
                                                      pos)
            self._sync()
        self.timings["decode_s"] += time.perf_counter() - t0
        self.timings["decode_tokens"] += len(active)
        self.decode_steps += 1
        self.tokens_generated += len(active)
        obs.incr("engine.tokens_generated", len(active))
        for slot in active:
            rec = self.slots[slot]
            rec.generated.append(sampled[slot])
            rec.next_token = sampled[slot]

    def _spec_round(self, active: list, mp_bucket: int) -> None:
        """One speculative round: k draft steps propose d1 .. d_{k-1}, the
        target verifies [t0, d1 .. d_{k-1}] in one k-token step, and each
        slot keeps the longest agreeing prefix plus the target's token after
        it (1 to k tokens).

        The draft makes k appends (the last feeds d_{k-1}, its logits
        unused), so its pools have no hole at the round's last position.
        Rejected positions leave stale KV above the accepted length in both
        pools; the next round's appends start at the new length and cover
        every stale position before anything reads it. The round's views,
        its first tokens and the proposals stay on the device, so its k + 1
        launches follow each other with no host wait; it reads back its
        tokens once, after the verify."""
        k = self.spec_tokens
        draft = self._decode_bucket(mp_bucket, draft=True)
        verify = self._verify_bucket(mp_bucket)
        base = self.state["lengths"].copy()
        t0 = time.perf_counter()
        pt, lens, act = (torch.as_tensor(np.ascontiguousarray(x),
                                         device=self.device)
                         for x in self._launch_views(active, mp_bucket))
        first = np.zeros((self.batch_slots, 1), np.int64)
        for slot in active:
            first[slot, 0] = self.slots[slot].next_token
        first = self._tokens(first)
        live = act.long()[:, None]              # zeroes the idle slots' tokens
        cur, proposals = first, []
        with obs.span("engine.spec_draft", active_slots=len(active), k=k,
                      mp_bucket=mp_bucket):
            for i in range(k):
                logits = draft(token=cur, page_table=pt,
                               lengths=lens + i * act)
                if i == k - 1:
                    break                       # a KV-only append of d_{k-1}
                cur = torch.argmax(logits, dim=-1, keepdim=True) * live
                proposals.append(cur)
        # the round's launches are queued without a host wait: a span ends
        # when its launches are issued, the verify's at its read-back
        with obs.span("engine.spec_verify", active_slots=len(active), k=k,
                      mp_bucket=mp_bucket):
            logits = verify(token=torch.cat([first] + proposals, dim=1),
                            page_table=pt, lengths=lens)
            # one read-back: the proposals (B, k-1), then the target's (B, k)
            host = torch.cat(proposals + [torch.argmax(logits, dim=-1)],
                             dim=1).cpu().numpy()
        drafted, preds = host[:, :k - 1], host[:, k - 1:]
        self._sync()
        emitted_all = accepted = 0
        for slot in active:
            rec = self.slots[slot]
            j = 0
            while j < k - 1 and drafted[slot, j] == preds[slot, j]:
                j += 1
            emitted = [int(x) for x in drafted[slot, :j]]
            emitted.append(int(preds[slot, j]))
            rec.generated.extend(emitted)
            rec.next_token = emitted[-1]
            self.state["lengths"][slot] = int(base[slot]) + j + 1
            self.spec_proposed += k - 1
            self.spec_accepted += j
            accepted += j
            self.spec_emitted += len(emitted)
            self.spec_participations += 1
            emitted_all += len(emitted)
        self.tokens_generated += emitted_all
        self.spec_rounds += 1
        obs.incr("engine.tokens_generated", emitted_all)
        obs.incr("engine.spec.rounds")
        obs.incr("engine.spec.proposed", (k - 1) * len(active))
        obs.incr("engine.spec.accepted", accepted)
        self.timings["decode_s"] += time.perf_counter() - t0
        self.timings["decode_tokens"] += emitted_all

    @torch.inference_mode()
    def step(self) -> bool:
        """Admit, advance mid-prefill slots by one chunk, decode one step
        (or one speculative round) for every decode-ready slot, retire
        finished. Returns False when there is nothing left to do."""
        self._admit()
        # chunk-interleaved prefill: one chunk per slot per step bounds the
        # decode stall at one chunk instead of one full prompt
        for slot in sorted(self.slots):
            rec = self.slots[slot]
            if rec.prefilling:
                self._advance_prefill(slot, rec)
        # retire slots that completed at admission (max_new_tokens == 1)
        for slot in [s for s, r in self.slots.items()
                     if not r.prefilling
                     and len(r.generated) >= r.req.max_new_tokens]:
            self._retire(slot, self.slots[slot])
        if not self.slots:
            if self.pending:
                self._admit()
                if not self.slots:
                    raise RuntimeError(
                        "paged engine stalled: pending requests but no "
                        "admissible slot (page pool too small?)")
                return True
            return False

        # page growth; on pool exhaustion preempt the youngest stalled slot
        # (freeing its pages) until the survivors fit. A lone slot never
        # stalls: submit() bounds any single sequence to the pool size.
        ahead = self.spec_tokens if self._spec else 1
        stalled = self._try_grow(ahead)
        while stalled:
            self._preempt(stalled[-1])
            stalled = self._try_grow(ahead)
        if not self.slots:
            return bool(self.pending)   # everything preempted; re-admit next
        active = [s for s, r in sorted(self.slots.items())
                  if not r.prefilling]
        if not active:
            self.steps += 1
            return True                 # all slots mid-prefill; decode next
        mp_bucket = self.page_bucket(max(self.slots[s].n_pages
                                         for s in active))
        self._note_occupancy()
        if self._spec:
            self._spec_round(active, mp_bucket)
        else:
            self._decode_one(active, mp_bucket)
        self.steps += 1

        for slot in list(self.slots):
            rec = self.slots[slot]
            if rec.prefilling:
                continue
            if len(rec.generated) >= rec.req.max_new_tokens:
                self._retire(slot, rec)
        return bool(self.slots or self.pending)

    def page_bucket(self, max_pages: int) -> int:
        """The page-table width of a decode launch whose longest active
        sequence holds ``max_pages`` pages: the next power of two, capped at
        ``max_pages_per_seq``."""
        return min(self.max_pages_per_seq, _pow2(max_pages))

    def report(self) -> dict:
        """Engine-level metrics, cumulative since construction, with the
        bucket LRU's hits, misses and evictions (``bucket_lru``).
        ``prefills`` and ``decode_steps`` count the exact-length prefills
        and the decode launches (a speculative round is counted under
        ``speculative``, not there); ``preempted_uids`` the requests
        preempted at least once."""
        out = {
            "steps": self.steps,
            "admissions": self.admissions,
            "preemptions": self.preemptions,
            "preempted_uids": sorted(self.preempted_uids),
            "prefills": self.prefills,
            "decode_steps": self.decode_steps,
            "tokens_generated": self.tokens_generated,
            "peak_pages_in_use": self.peak_pages_in_use,
            "page_pool_size": self.n_pages - 1,
            "bucket_lru": dict(self.lru_stats),
            "completed": len(self.results),
            "timings": dict(self.timings),
        }
        if self.prefix is not None:
            p = self.prefix
            out["prefix_cache"] = {
                "lookups": p.lookups,
                "hits": p.hits,
                "hit_rate": p.hits / p.lookups if p.lookups else 0.0,
                "matched_tokens": p.matched_tokens,
                "pages_held": p.pages_held,
                "hit_uids": sorted(self.prefix_hit_uids),
            }
        if self.chunk_tokens is not None:
            out["chunked_prefill"] = {"chunk_tokens": self.chunk_tokens,
                                      "chunks": self.chunks_prefilled}
        if self._spec:
            out["speculative"] = {
                "k": self.spec_tokens,
                "rounds": self.spec_rounds,
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "accept_rate": (self.spec_accepted / self.spec_proposed
                                if self.spec_proposed else 0.0),
                # emitted tokens per sequence per verify round, in [1, k]
                "mean_tokens_per_round":
                    (self.spec_emitted / self.spec_participations
                     if self.spec_participations else 0.0),
            }
        return out

    def run(self) -> dict:
        """Drive :meth:`step` until idle; returns {uid: tokens} results.
        :meth:`report` carries the run's engine metrics."""
        with obs.span("engine.run"):
            while self.step():
                pass
        return self.results
