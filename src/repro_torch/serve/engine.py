"""Fixed-batch serving: :class:`Engine` and the :class:`RequestQueue` over it.

:class:`Engine` runs one prefill and then one decode step per new token for
a fixed (batch, prompt_len) batch. :class:`RequestQueue` buckets requests by
padded prompt length and flushes full batches (a forced flush pads the last
batch with copies of its last request, which are not counted or returned).
Greedy decoding takes the first maximal logit; temperature sampling draws
through a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, prompt + generated) int32
    prompt_len: int
    steps: int


class Engine:
    """Fixed-batch prefill + decode over a model built by ``build_model``.

    ``timings`` keeps, per ``generate`` call, the wall-clock seconds of the
    prefill and of the decode loop (each ended by a device synchronise on
    CUDA) with the batch shape, for throughput reports.
    """

    def __init__(self, model, params, *, max_len: int = 4096):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.timings: list = []

    def _sync(self):
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    @staticmethod
    def _sample(logits, temperature: float, generator):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    @torch.inference_mode()
    def generate(self, prompts, max_new_tokens: int, *,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None
                 ) -> GenerationResult:
        """prompts: (B, S) token ids. Greedy (T = 0) or temperature sampling."""
        dev = self.model.device
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                  device=dev)
        b, s = prompts.shape
        if s + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {s} + {max_new_tokens} new tokens "
                             f"exceeds the cache length {self.max_len}")
        if temperature != 0.0 and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        cache = self.model.init_cache(b, self.max_len)
        t0 = time.perf_counter()
        cache, logits = self.model.prefill(self.params, prompts, cache)
        next_tok = self._sample(logits, temperature, generator)[:, None]
        self._sync()
        t1 = time.perf_counter()
        toks = [prompts]
        for i in range(max_new_tokens):
            toks.append(next_tok)
            if i == max_new_tokens - 1:
                break
            cache, logits = self.model.decode_step(self.params, next_tok,
                                                   cache, s + i)
            next_tok = self._sample(logits, temperature, generator)[:, None]
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
