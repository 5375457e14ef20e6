"""The port's telemetry (``repro_torch.obs``) on the CPU: the reference's
contract for its copy (a no-op that allocates nothing with no capture,
nested captures, spans, counters and gauges, the exporters and
``tools/trace_check.py``); each kernel entry's journal in kernel mode (the
entries run their plain versions here and journal all the same); one
layer's journal against the JAX package's for its traced block in
interpret mode (llama, whisper-base, mixtral-8x7b); both engines' and the
trainer's counters against the JAX engines' and trainer's on the same
traffic, and against the port's own attributes.

Inputs are made with numpy from a seed; the models run the reference's
seeded init converted with ``params_from_numpy``, in fp32.
"""
import contextlib
import dataclasses
import functools
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from repro import obs as jobs
from repro.configs import get_config as j_get_config
from repro.core import autotune
from repro.data import pipeline as jdata
from repro.models import build_model as j_build_model
from repro.optim import optimizer as jopt
from repro.serve import Engine as JEngine
from repro.serve import PagedEngine as JPagedEngine
from repro.serve import Request as JRequest
from repro.serve import RequestQueue as JRequestQueue
from repro.train import train_loop as j_train_loop

from repro_torch import data as tdata
from repro_torch import kernels, obs
from repro_torch import optim as topt
from repro_torch.configs import get_config
from repro_torch.kernels.attention import (attention, attention_decode,
                                           attention_decode_paged)
from repro_torch.kernels.fused_norm import dropout_residual_layernorm
from repro_torch.kernels.gemm import Epilogue, Prologue, gemm_fused
from repro_torch.kernels.rope import rope, rope_tables
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serve import Engine, PagedEngine, Request, RequestQueue
from repro_torch.train import train_loop

REPO = pathlib.Path(__file__).resolve().parent.parent
TRACE_CHECK = REPO / "tools" / "trace_check.py"
# the small llama of tests/test_torch_paged.py
SMALL = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             d_ff=256, vocab_size=512)


def _rand(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32) * 0.5)


def _cfgs(arch, **extra):
    """(JAX, port) configs in fp32: the small llama, or an arch's smoke
    config."""
    if arch == "llama":
        return tuple(dataclasses.replace(get("llama-1b"),
                                         compute_dtype="float32",
                                         **dict(SMALL, **extra))
                     for get in (j_get_config, get_config))
    return tuple(dataclasses.replace(get(arch, smoke=True),
                                     compute_dtype="float32", **extra)
                 for get in (j_get_config, get_config))


@functools.lru_cache(maxsize=None)
def _np_params(arch, **extra):
    jcfg, _ = _cfgs(arch, **extra)
    return jax.tree.map(np.asarray, j_build_model(
        jcfg, mode="reference").init(jax.random.PRNGKey(0)))


def _port_model(arch, mode="kernel", **extra):
    _, cfg = _cfgs(arch, **extra)
    return (build_model(cfg, mode=mode, device="cpu"),
            params_from_numpy(_np_params(arch, **extra), "cpu",
                              torch.float32))


# ---------------------------------------------------------------------------
# The obs copy: the reference's contract
# ---------------------------------------------------------------------------

def test_recording_api_is_a_noop_without_capture():
    assert not obs.enabled() and not obs.timing_enabled()
    obs.incr("nope")
    obs.gauge("nope", 3.0)
    obs.launch("gemm_fused", flops=1)
    obs.plan_decision("policy", "gemm", (1, 1, 1), "f32", {})
    with obs.span("nope", k=1):
        pass
    assert not obs.enabled()


def _forward():
    model, params = _port_model("llama")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, SMALL["vocab_size"], (2, 16)))
    with torch.no_grad():
        model.forward(params, tokens)


def _engine_run():
    model, params = _port_model("llama")
    eng = PagedEngine(model, params, batch_slots=2, page_size=8,
                      max_pages_per_seq=4, prefix_cache=True, chunk_tokens=8)
    for r in _requests(Request, "mixed"):
        eng.submit(r)
    eng.run()


def _train_step():
    model, _ = _port_model("llama")
    dcfg = tdata.DataConfig(vocab_size=SMALL["vocab_size"], seq_len=16,
                            global_batch=2)
    train_loop(model, tdata.DataIterator(dcfg, device="cpu"), 1,
               topt.AdamWConfig(schedule=topt.constant_schedule(1e-3)),
               log_every=0)


@pytest.mark.parametrize("run", [_forward, _engine_run, _train_step],
                         ids=["forward", "engine_run", "train_step"])
def test_instrumented_paths_allocate_nothing_when_disabled(run):
    """The acceptance criterion: a kernel-mode forward, a PagedEngine run
    with its fast paths and a training step, with no recorder active,
    build no event object."""
    obs.reset_null_allocations()
    run()
    assert not obs.enabled()
    assert obs.null_allocations() == 0


def test_tripwire_fires_on_an_unguarded_record():
    obs.reset_null_allocations()
    obs._record_launch(obs.LaunchEvent(op="rogue"))
    assert obs.null_allocations() == 1
    obs.reset_null_allocations()


def _gemm(seed=0):
    return gemm_fused(_rand(seed, 32, 64), _rand(seed + 1, 64, 64),
                      out_dtype=torch.float32)


def test_nested_captures_fan_out():
    with obs.capture() as outer:
        _gemm()
        with obs.capture() as inner:
            _gemm()
    assert inner.count("gemm_fused") == 1
    assert outer.count("gemm_fused") == 2
    assert outer.count("gemm_fused", variant="kernel") == 2


@pytest.mark.parametrize("kind", ["counter", "gauge", "span"])
def test_spans_counters_and_gauges(kind):
    with obs.capture() as cap:
        with obs.span("outer", tag="x"):
            obs.incr("hits")
            obs.incr("hits", 2.0)
            obs.gauge("peak", 3.0)
            obs.gauge("peak", 1.0)   # the running max keeps 3
    if kind == "counter":
        assert cap.counter("hits") == 3.0 and cap.counter("absent") == 0.0
    elif kind == "gauge":
        assert cap.counter("peak") == 3.0
    else:
        assert [s.name for s in cap.spans] == ["outer"]
        assert cap.spans[0].meta == {"tag": "x"} and cap.spans[0].dur >= 0


def test_summary_block_and_plan_audit():
    with obs.capture() as cap:
        with obs.span("s"):
            _gemm()
        obs.incr("c")
        obs.plan_decision("fusion", "mlp", (8, 8), "float32",
                          {"plan": "fused"}, candidates=[{"plan": "x"}])
    s = cap.summary()
    assert s["launches"] == {"gemm_fused": 1}
    assert s["modeled_dma_bytes"] == {"gemm_fused": 0}
    assert s["counters"] == {"c": 1.0}
    # the launch's policy verdict (the policy layer's) and the fusion one
    assert s["spans"] == 1 and s["plan_decisions"] == 2
    assert [p.op for p in cap.plans_of("policy")] == ["gemm"]
    assert cap.plans_of("fusion")[0].to_json()["chosen"] == {"plan": "fused"}


def test_timing_capture_fills_wall_clock():
    with obs.capture(timing=True) as cap:
        assert obs.timing_enabled()
        _gemm()
    (ev,) = cap.launches
    assert ev.wall_s is not None and ev.wall_s > 0
    with obs.capture() as cap:
        _gemm()
    assert cap.launches[0].wall_s is None


def _exported(tmp_path, key="t"):
    with obs.capture(timing=True) as cap:
        with obs.span("window", case="test"):
            _gemm()
            attention(_rand(3, 1, 2, 16, 16), _rand(4, 1, 1, 16, 16),
                      _rand(5, 1, 1, 16, 16), causal=True)
        obs.incr("tokens", 7)
    obs.export_chrome_trace(cap, tmp_path / f"TRACE_{key}.json")
    obs.export_counters(cap, tmp_path / f"COUNTERS_{key}.json")
    return cap


def test_chrome_trace_schema(tmp_path):
    _exported(tmp_path)
    doc = json.loads((tmp_path / "TRACE_t.json").read_text())
    evs = doc["traceEvents"]
    assert evs and all(
        isinstance(e["name"], str) and isinstance(e["pid"], int)
        and isinstance(e["ts"], (int, float)) and e["ph"] in "XiC"
        for e in evs)
    launches = [e for e in evs if e.get("cat") == "launch"]
    assert [e["name"] for e in launches] == ["gemm_fused", "attention_fwd"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in launches)
    assert launches[1]["args"]["dma_bytes"] > 0
    assert any(e["name"] == "tokens" and e["ph"] == "C" for e in evs)
    assert doc["otherData"]["producer"] == "repro_torch.obs"
    # each launch's policy verdict, from the policy layer
    assert [(p["kind"], p["op"]) for p in doc["otherData"]["plan_decisions"]] \
        == [("policy", "gemm"), ("policy", "attention_fwd")]
    assert [e["args"]["policy"]["op"] for e in launches] \
        == ["gemm", "attention_fwd"]


def test_counters_export_stable_keys(tmp_path):
    _exported(tmp_path)
    doc = json.loads((tmp_path / "COUNTERS_t.json").read_text())
    assert list(doc) == ["counters", "launches"]
    assert doc["counters"] == {"tokens": 7}
    assert doc["launches"] == {"attention_fwd": 1, "gemm_fused": 1}


def _trace_check(path):
    return subprocess.run([sys.executable, str(TRACE_CHECK), str(path)],
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("case", ["exports", "bad_trace", "bad_counters",
                                  "empty"])
def test_trace_check_tool(tmp_path, case):
    """``tools/trace_check.py`` passes the port's exports and rejects a
    trace event without a name or pid, a counter that is not a number, and
    a directory with nothing to check."""
    if case == "exports":
        _exported(tmp_path)
    elif case == "bad_trace":
        _exported(tmp_path)
        (tmp_path / "TRACE_bad.json").write_text(
            json.dumps({"traceEvents": [{"ph": "X"}]}))
    elif case == "bad_counters":
        (tmp_path / "COUNTERS_bad.json").write_text(
            json.dumps({"counters": {"a": "x"}, "launches": {"g": -1}}))
    res = _trace_check(tmp_path)
    if case == "exports":
        assert res.returncode == 0, res.stderr
        assert "OK (1 traces, 1 counter files" in res.stdout
    else:
        assert res.returncode == 1
        if case != "empty":
            assert "_bad.json" in res.stderr


# ---------------------------------------------------------------------------
# The kernel entries' journal
# ---------------------------------------------------------------------------

def _gemm_bwd():
    a = _rand(0, 24, 64).requires_grad_()
    b = _rand(1, 64, 32).requires_grad_()
    b2 = _rand(2, 64, 32).requires_grad_()
    out = gemm_fused(a, b, b2=b2, epilogue=Epilogue(activation="silu",
                                                     gate=True),
                     prologue=Prologue(norm="rmsnorm"),
                     gamma=torch.ones(64), out_dtype=torch.float32)
    out.sum().backward()


def _attention_bwd():
    q = _rand(0, 1, 4, 16, 16).requires_grad_()
    k = _rand(1, 1, 2, 16, 16).requires_grad_()
    v = _rand(2, 1, 2, 16, 16).requires_grad_()
    attention(q, k, v, causal=True, window=8).sum().backward()


def _decode():
    attention_decode(_rand(0, 2, 4, 1, 16), _rand(1, 2, 2, 32, 16),
                     _rand(2, 2, 2, 32, 16),
                     torch.tensor([5, 32], dtype=torch.int32), softcap=30.0)


def _decode_paged():
    table = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    attention_decode_paged(_rand(0, 2, 4, 2, 16), _rand(1, 4, 2, 8, 16),
                           _rand(2, 4, 2, 8, 16), table,
                           torch.tensor([12, 5], dtype=torch.int32))


def _rope():
    sin, cos = rope_tables(torch.arange(16), 16)
    x = _rand(0, 1, 2, 16, 16).requires_grad_()
    rope(x, sin, cos).sum().backward()


def _fused_norm():
    x = _rand(0, 8, 32)
    dropout_residual_layernorm(x, x, torch.ones(32), torch.zeros(32), 3,
                               dropout_p=0.1)


# entry -> its journal, (op, variant, chain, flops) in order
ENTRIES = {
    "gemm_fused": (_gemm, [("gemm_fused", "kernel", "none|none",
                            2 * 32 * 64 * 64)]),
    "gemm_fused_bwd": (_gemm_bwd, [
        ("gemm_fused", "kernel", "rmsnorm|silu*gate", 2 * 2 * 24 * 32 * 64),
        ("gemm_bwd_g", "g", "rmsnorm|silu*gate", None),
        ("gemm_bwd_da", "da", "rmsnorm|silu*gate", 2 * 24 * 32 * 64),
        ("gemm_bwd_db", "db", "rmsnorm|silu*gate", 2 * 2 * 24 * 32 * 64)]),
    "attention_bwd": (_attention_bwd, [
        ("attention_fwd", "windowed", "none", 4 * 4 * 16 * 16 * 16 // 2),
        ("attention_bwd", "causal", "none", 10 * 4 * 16 * 16 * 16 // 2),
        ("flash_attention_bwd", "dq_convert", None, None)]),
    "decode": (_decode, [("attention_decode", "", "softcap30",
                          4 * 2 * 4 * 32 * 16)]),
    "decode_paged": (_decode_paged, [("attention_decode", "paged", "none",
                                      4 * 2 * 4 * 2 * 2 * 8 * 16)]),
    "rope": (_rope, [("rope", "", None, 6 * 2 * 16 * 16),
                     ("rope", "bwd", None, 6 * 2 * 16 * 16)]),
    "fused_norm": (_fused_norm, [("fused_norm", "", None, 10 * 8 * 32)]),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_kernel_entry_journal(entry):
    """Each entry journals one event per launch it makes on the card, under
    the reference's op names and flops formulas (the launches the reference
    has no event for under their kernel's name), each mapped to its kernel
    by ``kernels.journal_counts``; the attention events carry the port's
    unique bytes."""
    run, want = ENTRIES[entry]
    with obs.capture() as cap:
        run()
    got = [(e.op, e.variant, e.chain, e.flops) for e in cap.launches]
    assert got == want
    counts = kernels.journal_counts(cap)
    assert sum(counts.values()) == len(want)
    assert all(e.wall_s is None for e in cap.launches)
    for e in cap.launches:
        assert (e.dma_bytes is not None) == e.op.startswith(
            ("attention_fwd", "attention_bwd", "flash_attention_bwd")), e


def test_journal_counts_map_every_kernel():
    """Every kernel has an op in the journal's table, and the paged decode
    kernel is told apart from the contiguous one by its variant."""
    names = {k.name for k in kernels.KERNELS}
    assert set(kernels.JOURNAL_KERNELS.values()) == names
    with obs.capture() as cap:
        _decode()
        _decode_paged()
        _decode_paged()
    counts = kernels.journal_counts(cap)
    assert counts["flash_decode"] == 1 and counts["flash_decode_paged"] == 2


# ---------------------------------------------------------------------------
# One layer's journal against the JAX package's traced block
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _jax_fused():
    """Pin the reference's fusion decisions to the fused plans that the
    port's kernel mode runs (its byte model decides per shape): the QKV
    chains with and without the rope store, and the MLP's."""
    orig = autotune.select_fusion

    def pinned(kind, shape, dtype="bfloat16", **kw):
        out = orig(kind, shape, dtype, **kw)
        return (dict(out, plan="fused")
                if kind in ("qkv_rope", "qkv", "mlp") else out)

    autotune.clear_policy_cache()
    autotune.select_fusion = pinned
    try:
        yield
    finally:
        autotune.select_fusion = orig
        autotune.clear_policy_cache()


ONE_LAYER = {"llama": dict(num_layers=1),
             "whisper-base": dict(num_layers=1, encoder_layers=1),
             "mixtral-8x7b": dict(num_layers=1)}


def _batch(arch, cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    if cfg.family != "encdec":
        return toks
    emb = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    return {"encoder_embeds": emb, "inputs": toks}


@pytest.mark.parametrize("arch", list(ONE_LAYER))
def test_one_layer_journal_matches_jax(arch):
    """One layer's forward in kernel mode without remat (whisper: one
    encoder and one decoder layer): the port's launch journal has the JAX
    package's ops, variants and chains in order (its scan traces the block
    once; interpret mode, the fused plans pinned), and the same
    standalone-norm and standalone-rope counts. 48 tokens: mixtral's
    window of 32 makes its attention 'windowed'."""
    extra = ONE_LAYER[arch]
    jcfg, cfg = _cfgs(arch, **extra)
    batch = _batch(arch, cfg)
    with _jax_fused(), jobs.capture() as jcap:
        m = j_build_model(jcfg, mode="pallas_interpret")
        m.forward(jax.tree.map(jax.numpy.asarray, _np_params(arch, **extra)),
                  jax.tree.map(jax.numpy.asarray, batch))
    model, params = _port_model(arch, **extra)
    tb = (torch.from_numpy(batch).long() if cfg.family != "encdec" else
          {"encoder_embeds": torch.from_numpy(batch["encoder_embeds"]),
           "inputs": torch.from_numpy(batch["inputs"]).long()})
    with torch.no_grad(), obs.capture() as cap:
        model.forward(params, tb)
    want = [(e.op, e.variant, e.chain) for e in jcap.launches]
    got = [(e.op, e.variant, e.chain) for e in cap.launches]
    assert got == want
    assert len(got) >= 5
    for name in ("model.standalone_norm", "model.standalone_rope"):
        assert cap.counter(name) == jcap.counter(name), name


# ---------------------------------------------------------------------------
# The engines' and the trainer's counters against the JAX package's
# ---------------------------------------------------------------------------

def _requests(cls, kind):
    """Three prompts of 5-17 tokens (two sharing a 9-token prefix), 5-11
    new tokens; under ``"tight"`` two 4-token prompts, 10 new each."""
    rng = np.random.default_rng(4)
    v = SMALL["vocab_size"]
    if kind == "tight":
        return [cls(u, rng.integers(0, v, 4).astype(np.int32), 10)
                for u in range(2)]
    head = rng.integers(0, v, 9).astype(np.int32)
    prompts = [rng.integers(0, v, 5), np.concatenate([head, [1, 2, 3]]),
               np.concatenate([head, rng.integers(0, v, 8)])]
    return [cls(u, np.asarray(p, np.int32), (9, 6, 11)[u])
            for u, p in enumerate(prompts)]


# engine kind -> (PagedEngine keywords, traffic, self-draft)
PAGED_RUNS = {
    "fast_paths": (dict(batch_slots=2, page_size=8, max_pages_per_seq=4,
                        prefix_cache=True, chunk_tokens=8), "mixed", True),
    "preemption": (dict(batch_slots=2, page_size=4, max_pages_per_seq=6,
                        n_pages=6), "tight", False),
}


def _engine_counters(cap):
    return {k: v for k, v in cap.counters.items() if k.startswith("engine.")}


@functools.lru_cache(maxsize=None)
def _jax_paged(kind):
    kw, traffic, draft = PAGED_RUNS[kind]
    jcfg, _ = _cfgs("llama")
    jm = j_build_model(jcfg, mode="reference")
    params = jax.tree.map(jax.numpy.asarray, _np_params("llama"))
    if draft:
        kw = dict(kw, draft_model=jm, draft_params=params, spec_tokens=3)
    with jobs.capture() as cap:
        eng = JPagedEngine(jm, params, **kw)
        for r in _requests(JRequest, traffic):
            eng.submit(r)
        eng.run()
    return _engine_counters(cap), sorted({s.name for s in cap.spans})


@pytest.mark.parametrize("kind", list(PAGED_RUNS))
def test_paged_engine_counters_match_jax(kind):
    """PagedEngine with a prefix cache, 8-token chunks and a self-draft
    (k 3), and a pool small enough to preempt: every ``engine.*`` counter
    and gauge equals the JAX PagedEngine's on the same traffic, and the
    engine's own attributes and report(); the spans have the reference's
    names."""
    kw, traffic, draft = PAGED_RUNS[kind]
    model, params = _port_model("llama", mode="reference")
    if draft:
        kw = dict(kw, draft_model=model, draft_params=params, spec_tokens=3)
    with obs.capture() as cap:
        eng = PagedEngine(model, params, **kw)
        for r in _requests(Request, traffic):
            eng.submit(r)
        eng.run()
    want, spans = _jax_paged(kind)
    got = _engine_counters(cap)
    assert got == want
    assert sorted({s.name for s in cap.spans}) == spans
    rep = eng.report()
    attrs = {"engine.admissions": eng.admissions,
             "engine.tokens_generated": eng.tokens_generated,
             "engine.peak_pages_in_use": eng.peak_pages_in_use,
             "engine.preemptions": eng.preemptions,
             "engine.chunks_prefilled": eng.chunks_prefilled,
             **{f"engine.bucket_lru.{k}": v
                for k, v in rep["bucket_lru"].items()}}
    if draft:
        attrs.update({"engine.spec.rounds": eng.spec_rounds,
                      "engine.spec.proposed": eng.spec_proposed,
                      "engine.spec.accepted": eng.spec_accepted})
    if eng.prefix is not None:
        attrs.update({"engine.prefix.lookups": rep["prefix_cache"]["lookups"],
                      "engine.prefix.hits": rep["prefix_cache"]["hits"],
                      "engine.prefix.tokens_saved":
                          rep["prefix_cache"]["matched_tokens"]})
    assert {k: got.get(k, 0) for k in attrs} == attrs
    if kind == "preemption":
        assert eng.preemptions >= 1
        assert cap.count("attention_decode", variant="paged") == 0  # plain
    else:
        assert rep["prefix_cache"]["hits"] >= 1 and eng.spec_rounds >= 1


@functools.lru_cache(maxsize=None)
def _jax_queue():
    jcfg, _ = _cfgs("llama")
    jm = j_build_model(jcfg, mode="reference")
    params = jax.tree.map(jax.numpy.asarray, _np_params("llama"))
    with jobs.capture() as cap:
        q = JRequestQueue(JEngine(jm, params, max_len=48,
                                  max_cached_buckets=2), 2, buckets=(32,))
        for r in _requests(JRequest, "mixed"):
            q.submit(r)
        q.flush(force=True)
    return _engine_counters(cap), [(s.name, s.meta) for s in cap.spans]


def test_engine_counters_match_jax():
    """Engine behind a RequestQueue (two batches, a bucket cap of 2): the
    bucket LRU's counters equal the JAX Engine's and ``lru_stats``, and each
    batch is an ``engine.prefill`` then an ``engine.decode`` span with the
    reference's fields."""
    model, params = _port_model("llama", mode="reference")
    eng = Engine(model, params, max_len=48, max_cached_buckets=2)
    with obs.capture() as cap:
        q = RequestQueue(eng, 2, buckets=(32,))
        for r in _requests(Request, "mixed"):
            q.submit(r)
        q.flush(force=True)
    want, spans = _jax_queue()
    got = _engine_counters(cap)
    assert got == want
    assert got == {f"engine.bucket_lru.{k}": v
                   for k, v in eng.lru_stats.items() if v}
    assert [(s.name, s.meta) for s in cap.spans] == spans


@functools.lru_cache(maxsize=None)
def _jax_trainer_counters(steps):
    jcfg, _ = _cfgs("llama")
    model = j_build_model(jcfg, mode="reference")
    dcfg = jdata.DataConfig(vocab_size=SMALL["vocab_size"], seq_len=16,
                            global_batch=2)
    opt = jopt.AdamWConfig(schedule=jopt.constant_schedule(1e-3))
    with jobs.capture() as cap:
        j_train_loop(model, jdata.DataIterator(dcfg), steps, opt,
                     log_every=0, log=lambda *a: None)
    return (cap.counter("trainer.steps"),
            [s.meta for s in cap.spans if s.name == "trainer.step"],
            {k: v for k, v in cap.counters.items()
             if k.startswith("trainer.bucket_pins")})


def test_trainer_counters_match_jax():
    """train_loop: ``trainer.steps`` and one ``trainer.step`` span per step
    (its ``step`` field), and the kernel-policy pinning's
    ``trainer.bucket_pins`` counters, as the JAX trainer records them."""
    steps = 3
    model, _ = _port_model("llama", mode="kernel")
    dcfg = tdata.DataConfig(vocab_size=SMALL["vocab_size"], seq_len=16,
                            global_batch=2)
    with obs.capture() as cap:
        train_loop(model, tdata.DataIterator(dcfg, device="cpu"), steps,
                   topt.AdamWConfig(schedule=topt.constant_schedule(1e-3)),
                   log_every=0)
    jsteps, jspans, jpins = _jax_trainer_counters(steps)
    spans = [s for s in cap.spans if s.name == "trainer.step"]
    assert cap.counter("trainer.steps") == jsteps == steps
    assert [s.meta for s in spans] == jspans == [{"step": i}
                                                 for i in range(steps)]
    assert all(s.dur > 0 for s in spans)
    assert {k: v for k, v in cap.counters.items()
            if k.startswith("trainer.bucket_pins")} == jpins == {
        "trainer.bucket_pins": 1.0, "trainer.bucket_pins.2x16": 1.0}
    # every layer's forward, its recompute and its backward journaled
    assert cap.count("gemm_fused") == steps * SMALL["num_layers"] * 8
    assert cap.count("gemm_bwd_da") == steps * SMALL["num_layers"] * 4


@pytest.mark.parametrize("policy,per_layer", [("full", 8), ("dots", 4),
                                              ("none", 4)])
def test_journal_follows_the_op_runs_under_remat(monkeypatch, policy,
                                                 per_layer):
    """A training step's forward GEMM events equal the custom op's runs
    (``ops.forward_ref`` counted): under "full" the recompute's launches
    are journaled, down to the block's last GEMM, where the recompute
    stops; under "dots" the outputs the policy kept are not launched
    again, and not journaled."""
    from repro_torch.kernels.gemm import ops as gemm_ops
    from repro_torch.train import init_state, loss_and_grads
    runs = []
    ref = gemm_ops.forward_ref

    def counting(*a, **kw):
        runs.append(1)
        return ref(*a, **kw)

    monkeypatch.setattr(gemm_ops, "forward_ref", counting)
    _, cfg = _cfgs("llama", remat_policy=policy)
    model = build_model(cfg, mode="kernel", device="cpu")
    batch = next(tdata.DataIterator(tdata.DataConfig(
        vocab_size=SMALL["vocab_size"], seq_len=16, global_batch=2),
        device="cpu"))
    with obs.capture() as cap:
        loss_and_grads(model, init_state(model, 0)["params"], batch)
    assert cap.count("gemm_fused") == len(runs) \
        == per_layer * SMALL["num_layers"]


@pytest.mark.parametrize("captured", [True, False],
                         ids=["captured", "no_capture"])
def test_backward_runs_on_the_capturing_thread(monkeypatch, captured):
    """``loss_and_grads`` runs autograd's backward on the calling thread
    (``torch.autograd.set_multithreading_enabled(False)``), with a capture
    or without, so a captured step runs as an uncaptured one: the
    recorder stack is per thread, and on the card autograd's device
    thread would journal none of the backward's launches."""
    from repro_torch.train import init_state, loss_and_grads
    modes = []
    real = torch.autograd.set_multithreading_enabled

    class spy(real):
        def __init__(self, mode):
            modes.append(mode)
            super().__init__(mode)

    monkeypatch.setattr(torch.autograd, "set_multithreading_enabled", spy)
    model, _ = _port_model("llama")
    batch = next(tdata.DataIterator(tdata.DataConfig(
        vocab_size=SMALL["vocab_size"], seq_len=16, global_batch=2),
        device="cpu"))
    params = init_state(model, 0)["params"]
    ctx = obs.capture() if captured else contextlib.nullcontext()
    with ctx as cap:
        loss_and_grads(model, params, batch)
    assert modes == [False]
    if captured:
        assert cap.count("gemm_bwd_da") == 4 * SMALL["num_layers"]
