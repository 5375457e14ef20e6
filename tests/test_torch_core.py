"""The port's policy layer (``repro_torch.core``) against the reference's
``repro.core`` on the CPU.

* ``grid_swizzle``'s orders, permutations, panel traffic and window pick,
  and ``cache_model``'s hit rates, equal the reference's exactly over a
  grid of (rows, cols, window, n_xcd, chunk); the Python mirror of the
  GEMM kernels' walk (``tile_coords``) equals ``windowed_traversal`` for
  every window the policies name;
* ``OpSignature.bucket()``, ``pretuned_cell_key`` and
  ``pretuned_fusion_key`` give the reference's keys for every op kind and
  chain the models launch;
* with no table installed ``select_policy`` is the kernels' hand-fitted
  plan (``plan_gemm``, ``pick_tile_n``, ``plan_decode``) at window 8;
* a table's schema and arch are checked with the reference's counters, a
  pinned cell wins, a miss falls through, an install invalidates the memo;
* a table's fitted ``chip`` is not installed: what the table does not pin
  decides as with no table;
* ``calibrate`` pins a measure's argmin; ``spearman`` and ``check_drift``
  equal the reference's; ``launch/calibrate.py`` exits with the drift
  gate's verdict (0 on the proxy rig, 1 where the measured ranking is the
  analytic one reversed); the ``plan_decision`` journal counts by kind
  (``cached`` included) equal the reference's for the same calls.
"""
import dataclasses
import itertools
import json
import os

import numpy as np
import pytest

from repro import obs as jobs
from repro.core import autotune as jat
from repro.core import cache_model as jcm
from repro.core import calibrate as jcal
from repro.core import grid_swizzle as jgs
from repro.kernels.gemm.epilogue import Epilogue as JEpilogue
from repro.kernels.gemm.prologue import Prologue as JPrologue

from repro_torch import obs
from repro_torch.configs import pretuned_table_path
from repro_torch.core import autotune as at
from repro_torch.core import cache_model as cm
from repro_torch.core import calibrate as cal
from repro_torch.core import grid_swizzle as gs
from repro_torch.core import perf_model as pm
from repro_torch.core.policy import policy_from_spec, policy_spec
from repro_torch.kernels.attention import decode
from repro_torch.kernels.gemm import backward as gemm_bwd
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.gemm.epilogue import Epilogue
from repro_torch.kernels.gemm.prologue import Prologue

REF_CPU_TABLE = os.path.join(os.path.dirname(jat.__file__), "..", "configs",
                             "pretuned", "cpu.json")


@pytest.fixture(autouse=True)
def _fresh_tables():
    """Each test starts and ends with no table and empty memos, in both
    packages."""
    for mod in (at, jat):
        mod.clear_pretuned()
        mod.clear_policy_cache()
    yield
    for mod in (at, jat):
        mod.clear_pretuned()
        mod.clear_policy_cache()


# ---------------------------------------------------------------------------
# grid_swizzle and cache_model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,cols", [(1, 1), (1, 7), (3, 5), (8, 8),
                                       (13, 4), (16, 9), (33, 2)])
def test_swizzle_equals_reference(rows, cols):
    for window, n_xcd, chunk in itertools.product((1, 2, 4, 8, 16), (1, 8),
                                                  (1, 3, 64)):
        for chiplet, win in ((True, True), (False, True), (True, False),
                             (False, False)):
            kw = dict(window=window, n_xcd=n_xcd, chunk=chunk,
                      enable_chiplet=chiplet, enable_window=win)
            got = gs.SwizzleConfig(**kw)
            want = jgs.SwizzleConfig(**kw)
            assert np.array_equal(gs.schedule_order(got, rows, cols),
                                  jgs.schedule_order(want, rows, cols))
            assert bool(gs.is_permutation(got, rows, cols)) \
                == bool(jgs.is_permutation(want, rows, cols)) is True
            assert gs.dma_bytes(got, rows, cols, 3, 5) \
                == jgs.dma_bytes(want, rows, cols, 3, 5)
    for a, b in ((1, 1), (100, 7), (7, 100)):
        assert gs.best_window(rows, cols, a, b) \
            == gs.SwizzleConfig(**dataclasses.asdict(
                jgs.best_window(rows, cols, a, b)))


@pytest.mark.parametrize("window", gs.WINDOWS + (2, 3))
def test_tile_coords_mirror_is_the_windowed_traversal(window):
    """The kernels' walk (csrc/gemm_sm90.cuh tile_coords) is Algorithm 1's
    windowed traversal at every window, every tile once."""
    for tiles_m, tiles_n in ((1, 1), (1, 9), (5, 3), (8, 16), (17, 6)):
        xy = np.arange(tiles_m * tiles_n)
        r, c = gs.windowed_traversal(xy, tiles_m, tiles_n, window)
        walk = [gs.tile_coords(int(t), tiles_m, tiles_n, window) for t in xy]
        assert walk == list(zip(r.tolist(), c.tolist()))
        assert sorted(walk) == sorted(itertools.product(range(tiles_m),
                                                        range(tiles_n)))


@pytest.mark.parametrize("window,chunk", [(1, 8), (4, 25), (8, 64)])
def test_cache_model_equals_reference(window, chunk):
    hw = dict(n_clusters=2, executors_per_cluster=4, l2_bytes=2 ** 18,
              llc_bytes=2 ** 20)
    for chiplet in (True, False):
        kw = dict(window=window, chunk=chunk, n_xcd=2, enable_chiplet=chiplet)
        got = cm.simulate_gemm_schedule(
            gs.SwizzleConfig(**kw), m=1024, n=768, k=512, block_m=128,
            block_n=128, block_k=128, hw=cm.CacheHW(**hw))
        want = jcm.simulate_gemm_schedule(
            jgs.SwizzleConfig(**kw), m=1024, n=768, k=512, block_m=128,
            block_n=128, block_k=128, hw=jcm.CacheHW(**hw))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    h100 = cm.simulate_gemm_schedule(gs.SwizzleConfig(window=window,
                                                      enable_chiplet=False),
                                     m=2048, n=2048, k=1024, block_m=128,
                                     block_n=256, block_k=256,
                                     hw=cm.CacheHW.h100())
    assert h100.llc_hit == 0.0 and 0.0 < h100.l2_hit < 1.0


# ---------------------------------------------------------------------------
# the keys
# ---------------------------------------------------------------------------

# (op, shape, causal, epilogue kwargs, prologue kwargs, variant): every op
# kind and chain the models launch
SIGS = [
    ("gemm", (1024, 2560, 2048), False, dict(rope=True, head_dim=64),
     dict(norm="rmsnorm"), ""),
    ("gemm", (1024, 2560, 2048), False, dict(rope=True, head_dim=64,
                                             bias=True), {}, ""),
    ("gemm", (1000, 512, 768), False, dict(bias=True),
     dict(norm="layernorm", beta=True), ""),
    ("gemm", (4, 8192, 2048), False, dict(activation="silu", gate=True),
     dict(norm="rmsnorm"), ""),
    ("gemm", (6000, 2048, 512), False, dict(activation="gelu"),
     dict(norm="layernorm", beta=True), ""),
    ("gemm", (1024, 2048, 8192), False, dict(residual=True, scale=True),
     {}, ""),
    ("gemm", (256, 4096, 14336), False, {}, {}, ""),
    ("gemm_bwd", (4096, 2048, 8192), False,
     dict(activation="silu", gate=True), dict(norm="rmsnorm"), "da"),
    ("gemm_bwd", (2048, 16384, 4096), False,
     dict(activation="silu", gate=True), dict(norm="rmsnorm"), "db"),
    ("gemm_bwd", (4096, 8192, 2048), False, dict(residual=True, scale=True),
     {}, "da"),
    ("attention_fwd", (3, 12, 512, 512, 64), True, {}, {}, ""),
    ("attention_bwd", (4, 32, 1024, 1024, 64), True, {}, {}, ""),
    ("attention_decode", (3, 8, 4, 296, 64), False, {}, {}, ""),
    ("fused_norm", (2048, 1024), False, {}, {}, ""),
    ("rope", (3, 10, 256, 256), False, {}, {}, ""),
]


def _sig_pair(op, shape, causal, ep, pro, variant, dtype="bfloat16"):
    def chains(ecls, pcls):
        return (ecls(**ep) if ep else None, pcls(**pro) if pro else None)
    return (at.OpSignature(op, shape, dtype, causal, *chains(Epilogue,
                                                             Prologue),
                           variant=variant),
            jat.OpSignature(op, shape, dtype, causal,
                            *chains(JEpilogue, JPrologue), variant=variant))


@pytest.mark.parametrize("case", SIGS, ids=lambda c: f"{c[0]}{c[1]}")
def test_keys_equal_reference(case):
    for dtype in ("bfloat16", "float32"):
        got, want = _sig_pair(*case, dtype=dtype)
        gb, wb = got.bucket(), want.bucket()
        assert gb[:4] == wb[:4] and gb[6:] == wb[6:]
        assert [None if c is None else c.describe() for c in gb[4:6]] \
            == [None if c is None else c.describe() for c in wb[4:6]]
        assert at.pretuned_cell_key(got) == jat.pretuned_cell_key(want)
    for kind, shape in (("mlp", (4096, 2048, 8192, 1)),
                        ("qkv_rope", (1024, 2048, 32, 8, 64)),
                        ("attention", (1, 16, 4, 1024, 1024, 128))):
        for kw in itertools.product((True, False), ("none", "rmsnorm"),
                                    (True, False)):
            args = dict(residual=kw[0], prenorm=kw[1], backward=kw[2],
                        causal=True, softcap=False, sink=False)
            assert at.pretuned_fusion_key(kind, shape, "bfloat16", **args) \
                == jat.pretuned_fusion_key(kind, shape, "bfloat16", **args)


# ---------------------------------------------------------------------------
# the no-table invariant
# ---------------------------------------------------------------------------

CHAINS = [({}, {}), (dict(rope=True, head_dim=64), dict(norm="rmsnorm")),
          (dict(rope=True, head_dim=32, bias=True), {}),
          (dict(activation="silu", gate=True), dict(norm="rmsnorm")),
          (dict(activation="gelu"), dict(norm="layernorm", beta=True)),
          (dict(residual=True, scale=True), {})]


@pytest.mark.parametrize("sms", [8, 78, 132])
def test_no_table_is_the_hand_fitted_plan(sms):
    """select_policy with no table: plan_gemm's (width, split) at window 8
    for the forward, pick_tile_n's width for both backward launches, and
    plan_decode's splits, over a sweep of shapes and chains."""
    for (m, n, k), (ep, pro) in itertools.product(
            itertools.product((1, 4, 96, 128, 129, 1024, 4096),
                              (256, 640, 2560, 8192), (512, 2048, 14336)),
            CHAINS):
        e, p = Epilogue(**ep), Prologue(**pro)
        pol = at.select_policy("gemm", (m, n, k), "bfloat16", epilogue=e,
                               prologue=p, sms=sms)
        hd = e.head_dim if e.rope else 0
        assert (pol.block_n, pol.splits, pol.window) == (
            *gemm_ops.plan_gemm(m, n, k, sms, gate=e.gate, head_dim=hd,
                                act=e.activation != "none"), 8)
        da, db = gemm_bwd.bwd_policies(m, n, k, e, p, sms)
        n2 = 2 * n if e.gate else n
        assert (da.block_n, da.window, db.block_n, db.window) == (
            at.pick_tile_n(m, k, sms), 8, at.pick_tile_n(k, n2, sms), 8)
    for b, hkv, rows, t, slots, d in itertools.product(
            (1, 3, 4, 16), (1, 8), (4, 5, 20), (1, 4), (64, 296, 4096),
            (64, 128)):
        if rows % t:
            continue
        pol = at.select_policy("attention_decode", (b, hkv, rows, slots, d),
                               sms=sms, q_tokens=t)
        units = decode.decode_units(b, hkv, rows, t)
        assert pol.splits == decode.plan_decode(units, -(-slots // 64),
                                                sms)[0]


def test_candidates_hold_the_pick_and_every_window():
    sig = at.OpSignature("gemm", (4096, 8192, 2048),
                         epilogue=Epilogue(activation="silu", gate=True))
    cands = at.candidate_policies(sig, sms=132)
    assert {(p.block_n, p.window) for p in cands} == {
        (w, win) for w in (128, 256) for win in gs.WINDOWS}
    assert at.ranked_candidates(sig, pm.H100, 132)[0].schedule.name \
        == "plan_gemm"
    assert all(p.is_legal() and p.smem_bytes() <= 232448 for p in cands)
    small = at.OpSignature("gemm", (4, 2048, 8192))
    splits = {p.splits for p in at.candidate_policies(small, sms=132)}
    assert 1 in splits and max(splits) > 1
    for pol in cands[:3]:
        assert policy_from_spec(json.loads(json.dumps(policy_spec(pol))),
                                epilogue=pol.epilogue) == pol


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

def _counters(cap):
    return {k: v for k, v in cap.counters.items()
            if k.startswith("autotune.")}


def test_table_rejections_match_reference():
    with open(REF_CPU_TABLE) as fh:
        table = json.load(fh)
    bad_schema = dict(table, schema_version=99)
    for t, arch in ((bad_schema, "cpu"), (table, "tpu"), (table, "cpu")):
        with obs.capture() as cap, jobs.capture() as jcap:
            assert at.install_pretuned(t, arch=arch) \
                == jat.install_pretuned(t, arch=arch)
        assert _counters(cap) == _counters(jcap)
    # the table measured on the card is refused here, by its arch
    path = pretuned_table_path("h100")
    if path is not None:
        at.clear_pretuned()
        with obs.capture() as cap:
            assert not at.load_pretuned(path)
        assert cap.counter("autotune.pretuned_rejected_arch") == 1
        assert at.active_pretuned() is None


def test_pinned_cell_wins_miss_falls_through_install_invalidates():
    sig = at.OpSignature("gemm", (1024, 2048, 8192),
                         epilogue=Epilogue(residual=True, scale=True))
    pick = at.select_policy("gemm", sig.shape, epilogue=sig.epilogue)
    other = next(p for p in at.candidate_policies(sig)
                 if (p.block_n, p.window) != (pick.block_n, pick.window))
    table = {"schema_version": 1, "arch": "cpu",
             "cells": {at.pretuned_cell_key(sig): {
                 "policy": policy_spec(other), "measured_time_s": 1e-5}},
             "fusion": {}}
    gen = at.pretuned_generation()
    with obs.capture() as cap:
        assert at.install_pretuned(table, arch="cpu")
        assert at.pretuned_generation() == gen + 1
        got = at.select_policy("gemm", sig.shape, epilogue=sig.epilogue)
        miss = at.select_policy("gemm", (1024, 2048, 4096),
                                epilogue=sig.epilogue)
    assert (got.block_n, got.splits, got.window) == (
        other.block_n, other.splits, other.window)
    assert (miss.block_n, miss.window) == gemm_ops.plan_gemm(
        1024, 2048, 4096, 132)[:1] + (8,)
    assert cap.counter("autotune.pretuned_hit") == 1
    assert cap.counter("autotune.pretuned_cell_miss") == 1
    at.clear_pretuned()
    again = at.select_policy("gemm", sig.shape, epilogue=sig.epilogue)
    assert (again.block_n, again.window) == (pick.block_n, pick.window)


def test_a_tables_fit_is_not_installed():
    """A table whose fitted chip is far from the card (the fit of a sweep
    that barely constrains it) changes no decision it does not pin: the
    backward's route at (1024, 512, 8192), which that chip's bandwidth
    would turn, included."""
    def decisions():
        return (at.select_bwd_mode(1024, 8192, 2048),
                at.select_bwd_mode(1024, 512, 8192),
                at.select_fusion("mlp", (1024, 2048, 8192, 1), "bfloat16",
                                 prenorm="rmsnorm")["plan"],
                at.select_fusion("attention", (4, 32, 8, 256, 256, 64),
                                 "bfloat16", causal=True)["plan"],
                at.select_policy("gemm", (4096, 2048, 8192)).describe(),
                at.select_policy("attention_decode",
                                 (4, 8, 4, 296, 64)).describe())
    before = decisions()
    table = {"schema_version": 1, "arch": "cpu", "cells": {}, "fusion": {},
             "chip": {"name": "cpu_calibrated", "hbm_bw": 46.5e12,
                      "peak_flops_bf16": 7.9e14, "vector_flops": 1.0e12,
                      "step_overhead_s": 2.1e-6,
                      "decode_saturation_steps": 8}}
    assert at.install_pretuned(table, arch="cpu")
    assert decisions() == before


# ---------------------------------------------------------------------------
# calibration and the drift gate
# ---------------------------------------------------------------------------

def test_calibrate_pins_the_measured_argmin():
    """A deterministic fake measure: each cell's winner is its argmin, the
    report installs, and the pins are what the autotuner then returns."""
    cells = cal.default_sweep(smoke=True)

    def fake(sig, pol):
        # cheapest: the narrowest window at the widest tile, fewest splits
        return 1e-6 * (1 + pol.window) * (1 + pol.splits) * 512 / pol.block_n

    report = cal.calibrate(cells, measure_fn=fake, arch="cpu")
    assert set(report) >= {"schema_version", "arch", "cells", "fusion",
                           "chip", "fit", "seed"}
    for key, cell in report["cells"].items():
        best = min(c["measured_time_s"] for c in cell["candidates"])
        assert cell["measured_time_s"] == best
    assert at.install_pretuned(json.loads(json.dumps(report)), arch="cpu")
    for sig in cells:
        pol = at.select_policy(sig.op, sig.shape, sig.dtype,
                               epilogue=sig.epilogue, prologue=sig.prologue,
                               variant=sig.variant, causal=sig.causal)
        pin = policy_from_spec(
            report["cells"][at.pretuned_cell_key(sig)]["policy"])
        assert (pol.block_n, pol.splits, pol.window) == (
            pin.block_n, pin.splits, pin.window)


def test_spearman_and_drift_equal_reference():
    rng = np.random.default_rng(0)
    for n in (2, 5, 9):
        xs = rng.integers(0, 4, n).astype(float)
        ys = rng.standard_normal(n)
        assert cal.spearman(xs, ys) == jcal.spearman(xs, ys)
    with open(REF_CPU_TABLE) as fh:
        table = json.load(fh)
    assert cal.check_drift(table) == jcal.check_drift(table)
    report = cal.calibrate(cal.default_sweep(smoke=True), arch="cpu")
    for tol in (0.05, 0.5):
        assert cal.check_drift(report, top1_tol=tol) \
            == jcal.check_drift(report, top1_tol=tol)


@pytest.mark.parametrize("measured", ["rig", "reversed"])
def test_calibrate_cli_exit_is_the_drift_gate(measured, tmp_path,
                                              monkeypatch, capsys):
    """``launch/calibrate.py --device cpu --smoke``: the proxy rig, priced
    in the analytic model's terms, passes the gate (exit 0); a measure
    that ranks every cell's candidates in the analytic order reversed
    fails it (exit 1), the report written all the same."""
    from repro_torch.launch import calibrate as calib_cli

    if measured == "reversed":
        monkeypatch.setattr(
            cal.CalibrationRig, "time",
            lambda self, sig, pol: 1.0 / at.score_policy(sig, pol).time_s)
    out = tmp_path / "CALIB_cpu.json"
    rc = calib_cli.main(["--device", "cpu", "--smoke", "--out", str(out)])
    text = capsys.readouterr().out
    with open(out) as fh:
        drift = cal.check_drift(json.load(fh))
    assert rc == (0 if measured == "rig" else 1)
    assert drift["ok"] == (measured == "rig")
    assert f"drift ok={drift['ok']}" in text
    assert text.count("VIOLATION") == len(drift["violations"])


def test_plan_decision_counts_equal_reference():
    """The same calls into both autotuners journal the same decisions by
    kind, memo replays (``cached``) included."""
    calls = [("policy", ("gemm", (1024, 2048, 8192)), {}),
             ("policy", ("gemm", (1024, 2048, 8192)), {}),
             ("policy", ("fused_norm", (2048, 1024)), {}),
             ("fusion", ("mlp", (1024, 2048, 8192, 1)),
              dict(prenorm="rmsnorm")),
             ("fusion", ("mlp", (1024, 2048, 8192, 1)),
              dict(prenorm="rmsnorm")),
             ("fusion", ("attention", (4, 32, 8, 256, 256, 64)),
              dict(causal=True)),
             ("bwd_route", (1024, 8192, 2048), {}),
             ("bwd_route", (1024, 8192, 2048), {})]
    caps = []
    for mod, o in ((at, obs), (jat, jobs)):
        with o.capture() as cap:
            for kind, args, kw in calls:
                if kind == "policy":
                    mod.select_policy(*args, "bfloat16", **kw)
                elif kind == "fusion":
                    mod.select_fusion(*args, "bfloat16", **kw)
                else:
                    mod.select_bwd_mode(*args)
        caps.append([(p.kind, p.op, p.cached) for p in cap.plans])
    assert caps[0] == caps[1]
    assert sum(c for _, _, c in caps[0]) == 3
