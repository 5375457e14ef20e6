"""The policy autotuner on Hopper (the reference's ``core/autotune.py``).

The reference enumerates every VMEM-legal policy of an op signature, ranks
them by its TPU models and memoizes the winner per (kind, shape bucket,
dtype, chain). The port keeps that surface, the keys and the pretuned-table
machinery; its content is the Hopper kernels':

1. :func:`candidate_policies` enumerates the plans a kernel takes: for the
   GEMMs every tile width x contraction split x walk window its mainloop
   compiles; for decode every key-split count; for the flash kernels,
   fused norm and RoPE the one layout each compiles for a head_dim;
2. the **analytic ranking** puts the hand-fitted plan first: the forward
   GEMM's :func:`plan_gemm`, the backward's :func:`pick_tile_n` and
   decode's :func:`plan_decode`, each at window 8 (the walk before the
   window became an argument). The rest follow by :func:`score_policy`,
   a wave model of the card. So with no pretuned table installed every
   launch is the launch the kernels made before the policy layer, bit for
   bit; a table measured on the card (:mod:`.calibrate`) pins a cell's
   winner ahead of the ranking;
3. :func:`select_policy` memoizes the winner per exact shape (the split
   plans depend on the exact unit and tile counts) and journals every
   verdict through ``obs.plan_decision``.

:func:`select_fusion` and :func:`select_bwd_mode` decide fused against
unfused plans and the kernel against the oracle backward from the byte
models of :mod:`.perf_model`, which count the port's kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

from repro_torch import obs

from . import perf_model as pm
from . import tiles
from .grid_swizzle import DEFAULT_WINDOW, WINDOWS, SwizzleConfig, dma_bytes
from .policy import (KernelPolicy, OP_KINDS, gemm_policy, make_policy,
                     policy_from_spec)

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1,
                "float8_e4m3fn": 1, "float8_e5m2": 1}


def dtype_name(dtype) -> str:
    """'bfloat16' for torch.bfloat16 or the string: the reference's key."""
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# The hand-fitted plans: the analytic ranking's first candidate
# ---------------------------------------------------------------------------

TILE_ROWS, TILE_DEPTH = tiles.GEMM_BM, tiles.GEMM_BK
TILE_WIDTHS = tiles.GEMM_WIDTHS
COLUMN_COST = pm.COLUMN_COST
# The forward's plan, fitted to chip_smoke.py phase 3's sweep of every
# (width, split) on an H100: a width is taken where its tiles give every SM
# about this many; up to one tile row of M the contraction is split, each
# split at least MIN_SPLIT_STAGES stages deep.
TILES_PER_SM = {256: 1.9, 128: 0.9}
MIN_SPLIT_STAGES = 4


def tile_widths(gate: bool = False, head_dim: int = 0) -> tuple:
    """The forward kernel's tile widths for a chain: the gated chain's
    tiles hold two 64-column boxes or more (B's and B2's); a rope chain's
    hold whole heads and are at most 128 wide."""
    return tuple(w for w in TILE_WIDTHS
                 if (not gate or w >= 128)
                 and (not head_dim or (w % head_dim == 0 and w <= 128)))


def tile_count(m: int, n: int, tile_n: int, gate: bool = False) -> int:
    """Output tiles of an (m, n) result at tile width ``tile_n``."""
    return -(-m // TILE_ROWS) * -(-n // (tile_n // 2 if gate else tile_n))


def split_count(tiles_: int, k: int, sms: int) -> int:
    """The contraction's split for ``tiles_`` output tiles over a K-deep
    contraction: 1 when the tiles fill the SMs, else as many as fill them,
    each at least MIN_SPLIT_STAGES stages deep, none empty."""
    if tiles_ >= sms:
        return 1
    stages = -(-k // TILE_DEPTH)
    splits = max(1, min(sms // tiles_, stages // MIN_SPLIT_STAGES))
    return -(-stages // -(-stages // splits))


def plan_gemm(m: int, n: int, k: int, sms: int, *, gate: bool = False,
              head_dim: int = 0, act: bool = False) -> tuple:
    """(tile width, split count) of the forward kernel for an (m, k) @
    (k, n) product on ``sms`` SMs. Up to one tile row (M <= TILE_ROWS):
    128-wide tiles and the contraction split over the SMs. Above: the
    widest width whose tiles give each SM TILES_PER_SM of them, else the
    narrowest; no split. A non-gated activation's store (``act``) takes
    128-wide tiles at most (slower at 256 at every shape of the sweep)."""
    widths = tile_widths(gate, head_dim)
    if act and not gate:
        widths = tuple(w for w in widths if w <= 128)
    if m <= TILE_ROWS:
        width = 128 if 128 in widths else max(widths)
        return width, split_count(tile_count(m, n, width, gate), k, sms)
    for w in sorted(widths, reverse=True):
        if w in TILES_PER_SM and (tile_count(m, n, w, gate)
                                  >= TILES_PER_SM[w] * sms):
            return w, 1
    return min(widths), 1


def pick_tile_n(m: int, n: int, sms: int) -> int:
    """The backward mainloop's tile width for an (m, n) output: the fewest
    rounds of tiles over the SMs, weighed by the width and the dearer
    columns of narrow tiles."""
    tiles_m = -(-m // TILE_ROWS)

    def cost(w):
        rounds = -(-tiles_m * -(-n // w) // sms)
        return rounds * w * COLUMN_COST[w]

    return min(sorted(TILE_WIDTHS, reverse=True), key=cost)


# the decode kernels' constants (csrc/decode_split.cuh): keys a tile, ring
# stages by head_dim, q rows a unit (the few-row body up to FEW_ROWS, else
# ROW_TILE); then plan_decode's blocks a SM and a split's least tiles
KEY_TILE = 64
DECODE_STAGES = {64: 6, 128: 3, 256: 3}
FEW_ROWS, ROW_TILE = 16, 32
BLOCKS_PER_SM, MIN_SPLIT_TILES = 2, 8


def rows_per_unit(rows: int, q_tokens: int = 1) -> int:
    """q rows of one decode unit: FEW_ROWS (padded) where one query token's
    rows (the GQA group, rows / q_tokens) fit in it, else ROW_TILE."""
    return FEW_ROWS if rows // q_tokens <= FEW_ROWS else ROW_TILE


def decode_units(batch: int, hkv: int, rows: int, q_tokens: int = 1) -> int:
    """Units of the decode kernels: (batch row, kv head, row tile)."""
    return batch * hkv * -(-rows // rows_per_unit(rows, q_tokens))


def split_tiles(n_tiles: int, n_splits: int) -> tuple:
    """(n_splits, tiles_per_split) of ``n_splits`` asked: splits of
    ceil(n_tiles / n_splits) consecutive tiles, none empty."""
    tps = -(-n_tiles // max(1, min(n_splits, n_tiles)))
    return -(-n_tiles // tps), tps


def plan_decode(units: int, n_tiles: int, sms: int) -> tuple:
    """(n_splits, tiles_per_split): enough blocks for BLOCKS_PER_SM a SM
    where the tiles allow, but no split under MIN_SPLIT_TILES tiles: a
    split's merge (a fence, the ticket, the partials' round trips through
    L2) costs about as much as walking that many tiles more. One split
    writes the output with no merge. The decode kernels take the count as
    given (``decode_split.cuh``'s ``plan``)."""
    ns = max(1, min(n_tiles // MIN_SPLIT_TILES,
                    -(-BLOCKS_PER_SM * sms // units)))
    return split_tiles(n_tiles, ns)


def _flash_fwd_layout(d: int) -> tuple:
    """(q rows, key rows a tile, stages) of csrc/flash_fwd.cu's Layout."""
    return 128, (128 if d == 64 else 64), (2 if d == 256 else 4)


def _flash_bwd_layout(d: int) -> tuple:
    """(q rows a stage, key rows a block, stages) of csrc/flash_bwd.cu."""
    return (128 if d == 64 else 64), (64 if d == 256 else 128), \
        (2 if d == 256 else 3)


def _rope_rows(rows: int, d: int, elem: int) -> int:
    """Rows a block of csrc/rope.cu takes (rope/kernel.py rope_plan)."""
    nv = -(-(d // 2) // (16 // elem))
    return 4 * max(1, min(-(-rows // 4), 256 // max(1, nv)))


def _norm_rows(d: int) -> int:
    """Rows a block of csrc/fused_norm.cu holds (one past 8192 columns)."""
    if d > 8192:
        return 1
    tpr = 32
    while tpr * 16 < d and tpr < 512:
        tpr *= 2
    return max(256, tpr) // tpr


# ---------------------------------------------------------------------------
# Signatures
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpSignature:
    """What the autotuner needs to know about one kernel launch.

    ``shape`` per op kind, as the reference's:
      gemm             (m, n, k)
      gemm_bwd         (M, K, N) for 'da', (K, N', M) for 'db'
      attention_fwd    (batch, heads, seq_q, seq_kv, head_dim)
      attention_bwd    (batch, heads, seq_q, seq_kv, head_dim)
      attention_decode (batch, kv_heads, group, kv_len, head_dim); group
                       is the q rows a kv head (G x T for a T-token call)
      fused_norm       (rows, d)
      rope             (batch, heads, seq, head_dim)

    ``q_tokens`` (decode only, the port's) is T of a speculative verify
    step: the kernels pick their body by the rows of one token.
    """

    op: str
    shape: tuple
    dtype: str = "bfloat16"
    causal: bool = False
    epilogue: Optional[object] = None
    prologue: Optional[object] = None
    variant: str = ""
    shard: Optional[object] = None
    q_tokens: int = 1

    def __post_init__(self):
        if self.op not in OP_KINDS:
            raise ValueError(f"unknown op kind {self.op!r}")
        if self.op == "gemm_bwd" and self.variant not in ("da", "db"):
            raise ValueError(f"gemm_bwd needs variant 'da' or 'db', "
                             f"got {self.variant!r}")
        if self.variant and self.op != "gemm_bwd":
            raise ValueError("variant is only meaningful for gemm_bwd")

    def bucket(self) -> tuple:
        """The table's cell: tile-constrained dims exact, batch-like dims
        rounded up to a power of two (the reference's buckets; a verify
        step's T joins the decode shape)."""
        def pow2(x: int) -> int:
            return 1 << max(0, (x - 1).bit_length())

        if self.op in ("attention_fwd", "attention_bwd"):
            b, h, sq, skv, d = self.shape
            shape = (pow2(b), pow2(h), sq, skv, d)
        elif self.op == "attention_decode":
            b, hkv, g, skv, d = self.shape
            shape = (pow2(b), pow2(hkv), g, skv, d)
            if self.q_tokens != 1:
                shape += (self.q_tokens,)
        elif self.op == "rope":
            b, h, s, d = self.shape
            shape = (pow2(b), pow2(h), s, d)
        else:
            shape = tuple(self.shape)
        return (self.op, shape, self.dtype, self.causal, self.epilogue,
                self.prologue, self.variant, self.shard)


@dataclasses.dataclass(frozen=True)
class PolicyScore:
    time_s: float        # modeled wall time of the launch
    dma_bytes: int       # modeled HBM bytes under the traversal
    detail: tuple = ()

    def rank_key(self, policy: KernelPolicy) -> tuple:
        return (self.time_s, self.dma_bytes, repr(policy.cache_key()))


def _gate(sig) -> bool:
    return bool(getattr(sig.epilogue, "gate", False))


def _rope_head_dim(sig) -> int:
    ep = sig.epilogue
    return ep.head_dim if ep is not None and getattr(ep, "rope", False) else 0


def _act(sig) -> bool:
    ep = sig.epilogue
    return ep is not None and getattr(ep, "activation", "none") != "none"


# ---------------------------------------------------------------------------
# Candidates and the analytic pick
# ---------------------------------------------------------------------------

def walk_windows(tiles_m: int) -> list:
    """The walk windows that give distinct orders over ``tiles_m`` tile
    rows: those under it, and one window that takes them all (8 where it
    does, the hand-fitted plans' window)."""
    out = [w for w in WINDOWS if w < tiles_m]
    whole = [w for w in WINDOWS if w >= tiles_m]
    if whole:
        out.append(DEFAULT_WINDOW if DEFAULT_WINDOW in whole else whole[0])
    return out


def _split_candidates(k: int, pick: int) -> list:
    stages = -(-k // TILE_DEPTH)
    out = {split_tiles(stages, s)[0] for s in (1, 2, 4, 8, 16)}
    out.add(pick)
    return sorted(out)


def analytic_policy(sig: OpSignature, sms: int) -> KernelPolicy:
    """The hand-fitted plan of ``sig`` on ``sms`` SMs at window 8: the
    launch the kernels made before the policy layer."""
    dt = sig.dtype if sig.dtype in _DTYPE_BYTES else "bfloat16"
    if sig.op == "gemm":
        m, n, k = sig.shape
        w, s = plan_gemm(m, n, k, sms, gate=_gate(sig),
                         head_dim=_rope_head_dim(sig), act=_act(sig))
        return gemm_policy(w, s, name="plan_gemm", in_dtype=dt,
                           epilogue=sig.epilogue, prologue=sig.prologue)
    if sig.op == "gemm_bwd":
        m, n, _ = sig.shape
        return gemm_policy(pick_tile_n(m, n, sms), op="gemm_bwd",
                           name="pick_tile_n", in_dtype=dt,
                           epilogue=sig.epilogue, prologue=sig.prologue)
    if sig.op == "attention_decode":
        b, hkv, g, skv, d = sig.shape
        units = decode_units(b, hkv, g, sig.q_tokens)
        ns, tps = plan_decode(units, -(-skv // KEY_TILE), sms)
        return _decode_policy(sig, ns, tps, "plan_decode", dt)
    return candidate_policies(sig, sms=sms)[0]


def _decode_policy(sig, ns, tps, name, dt):
    b, hkv, g, skv, d = sig.shape
    return make_policy("attention_decode",
                       block_m=min(g, rows_per_unit(g, sig.q_tokens)),
                       block_n=tps * KEY_TILE, block_k=d,
                       n_buffers=DECODE_STAGES.get(d, 3), splits=ns,
                       in_dtype=dt, name=name, epilogue=sig.epilogue)


def candidate_policies(sig: OpSignature,
                       swizzle: Optional[SwizzleConfig] = None,
                       sms: Optional[int] = None) -> list:
    """Every plan the kernel of ``sig`` takes that fits the budgets. GEMMs:
    width x split x window (``swizzle`` pins the window); decode: its
    split counts; the rest: the one layout the kernel compiles."""
    sms = sms or pm.H100.sms
    dt = sig.dtype if sig.dtype in _DTYPE_BYTES else "bfloat16"
    out = []
    if sig.op in ("gemm", "gemm_bwd"):
        m, n, k = sig.shape
        windows = ([swizzle.window if swizzle.enable_window else 1]
                   if swizzle is not None
                   else walk_windows(-(-m // TILE_ROWS)))
        if sig.op == "gemm":
            widths = tile_widths(_gate(sig), _rope_head_dim(sig))
            pick = plan_gemm(m, n, k, sms, gate=_gate(sig),
                             head_dim=_rope_head_dim(sig), act=_act(sig))[1]
            splits = (_split_candidates(k, pick)
                      if m <= TILE_ROWS or pick > 1 else [1])
        else:
            widths, splits = TILE_WIDTHS, [1]
        for w in widths:
            for s in splits:
                for win in windows:
                    pol = gemm_policy(w, s, win, op=sig.op, name="sm90",
                                      in_dtype=dt, epilogue=sig.epilogue,
                                      prologue=sig.prologue)
                    if pol.is_legal():
                        out.append(pol)
    elif sig.op == "attention_decode":
        b, hkv, g, skv, d = sig.shape
        n_tiles = -(-skv // KEY_TILE)
        units = decode_units(b, hkv, g, sig.q_tokens)
        asked = {plan_decode(units, n_tiles, sms)[0], 1, 2, 4, 8, 16, 32, 64}
        plans = sorted({split_tiles(n_tiles, s) for s in asked})
        for ns, tps in plans:
            pol = _decode_policy(sig, ns, tps, "sm90_d", dt)
            if pol.is_legal():
                out.append(pol)
    elif sig.op in ("attention_fwd", "attention_bwd"):
        d = sig.shape[-1]
        bq, bkv, st = (_flash_fwd_layout(d) if sig.op == "attention_fwd"
                       else _flash_bwd_layout(d))
        out.append(make_policy(sig.op, block_m=bq, block_n=bkv, block_k=d,
                               n_buffers=st, in_dtype=dt, name="flash_sm90",
                               epilogue=sig.epilogue))
    elif sig.op == "fused_norm":
        rows, d = sig.shape
        out.append(make_policy("fused_norm", block_m=_norm_rows(d),
                               block_k=d, n_buffers=1, in_dtype=dt,
                               name="norm_rows"))
    elif sig.op == "rope":
        b, h, s, d = sig.shape
        out.append(make_policy("rope", block_m=_rope_rows(
            b * h, d, _DTYPE_BYTES.get(dt, 2)), block_k=d, n_buffers=1,
            in_dtype=dt, name="rope_rows"))
    return out


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------

def gemm_traffic_bytes(policy: KernelPolicy, m: int, n: int, k: int,
                       dtype_bytes: int) -> int:
    """Panel traffic of the GEMM under the policy's walk (one SM walking
    the order alone, ``grid_swizzle.dma_bytes``) plus the chain's streams."""
    gate = bool(getattr(policy.epilogue, "gate", False))
    tile_out = policy.block_n // 2 if gate else policy.block_n
    rows, cols = -(-m // policy.block_m), -(-n // tile_out)
    a_panel = policy.block_m * k * dtype_bytes
    b_panel = k * policy.block_n * dtype_bytes
    traffic = dma_bytes(policy.swizzle, rows, cols, a_panel, b_panel)
    ep, pro = policy.epilogue, policy.prologue
    if ep is not None and hasattr(ep, "extra_read_bytes"):
        traffic += ep.extra_read_bytes(m, n, dtype_bytes)
    if pro is not None and hasattr(pro, "extra_read_bytes"):
        traffic += pro.extra_read_bytes(m, k, dtype_bytes)
    return traffic


def score_policy(sig: OpSignature, policy: KernelPolicy,
                 chip: pm.ChipSpec = pm.H100) -> PolicyScore:
    dtype_bytes = _DTYPE_BYTES.get(sig.dtype, 2)
    if sig.op in ("gemm", "gemm_bwd"):
        m, n, k = sig.shape
        step = pm.gemm_step_model(m=m, n=n, k=k, block_n=policy.block_n,
                                  splits=policy.splits,
                                  gate=sig.op == "gemm" and _gate(sig),
                                  dtype_bytes=dtype_bytes, chip=chip)
        traffic = gemm_traffic_bytes(policy, m, n, k, dtype_bytes)
        return PolicyScore(step["time_s"], traffic,
                           (("bound", step["bound"]),
                            ("waves", step["waves"])))
    if sig.op == "attention_decode":
        b, hkv, g, skv, d = sig.shape
        step = pm.decode_step_model(
            batch=b, kv_heads=hkv, group=g, kv_len=skv, head_dim=d,
            block_kv=policy.block_kv, dtype_bytes=dtype_bytes,
            units=decode_units(b, hkv, g, sig.q_tokens), chip=chip)
        return PolicyScore(step["time_s"],
                           step["kv_bytes"] + step["partial_bytes"],
                           (("n_splits", step["n_splits"]),
                            ("utilization", round(step["utilization"], 2))))
    if sig.op in ("attention_fwd", "attention_bwd"):
        b, h, sq, skv, d = sig.shape
        chain = (pm.attention_chain_bwd_model if sig.op == "attention_bwd"
                 else pm.attention_chain_model)
        c = chain(batch=b, heads=h, kv_heads=h, seq_q=sq, seq_kv=skv,
                  head_dim=d, causal=sig.causal, dtype_bytes=dtype_bytes,
                  chip=chip)
        return PolicyScore(c["time_s"], c["dma_bytes"])
    if sig.op == "fused_norm":
        rows, d = sig.shape
        traffic = 4 * rows * d * dtype_bytes
        return PolicyScore(traffic / chip.hbm_bw, traffic)
    b, h, s, d = sig.shape   # rope
    traffic = b * h * s * d * 2 * dtype_bytes + 2 * s * d * 4
    return PolicyScore(traffic / chip.hbm_bw, traffic)


def refine_with_cache_model(sig: OpSignature, policies: Iterable[KernelPolicy],
                            hw=None) -> list:
    """Re-rank GEMM candidates by the cache simulator (paper Tab. 4) on the
    H100's L2 (``cache_model.CacheHW.h100``); slow, never on a launch."""
    from .cache_model import CacheHW, simulate_gemm_schedule
    hw = hw if hw is not None else CacheHW.h100()
    m, n, k = sig.shape
    scored = []
    for pol in policies:
        r = simulate_gemm_schedule(
            pol.swizzle, m=-(-m // pol.block_m) * pol.block_m,
            n=-(-n // pol.block_n) * pol.block_n, k=k, block_m=pol.block_m,
            block_n=pol.block_n, block_k=max(pol.block_k, k // 8), hw=hw)
        scored.append((r.modeled_time_s, repr(pol.cache_key()), pol, r))
    scored.sort(key=lambda t: t[:2])
    return [(pol, r) for _, _, pol, r in scored]


def ranked_candidates(sig: OpSignature, chip: pm.ChipSpec, sms: int,
                      swizzle: Optional[SwizzleConfig] = None) -> list:
    """The analytic ranking: the hand-fitted plan first (when the search
    is not constrained away from it), the rest by :func:`score_policy`."""
    cands = candidate_policies(sig, swizzle=swizzle, sms=sms)
    pick = analytic_policy(sig, sms)

    def same(p):
        return (p.schedule.block_n, p.splits, p.window, p.block_m,
                p.block_k) == (pick.schedule.block_n, pick.splits,
                               pick.window, pick.block_m, pick.block_k)
    first = [p for p in cands if same(p)][:1]
    rest = sorted((p for p in cands if not (first and p is first[0])),
                  key=lambda p: score_policy(sig, p, chip).rank_key(p))
    if first:
        # the hand-fitted plan under its own schedule name
        first = [pick if swizzle is None else first[0]]
    return first + rest


# ---------------------------------------------------------------------------
# Pretuned tables: winners measured on the card, consulted ahead of the
# analytic ranking; every other cell is scored with the H100's analytic
# ChipSpec (the table's fitted one stays in the report, uninstalled)
# ---------------------------------------------------------------------------

PRETUNED_SCHEMA_VERSION = 1

_PRETUNED: dict = {"table": None, "gen": 0}


def default_arch() -> str:
    """The arch a table must name to install here: "h100" on an H100, the
    card's name (lower case, spaces as dashes) on another card, "cpu"
    without CUDA."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    name = torch.cuda.get_device_name(0)
    return "h100" if "H100" in name else name.lower().replace(" ", "-")


def pretuned_generation() -> int:
    return _PRETUNED["gen"]


def active_pretuned() -> Optional[dict]:
    return _PRETUNED["table"]


def _chain_str(chain) -> str:
    if chain is None:
        return "none"
    d = chain.describe()
    return d if isinstance(d, str) else str(d)


def _shard_str(shard) -> str:
    if shard is None:
        return "none"
    describe = getattr(shard, "describe", None)
    return describe() if callable(describe) else str(shard)


def pretuned_cell_key(sig: OpSignature) -> str:
    """The table key of one policy cell: shape bucket x dtype x chains."""
    op, shape, dtype, causal, ep, pro, variant, shard = sig.bucket()
    parts = [op, "x".join(str(x) for x in shape), dtype,
             "causal" if causal else "full",
             f"ep={_chain_str(ep)}", f"pro={_chain_str(pro)}"]
    if variant:
        parts.append(f"var={variant}")
    if shard is not None:
        parts.append(f"shard={_shard_str(shard)}")
    return "|".join(parts)


def pretuned_fusion_key(kind: str, bucket_shape: tuple, dtype: str, *,
                        residual: bool, prenorm: str, backward: bool,
                        causal: bool, softcap: bool, sink: bool,
                        shard=None) -> str:
    """The table key of one fusion-plan cell (select_fusion's memo)."""
    parts = [kind, "x".join(str(x) for x in bucket_shape), dtype,
             f"res={int(residual)}", f"pre={prenorm}",
             f"bwd={int(backward)}", f"causal={int(causal)}",
             f"cap={int(softcap)}", f"sink={int(sink)}"]
    if shard is not None:
        parts.append(f"shard={_shard_str(shard)}")
    return "|".join(parts)


def install_pretuned(table: dict, *, arch: Optional[str] = None) -> bool:
    """Validate and install a pretuned table; True iff installed. A schema
    or arch mismatch rejects it (counted; the state is untouched): a table
    measured on other hardware never pins a winner here. ``arch``
    overrides the expected arch (default :func:`default_arch`). The
    table's fitted ``chip`` is not installed: what it does not pin is
    scored with ``perf_model.H100``, as with no table."""
    if int(table.get("schema_version", -1)) != PRETUNED_SCHEMA_VERSION:
        obs.incr("autotune.pretuned_rejected_schema")
        return False
    expect = arch if arch is not None else default_arch()
    if table.get("arch") != expect:
        obs.incr("autotune.pretuned_rejected_arch")
        return False
    _PRETUNED["table"] = table
    _PRETUNED["gen"] += 1
    obs.incr("autotune.pretuned_installed")
    return True


def load_pretuned(path, *, arch: Optional[str] = None) -> bool:
    import json
    with open(path) as f:
        table = json.load(f)
    return install_pretuned(table, arch=arch)


def use_pretuned(table_or_path, *, arch: Optional[str] = None,
                 required: bool = False) -> bool:
    """Install a table given as a report dict or a JSON path: what the
    engines and the trainer take as ``pretuned=`` (with ``required``: a
    rejected table raises ValueError). The table stays installed for the
    process, as the reference's, until :func:`clear_pretuned` or another
    install."""
    if isinstance(table_or_path, dict):
        ok = install_pretuned(table_or_path, arch=arch)
    else:
        ok = load_pretuned(table_or_path, arch=arch)
    if required and not ok:
        raise ValueError(
            "pretuned table rejected: it must have schema_version "
            f"{PRETUNED_SCHEMA_VERSION} and arch "
            f"{arch if arch is not None else default_arch()!r}")
    return ok


def clear_pretuned() -> None:
    if _PRETUNED["table"] is not None:
        _PRETUNED["table"] = None
        _PRETUNED["gen"] += 1


def _sig_fits(sig: OpSignature, pol: KernelPolicy, sms: int) -> bool:
    """A pinned plan must be one the kernel takes for this exact launch:
    one of its candidates (a hand-edited table or a bucket's other shape
    may name one it does not)."""
    if pol.op != sig.op:
        return False
    for c in candidate_policies(sig, sms=sms):
        if (c.block_m, c.block_n, c.block_k, c.splits, c.window) == (
                pol.block_m, pol.block_n, pol.block_k, pol.splits,
                pol.window):
            return pol.is_legal()
    return False


# ---------------------------------------------------------------------------
# Memoized selection
# ---------------------------------------------------------------------------

_POLICY_CACHE: dict = {}
_CACHE_STATS = {"hits": 0, "misses": 0}
_POLICY_AUDIT: dict = {}
_PLAN_AUDIT: dict = {}


def _identity_to_none(chain):
    return None if chain is None or getattr(chain, "is_identity", False) \
        else chain


def select_policy(op: str, shape, dtype="bfloat16", *, causal: bool = False,
                  epilogue=None, prologue=None, variant: str = "",
                  shard=None, swizzle: Optional[SwizzleConfig] = None,
                  cache_sim: bool = False,
                  chip: Optional[pm.ChipSpec] = None,
                  sms: Optional[int] = None,
                  q_tokens: int = 1) -> KernelPolicy:
    """The policy of one launch; memoized per exact shape.

    An installed table pins the winner of its cell (the shape's bucket);
    a cell miss, a pin the launch cannot take, a constrained search
    (``swizzle=``, ``cache_sim=True``) fall to the analytic ranking, whose
    first candidate is the hand-fitted plan. ``sms``: the card's SM count
    (the chip's by default); ``q_tokens``: a decode call's T.
    """
    if chip is None:
        chip = pm.H100
    sms = int(sms or chip.sms)
    dtype = dtype_name(dtype)
    epilogue, prologue = _identity_to_none(epilogue), _identity_to_none(prologue)
    shape = tuple(int(x) for x in shape)
    key = (op, shape, dtype, bool(causal), epilogue, prologue, variant,
           shard, int(q_tokens), swizzle, bool(cache_sim), chip.name, sms,
           _PRETUNED["gen"])
    hit = _POLICY_CACHE.get(key)
    if hit is not None:
        _CACHE_STATS["hits"] += 1
        if obs.enabled():
            audit = _policy_audit(key)
            if audit is not None:
                obs.plan_decision("policy", op, shape, dtype,
                                  audit["chosen"], audit["candidates"],
                                  cached=True)
        return hit
    _CACHE_STATS["misses"] += 1
    sig = OpSignature(op, shape, dtype, causal=causal, epilogue=epilogue,
                      prologue=prologue, variant=variant, shard=shard,
                      q_tokens=int(q_tokens))

    table = _PRETUNED["table"]
    if table is not None and swizzle is None and not cache_sim:
        cell = (table.get("cells") or {}).get(pretuned_cell_key(sig))
        if cell is None:
            obs.incr("autotune.pretuned_cell_miss")
        else:
            pinned = policy_from_spec(cell["policy"], epilogue=epilogue,
                                      prologue=prologue)
            if _sig_fits(sig, pinned, sms):
                obs.incr("autotune.pretuned_hit")
                _POLICY_CACHE[key] = pinned
                audit = {"chosen": dict(pinned.describe(), pretuned=True),
                         "candidates": [
                             {"policy": pinned.schedule.name,
                              "blocks": [pinned.block_m, pinned.block_n,
                                         pinned.block_k],
                              "splits": pinned.splits,
                              "window": pinned.window,
                              "time_s": cell.get("measured_time_s"),
                              "dma_bytes": None, "chosen": True,
                              "pretuned": True}]}
                _POLICY_AUDIT[key] = audit
                obs.plan_decision("policy", op, shape, dtype,
                                  audit["chosen"], audit["candidates"])
                return pinned
            obs.incr("autotune.pretuned_illegal")

    scored = ranked_candidates(sig, chip, sms, swizzle)
    if not scored:
        raise ValueError(f"no legal policy for {sig}")
    best = scored[0]
    if cache_sim and op == "gemm":
        best = refine_with_cache_model(sig, scored[:8])[0][0]
    _POLICY_CACHE[key] = best
    # the candidates' audit is scored when a journal first asks for it
    _POLICY_AUDIT[key] = (sig, scored[:8], best, chip)
    if obs.enabled():
        audit = _policy_audit(key)
        obs.plan_decision("policy", op, shape, dtype, audit["chosen"],
                          audit["candidates"])
    return best


def _policy_audit(key) -> Optional[dict]:
    """The journal's entry of a memoized pick: the chosen policy and the
    first eight candidates, each with its analytic score."""
    audit = _POLICY_AUDIT.get(key)
    if isinstance(audit, tuple):
        sig, ranked, best, chip = audit
        cands = []
        for p in ranked:
            sc = score_policy(sig, p, chip)
            cands.append({"policy": p.schedule.name,
                          "blocks": [p.block_m, p.block_n, p.block_k],
                          "splits": p.splits, "window": p.window,
                          "time_s": sc.time_s, "dma_bytes": sc.dma_bytes,
                          "chosen": p is best})
        audit = {"chosen": best.describe(), "candidates": cands}
        _POLICY_AUDIT[key] = audit
    return audit


def policy_cache_stats() -> dict:
    return dict(_CACHE_STATS, size=len(_POLICY_CACHE))


def clear_policy_cache() -> None:
    _POLICY_CACHE.clear()
    _PLAN_CACHE.clear()
    _BWD_ROUTE_CACHE.clear()
    _POLICY_AUDIT.clear()
    _PLAN_AUDIT.clear()
    _CACHE_STATS.update(hits=0, misses=0)


# ---------------------------------------------------------------------------
# gemm_fused(bwd_mode="auto"): the kernel backward or the oracle's
# ---------------------------------------------------------------------------

_BWD_ROUTE_CACHE: dict = {}


def select_bwd_mode(m: int, n: int, k: int, *, dtype: str = "bfloat16",
                    epilogue=None, prologue=None,
                    chip: Optional[pm.ChipSpec] = None) -> str:
    """'kernel' or 'reference' for one ``gemm_fused(bwd_mode='auto')`` call,
    from :func:`perf_model.gemm_bwd_route_model`; memoized per
    (pow2-bucketed m, n, k, dtype, chain) and journaled as a ``bwd_route``
    plan decision."""
    if chip is None:
        chip = pm.H100
    m, n, k = int(m), int(n), int(k)
    dtype = dtype_name(dtype)
    epilogue, prologue = _identity_to_none(epilogue), _identity_to_none(prologue)
    m_bucket = 1 << max(0, (m - 1).bit_length())
    key = (m_bucket, n, k, dtype, _chain_str(epilogue),
           _chain_str(prologue), chip.name, _PRETUNED["gen"])
    hit = _BWD_ROUTE_CACHE.get(key)
    if hit is not None:
        if obs.enabled():
            obs.plan_decision("bwd_route", "gemm_bwd", (m, n, k), dtype,
                              {"mode": hit, "cached": True}, cached=True)
        return hit
    db = _DTYPE_BYTES.get(dtype, 2)
    n_saved = 0
    gated = bool(getattr(epilogue, "gate", False))
    # the port's forward saves the activation's input(s) in bf16; a scale
    # chain keeps no fp32 preact (its scale takes no gradient)
    if epilogue is not None and getattr(epilogue, "activation",
                                        "none") != "none":
        n_saved = 2 if gated else 1
    prenorm = prologue is not None
    route = pm.gemm_bwd_route_model(m=m_bucket, n=n, k=k, dtype_bytes=db,
                                    n_saved=n_saved, preact_bytes=db,
                                    gated=gated, prenorm=prenorm, chip=chip)
    mode = route["route"]
    _BWD_ROUTE_CACHE[key] = mode
    obs.plan_decision(
        "bwd_route", "gemm_bwd", (m, n, k), dtype,
        {"mode": mode, "kernel_score": route["kernel_score"],
         "reference_score": route["reference_score"],
         "peak_save_bytes": route["peak_save_bytes"]},
        [{"mode": "kernel", "time_s": route["kernel_time_s"],
          "score": route["kernel_score"], "chosen": mode == "kernel"},
         {"mode": "reference", "time_s": route["reference_time_s"],
          "score": route["reference_score"],
          "chosen": mode == "reference"}])
    return mode


# ---------------------------------------------------------------------------
# Fusion plans: fused or unfused, from the byte models alone
# ---------------------------------------------------------------------------

_PLAN_CACHE: dict = {}


def select_fusion(kind: str, shape, dtype="bfloat16", *,
                  residual: bool = True, prenorm: str = "none",
                  backward: bool = False, causal: bool = False,
                  softcap: bool = False, sink: bool = False, shard=None,
                  chip: Optional[pm.ChipSpec] = None) -> dict:
    """The fused or unfused plan of a model-layer chain, by the modeled
    HBM bytes of both (:mod:`.perf_model`, the port's kernels counted);
    an installed table pins the decision of the cells it carries. Kinds
    and shapes are the reference's:

      'mlp'       (tokens, d_model, d_ff, gated); ``residual`` False for
                  the MoE experts
      'qkv_rope'  (tokens, d_model, num_heads, num_kv_heads, head_dim)
      'qkv'       the same, rope-free
      'attention' (batch, heads, kv_heads, seq_q, seq_kv, head_dim)
      'gemm_collective' (m, n, k), the whole GEMM; ``shard`` must carry an
                  all_gather or reduce_scatter collective; 'fused' is the
                  ring plan, 'unfused' the gather plan

    Returns {plan, fused_bytes, unfused_bytes, traffic_reduction, fused,
    unfused} (and the collective's columns with ``shard``)."""
    if chip is None:
        chip = pm.H100
    dtype = dtype_name(dtype)
    shape = tuple(int(x) for x in shape)
    tokens = 1 << max(0, (shape[0] - 1).bit_length())
    key = (kind, (tokens,) + shape[1:], dtype, bool(residual), prenorm,
           bool(backward), bool(causal), bool(softcap), bool(sink),
           shard, chip.name, _PRETUNED["gen"])
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        if obs.enabled():
            audit = _PLAN_AUDIT.get(key)
            if audit is not None:
                obs.plan_decision("fusion", kind, shape, dtype,
                                  audit["chosen"], audit["candidates"],
                                  cached=True)
        return hit
    pinned_plan = None
    table = _PRETUNED["table"]
    if table is not None:
        fkey = pretuned_fusion_key(kind, (tokens,) + shape[1:], dtype,
                                   residual=bool(residual), prenorm=prenorm,
                                   backward=bool(backward),
                                   causal=bool(causal),
                                   softcap=bool(softcap), sink=bool(sink),
                                   shard=shard)
        cell = (table.get("fusion") or {}).get(fkey)
        if cell is None:
            obs.incr("autotune.pretuned_fusion_miss")
        elif cell.get("plan", {}).get("plan") in ("fused", "unfused"):
            pinned_plan = cell["plan"]["plan"]
            obs.incr("autotune.pretuned_fusion_hit")
    db = _DTYPE_BYTES.get(dtype, 2)
    if kind == "mlp":
        _, d, f, gated = shape
        model = pm.mlp_chain_bwd_model if backward else pm.mlp_chain_model
        variants = [model(tokens=tokens, d_model=d, d_ff=f, dtype_bytes=db,
                          gated=bool(gated), residual=residual,
                          prenorm=prenorm, fused=fused, chip=chip)
                    for fused in (True, False)]
    elif kind in ("qkv_rope", "qkv"):
        _, d, h, hkv, hd = shape
        model = (pm.qkv_rope_chain_bwd_model if backward
                 else pm.qkv_rope_chain_model)
        variants = [model(tokens=tokens, d_model=d, num_heads=h,
                          num_kv_heads=hkv, head_dim=hd, dtype_bytes=db,
                          prenorm=prenorm, rope=(kind == "qkv_rope"),
                          fused=fused, chip=chip)
                    for fused in (True, False)]
    elif kind == "attention":
        _, h, hkv, sq, skv, hd = shape
        model = (pm.attention_chain_bwd_model if backward
                 else pm.attention_chain_model)
        variants = [model(batch=tokens, heads=h, kv_heads=hkv, seq_q=sq,
                          seq_kv=skv, head_dim=hd, causal=causal,
                          softcap=softcap, sink=sink, dtype_bytes=db,
                          fused=fused, chip=chip)
                    for fused in (True, False)]
    elif kind == "gemm_collective":
        if shard is None or getattr(shard, "collective", "none") not in \
                ("all_gather", "reduce_scatter"):
            raise ValueError(
                "gemm_collective needs a ShardSpec with an all_gather or "
                f"reduce_scatter collective, got shard={shard!r}")
        _, n, k = shape
        variants = [pm.collective_gemm_model(
                        m=tokens, n=n, k=k, n_shards=shard.n_shards,
                        dtype_bytes=db, variant=shard.collective,
                        fused=fused, chip=chip)
                    for fused in (True, False)]
    else:
        raise ValueError(f"unknown fusion kind {kind!r}")
    if (shard is not None and kind != "gemm_collective"
            and getattr(shard, "collective", "none") != "none"):
        act_bytes = tokens * shape[1] * db
        if shard.collective == "all_to_all":
            act_bytes *= 2
        variants = [pm.collective_chain_model(
                        v, collective=shard.collective, nbytes=act_bytes,
                        n_shards=shard.n_shards, chip=chip)
                    for v in variants]
    fused, unfused = variants
    plan = dict(
        plan=("fused" if fused["dma_bytes"] < unfused["dma_bytes"]
              else "unfused"),
        fused_bytes=fused["dma_bytes"], unfused_bytes=unfused["dma_bytes"],
        traffic_reduction=unfused["dma_bytes"] / max(1, fused["dma_bytes"]),
        fused=fused, unfused=unfused)
    if pinned_plan is not None:
        plan["plan"] = pinned_plan
        plan["pretuned"] = True
    if shard is not None:
        chosen = fused if plan["plan"] == "fused" else unfused
        plan.update(shard=_shard_str(shard),
                    collective_bytes=chosen.get("collective_bytes", 0),
                    collective_s=chosen.get("collective_s", 0.0),
                    overlap_fraction=chosen.get("overlap_fraction", 0.0))
    _PLAN_CACHE[key] = plan
    audit = {"chosen": {"plan": plan["plan"],
                        "traffic_reduction": plan["traffic_reduction"],
                        "prenorm": prenorm, "backward": bool(backward),
                        **({"shard": plan["shard"],
                            "overlap_fraction": plan["overlap_fraction"]}
                           if shard is not None else {}),
                        **({"pretuned": True} if pinned_plan else {})},
             "candidates": [
                 {"plan": "fused", "dma_bytes": plan["fused_bytes"],
                  "chosen": plan["plan"] == "fused"},
                 {"plan": "unfused", "dma_bytes": plan["unfused_bytes"],
                  "chosen": plan["plan"] == "unfused"}]}
    _PLAN_AUDIT[key] = audit
    obs.plan_decision("fusion", kind, shape, dtype, audit["chosen"],
                      audit["candidates"])
    return plan


# ---------------------------------------------------------------------------
# Model-level resolution (Model.resolve_policies, the engines, the trainer)
# ---------------------------------------------------------------------------

def policies_for_model(cfg, *, batch: int, seq_len: int,
                       dtype: Optional[str] = None,
                       decode_len: Optional[int] = None,
                       shard=None) -> dict:
    """The kernel policies a model of ``cfg`` uses for a (batch, seq_len)
    bucket, {op kind: KernelPolicy}, under the reference's op keys;
    ``decode_len`` is the decode step's cache slots. ``shard`` also
    resolves (and journals) the sharded fusion plans of the bucket."""
    dtype = dtype_name(dtype or getattr(cfg, "compute_dtype", "bfloat16"))
    h = getattr(cfg, "num_heads", 0)
    d = getattr(cfg, "head_dim", 0) or 0
    dm = getattr(cfg, "d_model", 0)
    out = {}
    kinds = set(getattr(cfg, "block_pattern", ("attn",)))
    has_attn = bool(kinds & {"attn", "local", "moe"}) or \
        getattr(cfg, "family", "lm") in ("encdec", "vlm")
    if has_attn and h and d:
        attn_shape = (batch, h, seq_len, seq_len, d)
        out["attention_fwd"] = select_policy("attention_fwd", attn_shape,
                                             dtype, causal=True)
        out["attention_bwd"] = select_policy("attention_bwd", attn_shape,
                                             dtype, causal=True)
        hkv = getattr(cfg, "num_kv_heads", h) or h
        out["attention_decode"] = select_policy(
            "attention_decode",
            (batch, hkv, h // hkv, decode_len or seq_len, d), dtype)
        if getattr(cfg, "rope_style", "none") != "none":
            out["rope"] = select_policy("rope", (batch, h, seq_len, d), dtype)
    if dm:
        out["fused_norm"] = select_policy("fused_norm",
                                          (batch * seq_len, dm), dtype)
    d_ff = getattr(cfg, "d_ff", 0) or 0
    if dm and d_ff:
        from repro_torch.kernels.gemm.epilogue import Epilogue
        from repro_torch.kernels.gemm.prologue import norm_prologue
        gated = getattr(cfg, "mlp_act", "swiglu") in ("swiglu", "geglu")
        act = "gelu" if getattr(cfg, "mlp_act", "") in ("geglu", "gelu") \
            else "silu"
        tokens = batch * seq_len
        up_ep = (Epilogue(activation=act, gate=True) if gated
                 else Epilogue(activation=act))
        norm_kind = getattr(cfg, "norm", "rmsnorm")
        up_pro = None
        if select_fusion("mlp", (tokens, dm, d_ff, gated), dtype,
                         prenorm=norm_kind)["plan"] == "fused":
            up_pro = norm_prologue(norm_kind, beta=(norm_kind == "layernorm"))
        out["gemm_mlp_up"] = select_policy("gemm", (tokens, d_ff, dm), dtype,
                                           epilogue=up_ep, prologue=up_pro)
        out["gemm_mlp_down"] = select_policy(
            "gemm", (tokens, dm, d_ff), dtype,
            epilogue=Epilogue(residual=True, scale=True))
        if shard is not None:
            ns = max(1, shard.n_shards)
            if getattr(cfg, "moe", None) is not None:
                loc_f = d_ff if shard.collective == "all_to_all" \
                    else max(1, d_ff // ns)
                select_fusion("mlp", (tokens, dm, loc_f, gated), dtype,
                              residual=False, shard=shard)
            else:
                select_fusion("mlp", (tokens, dm, d_ff, gated), dtype,
                              prenorm=norm_kind, shard=shard)
    return out


def describe_policies(policies: dict) -> dict:
    return {op: pol.describe() for op, pol in sorted(policies.items())}
