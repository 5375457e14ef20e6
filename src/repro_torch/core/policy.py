"""KernelPolicy: one object that fully determines a kernel's launch plan.

The reference composes a Pallas kernel's tiling (a :class:`Schedule`: the
pipeline depth and the blocks), its grid traversal (a
:class:`SwizzleConfig`, Algorithm 1), its dtypes and its fused chains into
one frozen, hashable :class:`KernelPolicy`, legal by construction against
the VMEM budget. The port keeps the object and its names; its content is
the Hopper kernels' plan, legal against the shared-memory and register
budgets (:mod:`.tiles`):

  op               block_m          block_n            block_k    splits
  ---------------  ---------------  -----------------  ---------  -------
  gemm             tile rows (128)  tile width (64,    stage      the
                                    128, 256)          depth (64) contraction's
  gemm_bwd         128              tile width         64         1
  attention_fwd    q rows (128)     key rows a tile    head_dim   1
  attention_bwd    q rows a stage   key rows a block   head_dim   1
  attention_decode q rows a unit    keys a split       head_dim   key splits
  fused_norm       rows a block     (unused: 0)        d          1
  rope             rows a block     (unused: 0)        head_dim   1

``n_buffers`` is the ring's stage count and ``swizzle.window`` the GEMM
kernels' walk window (``group_m`` of ``csrc/gemm_sm90.cuh``). The flash
kernels compile one layout per head_dim, so their only candidate is that
layout; the policy states it. A gemm_bwd policy's block dims follow the
launch's own GEMM shape: (M, K, N) for dA, (K, N', M) for dB.

Chains (``epilogue``/``prologue``) are duck-typed, as in the reference, so
``repro_torch.core`` imports no kernel module.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from . import tiles
from .grid_swizzle import DEFAULT_WINDOW, ROW_MAJOR, SwizzleConfig
from .schedule import Schedule

OP_KINDS = ("gemm", "gemm_bwd", "attention_fwd", "attention_bwd",
            "attention_decode", "fused_norm", "rope")

_ACC_BYTES = {"float32": 4, "bfloat16": 2}


def walk(window: int = DEFAULT_WINDOW) -> SwizzleConfig:
    """The GEMM kernels' walk with ``window`` tile rows a group: Algorithm
    1's windowed traversal with its chiplet step off (one L2 on Hopper)."""
    return SwizzleConfig(window=int(window), n_xcd=1, enable_chiplet=False)


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """A complete launch plan for one kernel kind (see the module table)."""

    op: str
    schedule: Schedule
    swizzle: SwizzleConfig = ROW_MAJOR
    in_dtype: str = "bfloat16"
    acc_dtype: str = "float32"
    epilogue: Optional[object] = None
    prologue: Optional[object] = None

    def __post_init__(self):
        if self.op not in OP_KINDS:
            raise ValueError(f"unknown op kind {self.op!r}; have {OP_KINDS}")
        if self.acc_dtype not in _ACC_BYTES:
            raise ValueError(f"unsupported acc_dtype {self.acc_dtype!r}")
        if self.epilogue is not None and self.op not in (
                "gemm", "gemm_bwd", "attention_fwd", "attention_bwd",
                "attention_decode"):
            raise ValueError(f"epilogue chains only apply to gemm/gemm_bwd/"
                             f"attention policies, not {self.op!r}")
        if self.prologue is not None and self.op not in ("gemm", "gemm_bwd"):
            raise ValueError(f"prologue chains only apply to gemm/gemm_bwd "
                             f"policies, not {self.op!r}")

    # -- block accessors ----------------------------------------------------
    @property
    def block_m(self) -> int:
        return self.schedule.block_m

    @property
    def block_n(self) -> int:
        return self.schedule.block_n

    @property
    def block_k(self) -> int:
        return self.schedule.block_k

    @property
    def block_q(self) -> int:
        return self.schedule.block_m

    @property
    def block_kv(self) -> int:
        return self.schedule.block_n

    @property
    def block_rows(self) -> int:
        return self.schedule.block_m

    @property
    def n_buffers(self) -> int:
        return self.schedule.n_buffers

    @property
    def splits(self) -> int:
        return self.schedule.splits

    @property
    def window(self) -> int:
        """The walk's window: row-major (window off) is window 1."""
        sw = self.swizzle
        return sw.window if sw.enable_window else 1

    # -- the budgets ----------------------------------------------------------
    def smem_bytes(self) -> int:
        """Shared memory of one block of the kernel this policy launches."""
        s = self.schedule
        if self.op in ("gemm", "gemm_bwd"):
            return tiles.gemm_smem_bytes(s.block_n, s.n_buffers)
        d = s.block_k
        boxes = max(1, d // 64)
        if self.op == "attention_fwd":
            qbufs = 1 if d == 256 else 2
            q_bytes, kv_bytes = boxes * s.block_m * 128, boxes * s.block_n * 128
            return (qbufs * q_bytes + s.n_buffers * 2 * kv_bytes
                    + (3 * s.n_buffers + 2 * qbufs) * 8 + 1024)
        if self.op == "attention_bwd":
            split = d == 256
            kv = boxes * s.block_n * 128
            ds = (s.block_m // 64) * s.block_n * 128
            stage = 2 * boxes * s.block_m * 128
            return (2 * kv + 2 * (2 if split else 1) * ds
                    + s.n_buffers * (stage + 2 * s.block_m * 4)
                    + (2 * s.n_buffers + 1) * 8 + 1024)
        if self.op == "attention_decode":
            return s.n_buffers * 2 * boxes * 64 * 128 + 2 * s.n_buffers * 8
        return 0   # rope and fused_norm hold their rows in registers

    def registers(self) -> int:
        """Accumulator registers a consumer thread holds (GEMM kinds)."""
        if self.op in ("gemm", "gemm_bwd"):
            return tiles.accumulator_registers(self.block_n)
        return 0

    def check(self, budget: Optional[int] = None) -> int:
        """Raise ValueError on a shared-memory or register overflow;
        returns the shared-memory bytes otherwise."""
        budget = budget if budget is not None else self.schedule.smem_budget()
        what = f"{self.op} policy {self.schedule.name!r}"
        tiles.check_register_budget(self.registers(), what=what)
        return tiles.check_smem_budget(self.smem_bytes(), budget=budget,
                                       what=what)

    def is_legal(self, budget: Optional[int] = None) -> bool:
        try:
            self.check(budget=budget)
        except ValueError:
            return False
        return True

    def fits(self, *dims: int) -> bool:
        """True iff each problem dim is divisible by the matching block dim
        (the reference's rule; the port's kernels mask ragged edges, so the
        autotuner does not require it of a GEMM)."""
        blocks = (self.block_m, self.block_n, self.block_k)
        return all(d % b == 0 for d, b in zip(dims, blocks) if b)

    def describe(self) -> dict:
        """JSON-able summary for reports and the launch journal."""
        s, sw = self.schedule, self.swizzle
        return {
            "op": self.op,
            "epilogue": (self.epilogue.describe()
                         if self.epilogue is not None else "none"),
            "prologue": (self.prologue.describe()
                         if self.prologue is not None else "none"),
            "schedule": s.name,
            "blocks": [s.block_m, s.block_n, s.block_k],
            "n_buffers": s.n_buffers,
            "splits": s.splits,
            "swizzle": ("row_major" if not (sw.enable_window or sw.enable_chiplet)
                        else f"W{sw.window}/C{sw.chunk}"
                             f"{'/xcd' if sw.enable_chiplet else ''}"),
            "in_dtype": self.in_dtype,
            "acc_dtype": self.acc_dtype,
            "smem_kib": round(self.smem_bytes() / 1024, 2),
        }

    def cache_key(self) -> tuple:
        return (self.op, self.schedule, self.swizzle, self.in_dtype,
                self.acc_dtype, self.epilogue, self.prologue)


def make_policy(op: str, *, block_m: int, block_n: int = 0, block_k: int = 0,
                n_buffers: int = 2, swizzle: SwizzleConfig = ROW_MAJOR,
                in_dtype: str = "bfloat16", acc_dtype: str = "float32",
                name: str = "explicit", splits: int = 1,
                epilogue: Optional[object] = None,
                prologue: Optional[object] = None) -> KernelPolicy:
    """A policy from explicit block dims (no legality enforcement: call
    ``check()``; the autotuner only emits legal ones)."""
    sched = Schedule(name, n_buffers=n_buffers, block_m=block_m,
                     block_n=block_n, block_k=block_k, splits=splits)
    return KernelPolicy(op=op, schedule=sched, swizzle=swizzle,
                        in_dtype=in_dtype, acc_dtype=acc_dtype,
                        epilogue=epilogue, prologue=prologue)


def gemm_policy(width: int, splits: int = 1, window: int = DEFAULT_WINDOW,
                *, op: str = "gemm", name: str = "sm90",
                in_dtype: str = "bfloat16", epilogue=None,
                prologue=None) -> KernelPolicy:
    """The GEMM mainloop's policy at tile width ``width``: 128 x width
    tiles, 64-deep stages as many as its ring holds, ``splits`` contraction
    splits and the walk's ``window``."""
    sched = Schedule(name, n_buffers=tiles.gemm_stages(width),
                     block_m=tiles.GEMM_BM, block_n=width,
                     block_k=tiles.GEMM_BK, splits=splits)
    return KernelPolicy(op, sched, walk(window), in_dtype=in_dtype,
                        epilogue=epilogue, prologue=prologue)


def policy_spec(policy: KernelPolicy) -> dict:
    """JSON-able, bitwise-reconstructible spec of a policy's schedule,
    swizzle and dtype axes (a pretuned table's cell). The chains are not
    serialized: the cell's key already names them, and
    :func:`policy_from_spec` re-attaches the caller's live objects."""
    s, sw = policy.schedule, policy.swizzle
    return {
        "op": policy.op,
        "schedule": {"name": s.name, "n_buffers": s.n_buffers,
                     "block_m": s.block_m, "block_n": s.block_n,
                     "block_k": s.block_k,
                     "producer_fraction": s.producer_fraction,
                     "splits": s.splits, "consumers": s.consumers},
        "swizzle": {"window": sw.window, "chunk": sw.chunk,
                    "n_xcd": sw.n_xcd,
                    "enable_chiplet": sw.enable_chiplet,
                    "enable_window": sw.enable_window},
        "in_dtype": policy.in_dtype,
        "acc_dtype": policy.acc_dtype,
    }


def policy_from_spec(spec: dict, *, epilogue: Optional[object] = None,
                     prologue: Optional[object] = None) -> KernelPolicy:
    """Inverse of :func:`policy_spec`; a spec of the reference's schema
    (no ``splits``/``consumers``) reads as one split, two consumers."""
    sc = spec["schedule"]
    sched = Schedule(sc["name"], n_buffers=int(sc["n_buffers"]),
                     block_m=int(sc["block_m"]), block_n=int(sc["block_n"]),
                     block_k=int(sc["block_k"]),
                     producer_fraction=float(sc.get("producer_fraction", 0.0)),
                     splits=int(sc.get("splits", 1)),
                     consumers=int(sc.get("consumers",
                                          tiles.GEMM_CONSUMERS)))
    sw = spec["swizzle"]
    swizzle = SwizzleConfig(window=int(sw["window"]), chunk=int(sw["chunk"]),
                            n_xcd=int(sw["n_xcd"]),
                            enable_chiplet=bool(sw["enable_chiplet"]),
                            enable_window=bool(sw["enable_window"]))
    return KernelPolicy(op=spec["op"], schedule=sched, swizzle=swizzle,
                        in_dtype=spec["in_dtype"],
                        acc_dtype=spec.get("acc_dtype", "float32"),
                        epilogue=epilogue, prologue=prologue)


def resolve_policy(op: str, shape, dtype="bfloat16", *, causal: bool = False,
                   **kw) -> KernelPolicy:
    """The policy a kernel entry resolves when its caller passes none: the
    autotuner's, memoized per (op, shape bucket, dtype). (The port's kernels
    never took raw block keywords, so there is no deprecation shim.)"""
    from . import autotune  # function-level: autotune imports this module

    return autotune.select_policy(op, shape, dtype, causal=causal, **kw)

