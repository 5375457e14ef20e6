"""Ring-overlapped collective GEMM over one mesh axis.

The paper's async-worker pattern (loads stream the next tile while the
matrix units consume the current one) one level up: point-to-point hops
over the ring of a mesh axis's ranks stream the next operand chunk while
``gemm_fused`` launches consume the chunk already resident. Two variants,
the two Megatron tensor-parallel collectives:

* ``all_gather``: row-parallel A. Each rank holds an (m_loc, K) row block
  and the whole B. The ring rotates the row blocks; at every step each
  rank multiplies the block it holds into the matching output panel. After
  S steps every rank has the whole (M, N) product, and the gathered A
  never exists.
* ``reduce_scatter``: contraction-parallel A and B. Each rank holds (M,
  k_loc) and (k_loc, N) and owes a partial product. The fp32 panel
  accumulator rides the ring: at step s a rank computes its contribution
  to panel ``(rank - s - 1) % S`` and adds it to the accumulator it just
  received, so panel p sums its contributions in the fixed rank order
  p+1, p+2, ..., p, never in a library's reduction order.

Each hop is ``dist.batch_isend_irecv`` over the axis's group, started
before the current panel's launch and waited on after it. Every panel runs
``gemm_fused`` at one contraction split with the tile width of the panel's
shape (:func:`panel_plan`): each output element is then one full-K dot in
one order, so the ring, the unfused gather-then-GEMM plan and the oracle
agree bit for bit, the kernel on the card and its plain version on the
CPU. The reduce-scatter's panels are fp32 (the kernel's raw accumulators,
``ops._launch(f32_product=True)``).

These run on one rank with its local blocks, as the reference's functions
run inside ``shard_map``; :func:`gemm_collective_sharded` takes the full
operands, cuts this rank's blocks and returns its result. Each call adds
one to the ``obs`` counter ``gemm_collective.{variant}.{plan}``.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from .epilogue import EPILOGUE_NONE

VARIANTS = ("all_gather", "reduce_scatter")
PLANS = ("ring", "gather")


def panel_plan(m: int, n: int, k: int, device) -> tuple:
    """(tile width, 1): the forward kernel's tile width at the panel shape
    (m, n, k), one contraction split. Both plans of a call use it."""
    from . import ops

    return ops.plan_gemm(m, n, k, ops.sm_count(device))[0], 1


def _panel_gemm(a, b, *, mode, out_dtype, plan):
    """One panel: the kernel on a CUDA tensor in 'kernel' mode at ``plan``
    (an fp32 panel is the raw accumulators), else the plain version: the
    fp32 product cast to ``out_dtype``."""
    if mode == "kernel" and a.is_cuda:
        from . import ops

        out, _, _ = ops._launch(a.contiguous(), b.contiguous(),
                                EPILOGUE_NONE, b2=None, bias=None,
                                residual=None, scale=None, sin=None,
                                cos=None, gamma=None, eps=None,
                                out_dtype=torch.bfloat16, plan=plan,
                                f32_product=out_dtype == torch.float32)
        return out
    return (a.float() @ b.float()).to(out_dtype)


def _shift(x, group, rank: int, size: int):
    """Start sending ``x`` to the next rank of the ring and receiving the
    previous rank's into a new buffer: (buffer, requests)."""
    import torch.distributed as dist

    ranks = dist.get_process_group_ranks(group)
    buf = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(rank + 1) % size], group=group),
           dist.P2POp(dist.irecv, buf, ranks[(rank - 1) % size],
                      group=group)]
    return buf, dist.batch_isend_irecv(ops)


def _wait(reqs) -> None:
    for r in reqs:
        r.wait()


def _ag_ring(x, w, *, group, rank, size, mode, out_dtype, plan):
    """x: (m_loc, K) local rows; w: (K, N) whole. The whole (M, N) product
    on every rank. At step s the block a rank holds came from rank
    (rank - s) % S."""
    m_loc = x.shape[0]
    out = torch.empty((size * m_loc, w.shape[1]), dtype=out_dtype,
                      device=x.device)
    chunk = x.contiguous()
    for step in range(size):
        nxt = _shift(chunk, group, rank, size) if step < size - 1 else None
        origin = (rank - step) % size
        out[origin * m_loc:(origin + 1) * m_loc] = _panel_gemm(
            chunk, w, mode=mode, out_dtype=out_dtype, plan=plan)
        if nxt is not None:
            chunk, reqs = nxt
            _wait(reqs)
    return out


def _ag_gather(x, w, *, group, rank, size, mode, out_dtype, plan):
    """The unfused plan: the gathered A, then one GEMM."""
    from repro_torch.distributed.collectives import all_gather_cat

    return _panel_gemm(all_gather_cat(x, 0, group), w, mode=mode,
                       out_dtype=out_dtype, plan=plan)


def _rs_ring(x, w, *, group, rank, size, mode, out_dtype, plan):
    """x: (M, k_loc); w: (k_loc, N). This rank's (M / S, N) panel of the
    summed product, accumulated in fp32 in the ring's order."""
    m_loc = x.shape[0] // size
    acc = None
    for step in range(size):
        pending = (_shift(acc, group, rank, size) if acc is not None
                   else None)
        p = (rank - step - 1) % size
        y = _panel_gemm(x[p * m_loc:(p + 1) * m_loc], w, mode=mode,
                        out_dtype=torch.float32, plan=plan)
        if pending is None:
            acc = y
        else:
            received, reqs = pending
            _wait(reqs)
            acc = received + y
    return acc.to(out_dtype)


def _rs_gather(x, w, *, group, rank, size, mode, out_dtype, plan):
    """The unfused plan: the whole fp32 partial product per rank, the
    ranks' partials all-gathered, this rank's panel summed in the ring's
    order p+1, p+2, ..., p (so both plans give the same bits)."""
    import torch.distributed as dist

    m_loc = x.shape[0] // size
    partial = _panel_gemm(x, w, mode=mode, out_dtype=torch.float32,
                          plan=plan)
    parts = [torch.empty_like(partial) for _ in range(size)]
    dist.all_gather(parts, partial, group=group)
    acc = torch.zeros((m_loc, w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for i in range(size):
        src = (rank + 1 + i) % size
        acc = acc + parts[src][rank * m_loc:(rank + 1) * m_loc]
    return acc.to(out_dtype)


_FNS = {("all_gather", "ring"): _ag_ring,
        ("all_gather", "gather"): _ag_gather,
        ("reduce_scatter", "ring"): _rs_ring,
        ("reduce_scatter", "gather"): _rs_gather}


def gemm_collective(x, w, *, mesh, axis: str = "model", variant: str,
                    mode: str = "kernel", out_dtype=None,
                    plan: str | None = None, shard=None):
    """The collective GEMM on this rank's blocks over ``axis`` of ``mesh``.

    all_gather: x (m_loc, K) this rank's rows, w (K, N) whole -> (M, N).
    reduce_scatter: x (M, k_loc), w (k_loc, N) this rank's contraction
    slices -> this rank's (M / S, N) rows of the summed product.
    ``plan``: 'ring' (overlapped) or 'gather' (the unfused baseline); None
    asks ``core.autotune.select_fusion("gemm_collective", (M, N, K),
    shard=)`` ('fused' is the ring), ``shard`` a ``ShardSpec`` (by default
    the one ``axis`` of ``mesh``, its rows or contraction split)."""
    from repro_torch.core import autotune
    from repro_torch.distributed.collectives import axis_size
    from repro_torch.distributed.sharding import ShardSpec

    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; have {VARIANTS}")
    size = axis_size(mesh, axis)
    if plan is None:
        if variant == "all_gather":
            mnk = (x.shape[0] * size, w.shape[1], x.shape[1])
        else:
            mnk = (x.shape[0], w.shape[1], x.shape[1] * size)
        shard = shard or ShardSpec.for_axis(
            mesh, axis, dim="rows" if variant == "all_gather" else "contract",
            collective=variant)
        verdict = autotune.select_fusion("gemm_collective", mnk, x.dtype,
                                         shard=shard)
        plan = "ring" if verdict["plan"] == "fused" else "gather"
    if plan not in PLANS:
        raise ValueError(f"unknown plan {plan!r}; have {PLANS}")
    out_dtype = out_dtype or x.dtype
    if variant == "all_gather":
        pshape = (x.shape[0], w.shape[1], x.shape[1])
    else:
        if x.shape[0] % size:
            raise ValueError(f"reduce_scatter rows {x.shape[0]} not "
                             f"divisible by ring size {size}")
        pshape = (x.shape[0] // size, w.shape[1], x.shape[1])
    kplan = panel_plan(*pshape, x.device) if x.is_cuda else None
    obs.incr(f"gemm_collective.{variant}.{plan}")
    return _FNS[(variant, plan)](
        x, w, group=mesh.get_group(axis), rank=mesh.get_local_rank(axis),
        size=size, mode=mode, out_dtype=out_dtype, plan=kplan)


def gemm_collective_oracle(x_full, w_full, *, variant: str, axis_size: int,
                           out_dtype=None):
    """The plain oracle on the whole operands, one process. all_gather: the
    product. reduce_scatter: each rank's panel, its sources' fp32 partial
    products summed in the ring's order: the (S, M / S, N) stack."""
    out_dtype = out_dtype or x_full.dtype
    if variant == "all_gather":
        return (x_full.float() @ w_full.float()).to(out_dtype)
    m, k = x_full.shape
    s_ = axis_size
    m_loc, k_loc = m // s_, k // s_
    parts = [x_full[:, src * k_loc:(src + 1) * k_loc].float()
             @ w_full[src * k_loc:(src + 1) * k_loc].float()
             for src in range(s_)]
    panels = []
    for rank in range(s_):
        acc = torch.zeros((m_loc, w_full.shape[1]), dtype=torch.float32,
                          device=x_full.device)
        for i in range(s_):
            src = (rank + 1 + i) % s_
            acc = acc + parts[src][rank * m_loc:(rank + 1) * m_loc]
        panels.append(acc.to(out_dtype))
    return torch.stack(panels)


def gemm_collective_sharded(x, w, *, mesh, axis: str = "model",
                            variant: str = "all_gather", mode: str = "kernel",
                            out_dtype=None, plan: str | None = None,
                            shard=None):
    """The whole operands in, this rank's result out, as the reference's
    ``shard_map`` wrapper with each variant's specs: all_gather: x's rows
    over ``axis``, w whole -> the whole (M, N); reduce_scatter: x's
    columns and w's rows over ``axis`` -> this rank's (M / S, N) rows."""
    from repro_torch.distributed.collectives import axis_size

    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; have {VARIANTS}")
    size, rank = axis_size(mesh, axis), mesh.get_local_rank(axis)
    if variant == "all_gather":
        m_loc = x.shape[0] // size
        xl, wl = x[rank * m_loc:(rank + 1) * m_loc], w
    else:
        k_loc = x.shape[1] // size
        xl = x[:, rank * k_loc:(rank + 1) * k_loc]
        wl = w[rank * k_loc:(rank + 1) * k_loc]
    return gemm_collective(xl, wl, mesh=mesh, axis=axis, variant=variant,
                           mode=mode, out_dtype=out_dtype, plan=plan,
                           shard=shard)
