"""The train step and the fault-tolerant training loop.

``make_train_step`` builds the step: the loss and its grads by autograd
(microbatches' grads summed in fp32, as the reference's scan does), with
``grad_compress`` the int8 error-feedback round trip of the grads
(``optim.ef_compress``), then AdamW in place. ``train_loop`` is the
reference's loop: it resumes from the newest valid checkpoint in
``ckpt_dir``, saves every ``ckpt_every`` steps through an
``AsyncCheckpointer`` (snapshot now, write in the background), and on a
simulated failure waits for the write in flight and restores the newest
valid checkpoint, or restarts from scratch when there is none; a last save
ends the run. The straggler watchdog observes every step. Each step is an
``obs`` span "trainer.step" and adds one to the counter "trainer.steps",
as in the reference; each new batch shape pins its kernel policies first
(:func:`pin_bucket_policies`: the counters "trainer.bucket_pins" and
"trainer.bucket_pins.{B}x{S}", one log line, ``TrainLoopResult.policies``),
after ``pretuned=`` installs a measured table.

With a ``mesh`` the step is data parallel over its 'data' axis, each rank
on its own rows of the batch (``DataIterator(mesh=)``), and tensor
parallel over its 'model' axis, as the reference's step is under GSPMD:
every leaf is the rank's block under the logical rules
(``state.sharded_init``) and every family's forward splits the attention
heads (self and cross), the FFN, the experts (``moe_ep``/``moe_tp`` by
``resolve_impl``), the RG-LRU's channels, Mamba2's heads, the embedding,
the head and the cross entropy over 'model'
(``distributed.tensor_parallel``: a replicated leaf's grad comes out whole
on every rank, a split leaf's is the rank's own). Then:

* the objective is the *global* masked mean: each rank's cross entropy is
  weighted by its share of the batch's loss tokens (the token counts
  summed over 'data'), the MoE auxiliary term averaged over the ranks.
  With ``microbatches`` it is the reference's mean of the microbatches'
  masked means, the reference's microbatch p being rows [p B / n,
  (p + 1) B / n) of the global batch: each rank's rows (its block of the
  global batch, as ``DataIterator(mesh=)`` gives it where the 'data'
  extent divides the batch) are split into n parts, each part lies in
  one such microbatch and is weighted by its share of that microbatch's
  loss tokens, and the parts' grads are summed in fp32 and divided by n
  before any reduction, as ``loss_and_grads`` does;
* the grads are summed over 'data' in rank order, each leaf into the
  ZeRO-1 slice its moments hold (:func:`state.state_shardings`: the
  leaf's largest dim 'data' divides), a leaf with no such dim whole;
* ``grad_compress``'s error feedback runs after that exact reduce, as in
  the reference, each leaf at its whole leaf's scale;
* the global grad norm is taken over the slices, a leaf split over
  'model' counted over its blocks and a replicated one once, and AdamW
  updates each rank's slice (``zero1``: the moments are slices; the
  updated params are all-gathered over 'data') or, without ``zero1``, the
  whole leaves from the all-gathered grads. Both give the same bits: the
  grads are the same sums and AdamW is elementwise.

One code path serves every extent: at one rank every collective is an
identity and, on the plain path, the step is the single-device step bit
for bit (the vocab-parallel cross entropy included). A 'pod' axis raises,
and so does a split the port does not make (Mamba2's heads spanning part
of a B|C group), naming the shape.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch import obs
from repro_torch.core import autotune
from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import mesh_shape
from repro_torch.distributed.tensor_parallel import TensorParallel
from repro_torch.optim import AdamWConfig, adamw_update, ef_compress
from repro_torch.optim.optimizer import leaves
from . import checkpoint as ckpt_lib
from .state import init_state, sharded_init, state_shardings


class SimulatedFailure(RuntimeError):
    """Raised by the failure injector to emulate a node loss."""


@dataclasses.dataclass
class FailureInjector:
    fail_at_steps: tuple = ()
    _fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps slower than ``factor`` x the running median and calls a
    mitigation hook (on a fleet: move work off the slow host; here: record
    and notify)."""
    factor: float = 3.0
    warmup: int = 5
    durations: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def observe(self, step: int, seconds: float) -> bool:
        self.durations.append(seconds)
        if len(self.durations) <= self.warmup:
            return False
        med = sorted(self.durations)[len(self.durations) // 2]
        if seconds > self.factor * med:
            self.events.append((step, seconds, med))
            if self.on_straggler:
                self.on_straggler(step, seconds, med)
            return True
        return False


def _split_microbatches(batch: dict, n: int) -> list:
    return [dict(zip(batch, parts))
            for parts in zip(*(v.chunk(n, dim=0) for v in batch.values()))]


def _grad(loss, wrt) -> tuple:
    """``torch.autograd.grad`` with the backward on the calling thread.
    On the card autograd would run it (the recompute of a checkpointed
    block included) on a device thread of its own, whose ``obs`` recorder
    stack is empty, so a captured step would journal none of it. The
    step is no slower for it on an H100 (``chip_smoke.py`` phase 14 times
    both in turns)."""
    with torch.autograd.set_multithreading_enabled(False):
        return torch.autograd.grad(loss, wrt)


def loss_and_grads(model, params, batch, *, microbatches: int = 1) -> tuple:
    """(loss, metrics, grads): the grads in the order of
    ``optim.optimizer.leaves(params)``. With microbatches the batch rows
    are split, each part's grads summed in fp32 and divided, and the loss
    is the mean of the parts' losses, as the reference's scan computes."""
    wrt = leaves(params)
    if microbatches == 1:
        loss, metrics = model.loss(params, batch)
        return loss.detach(), metrics, _grad(loss, wrt)
    if batch["inputs"].shape[0] % microbatches:
        raise ValueError(f"batch of {batch['inputs'].shape[0]} rows does "
                         f"not split into {microbatches}")
    gsum, lsum = None, 0.0
    for mb in _split_microbatches(batch, microbatches):
        loss, _ = model.loss(params, mb)
        grads = [g.float() for g in _grad(loss, wrt)]
        if gsum is None:
            gsum = grads
        else:
            torch._foreach_add_(gsum, grads)
        lsum = lsum + loss.detach()
    loss = lsum / microbatches
    return (loss, {"ce": loss, "aux": torch.zeros((), device=loss.device)},
            torch._foreach_div(gsum, float(microbatches)))


def _check_mesh(model, mesh) -> None:
    sizes = mesh_shape(mesh)
    if "data" not in sizes:
        raise ValueError("make_train_step: the mesh has no 'data' axis")
    if "pod" in sizes:
        raise NotImplementedError(
            f"make_train_step: mesh {sizes}: the 'pod' axis belongs to the "
            "reference's make_production_mesh, which has no counterpart "
            "(ROADMAP Queue A: the 'pod' axis, not queued: no host mesh "
            "makes one)")


def zero1_dims(model, mesh) -> list:
    """Per leaf (``leaves`` order) the dim of its ZeRO-1 slice over 'data'
    (the moments' spec), or None where the leaf stays whole."""
    sh = state_shardings(model, mesh, zero1=True)["opt"]["m"]
    return [spec.index("data") if "data" in spec else None
            for spec in leaves(sh)]


def model_split(model, mesh) -> list:
    """Per leaf (``leaves`` order) whether its spec splits it over 'model'
    (its blocks differ from rank to rank)."""
    sh = state_shardings(model, mesh)["params"]
    return [any(e == "model" or (isinstance(e, tuple) and "model" in e)
                for e in spec) for spec in leaves(sh)]


def _ordered_rows(x, group):
    """The sum over the group's ranks of ``x`` in rank order, fp64."""
    sq = col.all_gather_cat(x[None], 0, group)
    acc = sq[0]
    for row in sq[1:]:
        acc = acc + row
    return acc


def _global_norm(local: list, dims: list, msplit: list, group, mgroup):
    """The grads' global norm from every rank's slices: each leaf's
    squared norm summed in rank order in fp64 over the 'data' ranks where
    ZeRO-1 slices it and over the 'model' ranks where the rules split it
    (a replicated leaf counted once; at one rank, the slice's norm
    exactly); then the norm of the leaves' norms, as ``optimizer._clip_``
    takes it."""
    norms = torch.stack(torch._foreach_norm(local))
    own = norms.double() ** 2
    dev = norms.device
    sliced = torch.tensor([d is not None for d in dims], device=dev)
    sq = torch.where(sliced, _ordered_rows(own, group), own)
    split = torch.tensor(msplit, device=dev)
    sq = torch.where(split, _ordered_rows(sq, mgroup), sq)
    return torch.linalg.vector_norm(sq.sqrt().float())


def _tokens(batch):
    mask = batch.get("loss_mask")
    return (mask.float().sum() if mask is not None else torch.tensor(
        float(batch["targets"].numel()), device=batch["targets"].device))


def _mesh_step(model, opt_cfg, mesh, *, zero1: bool, grad_compress: bool,
               microbatches: int):
    group = mesh.get_group("data")
    mgroup = mesh.get_group("model")
    ws = col.axis_size(mesh, "data")
    rank = mesh.get_local_rank("data")
    dims = zero1_dims(model, mesh)
    msplit = model_split(model, mesh)
    # the forward on this rank's blocks; the aux term averaged over 'data'
    # by the objective below, not inside the MoE
    run = dataclasses.replace(model, mesh=mesh, data_axes=(),
                              tp=TensorParallel(model, mesh))

    def amax(i, m):
        if dims[i] is not None:
            m = col.max_over(m, group)
        return col.max_over(m, mgroup) if msplit[i] else m

    def step_fn(state, batch):
        wrt = leaves(state["params"])
        n = microbatches
        if batch["inputs"].shape[0] % n:
            raise ValueError(f"a rank's {batch['inputs'].shape[0]} rows do "
                             f"not split into {n}")
        parts = _split_microbatches(batch, n) if n > 1 else [batch]
        counts = torch.stack([_tokens(mb) for mb in parts])
        # the reference's microbatch p is rows [p B / n, (p + 1) B / n) of
        # the global batch, so this rank's part j lies in its microbatch
        # (rank * n + j) // ws; each part's cross entropy is weighted by
        # its share of that microbatch's loss tokens (counted over 'data':
        # integers, exact in any order)
        owner = torch.arange(ws * n, device=counts.device) // ws
        every = col.all_gather_cat(counts[None], 0, group).reshape(-1)
        tokens = torch.zeros(n, device=counts.device).index_add_(
            0, owner, every)
        shares = counts / torch.clamp(tokens[owner[rank * n:(rank + 1) * n]],
                                      min=1.0)
        grads, obj_sum, ce_sum, aux_sum = None, 0.0, 0.0, 0.0
        for mb, share in zip(parts, shares):
            loss, metrics = run.loss(state["params"], mb)
            ce = metrics["ce"]
            # summed over ranks: each microbatch's masked mean plus the
            # ranks' mean aux term; at one rank both corrections are zeros
            obj = loss + ce * (share - 1.0) + (loss - ce) * (1.0 / ws - 1.0)
            g = _grad(obj, wrt)
            if n == 1:
                grads = list(g)
            elif grads is None:
                grads = [x.float() for x in g]
            else:
                torch._foreach_add_(grads, [x.float() for x in g])
            del g
            obj_sum = obj_sum + obj.detach()
            ce_sum = ce_sum + (ce * share).detach()
            aux_sum = aux_sum + metrics["aux"].detach()
        if n > 1:
            # the parts' mean, as ``loss_and_grads`` and the reference's scan
            torch._foreach_div_(grads, float(n))
        red = [col.sum_scatter(g, d, group) if d is not None
               else col.ordered_sum(g, group) for g, d in zip(grads, dims)]
        del grads
        if grad_compress:
            red, state["ef"] = ef_compress(red, state["ef"], amax=amax)
        norm = _global_norm(red, dims, msplit, group, mgroup)
        if zero1:
            local = [p.detach().narrow(d, rank * (p.shape[d] // ws),
                                       p.shape[d] // ws)
                     if d is not None else p.detach()
                     for p, d in zip(wrt, dims)]
            opt = {"m": leaves(state["opt"]["m"]),
                   "v": leaves(state["opt"]["v"]),
                   "count": state["opt"]["count"]}
            _, opt, om = adamw_update(opt_cfg, red, opt, local, norm=norm)
            state["opt"]["count"] = opt["count"]
            with torch.no_grad():
                for p, part, d in zip(wrt, local, dims):
                    if d is not None:
                        p.copy_(col.all_gather_cat(part, d, group))
        else:
            whole = [col.all_gather_cat(g, d, group) if d is not None else g
                     for g, d in zip(red, dims)]
            del red
            _, _, om = adamw_update(opt_cfg, whole, state["opt"],
                                    state["params"], norm=norm)
        state["step"] += 1
        out = {"loss": col.ordered_sum(obj_sum, group) / n,
               "ce": col.ordered_sum(ce_sum, group) / n,
               "aux": col.ordered_sum(aux_sum, group) / (ws * n)}
        return state, {**out, **om}

    return step_fn


def make_train_step(model, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    grad_compress: bool = False, mesh=None,
                    zero1: bool = True):
    """Returns step(state, batch) -> (state, metrics); the state is updated
    in place. With ``grad_compress`` the state holds ``"ef"``
    (``init_state(..., grad_compress=True)``). With ``mesh`` the step is
    data parallel over its 'data' axis and tensor parallel over its
    'model' axis (the module's docstring) on a state from
    ``sharded_init(model, seed, mesh, zero1=zero1, ...)``."""
    if mesh is not None:
        _check_mesh(model, mesh)
        return _mesh_step(model, opt_cfg, mesh, zero1=zero1,
                          grad_compress=grad_compress,
                          microbatches=microbatches)

    def step_fn(state, batch):
        loss, metrics, grads = loss_and_grads(model, state["params"], batch,
                                              microbatches=microbatches)
        if grad_compress:
            grads, state["ef"] = ef_compress(grads, state["ef"])
        _, _, om = adamw_update(opt_cfg, grads, state["opt"], state["params"])
        state["step"] += 1
        return state, {"loss": loss, **metrics, **om}

    return step_fn


@dataclasses.dataclass
class TrainLoopResult:
    state: dict
    losses: list
    restarts: int
    straggler_events: list
    step_seconds: list = dataclasses.field(default_factory=list)
    # {(batch, seq): {op: KernelPolicy}}, one entry per batch shape
    policies: dict = dataclasses.field(default_factory=dict)


def pin_bucket_policies(model, batch: dict, pinned: dict,
                        log: Callable = print, mesh=None) -> dict:
    """Resolve and pin the kernel policies of this batch's (batch, seq)
    bucket, once a bucket, as the reference's: the autotuner's
    ``policies_for_model`` (with ``mesh``, its ``train_shard_spec``: the
    sharded fusion plans journaled too), the ``obs`` counters
    "trainer.bucket_pins" and "trainer.bucket_pins.{B}x{S}" and one
    "[trainer] bucket (B, S): pinned kernel policies ..." line."""
    inputs = batch.get("inputs") if isinstance(batch, dict) else batch
    if inputs is None or getattr(inputs, "ndim", 0) < 2:
        return pinned
    key = (int(inputs.shape[0]), int(inputs.shape[1]))
    if key not in pinned:
        from repro_torch.distributed.sharding import train_shard_spec

        shard = train_shard_spec(model.cfg, mesh)
        pols = autotune.policies_for_model(model.cfg, batch=key[0],
                                           seq_len=key[1], shard=shard)
        pinned[key] = pols
        if obs.enabled():
            obs.incr("trainer.bucket_pins")
            obs.incr(f"trainer.bucket_pins.{key[0]}x{key[1]}")
        desc = "; ".join(f"{op}={p.schedule.name}"
                         f"{tuple(p.describe()['blocks'])}"
                         for op, p in sorted(pols.items()))
        log(f"[trainer] bucket {key}: pinned kernel policies "
            f"{desc or '(none)'}")
    return pinned


def train_loop(model, data_iter, num_steps: int, opt_cfg: AdamWConfig, *,
               seed: int = 0, params=None, mesh=None, zero1: bool = False,
               grad_compress: bool = False,
               microbatches: int = 1, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 50,
               checkpointer: Optional[ckpt_lib.AsyncCheckpointer] = None,
               failure_injector: Optional[FailureInjector] = None,
               watchdog: Optional[StragglerWatchdog] = None,
               max_restarts: int = 3, log_every: int = 10,
               pretuned=None, log: Callable = print) -> TrainLoopResult:
    """Train up to step ``num_steps`` from ``init_state(model, seed, params,
    grad_compress=...)``, or from the newest valid checkpoint in
    ``ckpt_dir``. ``checkpointer``: the ``AsyncCheckpointer`` to save
    through (its directory is the checkpoint directory); by default one
    over ``ckpt_dir`` keeping 3. Each step's host time ends when its loss
    reaches the host (a device synchronise); ``step_seconds`` keeps them.
    With ``mesh`` (and ``zero1``) the step is data parallel
    (:func:`make_train_step`), the state each rank's blocks
    (``sharded_init``), and checkpoints hold the global leaves, written by
    the mesh's first rank and restored into each rank's blocks.
    ``pretuned``: a measured policy table (a path or a report dict),
    installed for the process before the first bucket pins its policies
    (a rejected table raises)."""
    if pretuned is not None:
        autotune.use_pretuned(pretuned, required=True)
    step_fn = make_train_step(model, opt_cfg, microbatches=microbatches,
                              grad_compress=grad_compress, mesh=mesh,
                              zero1=zero1)
    specs = None
    if mesh is not None:
        specs = state_shardings(model, mesh, zero1=zero1,
                                grad_compress=grad_compress)
    if checkpointer is None and ckpt_dir is not None:
        checkpointer = ckpt_lib.AsyncCheckpointer(ckpt_dir, mesh=mesh,
                                                  specs=specs)
    ckpt_dir = checkpointer.directory if checkpointer is not None else None

    def fresh_state():
        if mesh is not None:
            return sharded_init(model, seed, mesh, zero1=zero1,
                                grad_compress=grad_compress, params=params)
        return init_state(model, seed, params, grad_compress=grad_compress)

    def restored_state():
        """The newest valid checkpoint restored into a fresh state's
        layout, or None; the data iterator moved to its step. Each kept
        payload is hashed once."""
        steps = ckpt_lib.available_steps(ckpt_dir) if ckpt_dir else []
        if not steps:
            return None
        state, step0 = ckpt_lib.restore(ckpt_dir, fresh_state(),
                                        step=max(steps), mesh=mesh,
                                        specs=specs)
        data_iter.load_state_dict({"step": step0})
        return state

    state = restored_state()
    if state is not None:
        log(f"[trainer] resumed from checkpoint at step {state['step']}")
    else:
        state = fresh_state()
    losses: list = []
    seconds: list = []
    restarts = 0
    pinned: dict = {}
    step = state["step"]
    while step < num_steps:
        try:
            batch = next(data_iter)
            pin_bucket_policies(model, batch, pinned, log=log, mesh=mesh)
            t0 = time.perf_counter()
            if failure_injector is not None:
                failure_injector.maybe_fail(step)
            with obs.span("trainer.step", step=step):
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            obs.incr("trainer.steps")
            if watchdog is not None:
                watchdog.observe(step, dt)
            losses.append(loss)
            seconds.append(dt)
            step += 1
            if log_every and step % log_every == 0:
                log(f"[trainer] step {step:5d} loss {loss:.4f} "
                    f"({dt * 1e3:.0f} ms)")
            if checkpointer is not None and step % ckpt_every == 0:
                checkpointer.save(state, step)
        except SimulatedFailure as e:
            restarts += 1
            log(f"[trainer] {e} — recovering (restart {restarts})")
            if restarts > max_restarts:
                raise
            if checkpointer is not None:
                checkpointer.wait()
            del state
            state = restored_state()
            if state is not None:
                step = state["step"]
                log(f"[trainer] restored step {step}")
            else:
                state = fresh_state()
                data_iter.load_state_dict({"step": 0})
                step = 0
                log("[trainer] no checkpoint — restarted from scratch")
    if checkpointer is not None:
        checkpointer.save(state, step)
        checkpointer.wait()
    return TrainLoopResult(state, losses, restarts,
                           watchdog.events if watchdog else [], seconds,
                           pinned)
