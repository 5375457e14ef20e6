"""Fault-tolerant checkpointing: atomic, versioned, written in the background.

The reference's on-disk format, so either package restores the other's
checkpoints: ``<dir>/step_<N:08d>/arrays.npz`` plus ``manifest.json``
(``{"step", "sha256", "keys"}``, the sha256 of the payload). The keys are
the state's paths (``params/blocks/attn/wq``, ``opt/m/...``, ``opt/count``,
``step``, ``ef/...``); the port's Python ints (``step``, ``opt/count``) are
written as 0-d int32 arrays, as JAX holds them, and read back as ints.
A save goes to a ``.tmp_save_`` directory and is then ``os.replace``d into
place, so a crash mid-save never corrupts the newest checkpoint, and only
the ``keep`` newest are kept.

``AsyncCheckpointer.save`` snapshots the state to host memory synchronously
and writes it in a background thread. The snapshot is a copy: AdamW updates
the parameters and moments in place, so a write that read the live tensors
would save whatever the next steps made of them. The state is fp32 and int
only; numpy has no bfloat16 (the port does not use ``ml_dtypes``), so a
bfloat16 leaf is refused on save and on restore.

Over a mesh (``mesh=`` and the state's ``specs``, ``state.state_shardings``)
a save first all-gathers every leaf to its global value on every rank and
the mesh's first rank writes it, in the same format: either package
restores the other's. ``restore(..., mesh=, specs=)`` gives each rank its
block of every global leaf under those specs, which may be another mesh's
than the one that saved (an elastic restore). A leaf whose spec carries a
layout (``sharding.LaidOut``: the tensor-parallel step's head-aligned q|k)
is un-permuted when gathered and permuted when restored, so the file
always holds the reference's layout.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.models.common import nest
from repro_torch.optim.optimizer import named_leaves

_HASH_CHUNK = 1 << 24


def _snapshot(state, pinned: dict | None = None) -> dict:
    """{path: host array}: copies of the tensors, int leaves as 0-d int32.
    With ``pinned`` (a dict the caller keeps), a card tensor is copied into
    a page-locked host buffer kept there under its path and reused by the
    next snapshot: a device-to-host copy at the link's rate, where a fresh
    pageable array is first zeroed page by page. The caller must not take
    the next snapshot until the arrays of this one are written."""
    flat, copied = {}, False
    for path, x in named_leaves(state):
        if not torch.is_tensor(x):
            flat[path] = np.asarray(x, np.int32)
        elif x.dtype == torch.bfloat16:
            raise TypeError(f"checkpoint: {path} is bfloat16, which numpy "
                            "cannot hold; the train state is fp32 and int")
        elif pinned is not None and x.is_cuda:
            buf = pinned.get(path)
            if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
                buf = pinned[path] = torch.empty(x.shape, dtype=x.dtype,
                                                 pin_memory=True)
            buf.copy_(x.detach(), non_blocking=True)
            flat[path], copied = buf.numpy(), True
        else:
            flat[path] = x.detach().to("cpu", copy=True).numpy()
    if copied:
        torch.cuda.synchronize()
    return flat


def _sha256(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(_HASH_CHUNK), b""):
            digest.update(block)
    return digest.hexdigest()


def _write(flat: dict, directory: str, step: int, keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_save_")
    try:
        payload = os.path.join(tmp, "arrays.npz")
        np.savez(payload, **flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": int(step), "sha256": _sha256(payload),
                       "keys": sorted(flat)}, f)
        final = os.path.join(directory, f"step_{int(step):08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(directory, keep)
    return final


def _global(state, mesh, specs):
    """The state with every leaf all-gathered to its global value in the
    reference's layout (every rank of the mesh calls it); ``state`` itself
    without a mesh."""
    if mesh is None:
        return state
    from repro_torch.distributed.sharding import gather_tree

    return gather_tree(state, specs, mesh)


def _writer(mesh) -> bool:
    """Whether this rank writes: the first of the mesh's world, or any
    rank without a mesh."""
    if mesh is None:
        return True
    import torch.distributed as dist

    return dist.get_rank() == 0


def _barrier(mesh) -> None:
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()


def save(state, directory: str, step: int, *, keep: int = 3, mesh=None,
         specs=None) -> str:
    """Write ``state`` as ``step`` synchronously; returns its directory.
    Over a mesh every rank calls it; the global leaves are written once."""
    flat = _snapshot(_global(state, mesh, specs))
    final = (_write(flat, directory, step, keep) if _writer(mesh)
             else os.path.join(directory, f"step_{int(step):08d}"))
    _barrier(mesh)
    return final


class AsyncCheckpointer:
    """Snapshot synchronously, write in the background; at most one write
    in flight. A card tensor's snapshot goes to a page-locked host buffer
    that the checkpointer keeps and reuses (as much host memory as the
    state's tensors). ``records`` holds one dict per save: ``step``,
    ``bytes`` (the payload's size), ``snapshot_s`` (the synchronous copy to
    the host), ``write_s`` and the write's ``write_start``/``write_end`` on
    ``time.perf_counter``'s clock."""

    def __init__(self, directory: str, keep: int = 3, *, mesh=None,
                 specs=None):
        self.directory = directory
        self.keep = keep
        self.mesh, self.specs = mesh, specs
        self._thread: threading.Thread | None = None
        self._pinned: dict = {}
        self.last_error: BaseException | None = None
        self.records: list = []

    def save(self, state, step: int) -> None:
        """Over a mesh every rank calls it (the gather is a collective);
        the first rank snapshots and writes."""
        self.wait()                        # the buffers are free again
        t0 = time.perf_counter()
        state = _global(state, self.mesh, self.specs)
        if not _writer(self.mesh):
            return
        flat = _snapshot(state, self._pinned)
        rec = {"step": int(step), "snapshot_s": time.perf_counter() - t0}
        self.records.append(rec)

        def work():
            start = time.perf_counter()
            try:
                final = _write(flat, self.directory, step, self.keep)
                rec["bytes"] = os.path.getsize(
                    os.path.join(final, "arrays.npz"))
            except BaseException as e:  # surfaced on the next wait()
                self.last_error = e
            end = time.perf_counter()
            rec.update(write_start=start, write_end=end,
                       write_s=end - start)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; raise its error, if it had one. Over
        a mesh every rank calls it: the others wait for the write."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier(self.mesh)
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


def _gc(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def available_steps(directory: str) -> list:
    """The steps whose payload matches its manifest's sha256, ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for d in sorted(os.listdir(directory)):
        if not d.startswith("step_"):
            continue
        man = os.path.join(directory, d, "manifest.json")
        payload = os.path.join(directory, d, "arrays.npz")
        if not (os.path.exists(man) and os.path.exists(payload)):
            continue
        with open(man) as f:
            meta = json.load(f)
        if _sha256(payload) == meta["sha256"]:
            out.append(meta["step"])
    return out


def restore(directory: str, template, *, step: int | None = None,
            device=None, mesh=None, specs=None, coords: dict | None = None):
    """(state, step): the newest valid checkpoint (or ``step``, which the
    caller has found valid: ``available_steps``) in ``template``'s
    structure. Each tensor leaf comes back in its template's type, on
    ``device`` or the template's, requiring grad where the template does;
    each int leaf as an int. With ``mesh`` and ``specs`` (the state's,
    ``state.state_shardings``) each tensor leaf is the block of the global
    leaf that the rank at ``coords`` (default: this rank) holds (permuted
    first where its spec carries a layout), and ``template`` holds the
    blocks' shapes. Each kept payload is hashed at most once."""
    from repro_torch.distributed.sharding import local_slice

    spec_of = dict(named_leaves(specs)) if mesh is not None \
        else {}
    if step is None:
        steps = available_steps(directory)
        if not steps:
            raise FileNotFoundError(f"no valid checkpoints under "
                                    f"{directory}")
        step = max(steps)
    payload = os.path.join(directory, f"step_{step:08d}", "arrays.npz")
    flat = {}
    with np.load(payload) as arrays:
        for key, tpl in named_leaves(template):
            arr = arrays[key]
            if key in spec_of and arr.ndim:
                arr = local_slice(arr, spec_of[key], mesh, coords)
            shape = tuple(tpl.shape) if torch.is_tensor(tpl) else ()
            if tuple(arr.shape) != shape:
                raise ValueError(f"shape mismatch for {key}: "
                                 f"ckpt {arr.shape} vs template {shape}")
            if arr.dtype.kind not in "biuf":
                raise TypeError(f"checkpoint: {key} has type {arr.dtype} "
                                "(bfloat16 or another type numpy cannot read "
                                "without ml_dtypes); the train state is fp32 "
                                "and int")
            if not torch.is_tensor(tpl):
                flat[key] = int(arr)
                continue
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=device or tpl.device, dtype=tpl.dtype)
            flat[key] = t.requires_grad_(tpl.requires_grad)
    return nest(flat), step
