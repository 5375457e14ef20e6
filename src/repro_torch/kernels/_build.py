"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
by ``nvcc`` for ``sm_90a`` into a shared library under ``kernels/build/``
(git-ignored), then loaded with ``ctypes``. The library's file name carries
a hash of its source, the ``*.cuh`` headers beside it (those it includes)
and the flags, so an edited source or header builds anew and an unchanged
one is reused; a source of another tree with its own headers (the smoke's
A/B) gets a library of its own even where the ``.cu`` is this tree's.
``build_all`` starts one ``nvcc`` per source, all at once, and waits for
them.

Every C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; :meth:`CudaKernel.check` turns a
non-zero code into an exception, so a refused launch (too many threads, too
much shared memory) never passes silently.

The op wrappers journal each launch into ``repro_torch.obs`` from their
Python entry (:func:`entry_clock`, :func:`journal`), on the CPU too, where
the entry runs the kernel's plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from repro_torch import obs

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that has the card")


class CudaKernel:
    """One kernel source: its library, its C entry point and its launch
    count. ``launches`` is incremented by the op wrapper each time it
    launches the kernel, and nowhere else."""

    def __init__(self, name: str, source: str, entry: str, argtypes: list):
        self.name = name
        self.entry = entry
        self.argtypes = argtypes
        self.source = CSRC / source
        self.launches = 0
        self._fn = None
        self._lib = None

    @property
    def lib_path(self) -> pathlib.Path:
        h = hashlib.sha256(self.source.read_bytes())
        # the headers the source includes: those of its own directory
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}-{h.hexdigest()[:16]}.so"

    def start_build(self):
        """Start nvcc for this source unless its library exists. Returns
        (process, temporary output) or None when there is nothing to build."""
        out = self.lib_path
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def finish_build(self, started) -> str:
        proc, tmp = started
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {self.source.name} ({proc.returncode}):\n{log}")
        out = self.lib_path
        os.replace(tmp, out)   # atomic: a reader never sees a torn library
        out.with_suffix(".log").write_text(log)
        return log

    def fn(self):
        """The bound C entry point (building the library on first use)."""
        if self._fn is None:
            started = self.start_build()
            if started is not None:
                self.finish_build(started)
            self._lib = ctypes.CDLL(str(self.lib_path))
            fn = getattr(self._lib, self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = self._lib.repro_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn = fn
        return self._fn

    def check(self, code: int) -> None:
        if code != 0:
            msg = self._lib.repro_error_string(code).decode()
            raise RuntimeError(f"{self.name}: CUDA error {code}: {msg}")

    def stream(self, device) -> int:
        """The handle of ``device``'s current stream. The C entry launches
        on the calling thread's current device, so tensors on another card
        are refused rather than handed to the wrong one."""
        if device.index != torch.cuda.current_device():
            raise ValueError(
                f"{self.name}: tensors on {device}, but the current CUDA "
                f"device is cuda:{torch.cuda.current_device()}")
        return torch.cuda.current_stream(device).cuda_stream


def build_all(kernels) -> dict:
    """Build every kernel's library in parallel (one nvcc per source).
    Returns {name: compiler log} (empty for libraries already built)."""
    started = [(k, k.start_build()) for k in kernels]
    logs = {}
    for k, st in started:
        logs[k.name] = "" if st is None else k.finish_build(st)
    for k in kernels:
        k.fn()
    return logs


def entry_clock():
    """The host clock at a kernel entry under a timed capture
    (``obs.capture(timing=True)``), else None."""
    return time.perf_counter() if obs.timing_enabled() else None


def journal(op: str, device, t0, **fields) -> None:
    """Journal one launch of ``op`` on ``device`` (the caller checks
    ``obs.enabled()`` first, so nothing is built when no capture is
    active). With ``t0`` from :func:`entry_clock`, ``wall_s`` is the host
    time since, ended by a synchronise of the card. A launch recorded into
    a CUDA graph is not journaled: the capture runs nothing (its counts are
    taken back, ``serve.engine.DecodeGraph``), and a replay runs no
    Python."""
    cuda = device.type == "cuda"
    if cuda and torch.cuda.is_current_stream_capturing():
        return
    wall = None
    if t0 is not None:
        if cuda:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    obs.launch(op, wall_s=wall, **fields)
