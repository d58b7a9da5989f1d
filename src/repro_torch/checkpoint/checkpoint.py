"""Crash-safe checkpoints, ported from `repro.checkpoint.checkpoint`.

ZO state is small by construction: (params, step, spent DP budget). Saves
are atomic (write to a temp dir, fsync, rename) with a CRC-32 manifest, so
a torn write is caught at restore instead of resuming from garbage. The
privacy ledger is part of the state: a crash never resets the spent
(ε, δ) budget.

Layout, the reference's byte for byte, so either package restores what the
other wrote:
  <dir>/step_<N>/arrays.npz      one entry per leaf, by path
  <dir>/step_<N>/manifest.json   {step, extra, crc32, dtypes, shapes}

A leaf's path is the reference's `_leaf_paths` name: dict keys and list
indices joined by "/", in JAX's flattening order (dicts by sorted key,
lists by index), e.g. "layers/attn/wq", "tail/0/conv_w".
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import spans
from repro_torch.runtime import inject as inj

PyTree = Any


def _leaf_paths(tree: PyTree) -> Tuple[List[str], List[Any]]:
    """(names, leaves) in JAX's flattening order."""
    names: List[str] = []
    leaves: List[Any] = []
    _walk(tree, (), names, leaves)
    return names, leaves


# Module-level recursion, not nested closures: a closure that calls itself
# is a reference cycle, which would keep the leaves (weights on the card)
# alive until the garbage collector runs.
def _walk(node, prefix: tuple, names: List[str], leaves: List[Any]) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], prefix + (str(k),), names, leaves)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, prefix + (str(i),), names, leaves)
    else:
        names.append("/".join(prefix))
        leaves.append(node)


def _unflatten(like: PyTree, leaves: List[Any]) -> PyTree:
    """`like`'s structure with `leaves` in flattening order."""
    return _build(like, iter(leaves))


def _build(node, it: Iterator) -> PyTree:
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return next(it)


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, params: PyTree,
         extra: Optional[Dict] = None, keep: int = 3) -> str:
    """Atomically persist (params, step, extra); returns the final path.
    Leaves may be torch tensors (on any device) or numpy arrays."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    names, leaves = _leaf_paths(params)
    arrays = {n: _host_array(leaf)
              for n, leaf in zip(names, leaves, strict=True)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)

    manifest = {
        "step": int(step),
        "extra": extra or {},
        "crc32": {n: zlib.crc32(a.tobytes()) for n, a in arrays.items()},
        "dtypes": {n: str(a.dtype) for n, a in arrays.items()},
        "shapes": {n: list(a.shape) for n, a in arrays.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _retain(directory, keep)
    return final


def _steps(directory: str) -> List[str]:
    return sorted(d for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def _retain(directory: str, keep: int) -> None:
    for stale in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, stale))


class AsyncCheckpointer:
    """Checkpoints written off the training thread.

    The params are updated in place by the next chunk (and a captured CUDA
    graph reads their addresses), so a snapshot must be taken in stream
    order before the next chunk's first kernel. With `double_buffer=True`
    (the default) `save` enqueues one non-blocking copy of every leaf into
    host buffers (pinned for leaves on the card) on the current stream,
    records a CUDA event after them, and starts the writer thread, which
    waits on the event before it serializes, CRCs and fsyncs: the next
    chunk dispatches without waiting for the transfer, and the card holds
    no second copy of the weights. The host buffers are allocated once
    and reused; `save` first joins the previous writer (`wait`), so they
    are never rewritten while they are read. On the CPU the copy is
    synchronous. `double_buffer=False` is the synchronous baseline: the
    training thread copies the leaves to the host itself. `stall_s` counts
    the training thread's time in `save` in both modes.

    Degradation contract (the reference's): a failing write is retried
    `write_retries` times with backoff (`inject.with_retries`); if it still
    fails, the failure is counted in `write_failures` and the run keeps its
    last good checkpoint (resume finds it through `latest_valid`). A
    failing snapshot skips the boundary (`snapshot_failures`). `injector`
    arms the `ckpt_snapshot` and `ckpt_write` sites; its `torn_write` mode
    truncates the just-written `arrays.npz`.

    Telemetry (`tracer`): each write runs in a ``ckpt_write`` span on the
    writer thread (its retries in ``retry`` spans), a torn write, a failed
    write and a skipped boundary drop ``ckpt_torn``, ``ckpt_write_failed``
    and ``ckpt_skipped`` instants, and each `save` records a
    ``ckpt_snapshot`` span from the same perf_counter endpoints that
    `stall_s` adds, so the spans' sum is `stall_s`."""

    def __init__(self, directory: str, keep: int = 3,
                 double_buffer: bool = True,
                 tracer: spans.Tracer = spans.NULL_TRACER,
                 injector: Optional[inj.FaultInjector] = None,
                 write_retries: int = 3):
        self.directory = directory
        self.keep = keep
        self.double_buffer = double_buffer
        self.stall_s = 0.0
        self.write_failures = 0
        self.snapshot_failures = 0
        self.retries: Dict[str, int] = {}
        self.write_retries = write_retries
        self._thread: Optional[threading.Thread] = None
        self._tracer = tracer
        self._injector = injector
        self._buffers: Optional[Tuple[tuple, List[torch.Tensor]]] = None

    def _save_retrying(self, step: int, host_params: PyTree,
                       extra: Optional[Dict]) -> None:
        """`save` with bounded retry, and keep-last-good on final failure."""
        def attempt():
            torn = None
            if self._injector is not None:
                torn = self._injector.fire("ckpt_write")
            path = save(self.directory, step, host_params, extra=extra,
                        keep=self.keep)
            if torn == "torn_write":
                tear_checkpoint(path)
                self._tracer.instant("ckpt_torn", step=step)

        try:
            inj.with_retries(attempt, site="ckpt_write",
                             attempts=self.write_retries,
                             tracer=self._tracer, retries=self.retries)
        except Exception as exc:  # noqa: BLE001 - keep the last good one
            self.write_failures += 1
            self._tracer.instant("ckpt_write_failed", step=step,
                                 error=type(exc).__name__)

    def _write(self, step: int, params: PyTree, buffers: List[torch.Tensor],
               copied: Optional[torch.cuda.Event],
               extra: Optional[Dict]) -> None:
        with self._tracer.span("ckpt_write", step=step):
            if copied is not None:
                copied.synchronize()
            host = _unflatten(params, [b.numpy() for b in buffers])
            self._save_retrying(step, host, extra)

    def _write_host(self, step: int, host: PyTree,
                    extra: Optional[Dict]) -> None:
        with self._tracer.span("ckpt_write", step=step):
            self._save_retrying(step, host, extra)

    def _snapshot_buffers(self, leaves: List[torch.Tensor]
                          ) -> List[torch.Tensor]:
        """Host buffers shaped like `leaves`, allocated on first use."""
        sig = tuple((tuple(t.shape), t.dtype, t.is_cuda) for t in leaves)
        if self._buffers is None or self._buffers[0] != sig:
            self._buffers = None
            self._buffers = (sig, [torch.empty(t.shape, dtype=t.dtype,
                                               pin_memory=t.is_cuda)
                                   for t in leaves])
        return self._buffers[1]

    def save(self, step: int, params: PyTree,
             extra: Optional[Dict] = None) -> None:
        t0 = time.perf_counter()
        self.wait()
        try:
            if self._injector is not None:
                self._injector.fire("ckpt_snapshot")
            _, leaves = _leaf_paths(params)
            if self.double_buffer and all(isinstance(t, torch.Tensor)
                                          for t in leaves):
                buffers = self._snapshot_buffers(leaves)
                for buf, leaf in zip(buffers, leaves):
                    buf.copy_(leaf.detach(), non_blocking=True)
                copied = None
                if any(t.is_cuda for t in leaves):
                    copied = torch.cuda.Event()
                    copied.record()
                self._thread = threading.Thread(
                    target=self._write,
                    args=(step, params, buffers, copied, extra), daemon=True)
            else:
                host = _unflatten(params, [
                    t.detach().to("cpu", copy=True).numpy()
                    if isinstance(t, torch.Tensor) else np.array(t)
                    for t in leaves])
                self._thread = threading.Thread(
                    target=self._write_host, args=(step, host, extra),
                    daemon=True)
            self._thread.start()
        except Exception as exc:  # noqa: BLE001 - skip the boundary
            self.snapshot_failures += 1
            self._tracer.instant("ckpt_skipped", step=step,
                                 error=type(exc).__name__)
        t1 = time.perf_counter()
        self.stall_s += t1 - t0
        # the span is the exact stall_s increment (the same endpoints)
        self._tracer.add_span("ckpt_snapshot", t0, t1, step=step)

    def wait(self) -> None:
        """Join the writer in flight (writes never interleave)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest(directory: str) -> Optional[str]:
    """Path of the newest step_* checkpoint (no integrity check)."""
    if not os.path.isdir(directory):
        return None
    ckpts = _steps(directory)
    return os.path.join(directory, ckpts[-1]) if ckpts else None


def valid_checkpoint(path: str) -> bool:
    """Whether `path` holds a complete, CRC-consistent checkpoint: any
    missing or undecodable manifest, unreadable or truncated npz, missing
    leaf or CRC mismatch makes it invalid rather than raising."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for n, crc in manifest["crc32"].items():
                if n not in data.files:
                    return False
                if zlib.crc32(data[n].tobytes()) != int(crc):
                    return False
        return True
    except Exception:  # noqa: BLE001 - any damage means "not valid"
        return False


def latest_valid(directory: str) -> Optional[str]:
    """Path of the newest checkpoint that passes full CRC validation,
    walking step_* newest first past torn or corrupt ones: with the atomic
    save, a resumable state exists whenever any save completed."""
    if not os.path.isdir(directory):
        return None
    for name in reversed(_steps(directory)):
        path = os.path.join(directory, name)
        if valid_checkpoint(path):
            return path
    return None


def tear_checkpoint(path: str) -> None:
    """Truncate a checkpoint's arrays.npz to half (a simulated torn write).
    The manifest stays, so `latest` still returns it; `valid_checkpoint`
    rejects it and `latest_valid` falls back past it."""
    npz = os.path.join(path, "arrays.npz")
    size = os.path.getsize(npz)
    with open(npz, "r+b") as f:
        f.truncate(max(size // 2, 1))
        f.flush()
        os.fsync(f.fileno())


def restore(path: str, params_like: PyTree) -> Tuple[PyTree, int, Dict]:
    """Load a checkpoint into the structure of `params_like`, verifying
    every leaf's CRC and shape; returns (params, step, extra). A tensor
    leaf comes back as a new tensor with the like leaf's dtype on its
    device, a numpy leaf as a numpy array."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    names, likes = _leaf_paths(params_like)
    restored = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for n, like in zip(names, likes, strict=True):
            arr = data[n]
            crc = zlib.crc32(arr.tobytes())
            if crc != manifest["crc32"][n]:
                raise IOError(f"checkpoint corruption detected in leaf {n!r} "
                              f"(crc {crc} != {manifest['crc32'][n]})")
            if list(arr.shape) != list(like.shape):
                raise ValueError(f"leaf {n!r} shape {arr.shape} != expected "
                                 f"{tuple(like.shape)}")
            if isinstance(like, torch.Tensor):
                restored.append(torch.from_numpy(arr).to(
                    device=like.device, dtype=like.dtype))
            else:
                restored.append(arr.astype(np.asarray(like).dtype))
    return _unflatten(params_like, restored), int(manifest["step"]), \
        manifest["extra"]
