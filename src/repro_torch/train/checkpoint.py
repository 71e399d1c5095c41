"""Checkpoint and restore with writes on a background thread.

Counterpart of ``repro.train.checkpoint`` on one device, with its format
and its commit protocol: a ``step-N.tmp`` directory written off the train
loop's thread, one ``.npy`` file a leaf keyed by the leaf's path, and
``manifest.json`` (each leaf's file, shape and dtype); then the atomic
rename to ``step-N``, and gc down to ``max_to_keep``.  Only committed
steps count (``all_steps``, ``latest_step``).

The port's train state is updated in place, so ``save`` copies every leaf
to the host (a copy, never a view: on the CPU ``.cpu()`` would return the
tensor itself, which the next step overwrites) before it returns.  numpy
has no bfloat16, so a bf16 leaf is written as its uint16 bits with the
manifest's dtype ``bfloat16``, and read back bitwise.  ``restore`` writes
each leaf into the target tree's tensor, so each comes back on that
tensor's device, in its dtype.  A state may hold a model module (the
recsys and GNN train cells' ``{"model", "opt"}``): its leaves are the
module's ``tree()``.
"""
from __future__ import annotations

import concurrent.futures
import json
import pathlib
import shutil
import threading

import numpy as np
import torch

from repro_torch.common.tree import tree_map_with_path

BF16 = "bfloat16"


def _tensor_tree(state):
    """``state`` as a tree of tensors: a module (anything with ``tree()``)
    as its parameter tree."""
    if isinstance(state, dict):
        return {k: _tensor_tree(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [_tensor_tree(v) for v in state]
    if hasattr(state, "tree"):
        return state.tree()
    return state


def _leaf_paths(state):
    """(keys, leaves): each leaf's path joined by "/" (dict keys, list
    indices), as the reference names them."""
    keyed = []
    tree_map_with_path(lambda path, t: keyed.append(
        ("/".join(map(str, path)), t)), _tensor_tree(state))
    return [k for k, _ in keyed], [t for _, t in keyed]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy (bf16 as its uint16 bits)."""
    host = t.detach().to("cpu", copy=True)
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16)
    return host.numpy()


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
        self._pending: list[concurrent.futures.Future] = []
        self._lock = threading.Lock()

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state, *, blocking: bool = False):
        """Copy every leaf to the host now, then write on a background
        thread.  Returns the write's future."""
        keys, leaves = _leaf_paths(state)
        host = [(_to_numpy(t), BF16 if t.dtype == torch.bfloat16
                 else None) for t in leaves]
        fut = self._pool.submit(self._write, step, keys, host)
        with self._lock:
            self._pending.append(fut)
        if blocking:
            fut.result()
        return fut

    def _write(self, step: int, keys, host):
        tmp = self.dir / f"step-{step:09d}.tmp"
        final = self.dir / f"step-{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": {}}
        for key, (arr, dtype) in zip(keys, host):
            fname = key.replace("/", ".") + ".npy"
            np.save(tmp / fname, arr)
            manifest["leaves"][key] = {"file": fname,
                                       "shape": list(arr.shape),
                                       "dtype": dtype or str(arr.dtype)}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        tmp.rename(final)  # atomic commit
        self._gc()
        return final

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.max_to_keep]:
            shutil.rmtree(self.dir / f"step-{s:09d}", ignore_errors=True)

    def wait(self):
        """Wait for every pending write (raising its error, if any)."""
        with self._lock:
            pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step-*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("-")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, step: int, target, shardings=None):
        """Load step ``step`` into ``target`` (a state whose tensors give
        each leaf's device and dtype) in place, and return it."""
        if shardings is not None:
            raise ValueError("restore: one device has no shardings to "
                             "restore onto")
        d = self.dir / f"step-{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        keys, leaves = _leaf_paths(target)
        for key, leaf in zip(keys, leaves):
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = np.load(d / meta["file"])
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs target {tuple(leaf.shape)}")
            leaf.copy_(_from_numpy(arr, meta["dtype"]))
        return target

