"""Checkpointing with async save (the port of
``repro/distributed/checkpoint.py``, with the same on-disk layout).

One directory ``step_%010d`` per step; every leaf of the state tree is saved
as its own ``leaf_%05d.npy``, keyed by its tree path in ``manifest.json``
(``step``, and each leaf's ``file``, ``shape`` and ``dtype``); bf16 is saved
as its 16-bit patterns (``uint16``).  A step is written into a temporary
directory and published by an atomic rename; the manager keeps the newest
``keep`` steps.  Saves run on a background thread, so training never waits
on the disk.  Either package reads the other's checkpoints.

Restore loads every leaf whole onto one device.  ``restore(...,
shardings=...)`` takes the reference's argument: a leaf's
``NamedSharding`` over a mesh of one device places the whole leaf there;
a larger mesh (the reference's elastic resharding across processes) is
refused until the port runs on several GPUs.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map_with_path


def _flatten(tree: Any) -> Dict[str, Any]:
    """{path: leaf} in ``tree_map``'s order, the manifest's keys."""
    out = {}
    tree_map_with_path(out.__setitem__, tree)
    return out


def _to_host(v) -> Tuple[np.ndarray, str]:
    """A private host copy of a leaf, taken now: (the array to write, its
    logical dtype).  A CPU tensor's ``numpy()`` shares its storage, so an
    in-place update queued after the save would reach a plain view."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    a = np.array(v)                      # a copy
    return a, str(a.dtype)


def _check_one_device(shardings: Any) -> None:
    """Every NamedSharding of the tree is over a mesh of one device."""
    if hasattr(shardings, "mesh") and hasattr(shardings, "spec"):
        if shardings.mesh.size != 1:
            raise NotImplementedError(
                f"restore under {shardings!r}: a mesh of "
                f"{shardings.mesh.size} devices; this process holds every "
                "leaf whole on one device")
    elif isinstance(shardings, dict):
        for v in shardings.values():
            _check_one_device(v)
    elif isinstance(shardings, (list, tuple)):
        for v in shardings:
            _check_one_device(v)


@dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    async_save: bool = True

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None
        if self.async_save:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # -- save ------------------------------------------------------------------
    def save(self, step: int, state: Any, *, blocking: bool = False) -> str:
        """Snapshot (the device -> host copy happens NOW; I/O maybe async)."""
        host = {k: _to_host(v) for k, v in _flatten(state).items()}
        path = os.path.join(self.directory, f"step_{step:010d}")
        if self.async_save and not blocking:
            self._q.put((step, path, host))
        else:
            self._write(step, path, host)
        return path

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                self._write(*item)
            except BaseException as e:  # surfaced on next wait()
                self._last_error = e
            finally:
                self._q.task_done()

    def _write(self, step: int, path: str,
               host: Dict[str, Tuple[np.ndarray, str]]):
        if os.path.exists(path):      # same step already published
            return
        tmp = f"{path}.tmp.{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {}}
        for i, (k, (a, logical)) in enumerate(host.items()):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), a)
            manifest["leaves"][k] = {
                "file": fname, "shape": list(a.shape), "dtype": logical,
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        try:
            os.rename(tmp, path)  # atomic publish
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)  # concurrent save won
        self._gc()

    def wait(self):
        """Block until queued saves land; re-raise background errors."""
        self._q.join()
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True
            )

    # -- restore ------------------------------------------------------------------
    def list_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and ".tmp" not in name:
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                device=None, shardings: Any = None) -> Tuple[int, Any]:
        """Restore into ``template``'s structure: each leaf a tensor of the
        template leaf's dtype on ``device``, or on the template tensor's own
        device (the CPU for a leaf that is not a tensor).  ``shardings``: a
        matching tree of ``NamedSharding`` (or None leaves) over a mesh of
        one device, which holds each leaf whole; any larger mesh raises
        ``NotImplementedError``."""
        if shardings is not None:
            _check_one_device(shardings)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)

        def load(meta, like):
            arr = np.load(os.path.join(path, meta["file"]))
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if isinstance(like, torch.Tensor):
                return t.to(device=device or like.device, dtype=like.dtype)
            return t.to(device or "cpu")

        leaves = manifest["leaves"]
        return step, tree_map_with_path(
            lambda path, like: load(leaves[path], like), template)

    def close(self):
        if self._worker is not None:
            self._q.put(None)
            self._worker.join(timeout=5)
