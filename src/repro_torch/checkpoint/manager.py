"""Checkpoint manager: atomic, async, keep-K, restart-friendly.

Counterpart of ``repro/checkpoint/manager.py``, on the same disk
format, so each package reads the other's snapshots:

    <dir>/step_000000123/        (atomic: written as .tmp_, then renamed)
        manifest.json            leaf names + shapes + dtypes + extras
        arr_00000.npy ...        one .npy per tree leaf

Leaves are numbered in ``jax.tree_util`` flatten order
(``repro_torch.tree``) and named as ``jax.tree_util.keystr`` names them
(``['shard000']['p']``).  A bfloat16 tensor, which numpy has no dtype
for, is written as 2-byte void (its bits; ``.npy`` descr ``V2``) with
``"dtype": "bfloat16"`` in the manifest — what the reference writes
through ``ml_dtypes``.  On read the manifest's dtype decides: a ``V2``
array whose entry says ``bfloat16`` is viewed back as
``torch.bfloat16``.  (The reference itself cannot restore such a leaf:
``jnp.asarray`` refuses a ``|V2`` array.)

Guarantees:
  * atomicity — a crash mid-save never corrupts the latest checkpoint
    (readers only see fully-renamed directories); leftover ``.tmp_``
    directories are removed on construction and ``steps()`` skips torn
    snapshots.  A save at a step already committed sets the old
    directory aside (``.old_``) and drops it only after the new one is
    renamed in place, so a crash between the two renames leaves the
    old snapshot to restore (``steps()`` counts it; construction
    renames it back),
  * async — ``save`` copies the leaves to the host and returns; a
    writer thread serializes them; a failed async write re-raises on
    the NEXT ``save()``/``wait()`` (synchronous saves raise at the call
    site),
  * keep-K garbage collection.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util

#: torch dtypes by the name the manifest gives them (numpy's names)
_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                 "float32": torch.float32, "float64": torch.float64,
                 "int8": torch.int8, "int16": torch.int16,
                 "int32": torch.int32, "int64": torch.int64,
                 "uint8": torch.uint8, "bool": torch.bool}
#: suffix of a committed step directory set aside while a save at the
#: same step commits
_ASIDE = ".old_"


def _keystr_walk(node, path: str, out: List[Tuple[str, Any]]) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _keystr_walk(node[k], f"{path}[{k!r}]", out)
    elif tree_util.is_namedtuple(node):
        for name, x in zip(node._fields, node):
            _keystr_walk(x, f"{path}.{name}", out)
    elif isinstance(node, (list, tuple)):
        for i, x in enumerate(node):
            _keystr_walk(x, f"{path}[{i}]", out)
    else:
        out.append((path, node))


def keystr_names(tree: Any) -> List[Tuple[str, Any]]:
    """``(name, leaf)`` in flatten order, each name as
    ``jax.tree_util.keystr`` gives it: ``['key']`` per dict level,
    ``.field`` per ``NamedTuple`` level, ``[i]`` per list or tuple
    level.  (A module-level walk: a recursive
    closure would hold the leaves in a reference cycle.)"""
    out: List[Tuple[str, Any]] = []
    _keystr_walk(tree, "", out)
    return out


def to_host(leaf) -> Tuple[np.ndarray, str]:
    """``(array, manifest dtype name)`` of one leaf on the host.  A
    bfloat16 tensor becomes its bits as 2-byte void."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """The CPU tensor a stored array stands for, by the manifest's
    dtype."""
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"bfloat16 leaf stored as {arr.dtype}")
        return torch.from_numpy(np.require(arr, requirements="C")
                                .view(np.int16)).view(torch.bfloat16)
    want = _TORCH_DTYPES.get(dtype)
    t = torch.from_numpy(np.require(arr, requirements="C"))
    if want is not None and t.dtype != want:
        raise ValueError(f"leaf stored as {arr.dtype}, manifest says "
                         f"{dtype}")
    return t


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True, on_write=None, tidy: bool = True):
        """``tidy``: drop or roll back what a crash mid-save left
        (``_gc_tmp``).  Where several processes open one directory, one
        tidies while the others wait and open it with ``tidy=False``
        (``launch.mesh.open_checkpoints``)."""
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        #: ``on_write(step, t0, nbytes)`` after each committed write
        #: (``t0``: ``time.perf_counter()`` when the write began)
        self.on_write = on_write
        os.makedirs(directory, exist_ok=True)
        if tidy:
            self._gc_tmp()

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree: Any,
             extras: Optional[Dict[str, Any]] = None) -> None:
        """Copy every leaf to the host now (on the calling thread, after
        the work that produced it on the device's stream), then write.
        """
        host = [(name,) + to_host(leaf) for name, leaf in keystr_names(tree)]
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_async, args=(step, host, extras or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, extras or {})

    def wait(self) -> None:
        """Block until the in-flight save lands (and re-raise its error)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def write(self, step: int, host, extras: Dict[str, Any]) -> None:
        """Write checkpoint ``step`` now from an iterable of ``(name, host
        array, manifest dtype)`` in flatten order (``to_host``), each
        written as it comes: a caller that makes the leaves one at a
        time holds one on the host."""
        self.wait()
        self._write(step, host, extras)

    def _write_async(self, step: int, host, extras: Dict[str, Any]) -> None:
        try:
            self._write(step, host, extras)
        except BaseException as e:
            self._error = e

    def _write(self, step: int, host, extras: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        final = self._step_dir(step)
        tmp = final + ".tmp_"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extras": extras, "leaves": []}
        nbytes = 0
        for i, (name, arr, dtype) in enumerate(host):
            fname = f"arr_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            nbytes += arr.nbytes
            manifest["leaves"].append(
                {"name": name, "file": fname,
                 "shape": list(arr.shape), "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        aside = None
        if os.path.exists(final):
            # the committed snapshot of this step stays restorable until
            # the new one is in place
            aside = final + _ASIDE
            if os.path.exists(aside):
                shutil.rmtree(aside)
            os.rename(final, aside)
        os.rename(tmp, final)          # the atomic commit point
        if aside is not None:
            shutil.rmtree(aside)
        self._gc()
        if self.on_write is not None:
            self.on_write(step, t0, nbytes)

    # -------------------------------------------------------------- restore
    def steps(self) -> List[int]:
        out = set()
        for d in os.listdir(self.directory):
            if not d.startswith("step_") or d.endswith(".tmp_"):
                continue
            name = d[:-len(_ASIDE)] if d.endswith(_ASIDE) else d
            if name != d and os.path.exists(os.path.join(self.directory,
                                                         name)):
                continue  # set aside, and its successor is committed
            if not os.path.exists(os.path.join(self.directory, d,
                                               "manifest.json")):
                continue  # torn: a restore must never pick it
            try:
                out.add(int(name[5:]))
            except ValueError:
                pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def peek_extras(self, step: int) -> Dict[str, Any]:
        """One snapshot's extras WITHOUT loading its arrays."""
        with open(os.path.join(self._step_dir(step),
                               "manifest.json")) as f:
            return json.load(f)["extras"]

    def leaves(self, step: int, like: Any) -> Iterator[torch.Tensor]:
        """The CPU tensor of each leaf of ``like`` in flatten order, in
        the manifest's dtype, read one at a time (names must match,
        shapes must equal ``like``'s)."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_name = {entry["name"]: entry for entry in manifest["leaves"]}
        for name, ref_leaf in keystr_names(like):
            entry = by_name.get(name)
            if entry is None:
                raise KeyError(f"checkpoint {step} missing leaf {name}")
            arr = np.load(os.path.join(d, entry["file"]))
            if list(arr.shape) != list(ref_leaf.shape):
                raise ValueError(
                    f"{name}: checkpoint shape {arr.shape} != "
                    f"expected {tuple(ref_leaf.shape)}")
            yield from_host(arr, entry["dtype"])

    def restore(self, step: int, like: Any) -> Tuple[Any, Dict[str, Any]]:
        """Restore into the structure of ``like`` (names must match):
        CPU tensors in the manifest's dtypes, and the extras."""
        _, treedef = tree_util.flatten(like)
        leaves = list(self.leaves(step, like))
        return tree_util.unflatten(treedef, leaves), self.peek_extras(step)

    def restore_latest(self, like: Any
                       ) -> Optional[Tuple[int, Any, Dict[str, Any]]]:
        step = self.latest_step()
        if step is None:
            return None
        tree, extras = self.restore(step, like)
        return step, tree, extras

    # ------------------------------------------------------------------ gc
    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def _gc_tmp(self) -> None:
        """Drop ``.tmp_`` directories a crash mid-save left behind: torn
        by construction (the rename never happened).  An ``.old_``
        directory is renamed back where its successor never committed,
        and dropped where it did."""
        for d in os.listdir(self.directory):
            path = os.path.join(self.directory, d)
            if not d.startswith("step_"):
                continue
            if d.endswith(".tmp_"):
                shutil.rmtree(path, ignore_errors=True)
            elif d.endswith(_ASIDE):
                final = path[:-len(_ASIDE)]
                if os.path.exists(final):
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    os.rename(path, final)

    def _step_dir(self, step: int) -> str:
        """The step's directory (its set-aside one while a save at the
        same step is between its two renames)."""
        final = os.path.join(self.directory, f"step_{step:09d}")
        if not os.path.exists(final) and os.path.exists(final + _ASIDE):
            return final + _ASIDE
        return final
