"""Checkpoint store with async save, in the JAX package's on-disk format.

The JAX package's ``checkpoint/store.py`` for one device: a checkpoint is a
directory holding ``arrays.npz`` (one array per leaf, ``leaf_00000`` ...,
leaves in the sorted order of their keys) and ``manifest.json`` (step, meta,
and each leaf's file, shape and dtype name), keyed by the leaf's path as
``jax.tree_util.keystr`` writes it (``['params']['blocks']['pos0']...``,
:func:`~repro_torch.models.params.leaves_with_path`).  dtypes ``np.savez``
stores natively are stored as they are; bfloat16 goes as its raw bytes
under the dtype name ``"bfloat16"``, which the port decodes itself through
a ``torch.uint16`` view (no ``ml_dtypes``).  Either package restores the
other's checkpoints bit for bit.

* **Atomicity**: writes go to ``<dir>.tmp`` then ``os.replace``, so a crash
  mid-save never corrupts the last good checkpoint.
* **Async save**: :meth:`CheckpointManager.save_async` copies the tree to
  host memory now and writes it in a background thread, so the train loop
  keeps stepping during serialisation; ``wait()`` joins before the next
  save (one outstanding snapshot).
* **Elastic restore**: :func:`restore_sharded` places the host tensors
  under the placements a ``DeviceMesh`` derives from the leaves' logical
  axes; the writing mesh's size does not matter (N -> M restarts are the
  default path, not a special case).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.params import leaves_with_path

#: dtypes np.savez can store natively; anything else goes as raw bytes
_NPZ_NATIVE = {"float64", "float32", "float16", "int64", "int32", "int16",
               "int8", "uint64", "uint32", "uint16", "uint8", "bool"}
#: dtypes stored as raw bytes: name -> (torch dtype, unsigned view of the
#: same width)
_RAW = {"bfloat16": (torch.bfloat16, torch.uint16, np.uint16)}


def _host(leaf) -> np.ndarray | torch.Tensor:
    """A copy of a leaf on the host that owns its memory: a numpy array,
    or a CPU tensor for a dtype numpy lacks.  A CPU leaf is cloned, since
    the train step updates the tree in place while the writer thread
    serialises the snapshot."""
    if isinstance(leaf, torch.Tensor):
        if hasattr(leaf, "full_tensor"):
            raise TypeError(
                "a DTensor leaf is saved whole: gather the tree first "
                "(repro_torch.distributed.elastic.gather_tree, a collective "
                "every rank joins) and save it from one rank")
        t = leaf.detach()
        t = t.clone() if t.device.type == "cpu" else t.cpu()
        if t.dtype == torch.bfloat16:
            return t
        return t.numpy()
    return np.array(leaf, copy=True)


def _dtype_name(host) -> str:
    if isinstance(host, torch.Tensor):
        return str(host.dtype).replace("torch.", "")
    return str(host.dtype)


def _snapshot(tree) -> Dict[str, Any]:
    return {key: _host(leaf) for key, leaf in leaves_with_path(tree)}


def _write(path: str, flat: Dict[str, Any], step: int,
           meta: Optional[Dict[str, Any]]) -> None:
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "meta": meta or {}, "leaves": {}}
    arrays = {}
    for i, (key, host) in enumerate(sorted(flat.items())):
        name = f"leaf_{i:05d}"
        dtype = _dtype_name(host)
        if dtype not in _NPZ_NATIVE:          # bf16: store raw bytes
            raw = host.contiguous().view(_RAW[dtype][1]).numpy()
            arrays[name] = np.frombuffer(raw.tobytes(), np.uint8)
        else:
            arrays[name] = host
        manifest["leaves"][key] = {
            "file": name, "shape": list(host.shape), "dtype": dtype}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def save_checkpoint(path: str, tree, *, step: int = 0,
                    meta: Optional[Dict[str, Any]] = None) -> None:
    """Synchronous atomic save of a nested dict of tensors or arrays."""
    _write(path, _snapshot(tree), step, meta)


def _unflatten(like, flat: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, f"{prefix}[{k!r}]")
                for k, v in like.items()}
    return flat[prefix]


def load_checkpoint(path: str, like=None):
    """Load to CPU tensors.  With ``like`` (a nested dict), returns (tree of
    its structure, manifest); otherwise (flat dict keyed by path,
    manifest)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    flat = {}
    for key, info in manifest["leaves"].items():
        arr = data[info["file"]]
        if info["dtype"] not in _NPZ_NATIVE:   # raw-byte leaves (bf16)
            dtype, _, np_unsigned = _RAW[info["dtype"]]
            bits = np.frombuffer(arr.tobytes(), np_unsigned).reshape(
                info["shape"])
            flat[key] = torch.from_numpy(bits.copy()).view(dtype)
        else:
            flat[key] = torch.from_numpy(np.array(arr))
    if like is None:
        return flat, manifest
    return _unflatten(like, flat), manifest


def restore_sharded(path: str, like, spec_tree, rules, mesh):
    """Elastic restore: (tree of DTensors on ``mesh``, manifest).

    ``spec_tree`` carries the logical axes (a ParamSpec tree of ``like``'s
    structure); each leaf is placed under
    :func:`~repro_torch.distributed.sharding.param_shardings` of ``rules`` on
    ``mesh``, each rank cutting its own block of the whole tensor it loaded.
    """
    from ..distributed.sharding import distribute_tree, param_shardings
    tree, manifest = load_checkpoint(path, like=like)
    return (distribute_tree(tree, param_shardings(spec_tree, rules, mesh),
                            mesh), manifest)


class CheckpointManager:
    """Rotating async checkpoint manager for the train loop."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save_async(self, tree, step: int,
                   meta: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot to host now, write in the background."""
        self.wait()
        flat = _snapshot(tree)

        def work():
            _write(self._step_dir(step), flat, step, meta)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(self, like, spec_tree=None, rules=None, mesh=None):
        """(tree like ``like``, manifest) of the latest checkpoint, or
        (None, None): CPU tensors, or with ``spec_tree`` and ``mesh`` the
        DTensors of :func:`restore_sharded`."""
        step = self.latest_step()
        if step is None:
            return None, None
        path = self._step_dir(step)
        if spec_tree is not None and mesh is not None:
            return restore_sharded(path, like, spec_tree, rules, mesh)
        return load_checkpoint(path, like=like)
