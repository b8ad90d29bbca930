"""Atomic checkpoints of parameter and optimizer trees.

The port of ``repro.train.checkpoint``, writing and reading the same
on-disk layout, so a checkpoint of either package restores in the other::

    <dir>/step_000123/
        manifest.json        # step, leaf paths, shapes, dtypes, extra
        shard_00000.npz      # flat {leaf_path: array} chunks
        ...
    <dir>/LATEST             # atomic pointer (rename-into-place)

Leaf paths are ``"/"``-joined keys (``"params/layers/attn/wq"``).  A
bfloat16 leaf, which numpy cannot hold, is stored as its ``uint16`` bit
pattern (``u2``) with ``"bfloat16"`` as its dtype in the manifest, as the
reference stores it through ``ml_dtypes``; here the bits go through
torch's own int16 view, with no ``ml_dtypes``.

Guarantees, as in the reference: *atomic* — a checkpoint directory is
staged under a temporary name and renamed into place, and ``LATEST`` is
updated last, so a crash mid-save leaves the previous checkpoint valid;
*monotone* — ``LATEST`` only advances; *elastic* — a restore needs only
the manifest and the tree to fill.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util

PyTree = Any

_SHARD_BYTES = 512 << 20


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(host array as stored, true dtype name) of one leaf; bfloat16,
    which numpy has no type for, is stored as its uint16 bits."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        bits = t.contiguous().view(torch.int16).cpu().numpy()
        return bits.view(np.uint16), "bfloat16"
    arr = t.cpu().numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, true_dtype: str) -> torch.Tensor:
    """The host tensor of a stored array (sharing its memory)."""
    if true_dtype == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(directory, step: int, tree: PyTree,
         extra: Optional[Dict[str, Any]] = None) -> Path:
    """Write ``tree`` as ``<directory>/step_<step>`` and point ``LATEST``
    at it.  Idempotent: an existing step directory is left as it is."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:09d}"
    if final.exists():
        return final
    stage = Path(tempfile.mkdtemp(dir=directory, prefix=".stage_"))
    manifest = {"step": step, "leaves": {}, "shards": [],
                "extra": extra or {}}
    shard: Dict[str, np.ndarray] = {}
    shard_bytes = 0
    shard_id = 0

    def flush():
        nonlocal shard, shard_bytes, shard_id
        if not shard:
            return
        name = f"shard_{shard_id:05d}.npz"
        np.savez(stage / name, **shard)
        manifest["shards"].append(name)
        shard, shard_bytes = {}, 0
        shard_id += 1

    for key, leaf in sorted(tree_util.paths(tree), key=lambda kv: kv[0]):
        arr, true_dtype = _to_numpy(leaf)
        manifest["leaves"][key] = {"shard": shard_id, "dtype": true_dtype,
                                   "shape": list(arr.shape)}
        shard[key] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= _SHARD_BYTES:
            flush()
    flush()
    (stage / "manifest.json").write_text(json.dumps(manifest))
    os.replace(stage, final)                       # atomic publish
    tmp_latest = directory / ".LATEST.tmp"
    tmp_latest.write_text(final.name)
    os.replace(tmp_latest, directory / "LATEST")   # atomic pointer bump
    return final


def latest_step(directory) -> Optional[int]:
    pointer = Path(directory) / "LATEST"
    if not pointer.exists():
        return None
    name = pointer.read_text().strip()
    if not (Path(directory) / name / "manifest.json").exists():
        return None
    return int(name.split("_")[-1])


def restore(directory, like: PyTree, step: Optional[int] = None
            ) -> Tuple[int, PyTree, Dict[str, Any]]:
    """Restore into the structure of ``like`` (tensors): each leaf takes
    its ``like`` leaf's dtype and device.  Returns
    ``(step, tree, extra)``; the latest step unless ``step`` is given.
    Raises ``KeyError`` for a missing leaf and ``ValueError`` for a
    shape that differs."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    ckpt = directory / f"step_{step:09d}"
    manifest = json.loads((ckpt / "manifest.json").read_text())
    arrays: Dict[str, np.ndarray] = {}
    for name in manifest["shards"]:
        with np.load(ckpt / name) as z:
            for k in z.files:
                arrays[k] = z[k]
    out = []
    for key, ref in tree_util.paths(like):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        want_shape = tuple(ref.shape)
        if tuple(arr.shape) != want_shape:
            raise ValueError(f"{key}: shape {arr.shape} != {want_shape}")
        t = _from_numpy(arr, manifest["leaves"][key]["dtype"])
        out.append(t.to(device=ref.device, dtype=ref.dtype))
    return step, tree_util.unflatten(like, out), manifest.get("extra", {})


def prune(directory, keep: int = 3) -> None:
    """Keep the newest ``keep`` checkpoints (never the LATEST target)."""
    directory = Path(directory)
    latest = latest_step(directory)
    steps = sorted(int(p.name.split("_")[-1])
                   for p in directory.glob("step_*") if p.is_dir())
    for s in steps[:-keep] if len(steps) > keep else []:
        if s != latest:
            shutil.rmtree(directory / f"step_{s:09d}", ignore_errors=True)
