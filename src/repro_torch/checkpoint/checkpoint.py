"""Tree checkpointing: npz payload + JSON metadata, the on-disk format of
src/repro/checkpoint/checkpoint.py.

``ckpt_{step:08d}.npz`` holds one array ``leaf_{i}`` per tensor of the
tree (``util.tree`` order: the reference's ``jax.tree`` order), and
``ckpt_{step:08d}.json`` holds ``{step, leaves: [{key, path, dtype, shape,
spec}]}`` with the reference's key paths and ``spec`` null (the port keeps
no sharding).  A bf16 tensor is written as its raw 2-byte words (an npy
header of ``<V2``) with ``"dtype": "bfloat16"``, byte for byte what the
reference writes; ``restore`` reinterprets such bits from the JSON's dtype, so no
bf16 numpy type is needed.  Checkpoints cross between the two packages.

Over a mesh of ranks a checkpoint is still written whole (the ranks'
slices gathered by ``sharding.partition.gather``, rank 0 writing), and
``restore(..., specs=, mesh=)`` places it again: each rank keeps its
slice of every leaf by the leaf's spec.
"""
from __future__ import annotations

import json
import zipfile
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
from numpy.lib import format as npy_format

from repro_torch.util import tree

# the npy header of a bf16 leaf as numpy writes the reference's bf16 type:
# 2-byte words, little-endian
_BF16_DESCR = "<V2"


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _savez(path: str, payload: dict) -> None:
    """``np.savez``'s archive (stored, zip64 members ``{key}.npy``), with
    each bf16 leaf's header naming the reference's ``<V2``."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, dtype) in payload.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if dtype == "bfloat16":
                    npy_format.write_array_header_1_0(
                        f, {"descr": _BF16_DESCR, "fortran_order": False,
                            "shape": arr.shape})
                    f.write(np.ascontiguousarray(arr).tobytes())
                else:
                    npy_format.write_array(f, arr)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(directory: str | Path, tree_: Any, step: int = 0) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    payload, meta = {}, {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(tree.leaves_with_paths(tree_)):
        arr, dtype = _to_numpy(torch.as_tensor(leaf))
        key = f"leaf_{i}"
        payload[key] = (arr, dtype)
        meta["leaves"].append({"key": key, "path": tree.path_str(path),
                               "dtype": dtype, "shape": list(arr.shape),
                               "spec": None})
    out = directory / f"ckpt_{step:08d}"
    _savez(str(out) + ".npz", payload)
    (directory / f"ckpt_{step:08d}.json").write_text(json.dumps(meta))
    return out


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    steps = sorted(int(p.stem.split("_")[1])
                   for p in directory.glob("ckpt_*.json"))
    return steps[-1] if steps else None


def restore(directory: str | Path, tree_like: Any,
            step: Optional[int] = None, specs: Any = None,
            mesh=None) -> Any:
    """Restore into the structure of ``tree_like`` (shapes must match):
    each leaf in its ``tree_like`` leaf's dtype, on that leaf's device.
    With ``specs`` (a tree of specs in ``tree_like``'s structure) and
    ``mesh``: ``tree_like`` holds this rank's slices, and each whole leaf
    read is cut to this rank's slice by its spec before it moves."""
    from repro_torch.sharding import partition
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    meta = json.loads((directory / f"ckpt_{step:08d}.json").read_text())
    by_path = {m["path"]: m for m in meta["leaves"]}
    new_leaves = []
    with np.load(directory / f"ckpt_{step:08d}.npz") as data:
        for path, leaf in tree.leaves_with_paths(tree_like):
            m = by_path[tree.path_str(path)]
            arr = data[m["key"]]
            spec = None if specs is None else partition.spec_at(specs, path)
            shape = list(arr.shape) if spec is None else \
                list(partition.local_shape(arr.shape, spec, mesh))
            if shape != list(leaf.shape):
                raise ValueError(f"shape mismatch at {m['path']}: "
                                 f"{tuple(shape)} vs {tuple(leaf.shape)}")
            t = _from_numpy(arr, m["dtype"])
            if spec is not None:
                t = partition.local_slice(t, spec, mesh).clone()
            new_leaves.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return tree.unflatten(tree_like, new_leaves)
