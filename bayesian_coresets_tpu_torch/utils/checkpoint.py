"""Checkpoint / resume for solver and coreset state.

Port of ``bayesian_coresets_tpu/utils/checkpoint.py``: a NamedTuple or
tuple of tensors (or numbers), optionally with a ``torch.Generator``'s
state, round-trips through one ``.npz`` file written under a private name
and renamed into place, so a crash mid-write never leaves a torn file.
Where the JAX package stores a PRNG key, this stores the generator's state.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

_GEN = "__generator__"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    x = np.asarray(leaf)
    if x.dtype == object:
        raise TypeError(f"not an array: {type(leaf)}")
    return x


def save(path: str, tree, meta: dict | None = None,
         generator: torch.Generator | None = None) -> None:
    """Save the leaves of ``tree`` (and ``generator``'s state) to ``path``."""
    arrays = {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(tree)}
    if generator is not None:
        arrays[_GEN] = generator.get_state().numpy()
    arrays["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load(path: str, like=None, generator: torch.Generator | None = None,
         device=None):
    """Load a checkpoint; returns ``(tree, meta)``.

    With ``like`` (a NamedTuple or tuple with the same number of leaves),
    each stored leaf becomes a tensor of ``like``'s leaf dtype on its
    device, packed into ``like``'s type; otherwise a list of tensors on
    ``device`` (default: the CPU).  With ``generator``, the stored
    generator state is set into it.
    """
    with np.load(path) as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        arrays = [data[f"leaf_{i}"] for i in range(n)]
        meta = json.loads(bytes(data["__meta__"]).decode()) if "__meta__" in data.files else {}
        if generator is not None:
            if _GEN not in data.files:
                raise ValueError(f"{path} holds no generator state")
            generator.set_state(torch.from_numpy(data[_GEN].copy()))
    if like is None:
        return [torch.as_tensor(a, device=device) for a in arrays], meta
    if len(like) != n:
        raise ValueError(f"checkpoint has {n} leaves; template has {len(like)}")
    leaves = [torch.as_tensor(a, dtype=t.dtype, device=t.device) if isinstance(t, torch.Tensor)
              else torch.as_tensor(a, device=device) for a, t in zip(arrays, like)]
    return (type(like)(*leaves) if hasattr(like, "_fields") else tuple(leaves)), meta
