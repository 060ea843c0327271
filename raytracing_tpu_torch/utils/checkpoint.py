"""Checkpoints of an inverse fit (twin of `raytracing_tpu.utils.checkpoint`).

`save` writes the parameters, the optimizer's state (a
`torch.optim.Optimizer.state_dict()`) and the step to one `.npz`: every
tensor or array as one entry, and the nesting of dicts, lists and tuples
with the plain values (numbers, strings, None) as a JSON manifest beside
them. `load` restores the same structure bit for bit and raises when a
stored entry's shape differs from the one it is asked to fill.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch


def _encode(tree, arrays: dict):
    """The JSON form of `tree`; each tensor or array goes into `arrays` and
    is named in its place."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        name = f"leaf_{len(arrays)}"
        is_torch = isinstance(tree, torch.Tensor)
        arrays[name] = tree.detach().cpu().numpy() if is_torch else tree
        return {"leaf": name, "torch": is_torch}
    if isinstance(tree, dict):
        return {"dict": [[k, _encode(v, arrays)] for k, v in tree.items()]}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_encode(v, arrays) for v in tree]}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"value": tree}
    raise TypeError(f"checkpoint: cannot store a {type(tree).__name__}")


def _decode(node, arrays, like, where: str):
    """Rebuild the tree of `node`; tensors land on the device of the tensor
    at the same place in `like` (else the CPU), with its shape checked."""
    if "leaf" in node:
        a = arrays[node["leaf"]]
        if like is not None and hasattr(like, "shape") and \
                tuple(a.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint entry {where}: shape "
                             f"{tuple(a.shape)} != expected "
                             f"{tuple(like.shape)}")
        if not node["torch"]:
            return a
        dev = like.device if isinstance(like, torch.Tensor) else "cpu"
        return torch.from_numpy(a).to(dev)
    if "dict" in node:
        out = {}
        for k, v in node["dict"]:
            sub = like.get(k) if isinstance(like, dict) else None
            out[k] = _decode(v, arrays, sub, f"{where}[{k!r}]")
        return out
    for kind in ("list", "tuple"):
        if kind in node:
            items = [_decode(v, arrays,
                             like[i] if isinstance(like, (list, tuple))
                             and i < len(like) else None, f"{where}[{i}]")
                     for i, v in enumerate(node[kind])]
            return items if kind == "list" else tuple(items)
    return node["value"]


def save(path: str, params: Any, opt_state: Any = None, step: int = 0,
         metadata: Optional[dict] = None) -> None:
    """Write (params, opt_state, step, metadata) to `path` (.npz); the file
    is replaced only once it is whole."""
    arrays: dict = {}
    manifest = {"tree": _encode({"params": params, "opt_state": opt_state},
                                arrays),
                "step": int(step), "metadata": metadata or {}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"  # np.savez keeps a .npz suffix
    np.savez(tmp, __manifest__=json.dumps(manifest), **arrays)
    os.replace(tmp, path)


def load(path: str, like_params: Any, like_opt_state: Any = None
         ) -> Tuple[Any, Any, int, dict]:
    """(params, opt_state, step, metadata) from `path`. like_params /
    like_opt_state: what they must fill — each stored tensor must have the
    shape of its counterpart there (else ValueError), and lands on its
    device."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["__manifest__"]))
        arrays = {k: z[k] for k in z.files if k != "__manifest__"}
    tree = _decode(manifest["tree"], arrays,
                   {"params": like_params, "opt_state": like_opt_state}, "")
    return (tree["params"], tree["opt_state"], manifest["step"],
            manifest["metadata"])
