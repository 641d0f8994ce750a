"""Crash forensics: input snapshots on numerical failures (port of
gs2mesh_tpu utils/debug.py).

Parity with the reference rasterizer's debug mode, which deep-copies kernel
inputs and dumps snapshot_fw/bw.dump on CUDA errors
(diff_gaussian_rasterization/__init__.py:83-90,132-139). The check is
host-driven: validate outputs and dump the inputs when something is
non-finite. Trees are tensors, numpy arrays and scalars inside tuples,
lists, NamedTuples, dicts and dataclasses; paths are written as
``jax.tree_util.keystr`` writes them (``['key']``, ``[0]``, ``.field``;
dict keys in sorted order, None an empty subtree).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _dict_keys(d: dict):
    try:
        return sorted(d)
    except TypeError:
        return list(d)


def _leaves_with_path(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in _dict_keys(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif _is_namedtuple(tree):
        for k in tree._fields:
            yield from _leaves_with_path(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves_with_path(getattr(tree, f.name),
                                         f"{path}.{f.name}")
    else:
        yield path, tree


def _tree_map(fn: Callable, tree: Any) -> Any:
    """fn on every leaf, the structure kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return fn(tree)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_finite_tree(tree: Any, name: str = "value") -> list:
    """Returns a list of paths with non-finite leaves (empty = clean)."""
    bad = []
    for path, leaf in _leaves_with_path(tree):
        arr = _host(leaf)
        if (np.issubdtype(arr.dtype, np.floating)
                and not np.isfinite(arr).all()):
            bad.append(f"{name}{path}")
    return bad


def debug_dump(inputs: Any, outputs: Any, dump_dir: str = ".",
               tag: str = "fw") -> str:
    """Write a snapshot_{tag}.dump with host numpy copies of inputs and
    outputs (the reference's snapshot_fw/bw.dump contract)."""
    path = os.path.join(dump_dir, f"snapshot_{tag}.dump")
    payload = {
        "time": time.time(),
        "inputs": _tree_map(_host, inputs),
        "outputs": _tree_map(_host, outputs),
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    print(f"[debug] wrote {path}")
    return path


def guard_render(inputs: Any, outputs: Any, dump_dir: str = ".",
                 tag: str = "fw") -> None:
    """Dump + raise when render outputs go non-finite (debug-mode hook)."""
    bad = check_finite_tree(outputs, "output")
    if bad:
        debug_dump(inputs, outputs, dump_dir, tag)
        raise FloatingPointError(
            f"non-finite render outputs: {bad}; snapshot written")
