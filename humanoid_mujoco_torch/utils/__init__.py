"""Host utilities: a map over tensor trees, and profiling
(utils/profiling.py)."""

import dataclasses

import torch

from .profiling import StageTimers, trace_to


def tree_map(fn, tree):
    """`tree` with fn applied to each tensor leaf: through dataclasses
    (their init fields), dicts, tuples and lists; other leaves as they
    are. A dataclass none of whose fields changed comes back itself (a
    model's Structure keeps its identity)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        new = {f.name: tree_map(fn, getattr(tree, f.name))
               for f in dataclasses.fields(tree) if f.init}
        if all(v is getattr(tree, k) for k, v in new.items()):
            return tree
        return dataclasses.replace(tree, **new)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return tree


__all__ = ["StageTimers", "trace_to", "tree_map"]
