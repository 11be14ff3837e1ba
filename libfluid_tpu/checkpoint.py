"""Checkpoint / resume for simulation state pytrees.

The reference has no simulation checkpointing; its nearest analogues are the
Maya ``grid_node`` per-frame particle cache (``grid_node.cpp:350-366``) and the
points.txt / mesh.obj export-import round trip (``point_cloud.h:15-37``,
``mesh.h:56-99``). For an accelerator framework, restart-from-checkpoint is the failure
-recovery story (SURVEY.md §5), so this module checkpoints the *complete* state
pytree — particles, grid, sources, RNG key, sim time — not just positions.

Design: dependency-free ``.npz`` snapshots. Every leaf is addressed by its
pytree key-path, so any NamedTuple nesting (SimState -> MacGrid/SourceSet)
round-trips without bespoke code, and adding fields stays backward compatible
(missing keys fall back to the template's value). Restore is sharding-aware:
pass ``sharding=`` (a pytree prefix or a single NamedSharding) and leaves are
``jax.device_put`` onto the mesh during load — no host-side repiicate-then-
-reshard step.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional

import numpy as np
import jax

FORMAT_VERSION = 1
_MANIFEST = "__manifest__"


def _leaf_key(path) -> str:
    parts = []
    for p in path:
        if isinstance(p, jax.tree_util.GetAttrKey):
            parts.append(p.name)
        elif isinstance(p, jax.tree_util.SequenceKey):
            parts.append(str(p.idx))
        elif isinstance(p, jax.tree_util.DictKey):
            parts.append(str(p.key))
        else:
            parts.append(str(p))
    return ".".join(parts) or "_root"


def save(path: str, state: Any, metadata: Optional[dict] = None) -> None:
    """Write `state` (any pytree of arrays) to `path` (.npz), atomically."""
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    arrays = {}
    for kp, leaf in leaves:
        arrays[_leaf_key(kp)] = np.asarray(jax.device_get(leaf))
    manifest = {
        "version": FORMAT_VERSION,
        "keys": sorted(arrays.keys()),
        "metadata": metadata or {},
    }
    arrays[_MANIFEST] = np.frombuffer(
        json.dumps(manifest).encode("utf-8"), dtype=np.uint8
    )
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def metadata(path: str) -> dict:
    """Read just the metadata dict of a checkpoint."""
    with np.load(path) as data:
        manifest = json.loads(bytes(data[_MANIFEST]).decode("utf-8"))
    return manifest.get("metadata", {})


def restore(path: str, like: Any, sharding: Any = None, strict: bool = True) -> Any:
    """Load a checkpoint into the structure of `like` (a template pytree,
    e.g. ``new_state(cfg, key)``). Leaves present in the file replace the
    template's; with ``strict=False`` missing leaves keep the template value
    (forward compatibility when fields are added). dtypes/shapes must match
    the template — capacity changes are a re-seeding problem, not a load
    problem. `sharding` may be None, a single sharding applied to every leaf,
    or a matching pytree of shardings."""
    with np.load(path) as data:
        manifest = json.loads(bytes(data[_MANIFEST]).decode("utf-8"))
        if manifest["version"] > FORMAT_VERSION:
            raise ValueError(
                f"checkpoint version {manifest['version']} is newer than "
                f"supported {FORMAT_VERSION}"
            )
        stored = {k: data[k] for k in manifest["keys"]}

    leaves, treedef = jax.tree_util.tree_flatten_with_path(like)
    shard_leaves: list
    if sharding is None or not isinstance(
        sharding, (list, tuple, dict)
    ) and not hasattr(sharding, "tree_flatten"):
        shard_leaves = [sharding] * len(leaves)
    else:
        shard_leaves = jax.tree_util.tree_leaves(
            sharding, is_leaf=lambda x: x is None
        )
        if len(shard_leaves) != len(leaves):
            raise ValueError("sharding pytree does not match the template")

    out = []
    used = set()
    for (kp, tmpl), shard in zip(leaves, shard_leaves):
        key = _leaf_key(kp)
        if key in stored:
            arr = stored[key]
            used.add(key)
            t = np.asarray(jax.device_get(tmpl)) if not hasattr(tmpl, "shape") else tmpl
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(
                    f"checkpoint leaf {key!r} has shape {arr.shape}, "
                    f"template expects {tuple(t.shape)}"
                )
            val = arr.astype(t.dtype) if arr.dtype != t.dtype else arr
        elif strict:
            raise KeyError(f"checkpoint is missing leaf {key!r}")
        else:
            val = tmpl
        out.append(jax.device_put(val, shard) if shard is not None else val)

    extra = set(stored) - used
    if extra and strict:
        raise KeyError(f"checkpoint has unknown leaves: {sorted(extra)}")
    return jax.tree_util.tree_unflatten(treedef, out)
