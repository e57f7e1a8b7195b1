"""Iterate checkpoint/resume.

The reference has NO checkpointing (SURVEY.md §5: solver state is never
serialized); this framework adds it — the full IPM state is 12 space
vectors plus a few scalars, so checkpoints are cheap and a preempted
long solve resumes exactly.

Format: single .npz with flattened leaves + a structure descriptor.
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from pips_ipmpp_tpu.core.spaces import RVec, XVec
from pips_ipmpp_tpu.ipm.formulation import Iterate

_CKPT_VERSION = 1


def _flatten_iterate(it: Iterate):
    leaves = []
    spec = []
    for name in ("x", "s", "y", "z", "v", "w", "t", "u",
                 "gamma", "phi", "lam", "pi"):
        val = getattr(it, name)
        if isinstance(val, XVec):
            spec.append((name, "XVec"))
            leaves += [val.first, val.blocks]
        elif isinstance(val, RVec):
            spec.append((name, "RVec"))
            leaves += [val.first, val.blocks, val.link]
        else:
            spec.append((name, "array"))
            leaves.append(val)
    return leaves, spec


def save_checkpoint(path: str, it: Iterate, iteration: int,
                    delta_p: float, delta_d: float,
                    extra: dict | None = None) -> None:
    leaves, spec = _flatten_iterate(it)
    arrays = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    meta = dict(version=_CKPT_VERSION, spec=spec, iteration=iteration,
                delta_p=float(delta_p), delta_d=float(delta_d),
                extra=extra or {})
    tmp = path + ".tmp.npz"
    np.savez(tmp, meta=json.dumps(meta), **arrays)
    os.replace(tmp, path)   # atomic swap


def load_checkpoint(path: str, dtype=None):
    """Returns (iterate, iteration, delta_p, delta_d, extra)."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    if meta["version"] > _CKPT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta['version']}")
    leaves = [data[f"leaf_{i}"] for i in range(len([
        k for k in data.files if k.startswith("leaf_")]))]
    if dtype is not None:
        leaves = [jnp.asarray(l, dtype) for l in leaves]
    else:
        leaves = [jnp.asarray(l) for l in leaves]
    fields = {}
    pos = 0
    for name, kind in meta["spec"]:
        if kind == "XVec":
            fields[name] = XVec(leaves[pos], leaves[pos + 1])
            pos += 2
        elif kind == "RVec":
            fields[name] = RVec(leaves[pos], leaves[pos + 1], leaves[pos + 2])
            pos += 3
        else:
            fields[name] = leaves[pos]
            pos += 1
    it = Iterate(**fields)
    return it, meta["iteration"], meta["delta_p"], meta["delta_d"], \
        meta["extra"]
