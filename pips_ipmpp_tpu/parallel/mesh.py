"""Device mesh + sharding specs for the arrowhead structure.

The reference's single distribution axis is blocks->MPI-ranks
(DistributedTree::assignProcesses, Core/Readers/Distributed/
DistributedTree.C:35-90) with first-stage/linking data replicated on every
rank.  Equivalent here: a 1-D `jax.sharding.Mesh` over an axis named
"blocks"; per-block batched arrays are sharded on their leading axis,
first-stage/linking arrays are replicated, and the Schur-complement
reduction rides device collectives (NVLink, all to all, between the GPUs
of one host), inserted by GSPMD under jit or written explicitly as psum
under shard_map — both supported, see dist_solver.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pips_ipmpp_tpu.core.lp import ArrowheadLP
from pips_ipmpp_tpu.core.spaces import RVec, XVec

BLOCK_AXIS = "blocks"

# per-block (leading batch axis) fields of ArrowheadLP /
# SparseArrowheadLP (whose B/D/Bt/Dt are Ell pytrees with batched leaves)
_BLOCK_FIELDS = frozenset({
    "cN", "A", "B", "bN", "C", "D", "iclowN", "clowN", "icuppN", "cuppN",
    "ixlowN", "xlowN", "ixuppN", "xuppN", "F", "G", "Bt", "Dt",
})


def make_mesh(n_devices: Optional[int] = None, axis: str = BLOCK_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devs)} devices are available (a silently smaller "
                f"mesh would invalidate scaling comparisons)")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def lp_pspecs(lp: ArrowheadLP, axis: str = BLOCK_AXIS):
    """PartitionSpec pytree matching the LP: block axis sharded.

    Fields may themselves be pytrees (the sparse LP's Ell storage):
    every leaf of a block field shards its leading (batch) axis."""
    specs = {}
    for f in dataclasses.fields(lp):
        v = getattr(lp, f.name)
        sharded = f.name in _BLOCK_FIELDS
        specs[f.name] = jax.tree.map(
            lambda l: (P(axis, *([None] * (np.ndim(l) - 1))) if sharded
                       else P(*([None] * np.ndim(l)))), v)
    return type(lp)(**specs)


def space_pspec(template, axis: str = BLOCK_AXIS):
    """PartitionSpec pytree for any pytree whose leaves are XVec/RVec or
    replicated arrays: .blocks sharded, .first/.link replicated."""
    def leaf_spec(leaf):
        if isinstance(leaf, XVec):
            return XVec(P(*([None] * leaf.first.ndim)),
                        P(axis, *([None] * (leaf.blocks.ndim - 1))))
        if isinstance(leaf, RVec):
            return RVec(P(*([None] * leaf.first.ndim)),
                        P(axis, *([None] * (leaf.blocks.ndim - 1))),
                        P(*([None] * leaf.link.ndim)))
        return P(*([None] * np.ndim(leaf)))

    return jax.tree.map(leaf_spec, template,
                        is_leaf=lambda x: isinstance(x, (XVec, RVec)))


def shard_arrowhead_lp(lp: ArrowheadLP, mesh: Mesh,
                       axis: str = BLOCK_AXIS) -> ArrowheadLP:
    """Place an ArrowheadLP on the mesh: block batch sharded, rest
    replicated. N must be divisible by the mesh size (pad with
    core.lp.pad_num_blocks / dummy blocks first — the analog of the
    reference's kStochDummy nodes)."""
    nd = mesh.devices.size
    if lp.N % nd != 0:
        raise ValueError(
            f"N={lp.N} blocks not divisible by {nd} devices; "
            "use pips_ipmpp_tpu.core.lp.pad_num_blocks first")
    specs = lp_pspecs(lp, axis)
    return jax.tree.map(
        lambda v, s: jax.device_put(v, NamedSharding(mesh, s)), lp, specs)
