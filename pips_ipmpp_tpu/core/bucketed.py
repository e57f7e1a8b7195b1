"""Bucketed arrowhead LP: heterogeneous block sizes without global padding.

The reference handles heterogeneous scenario blocks natively (each tree
node carries its own sparse matrices, DistributedMatrix.h:44-48).  The
batched layout of core/lp.py pads every block to the global maximum
shape — O(N * max^2) waste when block sizes vary widely.  Bucketing keeps
the batching: blocks are grouped into a few SIZE BUCKETS, each bucket
padded only to its own maximum and batched separately; all
buckets share one first stage and one set of linking rows, and their Schur
contributions are summed before a single root factorization
(linalg/bucket_backend.py).

Space vectors over a bucketed LP carry `blocks` as a TUPLE of per-bucket
arrays (XVec/RVec are pytrees, so all fused elementwise IPM ops and the
leaf-generic reductions in core/spaces.py work unchanged).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np

from pips_ipmpp_tpu.core.lp import ArrowheadLP, make_arrowhead_lp


@dataclasses.dataclass
class BucketedArrowheadLP:
    """A tuple of per-bucket ArrowheadLPs sharing identical first-stage and
    linking data, plus the block->(bucket, position) placement map."""
    buckets: tuple          # tuple[ArrowheadLP, ...]
    placement: tuple        # tuple[(bucket, pos), ...] per original block

    @property
    def n0(self) -> int:
        return self.buckets[0].n0

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def N(self) -> int:
        return len(self.placement)

    def total_vars(self) -> int:
        return self.n0 + sum(b.N * b.n for b in self.buckets)

    def astype(self, dtype) -> "BucketedArrowheadLP":
        return BucketedArrowheadLP(
            tuple(b.astype(dtype) for b in self.buckets), self.placement)


jax.tree_util.register_pytree_node(
    BucketedArrowheadLP,
    lambda lp: ((lp.buckets,), lp.placement),
    lambda placement, children: BucketedArrowheadLP(children[0], placement))


def bucket_blocks(shapes: list, quantum: int = 64) -> list:
    """Group block shapes (n, mE, mI) into buckets: shapes are quantized
    up to multiples of `quantum` (64: a tile-friendly edge chosen on the
    earlier accelerator, unmeasured on the GPU) and grouped by the
    quantized triple — padding waste is bounded by the quantum while the
    number of distinct compiled batch shapes stays small.  Returns the
    bucket key per block."""
    keys = []
    for (n, mE, mI) in shapes:
        q = lambda v: max(((int(v) + quantum - 1) // quantum) * quantum, 1)
        keys.append((q(n), q(mE), q(mI)))
    return keys


def make_bucketed_arrowhead_lp(blocks: list, first_stage: dict,
                               linking_eq: Optional[dict] = None,
                               linking_ineq: Optional[dict] = None,
                               dtype=None, quantum: int = 64,
                               ) -> BucketedArrowheadLP:
    """Build a BucketedArrowheadLP from the same per-block dicts as
    `make_arrowhead_lp` (core/lp.py), grouping blocks into size buckets
    instead of padding everything to the global max.

    Padding inside each bucket (and exact-equivalence padded rows/vars)
    is inherited from make_arrowhead_lp.  `quantum` controls the bucket
    granularity: larger => fewer buckets, more padding.
    """
    import jax.numpy as jnp
    if dtype is None:
        dtype = jnp.float64

    shapes = [(len(b["c"]), np.asarray(b["b"]).shape[0],
               np.asarray(b["clow"]).shape[0]) for b in blocks]
    keys = bucket_blocks(shapes, quantum)
    order = sorted(set(keys))
    bucket_of = {k: i for i, k in enumerate(order)}

    members: list[list[int]] = [[] for _ in order]
    for i, k in enumerate(keys):
        members[bucket_of[k]].append(i)

    placement = [None] * len(blocks)
    subs = []
    for bi, idxs in enumerate(members):
        for pos, i in enumerate(idxs):
            placement[i] = (bi, pos)
        subs.append(make_arrowhead_lp([blocks[i] for i in idxs],
                                      first_stage, linking_eq, linking_ineq,
                                      dtype=dtype))
    return BucketedArrowheadLP(tuple(subs), tuple(placement))
