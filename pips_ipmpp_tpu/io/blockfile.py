"""Block-file I/O: one .npz per block + a meta file.

Replaces the reference's GDX block files (`model0.gdx..modelN.gdx` read via
the vendored statgdx API, Drivers/gams/gmspips/gmspipsio.h:5-83) with a
self-describing npz-per-block layout:

    <stem>_meta.npz     : N, linking dims, linking eq rhs + ineq bounds
    <stem>_block0.npz   : first-stage arrays (c, A, b, C, bounds, F0, G0)
    <stem>_block<i>.npz : block arrays (c, A, B, b, C, D, bounds, F, G)

Matrices are stored dense (same as the in-memory device layout); a CSR triplet
variant can be added per-array without changing the format version.
"""
from __future__ import annotations

import os
from typing import Optional

import jax.numpy as jnp
import numpy as np

from pips_ipmpp_tpu.core.lp import ArrowheadLP, make_arrowhead_lp

FORMAT_VERSION = 1

_FIRST_KEYS = ("c", "A", "b", "C", "iclow", "clow", "icupp", "cupp",
               "ixlow", "xlow", "ixupp", "xupp", "F0", "G0")
_BLOCK_KEYS = ("c", "A", "B", "b", "C", "D", "iclow", "clow", "icupp",
               "cupp", "ixlow", "xlow", "ixupp", "xupp", "F", "G")


def write_blocks(lp: ArrowheadLP, stem: str) -> None:
    """Write an ArrowheadLP as block files (the inverse of read_blocks)."""
    np.savez(f"{stem}_meta.npz",
             version=FORMAT_VERSION, N=lp.N,
             bl=np.asarray(lp.bl),
             iclowl=np.asarray(lp.iclowl), clowl=np.asarray(lp.clowl),
             icuppl=np.asarray(lp.icuppl), cuppl=np.asarray(lp.cuppl))
    np.savez(f"{stem}_block0.npz",
             c=np.asarray(lp.c0), A=np.asarray(lp.A0), b=np.asarray(lp.b0),
             C=np.asarray(lp.C0),
             iclow=np.asarray(lp.iclow0), clow=np.asarray(lp.clow0),
             icupp=np.asarray(lp.icupp0), cupp=np.asarray(lp.cupp0),
             ixlow=np.asarray(lp.ixlow0), xlow=np.asarray(lp.xlow0),
             ixupp=np.asarray(lp.ixupp0), xupp=np.asarray(lp.xupp0),
             F0=np.asarray(lp.F0), G0=np.asarray(lp.G0))
    for i in range(lp.N):
        np.savez(f"{stem}_block{i + 1}.npz",
                 c=np.asarray(lp.cN[i]), A=np.asarray(lp.A[i]),
                 B=np.asarray(lp.B[i]), b=np.asarray(lp.bN[i]),
                 C=np.asarray(lp.C[i]), D=np.asarray(lp.D[i]),
                 iclow=np.asarray(lp.iclowN[i]), clow=np.asarray(lp.clowN[i]),
                 icupp=np.asarray(lp.icuppN[i]), cupp=np.asarray(lp.cuppN[i]),
                 ixlow=np.asarray(lp.ixlowN[i]), xlow=np.asarray(lp.xlowN[i]),
                 ixupp=np.asarray(lp.ixuppN[i]), xupp=np.asarray(lp.xuppN[i]),
                 F=np.asarray(lp.F[i]), G=np.asarray(lp.G[i]))


def read_blocks(stem: str, n_blocks: Optional[int] = None,
                dtype=jnp.float64) -> ArrowheadLP:
    """Read block files into an ArrowheadLP (heterogeneous blocks are
    padded). `n_blocks` = N+1 in gmspips convention (counting block 0) or
    None to use the meta file."""
    meta = np.load(f"{stem}_meta.npz")
    if int(meta.get("version", 1)) > FORMAT_VERSION:
        raise ValueError(f"unsupported block-file version "
                         f"{int(meta['version'])}")
    N = int(meta["N"]) if n_blocks is None else n_blocks - 1
    b0file = np.load(f"{stem}_block0.npz")
    first = {k: b0file[k] for k in _FIRST_KEYS}
    blocks = []
    for i in range(N):
        path = f"{stem}_block{i + 1}.npz"
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        bf = np.load(path)
        blocks.append({k: bf[k] for k in _BLOCK_KEYS})
    return make_arrowhead_lp(
        blocks, first,
        linking_eq={"b": meta["bl"]},
        linking_ineq={"iclow": meta["iclowl"], "clow": meta["clowl"],
                      "icupp": meta["icuppl"], "cupp": meta["cuppl"]},
        dtype=dtype)


def write_solution(stem: str, x: np.ndarray, y: np.ndarray = None,
                   z: np.ndarray = None, objective: float = None) -> None:
    """Write solution (the role of gmspipsio writeSolution, gmspipsio.h:71)."""
    kw = {"x": x}
    if y is not None:
        kw["y"] = y
    if z is not None:
        kw["z"] = z
    if objective is not None:
        kw["objective"] = objective
    np.savez(f"{stem}_solution.npz", **kw)
