"""Which parts of the scan engine's carry live where on the ("cells",
"silo") mesh (the engine part of ``repro.sharding.rules``).

In the reference these are ``PartitionSpec``s for ``shard_map``.  Here a
spec is a tuple of mesh-axis names per leaf: ``("cells",)`` — the leaf
belongs to one cell and lives on the ranks of that cell's block;
``("cells", "silo")`` — the memory panel under ``silo_reduce="psum"``,
whose rows are split over the silo ranks (rank s holds rows s·N/silo …
(s + 1)·N/silo − 1); ``()`` — every rank holds every cell (no cell
sharding).  ``fed/scan_engine.py`` reads them to assemble a checkpoint's
full carry and to split a loaded one back.  The LM stack's parameter
rules belong to ROADMAP item 13.
"""
from __future__ import annotations

ENGINE_CELL_AXIS = "cells"
ENGINE_SILO_AXIS = "silo"


def engine_batch_spec(cell_sharding: bool = True) -> tuple:
    """The spec of the engine's per-cell state (cells, carries,
    trajectories): split by cell over "cells", or, with
    ``cell_sharding=False``, held whole on every rank."""
    return (ENGINE_CELL_AXIS,) if cell_sharding else ()


def engine_carry_specs(carry_shapes, *, cell_sharding: bool = True,
                       panel_sharded: bool = False):
    """Per-leaf specs for a carry tree (nested dicts and lists, leaves with
    a ``shape``, or None).  Every leaf follows :func:`engine_batch_spec`;
    under ``psum`` (``panel_sharded``) a memory panel (a leaf named
    ``mem`` with two or more dims) is also split into rows over "silo"."""
    base = engine_batch_spec(cell_sharding)

    def spec_of(path, x):
        if (panel_sharded and path and path[-1] == "mem"
                and len(x.shape) >= 2):
            return base + (ENGINE_SILO_AXIS,)
        return base

    def walk(path, x):
        if isinstance(x, dict):
            return {k: walk(path + (k,), v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(path + (i,), v) for i, v in enumerate(x))
        return None if x is None else spec_of(path, x)

    return walk((), carry_shapes)
