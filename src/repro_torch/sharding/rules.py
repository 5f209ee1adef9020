"""Sharding specs (the port of ``repro.sharding.rules``): the LM's
parameters, batches and caches on the production mesh, and the scan
engine's carry on the ("cells", "silo") mesh.

**The LM part.**  Weights get 2D sharding (FSDP over ``data`` x TP over
``model``) by the path rules below; a dim that does not divide by its
axes' size is replicated on them (DESIGN.md §4).  A spec is the
reference's ``PartitionSpec`` held as a tuple (``sharding/ctx.py``).  The
port's params are a flat dict under dotted keys: a leaf's path is its key
split at the dots, so ``"moe" in path`` and the right-aligned rule of a
stacked (L, ...) leaf read as in the reference.  :func:`local_shape` gives
the shard one device holds.

**The engine part.**  In the reference these are ``PartitionSpec``s for ``shard_map``.  Here a
spec is a tuple of mesh-axis names per leaf: ``("cells",)`` — the leaf
belongs to one cell and lives on the ranks of that cell's block;
``("cells", "silo")`` — the memory panel under ``silo_reduce="psum"``,
whose rows are split over the silo ranks (rank s holds rows s·N/silo …
(s + 1)·N/silo − 1); ``()`` — every rank holds every cell (no cell
sharding).  ``fed/scan_engine.py`` reads them to assemble a checkpoint's
full carry and to split a loaded one back.
"""
from __future__ import annotations

from repro_torch.sharding.ctx import axes_total, mesh_sizes
from repro_torch.utils.tree import map_with_path

# When False, the "fsdp" logical axis maps to replication: TP-only weight
# sharding, the standard serving layout (decode would otherwise all-gather
# the full FSDP-sharded weights every token).
FSDP_ENABLED = True

# Head-aware TP (default on): see ShardCtx.head_divisors.  The `legacy_tp`
# variant turns it off.
HEAD_AWARE_TP = True

# (path-suffix match, (dim -> logical axis)); the first match wins.
# logical: "tp" tensor-parallel, "fsdp" data-axis weight sharding
_RULES: list[tuple[tuple[str, ...], tuple[str | None, ...]]] = [
    (("embed",), ("tp", "fsdp")),              # (V, d)
    (("lm_head",), ("fsdp", "tp")),            # (d, V)
    (("wq",), ("fsdp", "tp")),
    (("wk",), ("fsdp", "tp")),
    (("wv",), ("fsdp", "tp")),
    (("wo",), ("tp", "fsdp")),
    (("router",), ("fsdp", None)),
    (("w_gate",), ("fsdp", "tp")),
    (("w_in",), ("fsdp", "tp")),
    (("w_out",), ("tp", "fsdp")),
    (("w_z",), ("fsdp", "tp")),
    (("w_x",), ("fsdp", "tp")),
    (("w_B",), ("fsdp", None)),
    (("w_C",), ("fsdp", None)),
    (("w_dt",), ("fsdp", None)),
]


def _axes_for(path: tuple[str, ...], shape: tuple[int, ...]):
    name = path[-1]
    moe = "moe" in path
    axes = None
    for (suffix, rule_axes) in _RULES:
        if name == suffix[0]:
            if moe and name in ("w_in", "w_out", "w_gate"):
                # (E, a, b): experts over tp, FSDP on the larger inner dim
                axes = ("tp", "fsdp", None)
            else:
                axes = rule_axes
            break
    if axes is not None and not FSDP_ENABLED:
        axes = tuple(None if a == "fsdp" else a for a in axes)
    return axes  # None -> replicate (norms, scalars, biases, conv)


def _phys(axes: tuple):
    return axes[0] if len(axes) == 1 else tuple(axes)


def param_specs(params, ctx):
    """Specs matching ``params`` (a flat dotted dict, or nested);
    divisibility-checked."""
    sizes = mesh_sizes(ctx.mesh)
    tp_total = axes_total(sizes, ctx.axis_map.get("tp"))

    def spec_of(path, x):
        axes = _axes_for(path, x.shape)
        if axes is None:
            return ()
        # head-aware TP (see ShardCtx.head_divisors)
        unit = ctx.head_divisors.get(path[-1])
        if unit is not None and tp_total > 1 and unit % tp_total != 0:
            axes = tuple(None if a == "tp" else a for a in axes)
        # stacked-per-layer leaves carry a leading L dim: right-align the rule
        ndim = len(x.shape)
        axes = (None,) * max(0, ndim - len(axes)) + tuple(axes[:ndim])
        phys = []
        for dim, logical in enumerate(axes):
            mesh_axes = () if logical is None else \
                (ctx.axis_map.get(logical) or ())
            total = axes_total(sizes, mesh_axes)
            phys.append(_phys(mesh_axes) if total > 1 and
                        x.shape[dim] % total == 0 else None)
        return tuple(phys)

    return map_with_path(spec_of, params)


def batch_specs(batch, ctx):
    """Shard dim 0 (batch) of every input over the dp axes when it
    divides."""
    sizes = mesh_sizes(ctx.mesh)
    dp = ctx.axis_map.get("dp") or ()
    total = axes_total(sizes, dp)

    def spec_of(path, x):
        ndim = len(x.shape)
        if ndim >= 1 and total > 1 and x.shape[0] % total == 0:
            return (_phys(dp),) + (None,) * (ndim - 1)
        return (None,) * ndim

    return map_with_path(spec_of, batch)


def cache_specs(cache, ctx, *, seq_shard: bool):
    """KV/SSM cache specs.  Layout: kv (L, B, S, H, D), ssm (L, B, H, P,
    N), conv (L, B, K-1, C); the port's host-int ``len`` gets None (it is
    no tensor).  ``seq_shard=True`` (batch=1 long-context): shard the
    cache's *sequence* dim over the dp axes instead of batch."""
    sizes = mesh_sizes(ctx.mesh)
    dp = ctx.axis_map.get("dp") or ()
    tp = ctx.axis_map.get("tp") or ()
    dp_total = axes_total(sizes, dp)
    tp_total = axes_total(sizes, tp)
    dp_phys = _phys(dp) if dp else None
    tp_phys = _phys(tp) if tp else None

    def spec_of(path, x):
        if not hasattr(x, "shape"):
            return None
        name, ndim = path[-1], len(x.shape)
        spec = [None] * ndim
        if name in ("k", "v") and ndim == 5:          # (L,B,S,Hkv,D)
            if not seq_shard and dp_total > 1 and x.shape[1] % dp_total == 0:
                spec[1] = dp_phys
            if seq_shard and dp_total > 1 and x.shape[2] % dp_total == 0:
                spec[2] = dp_phys
            if tp_total > 1 and x.shape[3] % tp_total == 0:
                spec[3] = tp_phys
        elif name == "ssm" and ndim == 5:             # (L,B,H,P,N)
            if dp_total > 1 and x.shape[1] % dp_total == 0:
                spec[1] = dp_phys
            if tp_total > 1 and x.shape[2] % tp_total == 0:
                spec[2] = tp_phys
        elif name == "conv" and ndim == 4:            # (L,B,K-1,C)
            if dp_total > 1 and x.shape[1] % dp_total == 0:
                spec[1] = dp_phys
            if tp_total > 1 and x.shape[3] % tp_total == 0:
                spec[3] = tp_phys
        elif name in ("enc_k", "enc_v") and ndim == 5:
            if not seq_shard and dp_total > 1 and x.shape[1] % dp_total == 0:
                spec[1] = dp_phys
            if tp_total > 1 and x.shape[3] % tp_total == 0:
                spec[3] = tp_phys
        return tuple(spec)

    return map_with_path(spec_of, cache)


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The shard of a leaf of ``shape`` that one device of ``mesh`` holds
    under ``spec``: each dim divided by the product of its axes' sizes
    (the specs above shard only dims that divide)."""
    sizes = mesh_sizes(mesh)
    out = []
    for dim, n in enumerate(shape):
        axes = spec[dim] if spec and dim < len(spec) else None
        axes = (axes,) if isinstance(axes, str) else (axes or ())
        total = axes_total(sizes, axes)
        if n % total:
            raise ValueError(f"local_shape: dim {dim} of {tuple(shape)} "
                             f"does not divide by {total} ({spec})")
        out.append(n // total)
    return tuple(out)


# ---------------------------------------------------------------- scan engine

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
