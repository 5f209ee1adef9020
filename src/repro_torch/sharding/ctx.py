"""Logical-axis sharding context (the port of ``repro.sharding.ctx``).

Model code names activation dims by *logical* axes (``"dp"``, ``"tp"``,
...); the launcher installs a ``ShardCtx`` that maps them to the physical
axes of a mesh.  Outside a context the hints are no-ops.

Logical names:
  dp    batch/data-parallel axis    -> ("pod","data") multi-pod, ("data",) single
  tp    tensor-parallel axis        -> ("model",)
  fsdp  parameter-sharding axis     -> ("data",)  (2D weight sharding with tp)
  sp    sequence axis (long-context decode, batch=1) -> ("data",)

A spec is the layout of the reference's ``PartitionSpec`` held as a tuple:
one entry per dim, each None (replicated), an axis name or a tuple of
axis names.  Eager torch has no SPMD compiler to take an activation hint,
so :func:`shard_act` returns its input; :func:`act_spec` gives the spec the
reference's hint would carry.  The readers of the context are
``models/ffn.apply_moe`` (``MOE_GROUPS = -1``: one dispatch group per dp
shard) and the dry-run's parameter, batch and cache specs.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ShardCtx:
    axis_map: dict = field(default_factory=dict)   # logical -> tuple of mesh axes
    mesh: object = None
    # sizes of the physical tp / dp axes, for divisibility checks
    tp_size: int = 1
    dp_size: int = 1
    # head-aware TP: leaf name -> semantic unit count (e.g. {"wq": n_heads}).
    # A projection whose flat dim divides by tp but whose HEAD count does
    # not stays replicated over tp (the (B, S, H, dh) reshape would
    # otherwise regather the attention path, the KV cache included).
    head_divisors: dict = field(default_factory=dict)

    def resolve(self, *logical) -> tuple:
        """The spec of dims named by ``logical`` (None: replicated)."""
        phys = []
        for name in logical:
            axes = None if name is None else self.axis_map.get(name)
            if not axes:
                phys.append(None)
            elif len(axes) == 1:
                phys.append(axes[0])
            else:
                phys.append(tuple(axes))
        return tuple(phys)


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a mesh: the port's meshes carry ``shape``, a
    duck-typed one (the reference's tests) ``devices.shape``."""
    shape = getattr(mesh, "shape", None)
    if not isinstance(shape, tuple):
        shape = tuple(mesh.devices.shape)
    return dict(zip(mesh.axis_names, shape))


def axes_total(sizes: dict, axes) -> int:
    """The product of the sizes of ``axes`` (1 for none)."""
    return math.prod(sizes.get(a, 1) for a in axes or ())


_ctx: contextvars.ContextVar[ShardCtx | None] = contextvars.ContextVar(
    "shard_ctx", default=None)


def current_ctx() -> ShardCtx | None:
    return _ctx.get()


@contextlib.contextmanager
def use_sharding(ctx: ShardCtx):
    token = _ctx.set(ctx)
    try:
        yield ctx
    finally:
        _ctx.reset(token)


def act_spec(shape, *logical, ctx: ShardCtx | None = None) -> tuple | None:
    """The spec the reference's ``shard_act`` constrains an activation of
    ``shape`` to under ``ctx`` (default: the installed one); None outside
    a context.  A logical axis is dropped (replicated) where the dim does
    not divide by the product of its physical axes' sizes, or that
    product is 1."""
    ctx = ctx if ctx is not None else _ctx.get()
    if ctx is None or ctx.mesh is None:
        return None
    sizes = mesh_sizes(ctx.mesh)
    checked = []
    for dim, name in enumerate(logical):
        total = 1 if name is None else axes_total(sizes,
                                                  ctx.axis_map.get(name))
        checked.append(name if total > 1 and shape[dim] % total == 0
                       else None)
    return ctx.resolve(*checked)


def shard_act(x, *logical):
    """``x`` as it is: eager torch takes no sharding hint (the reference's
    ``with_sharding_constraint``; :func:`act_spec` gives its spec)."""
    return x
