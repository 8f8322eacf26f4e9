"""Device mesh and tensor-parallel sharding rules."""

from .mesh import (
    TP_RULES,
    Mesh,
    Sharding,
    auto_mesh,
    make_mesh,
    param_pspec,
    param_shardings,
    shard_params,
)

__all__ = [
    "Mesh",
    "Sharding",
    "make_mesh",
    "auto_mesh",
    "param_shardings",
    "shard_params",
    "param_pspec",
    "TP_RULES",
]
