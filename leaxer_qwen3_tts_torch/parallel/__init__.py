"""Device mesh, the data axis's row split and tensor-parallel sharding rules."""

from .mesh import (
    TP_RULES,
    Mesh,
    Sharding,
    auto_mesh,
    make_mesh,
    param_pspec,
    param_shardings,
    row_groups,
    shard_params,
    split_rows,
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
    "split_rows",
    "row_groups",
]
