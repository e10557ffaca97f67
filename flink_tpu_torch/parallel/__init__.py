"""The multi-device window path (port of ``flink_tpu/parallel``): the
mesh of shards, the keyBy exchange between them, sharded window state with
a two-phase global top k, the live-rescale page format, and the mesh's
configuration. One process drives D shards, each on a ``torch.device``
of the mesh's list (by default all on the entry point's card)."""

from .exchange import (ExchangePlan, bucket_capacity, exchange_round,
                       keyby_exchange, plan_exchange)
from .mesh import (DATA_AXIS, device_index_for_key_groups, hash_int64_device,
                   key_groups_device, make_mesh, murmur_mix_device,
                   shard_ranges)
from .plan import DECLARED_AXES, MESH_RUNTIME, AxisRule, parse_axis_rules
from .rescale import MigrationPlan, paginate_snapshot, plan_migration
from .sharded_window import (AggDef, ShardedWindowAgg, ShardedWindowState,
                             global_topk)

__all__ = [
    "DATA_AXIS", "make_mesh", "shard_ranges", "murmur_mix_device",
    "hash_int64_device", "key_groups_device", "device_index_for_key_groups",
    "keyby_exchange", "plan_exchange", "exchange_round", "ExchangePlan",
    "bucket_capacity", "AggDef", "ShardedWindowAgg", "ShardedWindowState",
    "global_topk", "AxisRule", "parse_axis_rules",
    "DECLARED_AXES", "MESH_RUNTIME", "MigrationPlan", "paginate_snapshot",
    "plan_migration",
]
