"""Multi-device scaling: data-parallel lane sharding over a list of devices
(port of wvpk/parallel).

Blocks are self-seeded, so batch decode and encode are pure data
parallelism: each device runs the unsharded path's kernels on a contiguous
run of a bucket's lanes, with no collective on the hot path.
"""

from .mesh import (make_mesh, shard_bucket, shard_lanes_call, shard_ranges,
                   sharded_decode_bucket, sharded_decode_states,
                   sharded_encode_scans, sharded_hybrid_encode_scan,
                   sharded_invert_warm_state)

__all__ = ["make_mesh", "shard_bucket", "shard_lanes_call", "shard_ranges",
           "sharded_decode_bucket", "sharded_decode_states",
           "sharded_encode_scans", "sharded_hybrid_encode_scan",
           "sharded_invert_warm_state"]
