"""The node-sharded twins of the exact model (``sharded``) and of the
compressed model (``sharded_compressed``), their shard groups and
board-exchange modes (``mesh``: the one-process group; ``dist``: the
group over ``torch.distributed`` ranks) and the launcher of a group of
ranks on one machine (``launch``)."""

from sidecar_tpu_torch.parallel.dist import DistShardGroup  # noqa: F401
from sidecar_tpu_torch.parallel.launch import (  # noqa: F401
    RankContext,
    spawn_group,
)
from sidecar_tpu_torch.parallel.mesh import (  # noqa: F401
    BOARD_EXCHANGES,
    LocalShardGroup,
    local_rows,
    resolve_board_exchange,
)
from sidecar_tpu_torch.parallel.sharded import ShardedSim  # noqa: F401
from sidecar_tpu_torch.parallel.sharded_compressed import (  # noqa: F401
    ShardedCompressedSim,
)
