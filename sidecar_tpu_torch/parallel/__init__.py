"""The node-sharded twins of the exact model (``sharded``) and of the
compressed model (``sharded_compressed``), and their shard groups and
board-exchange modes (``mesh``)."""

from sidecar_tpu_torch.parallel.mesh import (  # noqa: F401
    BOARD_EXCHANGES,
    LocalShardGroup,
    resolve_board_exchange,
)
from sidecar_tpu_torch.parallel.sharded import ShardedSim  # noqa: F401
from sidecar_tpu_torch.parallel.sharded_compressed import (  # noqa: F401
    ShardedCompressedSim,
)
