"""Channel x time-block sharding over a Mesh (in-process or
torch.distributed)."""

from ..models.lengths import chain_input_span, chain_shift_period
from .mesh import Mesh
from .sharding import ShardedResampler
from .stream_sharding import ShardedStreamResampler

__all__ = ["Mesh", "ShardedResampler", "ShardedStreamResampler",
           "chain_input_span", "chain_shift_period"]
