"""Device executors and the hand-written CUDA kernel they launch."""

from .fused import FusedUpExec, can_fuse
from .pallas_frac import frac_whole, frac_whole_ref
