"""r8brain_torch -- the resampler on PyTorch and CUDA (NVIDIA Hopper).

A port of the reference JAX package ``r8brain_tpu``, which stays in the
repository unchanged and is what this package is tested against.  This
package imports neither JAX nor anything of the reference package: the
host-side design and planning layer is its own copy.

Public API:
  * Resampler / Resampler16 / Resampler16IR / Resampler24 -- batched
    [channels, time] converters (models.resampler).  Entry points run on
    ``device="cuda"`` unless the caller passes ``device="cpu"``.
  * resample_fn -- the resampler as a linear, differentiable function of
    a fixed-length input (functional): torch.func.vmap / grad / vjp /
    jvp and backward() compose with it.
  * StreamResampler -- push-mode streaming over a Resampler: process /
    flush, whole-block device calls (one block or k at once),
    get_state / set_state checkpoints (models.stream).
  * ShardedResampler / ShardedStreamResampler / Mesh -- channel x
    time-block sharding of the oneshot and the stream over a ("ch", "t")
    mesh, in-process or on torch.distributed (parallel).
  * OracleResampler -- the float64 host executor of a plan, sample-exact
    against the C++ reference's goldens: the specification the device
    paths are held to (models.oracle, NumPy).
  * make_plan / Plan -- stage planner (models.plan).
  * plan_from_reference / stream_state_from_reference /
    sharded_stream_state_from_reference -- carry a reference-package
    plan, or stream checkpoint, across (convert).
  * FusedUpExec -- the fused [conv(up), whole-frac] executor (ops.fused).
  * frac_whole / frac_whole_ref -- the framed-matmul CUDA kernel and its
    plain PyTorch version (ops.pallas_frac).
  * ops.pallas_ozaki.ozaki_framed / ozaki_framed_ref -- the split-operand
    (ozaki) CUDA kernel of the guarantee chain and its plain version;
    ops.stages.ConvExec / FracWholeExec -- the chain's stage executors.
  * design.* -- host-side filter design (sinc, lpfilter, minphase,
    halfband, fracbank); utils.fir / utils.scan -- FIR responses and
    their scanners (extrema, level crossings).
  * io -- WAV read / write, whole-file and incremental (io.wavio).
  * native -- the shared C++ engine's binding: plan blobs
    (build_plan_blob, native_design_blob) and NativeResampler.
  * cli -- the WAV converter, ``python -m r8brain_torch.cli`` (script
    ``r8btorch``).
"""

from .convert import (plan_from_reference,
                      sharded_stream_state_from_reference,
                      stream_state_from_reference)
from .functional import resample_fn
from .design.lpfilter import LINEAR_PHASE, MIN_PHASE, build_lp_filter, get_lp_filter
from .models.oracle import OracleResampler
from .models.plan import Plan, make_plan
from .models.resampler import (Resampler, Resampler16, Resampler16IR,
                               Resampler24)
from .models.stream import StreamResampler
from .parallel import Mesh, ShardedResampler, ShardedStreamResampler
from .ops.fused import FusedUpExec
from .ops.pallas_frac import frac_whole, frac_whole_ref

__version__ = "0.1.0"

__all__ = [
    "LINEAR_PHASE",
    "MIN_PHASE",
    "build_lp_filter",
    "get_lp_filter",
    "OracleResampler",
    "Plan",
    "make_plan",
    "plan_from_reference",
    "stream_state_from_reference",
    "sharded_stream_state_from_reference",
    "Resampler",
    "Resampler16",
    "Resampler16IR",
    "Resampler24",
    "StreamResampler",
    "Mesh",
    "ShardedResampler",
    "ShardedStreamResampler",
    "resample_fn",
    "FusedUpExec",
    "frac_whole",
    "frac_whole_ref",
    "__version__",
]
