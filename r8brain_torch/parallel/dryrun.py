"""One sharded step of each sharded path over an n-shard in-process mesh.

The port's counterpart of the reference's ``__graft_entry__.py::
dryrun_multichip``, with its three scenarios, each held against the
unsharded chain and against the port's float64 CPU path:

* the 24-bit preset (ReqAtten 180.15, CDSPResampler.h:807), 44.1k -> 96k,
  on the df32 guarantee engine (``precision="high"``,
  ``conv_engine="fft"``, ``fused=False``), sharded: -141 dB re the float64
  output's power;
* a sharded stream of one start block and one steady block: -120 dB
  against the unsharded oneshot;
* 44.1k -> 96001 (the polynomial split chain) time-sharded, the same
  engine: -141 dB.

    python -m r8brain_torch.parallel.dryrun [n_shards] [device]
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from ..models.resampler import Resampler
from .mesh import Mesh
from .sharding import ShardedResampler
from .stream_sharding import ShardedStreamResampler

__all__ = ["dryrun_multichip"]

PARITY_DB = -120.0  # sharded against unsharded, float32 (the reference's)
CLASS_DB = -141.0   # against the float64 path, relative (the golden class)


def _db(y, ref, rel: bool = False) -> float:
    d = np.asarray(y, np.float64) - ref
    p = np.mean(ref * ref) if rel else 1.0
    return float(10.0 * np.log10(np.mean(d * d) / p + 1e-300))


def _mesh(n: int) -> Mesh:
    if n % 2 == 0 and n > 2:
        return Mesh((2, n // 2), ("ch", "t"))
    return Mesh((n,), ("t",))


def dryrun_multichip(n_devices: int, device="cuda", C: int = 4,
                     n: int = 4410, resamplers: Optional[dict] = None
                     ) -> dict:
    """Run the three scenarios on ``n_devices`` in-process shards on
    ``device``; returns each one's dB figures and raises AssertionError
    when one misses its bound.  ``resamplers``, when given, receives the
    resamplers it built by scenario ("preset24", "poly"), for a caller
    that inspects their executors."""
    mesh = _mesh(n_devices)
    kw = dict(precision="high", conv_engine="fft", fused=False,
              device=device)
    out = {"mesh": mesh.shape}
    for label, dst in (("preset24", 96000), ("poly", 96001)):
        rs = Resampler(44100, dst, 2.0, 180.15, 0, **kw)
        if resamplers is not None:
            resamplers[label] = rs
        rs64 = Resampler(44100, dst, 2.0, 180.15, 0, dtype=torch.float64,
                         device="cpu")
        x = torch.from_numpy(np.random.default_rng(
            1 if dst == 96000 else 3).standard_normal((C, n))).float()
        out_len = rs.default_out_len(n)
        y = ShardedResampler(rs, mesh).oneshot(x, out_len)
        assert tuple(y.shape) == (C, out_len), y.shape
        y = y.double().cpu().numpy()
        y_un = rs.oneshot(x, out_len).double().cpu().numpy()
        ref = rs64.oneshot(x.double(), out_len).numpy()
        out[label] = {"vs_unsharded_db": _db(y, y_un),
                      "vs_f64_rel_db": _db(y, ref, rel=True)}
        assert out[label]["vs_unsharded_db"] < PARITY_DB, (label, out)
        assert out[label]["vs_f64_rel_db"] < CLASS_DB, (label, out)
        if dst != 96000:
            continue
        # the sharded stream: one start and one steady block
        ss = ShardedStreamResampler(rs, mesh, seg_len=512)
        xs = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (C, 2 * ss.block))).float()
        ys = torch.cat([ss.process_block(xs[:, : ss.block]),
                        ss.process_block(xs[:, ss.block :])], dim=1)
        ref_s = rs.oneshot(xs, rs.default_out_len(2 * ss.block))
        ref_s = ref_s.double().cpu().numpy()[:, : ys.shape[1]]
        out["stream"] = {"vs_unsharded_db": _db(ys.double().cpu().numpy(),
                                                ref_s),
                         "outputs": int(ys.shape[1])}
        assert out["stream"]["vs_unsharded_db"] < PARITY_DB, out
    return out


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4,
                           sys.argv[2] if len(sys.argv) > 2 else "cuda"))
