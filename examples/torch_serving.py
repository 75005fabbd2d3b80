"""Serving-shape demo on the port: continuous many-channel conversion over
a channel x time mesh with per-block halo exchange (examples/serving.py on
the reference package).

The reference scales this by running one CDSPResampler object per channel
on caller threads (README.md:52-55, example.cpp:29-39); here the whole
channel batch is ONE sharded stream: channels ride the ``ch`` mesh axis
(no exchange), time segments within each pushed block ride ``t`` with
halos taken from the neighbouring segments, and the inter-block carry
stays on the device.  The mesh here is in-process (every shard runs in
this process, one after another); ``Mesh(shape, group=...)`` spans the
ranks of a torch.distributed process group instead, one shard a rank.

Usage: python examples/torch_serving.py [--device cpu] [--channels 64]
       [--blocks 4]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=4)
    args = ap.parse_args(argv)

    import numpy as np

    from r8brain_torch import (Mesh, Resampler, ShardedStreamResampler,
                               StreamResampler)

    mesh = Mesh((2, 2), ("ch", "t"))
    rs = Resampler(44100, 96000, 2.0, 180.15, 0, precision="high",
                   device=args.device)
    ss = ShardedStreamResampler(rs, mesh, seg_len=4096)
    print(f"mesh {mesh.shape}; block {ss.block} in-samples "
          f"({ss.block/44100*1e3:.0f} ms), halo {ss.H}, lag {ss.lat_o} "
          f"out-samples")

    t = np.arange(args.blocks * ss.block) / 44100.0
    sig = (np.sin(2 * np.pi * 440.0 * t)[None, :] * np.linspace(
        0.1, 0.9, args.channels)[:, None]).astype(np.float32)
    total = 0
    for b in range(args.blocks):
        block = sig[:, b * ss.block : (b + 1) * ss.block]
        y = ss.process_block(block)  # a tensor on the device
        total += int(y.shape[1])
        print(f"block {b}: pushed {ss.block}, emitted {y.shape[1]} "
              f"on {y.device}")
    expect = rs.default_out_len(args.blocks * ss.block)
    print(f"emitted {total} of {expect} (lag {expect - total} flushes "
          f"with the next block or ss.flush())")

    # Single-device any-ratio serving: push k blocks per call --
    # StreamResampler.process_blocks_device runs each kernel once for the
    # k blocks.
    st = StreamResampler(Resampler(44100, 96001, 2.0, 180.15, 0,
                                   device=args.device), block_len=2048)
    k = 4
    y = st.process_blocks_device(sig[:, : k * st.block])
    print(f"poly 44100->96001 batched k={k}: pushed {k}x{st.block}, "
          f"emitted {y.shape[1]} in one call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
