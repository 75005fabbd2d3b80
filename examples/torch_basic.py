"""Basic usage example on the PyTorch / CUDA port (example.cpp:16-79
equivalent; examples/basic.py on the reference package).

The reference loops one CDSPResampler24 per channel with a push-mode WAV
loop; here all channels convert in one batched device call, and the
streaming variant shows the push-mode API with zero-flush.

Run: python examples/torch_basic.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import r8brain_torch as r8b

    src, dst = 44100, 96000
    n = 44100
    t = np.arange(n) / src
    x = np.stack([0.5 * np.sin(2 * np.pi * 440.0 * t),
                  0.5 * np.sin(2 * np.pi * 1000.0 * t)]).astype(np.float32)

    # 1) offline batched conversion (24-bit preset)
    rs = r8b.Resampler24(src, dst, device=args.device)
    y = rs.oneshot(x).cpu().numpy()
    print(f"oneshot: {x.shape} @ {src} Hz -> {y.shape} @ {dst} Hz "
          f"on {rs.device}")

    # 2) push-mode streaming with zero-flush
    st = r8b.StreamResampler(rs, block_len=4096)
    outs = [st.process(x[:, i : i + 3000]) for i in range(0, n, 3000)]
    outs.append(st.flush(rs.default_out_len(n)))
    ys = np.concatenate([o.cpu().numpy() for o in outs], axis=1)
    print(f"streaming: {ys.shape}, matches oneshot: "
          f"{np.allclose(ys, y, atol=1e-6)}")

    # 3) the host float64 oracle (the sample-exact reference executor)
    orc = r8b.OracleResampler(src, dst, atten=180.15)
    yo = orc.oneshot(x[0].astype(np.float64), y.shape[1])
    d = y[0] - yo
    print(f"device-vs-oracle RMS: {10*np.log10(np.mean(d*d)+1e-300):.1f} dB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
