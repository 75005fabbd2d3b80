"""Differentiable DSP through the port's resampler (no reference analog;
examples/differentiable.py on the reference package).

Inverse problem: we observe a signal only AFTER sample-rate conversion
(y_obs at 96 kHz) and recover the 44.1 kHz source by gradient descent
through the converter itself -- possible because the whole stage chain is
a linear function of a fixed-length input
(r8brain_torch.functional.resample_fn), so ``torch.func.grad`` of the
data-fit loss is exact (on the card, frac_whole's backward is the same
kernel on the adjoint operator).  The reference (CDSPResampler.h) is a
stateful C++ object and cannot do this.

Run: python examples/torch_differentiable.py [--device cpu] [--iters N]
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--n", type=int, default=2048)
    args = ap.parse_args(argv)

    import torch

    import r8brain_torch as r8b

    src, dst, n = 44100, 96000, args.n

    # Hidden source: bandlimited noise (content below the SRC passband
    # edge, so the chain preserves it and the problem is well-posed).
    rng = np.random.default_rng(0)
    spec = rng.standard_normal(n // 2 + 1) + 1j * rng.standard_normal(
        n // 2 + 1)
    spec[int(0.4 * n / 2):] = 0.0
    x_true = np.fft.irfft(spec, n).astype(np.float32)
    x_true *= 0.5 / np.abs(x_true).max()

    rs = r8b.Resampler(src, dst, atten=136.45, device=args.device)
    f = r8b.resample_fn(rs, n)
    x_true = torch.from_numpy(x_true).to(rs.device)
    y_obs = f(x_true)
    print(f"observed: {n} @ {src} Hz -> {y_obs.shape[0]} @ {dst} Hz "
          f"on {rs.device}")

    def loss(x):
        r = f(x) - y_obs
        return torch.mean(r * r)

    grad_loss = torch.func.grad_and_value(loss)

    # Minimal Adam (kept dependency-free; torch.optim.Adam does the same)
    lr, b1, b2, eps = 3e-2, 0.9, 0.999, 1e-8
    x = torch.zeros_like(x_true)
    m, v = torch.zeros_like(x), torch.zeros_like(x)
    for i in range(args.iters):
        g, l = grad_loss(x)
        t = i + 1
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** t)
        vh = v / (1 - b2 ** t)
        x = x - lr * mh / (torch.sqrt(vh) + eps)
        if i % max(1, args.iters // 5) == 0 or i == args.iters - 1:
            print(f"iter {i:4d}  loss {float(l):.3e}")

    err = (x - x_true).double()
    snr = 10 * np.log10(float(x_true.double().square().mean())
                        / (float(err.square().mean()) + 1e-30))
    print(f"recovered source SNR: {snr:.1f} dB")
    if snr < 20.0:
        raise SystemExit("recovery failed -- gradient path broken?")
    return 0


if __name__ == "__main__":
    sys.exit(main())
