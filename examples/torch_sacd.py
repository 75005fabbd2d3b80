"""PCM <-> DSD64 conversion demo on the port (bench/sacd.cpp:20-270
equivalent; examples/sacd.py on the reference package).

Forward: 44.1 kHz PCM -> 2.8224 MHz (DSD64 rate) via the resampler's
extreme-ratio path, then 1-bit quantization with second-order noise-shaping
dither (the reference uses a 2-biquad 1-bit dither, CDither1Bit,
bench/sacd.cpp:20-106; here: a classic second-order error-feedback
delta-sigma modulator with TPDF dither, a recursion sample by sample, run
on the host).
Back: DSD64 bitstream -> 176.4 kHz PCM through the same resampler chain
(bench/sacd.cpp:218-264).

Run:  python examples/torch_sacd.py [--seconds 0.25] [--device cpu]
Prints the in-band SNR of the round trip.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

DSD64 = 2822400.0


def one_bit_noise_shape(x, seed: int = 0) -> np.ndarray:
    """Second-order error-feedback 1-bit modulator with TPDF dither.

    y[n] = sign(x[n] + 2 e[n-1] - e[n-2] + d[n]),  e = y - (input to quant)
    x: [C, N] -> [C, N] of +-1.  The recursion runs sample by sample in
    plain Python floats, one channel after another.
    """
    x = np.asarray(x, dtype=np.float64)
    C, N = x.shape
    rng = np.random.default_rng(seed)
    # TPDF dither at 1 LSB (here full scale is +-1)
    d = (rng.random((C, N)) + rng.random((C, N)) - 1.0) * 0.5
    y = np.empty((C, N))
    for c in range(C):
        e1 = e2 = 0.0
        out = []
        for xn, dn in zip(x[c].tolist(), d[c].tolist()):
            v = xn + 2.0 * e1 - e2
            q = 1.0 if v + dn >= 0.0 else -1.0
            e1, e2 = v - q, e1
            out.append(q)
        y[c] = out
    return y


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=0.25)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from r8brain_torch.models.resampler import Resampler

    def convert(src, dst, x):
        rs = Resampler(src, dst, 2.0, 140.0, 0, device=args.device)
        return rs.oneshot(np.asarray(x, dtype=np.float32)).cpu().numpy()

    src = 44100.0
    n = int(src * args.seconds)
    t = np.arange(n) / src
    x = (0.45 * np.sin(2 * np.pi * 1000.0 * t)
         + 0.1 * np.sin(2 * np.pi * 7333.0 * t)).astype(np.float32)[None]

    print(f"PCM {src:g} -> DSD64 {DSD64:g} ...")
    hi = convert(src, DSD64, x)
    print(f"  {x.shape[1]} -> {hi.shape[1]} samples; 1-bit noise shaping ...")
    dsd = one_bit_noise_shape(np.clip(hi, -0.99, 0.99))

    back_rate = 176400.0
    print(f"DSD64 -> PCM {back_rate:g} ...")
    y = convert(DSD64, back_rate, dsd)[0]

    # in-band SNR vs an ideally-resampled reference
    ref = convert(src, back_rate, x)[0]
    m = min(len(y), len(ref))
    sl = slice(m // 8, m - m // 8)
    d = y[sl] - ref[sl]
    # restrict to the audio band (0..20 kHz)
    D = np.fft.rfft(d * np.hanning(len(d)))
    S = np.fft.rfft(ref[sl] * np.hanning(len(d)))
    f = np.fft.rfftfreq(len(d), 1 / back_rate)
    band = f <= 20000.0
    snr = 10 * np.log10(np.sum(np.abs(S[band]) ** 2)
                        / (np.sum(np.abs(D[band]) ** 2) + 1e-30))
    print(f"round-trip in-band SNR: {snr:.1f} dB "
          f"(2nd-order 1-bit modulator at 64x oversampling)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
