"""Command-line WAV sample-rate converter (bench/r8bfreesrc.cpp equivalent).

Usage:
    python -m r8brain_torch.cli in.wav out.wav <dst_rate>
        [--tb 2.0] [--atten 180.15] [--phase lin|min]
        [--bits 24] [--float] [--precision fast|high|oracle|native]
        [--device cuda|cpu] [--bench] [--stream] [--max-chunk N]

Installed as the ``r8btorch`` script.  The device paths (``fast``,
``high``) convert all channels as one batched ``Resampler.oneshot`` on
``--device`` (default ``cuda``, which raises RuntimeError when CUDA is not
available: there is no silent fallback to the CPU); ``oracle`` (the float64
OracleResampler) and ``native`` (the C++ engine and its designer) run on
the host, one channel at a time, as the reference loops one CDSPResampler
object per channel (example.cpp:29-39).  --bench prints timing and Mrops
like the reference tool (bench/r8bfreesrc.cpp:118-141).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .io.wavio import WavReader, WavWriter, read_wav, write_wav
from .models.resampler import Resampler, resolve_device
from .models.stream import StreamResampler

#: the --stream path's block, in input frames
STREAM_BLOCK = 65536


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="r8brain_torch.cli",
        description="Professional sample-rate converter (PyTorch / CUDA)")
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("dst_rate", type=float)
    ap.add_argument("--tb", type=float, default=2.0,
                    help="transition band %% (0.5-45)")
    ap.add_argument("--atten", type=float, default=180.15,
                    help="stop-band attenuation dB (49-218)")
    ap.add_argument("--phase", choices=("lin", "min"), default="lin")
    ap.add_argument("--bits", type=int, default=None,
                    choices=(16, 24, 32, 64),
                    help="output sample depth (PCM: 16/24/32, default 24; "
                         "with --float: 32/64, default 32)")
    ap.add_argument("--float", action="store_true",
                    help="write IEEE float output (32-bit by default)")
    ap.add_argument("--precision",
                    choices=("fast", "high", "oracle", "native"),
                    default="high",
                    help="fast=f32, high=f32 + the operator residual "
                         "(-141 dB class), oracle=host float64 reference "
                         "executor, native=C++ engine + designer (f64)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the fast / high paths run (cuda raises "
                         "when CUDA is not available)")
    ap.add_argument("--bench", action="store_true",
                    help="print timing/Mrops for the conversion")
    ap.add_argument("--stream", action="store_true",
                    help="convert via the push-mode streaming engine in "
                         "fixed device blocks with incremental WAV "
                         "read/write -- O(block) host memory regardless "
                         "of file length")
    ap.add_argument("--max-chunk", type=int, default=None, metavar="N",
                    help="bound DEVICE memory on the oneshot path: inputs "
                         "longer than N samples run through the streaming "
                         "engine in N-sample blocks (whole file stays "
                         "host-side; see --stream for bounded host memory "
                         "too)")
    args = ap.parse_args(argv)
    if args.bits is None:
        args.bits = 32 if args.float else 24
    elif args.float and args.bits not in (32, 64):
        ap.error(f"--float writes IEEE-float WAVs (32 or 64 bits); "
                 f"--bits {args.bits} is PCM-only")
    elif not args.float and args.bits == 64:
        ap.error("--bits 64 requires --float (no 64-bit PCM)")
    if args.stream and args.precision in ("oracle", "native"):
        ap.error("--stream applies to the device paths only "
                 "(use --precision fast|high)")
    device = None
    if args.precision in ("fast", "high"):
        device = resolve_device(args.device)

    dst_rate = args.dst_rate
    phase = 0 if args.phase == "lin" else 1

    if args.stream:
        return _stream_convert(args, dst_rate, phase, device)

    wav = read_wav(args.infile)
    src_rate = wav.rate
    x = wav.data
    out_len = int(np.floor(wav.frames * dst_rate / src_rate))

    t0 = time.perf_counter()
    if args.precision == "oracle":
        from .models.oracle import OracleResampler

        y = np.stack([
            OracleResampler(src_rate, dst_rate, 4096, args.tb, args.atten,
                            phase).oneshot(c, out_len) for c in x])
    elif args.precision == "native":
        # the C++ engine and its designer, one handle per channel (the
        # reference's example.cpp loop); the design runs once and every
        # channel's engine shares the plan blob
        from .native import NativeResampler, native_design_blob

        blob = native_design_blob(src_rate, dst_rate, args.tb, args.atten,
                                  phase)
        y = np.stack([
            NativeResampler(src_rate, dst_rate, blob=blob)
            .oneshot(c, out_len) for c in x])
    else:
        rs = Resampler(src_rate, dst_rate, args.tb, args.atten, phase,
                       dtype=torch.float32, precision=args.precision,
                       device=device)
        # the copy to the host waits for the device, so the conversion's
        # device work lies inside the timed window
        y = rs.oneshot(x.astype(np.float32), out_len,
                       max_chunk=args.max_chunk).cpu().numpy().astype(
                           np.float64)
    dt = time.perf_counter() - t0

    write_wav(args.outfile, int(dst_rate), y, args.bits, args.float)
    if args.bench:
        mrops = 1e-6 * wav.frames * wav.channels / dt
        print(f"{wav.frames} frames x {wav.channels} ch "
              f"{src_rate:g} -> {dst_rate:g} in {dt:.3f}s = {mrops:.1f} Mrops",
              file=sys.stderr)
    return 0


def _stream_convert(args, dst_rate, phase, device):
    """Incremental convert: WavReader -> StreamResampler -> WavWriter,
    O(block) host memory (the reference's example.cpp push loop, with the
    file I/O streamed too)."""
    t0 = time.perf_counter()
    frames = 0
    with WavReader(args.infile) as rd:
        src_rate = rd.rate
        out_len = int(np.floor(rd.frames * dst_rate / src_rate))
        rs = Resampler(src_rate, dst_rate, args.tb, args.atten, phase,
                       dtype=torch.float32, precision=args.precision,
                       device=device)
        st = StreamResampler(rs, block_len=STREAM_BLOCK)
        written = 0
        with WavWriter(args.outfile, int(dst_rate), rd.channels,
                       args.bits, args.float) as wr:
            while True:
                blk = rd.read(STREAM_BLOCK)
                if blk.shape[1] == 0:
                    break
                frames += blk.shape[1]
                y = st.process(blk.astype(np.float32)).cpu().numpy()
                y = y[:, : max(0, out_len - written)]
                wr.write(y)
                written += y.shape[1]
            tail = st.flush(out_len).cpu().numpy()
            tail = tail[:, : max(0, out_len - written)]
            wr.write(tail)
            written += tail.shape[1]
        channels = rd.channels
    dt = time.perf_counter() - t0
    if args.bench:
        mrops = 1e-6 * frames * channels / dt
        print(f"{frames} frames x {channels} ch "
              f"{src_rate:g} -> {dst_rate:g} in {dt:.3f}s = {mrops:.1f} "
              f"Mrops (streamed)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
