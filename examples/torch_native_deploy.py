"""Native deployment example on the port (DLL/r8bsrc.cpp:45-109 workflow
equivalent; examples/native_deploy.py on the reference package).

The reference ships a flat C ABI DLL so host applications can resample
without compiling the C++ headers; here the deployment artifact is a
*plan blob* -- the port's planner designs the stage chain and all filter
kernels in float64 once, serializes them, and the dependency-free C++
engine (native/, C ABI in native/r8bt.h, built to libr8bt.so) executes
the blob with one handle per channel/stream, any thread.

The blob can be written at build time and shipped alongside libr8bt.so,
so production hosts need neither Python nor PyTorch.  From C:

    r8bt_handle h = r8bt_create_from_blob(blob, len);
    long m = r8bt_process(h, in, in_len, &out);   // push-mode
    r8bt_delete(h);

Run: python examples/torch_native_deploy.py [--blob PATH]
(the blob goes to a temporary directory unless --blob names a file)
"""

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--blob", default=None,
                    help="where to write the plan blob")
    args = ap.parse_args(argv)

    from r8brain_torch.models.plan import make_plan
    from r8brain_torch.native import NativeResampler, build_plan_blob

    src, dst = 44100, 96000

    # 1) design once (host, float64): 24-bit preset chain
    plan = make_plan(src, dst, trans_band=2.0, atten=180.15, phase=0)
    blob = build_plan_blob(plan)
    with tempfile.TemporaryDirectory() as tmp:
        blob_path = Path(args.blob or Path(tmp) / "r8bt_44k_96k_24bit.blob")
        blob_path.write_bytes(blob)
        print(plan.describe())
        print(f"blob {len(blob)} bytes -> {blob_path}")
        assert blob_path.read_bytes() == blob

    # 2) deploy-side: one engine per channel/stream (the reference's
    #    concurrency contract, README.md:52-55), push-mode loop
    n = src  # 1 s
    t = np.arange(n) / src
    x = 0.5 * np.sin(2 * np.pi * 440.0 * t)
    eng = NativeResampler(src, dst, blob=blob)
    outs = []
    for i in range(0, n, 4096):          # arbitrary chunking
        outs.append(eng.process(x[i:i + 4096]))
    want = int(round(n * dst / src))
    while sum(map(len, outs)) < want:    # zero-flush the latency tail
        outs.append(eng.process(np.zeros(4096)))
    y = np.concatenate(outs)[:want]
    print(f"streamed {n} -> {len(y)} samples "
          f"(peak {np.abs(y).max():.3f})")

    # 3) sanity vs the offline oracle
    from r8brain_torch.models.oracle import OracleResampler

    yo = OracleResampler(src, dst, 4096, 2.0, 180.15, plan=plan).oneshot(
        x, want)
    skip = int(0.05 * dst)
    d = y[skip:-skip] - yo[skip:-skip]
    rms = 20 * np.log10(np.sqrt(np.mean(d * d)) /
                        np.sqrt(np.mean(yo[skip:-skip] ** 2)))
    print(f"native vs oracle: {rms:.1f} dB RMS (golden class <= -141)")
    assert rms <= -141.0

    # 4) fully standalone path: the C++ designer inside libr8bt
    #    (native/r8bt_design.cpp) -- no Python design work, the exact
    #    r8b_create(src, dst, maxlen, tb, res) workflow of the reference
    #    DLL.  From C:  r8bt_create(44100, 96000, 2.0, 2 /* r8brr24 */)
    eng2 = NativeResampler(src, dst, trans_band=2.0, atten=180.15,
                           design="native")
    y2 = eng2.oneshot(x, want)
    print(f"native-designed vs python-designed: "
          f"max |diff| {np.abs(y2 - y).max():.2e}")
    assert np.abs(y2 - y).max() < 1e-12
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
