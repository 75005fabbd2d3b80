#!/usr/bin/env python3
"""The differential fuzzer on the r8brain_torch port: every executor of one
random configuration on the same signal, each pair held to its class.

    python tools/torch_fuzz.py [--trials 400] [--first 0]
        [--device cuda|cpu] [--executors orc,f32,oz,stm,nat,...]

The trial loop of the reference package's fuzzer
(tests/test_differential_slow.py:91-204), on the port.  Trial t draws a
configuration (src, dst, tb, atten, phase) from ``default_rng(20260820)``
in the reference's order (``draw_config``: its four ratio families, atten
over 49..218 dB, tb over 0.75..12, 15 % minimum phase), then n from
[2500, 6000); the input is ``lcg_uniform(7000 + t, n)`` rounded to
float32, the chunks of the stream and native executors come from
``default_rng(3000 + t)`` (1..2199 samples).  The executors:

* ``orc``: ``OracleResampler``, float64 on the CPU;
* ``f32``: ``Resampler`` float32 ``"fast"``, default fusion;
* ``oz``: ``precision="high"``, ``fused=False``, ``conv_engine`` =
  ``frac_engine`` = ``"ozaki"`` (the guarantee chain, df32 carry);
* ``stm``: ``StreamResampler(f32, block_len=2048)`` fed the chunks, then
  ``flush(out_len)``;
* ``nat``: the shared C++ engine (``NativeResampler``, the port's own
  build) on the same plan, fed the same chunks and zero-flushed;
* ``high``: float32 ``"high"``, default fusion;
* ``fft``: ``precision="high"``, ``fused=False``,
  ``conv_engine="pallas_fft5"`` (``df_fft_conv``), on plans with a conv
  stage;
* ``sym``: ``fused=False``, ``conv_engine="toeplitz_sym"``
  (``sym_conv``), on plans where a conv stage keeps that engine (the
  stage executor's own rule: a kernel that is not centrosymmetric falls
  back to ``"toeplitz"``, and then the trial does not run ``sym``).

``--device cuda`` (the default; it raises without CUDA) runs all eight,
``--device cpu`` the first five (each kernel through its plain version);
``--executors`` picks others.  Each pair is held to its bound in dB
relative to the reference signal's RMS (``BOUNDS``, the reference's eight
and the card's three), and the dB re full scale of every float32
executor against ``orc`` is recorded beside them: a trial above
``CLASS_DB`` (-141, the port's sold class) is printed with its config,
the same executor's CPU plain model's dB and the card's distance from it.
The last line is one JSON object: ``metric``, ``trials``, ``worst_db``,
``worst_cfg`` (the reference's keys), ``re_fs_over_141`` (a count per
float32 executor), ``worst_re_fs``, ``runs`` (trials each executor ran)
and ``device``.  Exits 1 when any pair misses its bound.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from helpers import lcg_uniform, rms_db  # noqa: E402

SEED = 20260820
STREAM_BLOCK = 2048
CLASS_DB = -141.0
#: dB relative to the reference signal's RMS: the reference's eight pairs
#: at its values, and the card's executors at the f32 chain's class
BOUNDS = {"orc_nat": -240.0, "orc_f32": -115.0, "orc_oz": -150.0,
          "f32_oz": -112.0, "f32_nat": -115.0, "oz_nat": -150.0,
          "orc_stm": -115.0, "f32_stm": -120.0,
          "orc_high": -115.0, "orc_fft": -115.0, "orc_sym": -115.0}
BASE = ("orc", "f32", "oz", "stm", "nat")
CARD = ("high", "fft", "sym")
FLOAT32 = ("f32", "high", "oz", "stm", "fft", "sym")
#: Resampler options of each float32 executor built from a Resampler
OPTIONS = {
    "f32": dict(precision="fast"),
    "high": dict(precision="high"),
    "oz": dict(precision="high", fused=False, conv_engine="ozaki",
               frac_engine="ozaki"),
    "fft": dict(precision="high", fused=False, conv_engine="pallas_fft5"),
    "sym": dict(fused=False, conv_engine="toeplitz_sym"),
}


#: pinned configurations: the reference fuzzer's four thinnest margins
#: (tests/test_fuzzer_pins.py, n 3000, input seed 7176), then the faults
#: the port's own sweeps found.  (label, (src, dst, tb, atten, phase),
#: executor, bound dB relative to the oracle's RMS, n, input seed: a
#: trial's 7000 + trial, its chunks then the trial's)
PINS = [
    ("oz_poly_down", (431181.83, 44100.0, 9.625, 139.53, 0), "oz", -150.0,
     3000, 7176),
    ("oz_hb_down", (80039.87, 44100.0, 3.327, 161.0, 0), "oz", -150.0,
     3000, 7176),
    ("oz_hb_8x", (352800.0, 44100.0, 3.951, 136.1, 0), "oz", -150.0,
     3000, 7176),
    ("f32_down_tb08", (44100.0, 33075.0, 0.791, 127.59, 0), "f32", -115.0,
     3000, 7176),
]


#: faults of the port's sweeps at the sold class: a float32 executor of a
#: trial above CLASS_DB re full scale on the card where its CPU model held
#: it.  (label, (src, dst, tb, atten, phase), executor, bound dB re full
#: scale, n, input seed)
CLASS_PINS = [
    # draw 137: [fused pair, conv, half-band]; -140.12 on an H100 at
    # 32-term folds, CPU model -144.01 (models/resampler.py HB_TAIL)
    ("f32_short_conv_hb", (44100.0, 328545.0, 1.383, 194.9, 0), "f32",
     CLASS_DB, 3466, 7137),
    ("stm_short_conv_hb", (44100.0, 328545.0, 1.383, 194.9, 0), "stm",
     CLASS_DB, 3466, 7137),
]


def pin_input(pin) -> np.ndarray:
    """A pinned configuration's float32 input."""
    return lcg_uniform(pin[5], pin[4]).astype(np.float32)


def run_pin(pin, device, plan=None):
    """A pinned configuration's executor output and the oracle's, float64
    numpy, on ``plan`` (default: the port's own)."""
    from r8brain_torch.models.plan import make_plan

    _label, cfg, name, _bound, n, seed = pin
    src, dst = cfg[:2]
    if plan is None:
        plan = make_plan(*cfg)
    x32 = pin_input(pin)
    out_len = int(np.floor(n * dst / src))
    ref = run_executor("orc", cfg, plan, x32, out_len, (), "cpu")
    y = run_executor(name, cfg, plan, x32, out_len,
                     chunk_sizes(seed - 7000, n), device)
    return y, ref


def draw_config(rng: np.random.Generator, trial: int):
    """One random (src, dst, tb, atten, phase) draw, cycling through the
    reference's ratio families (tests/test_differential_slow.py:64-90,
    letter for letter)."""
    fam = trial % 4
    src = 44100.0
    if fam == 0:
        # masstest family: non-integer ratio -> polynomial interpolator
        dst = float(np.round(src * (1.0 + 9.0 * rng.random()), 2))
    elif fam == 1:
        # zerotest family: rational k/20 -> whole-stepping / intermediate
        k = int(rng.integers(21, 641))
        dst = src * k / 20.0
    elif fam == 2:
        # pow2 / 3*2^c branches -> half-band cascades
        dst = src * float(rng.choice([2, 3, 4, 6, 8, 12, 16]))
    else:
        # single-step common ratios {1/2, 1/3, 2/3, 3/2, 3/4} + friends
        num, den = [(1, 2), (1, 3), (2, 3), (3, 2), (3, 4),
                    (4, 3), (5, 4)][int(rng.integers(0, 7))]
        dst = src * num / den
    if fam != 3 and rng.random() < 0.45:
        src, dst = dst, src  # downsampling direction
    tb = float(np.round(np.exp(rng.uniform(np.log(0.75), np.log(12.0))), 3))
    atten = float(np.round(rng.uniform(49.0, 218.0), 2))
    phase = 1 if rng.random() < 0.15 else 0
    return src, dst, tb, atten, phase


def draws(count: int, first: int = 0):
    """(trial, (src, dst, tb, atten, phase), n) of trials first ..
    first + count - 1, the generator advanced through the earlier ones."""
    rng = np.random.default_rng(SEED)
    for trial in range(first + count):
        cfg = draw_config(rng, trial)
        n = int(rng.integers(2500, 6000))
        if trial >= first:
            yield trial, cfg, n


def chunk_sizes(trial: int, n: int):
    """The chunks the stream and native executors are fed."""
    crng = np.random.default_rng(3000 + trial)
    sizes, pos = [], 0
    while pos < n:
        c = min(int(crng.integers(1, 2200)), n - pos)
        sizes.append(c)
        pos += c
    return sizes


def rel_db(y: np.ndarray, ref: np.ndarray) -> float:
    return rms_db(y - ref) - rms_db(ref)


def build(name: str, cfg, plan, device):
    """The Resampler of float32 executor ``name`` on ``plan``, or None
    where the plan has no stage that takes its engine."""
    import torch

    from r8brain_torch import Resampler
    from r8brain_torch.models.plan import ConvStage
    from r8brain_torch.ops.stages import ConvExec

    if name == "fft" and not any(isinstance(s, ConvStage)
                                 for s in plan.stages):
        return None
    rs = Resampler(*cfg, dtype=torch.float32, plan=plan, device=device,
                   **OPTIONS["f32" if name == "stm" else name])
    if name == "sym" and not any(isinstance(e, ConvExec)
                                 and e.engine == "toeplitz_sym"
                                 for e in rs.execs):
        return None
    return rs


def run_executor(name: str, cfg, plan, x32: np.ndarray, out_len: int,
                 sizes, device, rs=None):
    """Executor ``name``'s output (float64 numpy) on x32, or None where it
    does not apply to the plan.  ``rs``: the f32 Resampler, reused by
    ``stm``."""
    import torch

    src, dst, tb, atten, phase = cfg
    x64 = x32.astype(np.float64)
    if name == "orc":
        from r8brain_torch.models.oracle import OracleResampler

        return OracleResampler(src, dst, 4096, tb, atten, phase,
                               plan=plan).oneshot(x64, out_len)
    if name == "nat":
        from r8brain_torch.native import NativeResampler

        nat = NativeResampler(src, dst, plan=plan)
        outs, pos = [], 0
        for c in sizes:
            outs.append(nat.process(x64[pos : pos + c]))
            pos += c
        got = sum(o.shape[0] for o in outs)
        zeros = np.zeros(4096)
        while got < out_len:
            outs.append(nat.process(zeros))
            got += outs[-1].shape[0]
        return np.concatenate(outs)[:out_len]
    if name == "stm":
        from r8brain_torch import StreamResampler

        st = StreamResampler(rs if rs is not None else
                             build("f32", cfg, plan, device),
                             block_len=STREAM_BLOCK)
        outs, pos = [], 0
        for c in sizes:
            outs.append(st.process(x32[pos : pos + c][None]))
            pos += c
        outs.append(st.flush(out_len))
        return torch.cat(outs, dim=1)[0].cpu().double().numpy()
    r = rs if rs is not None and name == "f32" else build(name, cfg, plan,
                                                          device)
    if r is None:
        return None
    return r.oneshot(x32, out_len).cpu().double().numpy()


def run_trial(trial: int, cfg, n: int, executors, device, plan=None,
              extra=None):
    """One trial: every executor of ``executors`` on the trial's input.
    ``extra``: {name: fn(cfg, plan, x32, out_len) -> float64 array} of
    executors outside the port (a test's reference package).  Returns
    {"outputs": {name: array}, "pairs": {pair: dB relative}, "re_fs":
    {float32 executor: dB re full scale against orc}, "n", "out_len",
    "plan", "x32", "sizes"}; executors that do not apply are absent."""
    from r8brain_torch.models.plan import make_plan

    src, dst, tb, atten, phase = cfg
    if plan is None:
        plan = make_plan(src, dst, tb, atten, phase)
    # float32-representable input so the float32 executors see the same
    # signal the float64 ones do (no representation error)
    x32 = lcg_uniform(7000 + trial, n).astype(np.float32)
    out_len = int(np.floor(n * dst / src))
    sizes = chunk_sizes(trial, n)
    outs, rs32 = {}, None
    for name in executors:
        if name in ("f32", "stm") and rs32 is None:
            rs32 = build("f32", cfg, plan, device)
        y = run_executor(name, cfg, plan, x32, out_len, sizes, device,
                         rs=rs32)
        if y is not None:
            assert y.shape == (out_len,), (name, y.shape, out_len)
            outs[name] = y
    for name, fn in (extra or {}).items():
        outs[name] = np.asarray(fn(cfg, plan, x32, out_len), np.float64)
    pairs = {}
    for pair in BOUNDS:
        a, b = pair.split("_")
        if a in outs and b in outs:
            pairs[pair] = rel_db(outs[b], outs[a])
    re_fs = {name: rms_db(outs[name] - outs["orc"]) for name in FLOAT32
             if name in outs and "orc" in outs}
    return {"outputs": outs, "pairs": pairs, "re_fs": re_fs, "n": n,
            "out_len": out_len, "plan": plan, "x32": x32, "sizes": sizes}


def sweep(trials: int, first: int = 0, executors=None, device="cuda",
          log=print):
    """The fuzzer's loop over ``trials`` draws from ``first``: every pair
    against its bound, every float32 executor's dB re full scale against
    CLASS_DB (a trial above it printed with the executor's CPU plain
    model).  Returns (summary dict, list of bound failures)."""
    import torch

    device = torch.device(device)
    if executors is None:
        executors = BASE + (CARD if device.type == "cuda" else ())
    worst = {k: (-np.inf, None) for k in BOUNDS}
    worst_fs = {k: (-np.inf, None) for k in FLOAT32}
    over = {k: 0 for k in FLOAT32 if k in executors}
    runs = {k: 0 for k in executors}
    fails = []
    for trial, cfg, n in draws(trials, first):
        t0 = time.perf_counter()
        r = run_trial(trial, cfg, n, executors, device)
        tag = (trial,) + tuple(cfg)
        for name in r["outputs"]:
            runs[name] += 1
        for pair, d in r["pairs"].items():
            if d > worst[pair][0]:
                worst[pair] = (d, tag)
            if not d < BOUNDS[pair]:
                fails.append((pair, d, tag))
                log(f"torch_fuzz: FAIL trial {trial} {cfg} n={n} {pair} "
                    f"{d:.2f} dB relative (bound {BOUNDS[pair]:g})")
        for name, d in r["re_fs"].items():
            if d > worst_fs[name][0]:
                worst_fs[name] = (d, tag)
            if d > CLASS_DB:
                over[name] += 1
                cpu = run_executor(name, cfg, r["plan"], r["x32"],
                                   r["out_len"], r["sizes"], "cpu")
                d_cpu = rms_db(cpu - r["outputs"]["orc"])
                d_card = rms_db(r["outputs"][name] - cpu)
                log(f"torch_fuzz: trial {trial} {cfg} n={n} {name} "
                    f"{d:.2f} dB re full scale vs orc (class "
                    f"{CLASS_DB:g}); its CPU plain model {d_cpu:.2f}, "
                    f"{device.type} vs CPU model {d_card:.2f}")
        log(f"torch_fuzz: trial {trial} {cfg} n={n} "
            f"{time.perf_counter() - t0:.2f} s: " + ", ".join(
                f"{k} {v:.1f}" for k, v in r["pairs"].items()))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    summary = {
        "metric": "differential_fuzzer", "trials": trials,
        "worst_db": {k: round(v[0], 1) for k, v in worst.items()
                     if v[1] is not None},
        "worst_cfg": {k: v[1] for k, v in worst.items() if v[1] is not None},
        "re_fs_over_141": over,
        "worst_re_fs": {k: [round(v[0], 2), v[1]] for k, v in
                        worst_fs.items() if v[1] is not None},
        "runs": runs, "device": name}
    return summary, fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=400)
    ap.add_argument("--first", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--executors", default=None,
                    help="comma-separated; default the five, and on cuda "
                         "also high, fft and sym")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch_fuzz: CUDA is not available; pass "
                           "--device cpu for the plain PyTorch path")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ex = None
    if args.executors:
        ex = tuple(args.executors.split(","))
        bad = [e for e in ex if e not in BASE + CARD]
        if bad:
            ap.error(f"unknown executors {bad}")
    t0 = time.perf_counter()
    summary, fails = sweep(args.trials, args.first, ex, args.device,
                           log=lambda s: print(s, file=sys.stderr))
    summary["seconds"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(summary))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
