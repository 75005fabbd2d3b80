#!/usr/bin/env python3
"""The port's benchmark matrix: every throughput, accuracy and serving row
of tools/bench_matrix.py, run through the port's tools, one JSON line a
row.

    python tools/torch_bench_matrix.py [--round 1] [--out FILE] [--quick]
        [--device cuda|cpu] [--commit SHA]

tools/bench_matrix.py on the port.  The rows are the reference's, copied
letter for letter (labels, env overrides, argument lists, timeouts), and
run serialised, one card job at a time (concurrent jobs corrupt each
other's timing): ``BENCH_RUNS`` through tools/torch_bench.py,
``ACCURACY_RUNS`` through tools/torch_chip_accuracy.py, then the four
serving rows (``SERVE_RUNS``) through tools/torch_bench_stream.py and
tools/torch_latency_curve.py, each tool with ``--device``.  Each record
is the tool's last JSON line with ``rc``, ``label``, ``wall_s``, the
effective ``R8B_*`` / ``R8BT_*`` env (``env``) and the card
(``card``: ``nvidia-smi --query-gpu=name,power.limit``); a timeout or a
garbled line becomes an ``error`` record and the sweep goes on.  The
first line (``_meta``) names the commit (``--commit``, by default ``git
rev-parse HEAD``: a copy without ``.git`` names it so), the SHA-256 of the
code the rows run (``code_sha256``: ``r8brain_torch/`` and the four
tools), the device and the card.  Each record is appended as its row
ends, so a cut run keeps the rows it measured.

The output is ``BENCHMATRIX_torch_r<N>.json`` (``--round``) at the repo
root, or ``BENCHMATRIX_torch_quick.json`` under ``--quick`` (the first
two throughput rows); neither can be a pre-port ``BENCHMATRIX_r<N>.json``,
which ``--out`` refuses too.  ``--device`` is ``cuda`` by default and
raises without CUDA; ``cpu`` exists for the smoke tests
(tests/test_torch_bench_matrix.py), and no number of it is a device
figure.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

BENCH_TOOL = "tools/torch_bench.py"
ACC_TOOL = "tools/torch_chip_accuracy.py"
STREAM_TOOL = "tools/torch_bench_stream.py"
CURVE_TOOL = "tools/torch_latency_curve.py"
# what the rows run, hashed into _meta's code_sha256
CODE = ("r8brain_torch", BENCH_TOOL, ACC_TOOL, STREAM_TOOL, CURVE_TOOL)
# the reference's committed round files, which this tool never writes
PRE_PORT = re.compile(r"BENCHMATRIX_r\d+\.json")

BENCH_RUNS = [
    # (label, env overrides, timeout seconds)
    ("flagship_fast", {}, 1800),
    ("flagship_high", {"R8B_BENCH_PRECISION": "high"}, 1800),
    ("down_96k_44k_fast", {"R8B_BENCH_SRC": "96000",
                           "R8B_BENCH_DST": "44100"}, 1800),
    ("down_96k_44k_high", {"R8B_BENCH_SRC": "96000",
                           "R8B_BENCH_DST": "44100",
                           "R8B_BENCH_PRECISION": "high"}, 1800),
    ("up_44k_48k_fast", {"R8B_BENCH_SRC": "44100",
                         "R8B_BENCH_DST": "48000"}, 1800),
    ("up_44k_48k_high", {"R8B_BENCH_SRC": "44100",
                         "R8B_BENCH_DST": "48000",
                         "R8B_BENCH_PRECISION": "high"}, 1800),
    ("poly_96001_fast", {"R8B_BENCH_SRC": "44100",
                         "R8B_BENCH_DST": "96001"}, 1800),
    ("poly_96001_high", {"R8B_BENCH_SRC": "44100",
                         "R8B_BENCH_DST": "96001",
                         "R8B_BENCH_PRECISION": "high"}, 1800),
    ("dsd64_to_96k", {"R8B_BENCH_SRC": "2822400", "R8B_BENCH_DST": "96000",
                      "R8B_BENCH_ATTEN": "150", "R8B_BENCH_CHANNELS": "64",
                      "R8B_BENCH_SECONDS": "0.25",
                      "R8B_BENCH_METRIC": "dsd64_to_96k_throughput"}, 2400),
    ("pcm_to_dsd64", {"R8B_BENCH_SRC": "44100", "R8B_BENCH_DST": "2822400",
                      "R8B_BENCH_ATTEN": "150", "R8B_BENCH_CHANNELS": "64",
                      "R8B_BENCH_SECONDS": "0.25",
                      "R8B_BENCH_METRIC": "pcm_to_dsd64_throughput"}, 2400),
    ("hp_dfft5_guarantee", {"R8B_BENCH_PRECISION": "high",
                            "R8B_BENCH_FUSED": "0",
                            "R8B_BENCH_ENGINE": "pallas_fft5",
                            "R8B_BENCH_METRIC": "hp_dfft5_guarantee"}, 2400),
    ("hp_dfft4_guarantee", {"R8B_BENCH_PRECISION": "high",
                            "R8B_BENCH_FUSED": "0",
                            "R8B_BENCH_ENGINE": "pallas_fft4",
                            "R8B_BENCH_METRIC": "hp_dfft4_guarantee"}, 2400),
    ("ozaki_guarantee", {"R8B_BENCH_PRECISION": "high",
                         "R8B_BENCH_FUSED": "0",
                         "R8B_BENCH_ENGINE": "ozaki",
                         "R8B_BENCH_METRIC": "ozaki_guarantee"}, 2400),
    # the guarantee chain with the df32 inter-stage carry off
    # (R8BT_DF_CARRY=0: per-seam rounding), beside the carry-on row
    ("ozaki_guarantee_nocarry", {"R8B_BENCH_PRECISION": "high",
                                 "R8B_BENCH_FUSED": "0",
                                 "R8B_BENCH_ENGINE": "ozaki",
                                 "R8BT_DF_CARRY": "0",
                                 "R8B_BENCH_METRIC":
                                     "ozaki_guarantee_nocarry"}, 2400),
    ("preset_16", {"R8B_BENCH_ATTEN": "136.45"}, 1800),
    ("preset_16IR", {"R8B_BENCH_ATTEN": "109.56"}, 1800),
    ("preset_def", {"R8B_BENCH_ATTEN": "206.91"}, 1800),
    ("fast_10k_channels", {"R8B_BENCH_CHANNELS": "10240",
                           "R8B_BENCH_ITERS": "4",
                           "R8B_BENCH_METRIC": "fast_10k_channels"}, 2400),
]

ACCURACY_RUNS = [
    # (label, tools/torch_chip_accuracy.py arguments, timeout seconds)
    ("acc_flagship", ["--configs",
                      "fast,high,high_toeplitz,hp_dfft_pallas5,"
                      "hp_dfft_pallas4,ozaki"], 3600),
    ("acc_poly", ["--src", "44100", "--dst", "96001",
                  "--configs", "fast,high,ozaki"], 2400),
    ("acc_dsd", ["--src", "2822400", "--dst", "96000", "--atten", "150",
                 "--seconds", "0.25", "--channels", "2",
                 "--configs", "fast,ozaki"], 3600),
    # the minimum-phase chain
    ("acc_minphase", ["--phase", "1",
                      "--configs", "fast,high,ozaki"], 2400),
    # attenuation on the flagship ratio: the presets and the 218 cap
    ("acc_flag_a109", ["--atten", "109.56",
                       "--configs", "fast,high,ozaki"], 1800),
    ("acc_flag_a136", ["--atten", "136.45",
                       "--configs", "fast,high,ozaki"], 1800),
    ("acc_flag_a218", ["--atten", "218",
                       "--configs", "fast,high,ozaki"], 1800),
    # the transition band's limits (CDSPFIRFilter.h:77-90)
    ("acc_flag_tb05", ["--tb", "0.5",
                       "--configs", "fast,high,ozaki"], 3600),
    ("acc_flag_tb45", ["--tb", "45",
                       "--configs", "fast,high,ozaki"], 2400),
    # downsampling
    ("acc_down", ["--src", "96000", "--dst", "44100",
                  "--configs", "fast,high,ozaki"], 1800),
    ("acc_down_a218", ["--src", "96000", "--dst", "44100",
                       "--atten", "218",
                       "--configs", "fast,high,ozaki"], 2400),
    # the fractional bank's ratio
    ("acc_48k", ["--src", "44100", "--dst", "48000",
                 "--configs", "fast,high,ozaki"], 1800),
    ("acc_48k_a136", ["--src", "44100", "--dst", "48000",
                      "--atten", "136.45",
                      "--configs", "fast,high,ozaki"], 2400),
    # the polynomial interpolator's corners
    ("acc_poly_a136", ["--src", "44100", "--dst", "96001",
                       "--atten", "136.45",
                       "--configs", "fast,high,ozaki"], 2400),
    ("acc_poly_a218", ["--src", "44100", "--dst", "96001",
                       "--atten", "218",
                       "--configs", "fast,high,ozaki"], 2400),
    # PCM -> DSD64 (the up direction of the SACD workload)
    ("acc_to_dsd", ["--src", "44100", "--dst", "2822400", "--atten", "150",
                    "--seconds", "0.05", "--channels", "2",
                    "--configs", "fast,ozaki"], 3600),
]

SERVE_RUNS = [
    # (label, tool, env overrides, timeout seconds): the serving rows,
    # rational and polynomial (tools/bench_matrix.py:190-209)
    ("stream_throughput", STREAM_TOOL, {}, 2400),
    ("stream_latency_curve", CURVE_TOOL, {}, 3600),
    ("stream_throughput_poly", STREAM_TOOL, {"R8B_SBENCH_DST": "96001"},
     3600),
    ("stream_latency_curve_poly", CURVE_TOOL, {"R8B_LBENCH_DST": "96001"},
     3600),
]


def rows(quick: bool = False):
    """Every row in the reference's order: (label, tool, tool arguments,
    env overrides, timeout)."""
    out = [(label, BENCH_TOOL, [], env, to) for label, env, to in
           (BENCH_RUNS[:2] if quick else BENCH_RUNS)]
    if not quick:
        out += [(label, ACC_TOOL, args, {}, to)
                for label, args, to in ACCURACY_RUNS]
        out += [(label, tool, [], env, to)
                for label, tool, env, to in SERVE_RUNS]
    return out


def code_sha256(root: Path = ROOT) -> str:
    """SHA-256 over the paths and bytes of every file the rows run
    (CODE; build outputs and bytecode left out)."""
    h = hashlib.sha256()
    for name in CODE:
        p = root / name
        files = [p] if p.is_file() else sorted(
            f for f in p.rglob("*") if f.is_file()
            and "_build" not in f.parts and "__pycache__" not in f.parts)
        for f in files:
            h.update(f.relative_to(root).as_posix().encode() + b"\0")
            h.update(f.read_bytes() + b"\0")
    return h.hexdigest()


def card_of(device: str) -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives it (its first line), or "cpu"."""
    if device == "cpu":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()


def run_one(label, cmd, env, timeout, card, out_path):
    """One row: ``cmd`` under ``env`` from the repo root, its last JSON
    line as the record, with rc, label, wall_s, the effective R8B_* /
    R8BT_* env and the card, appended to ``out_path``; a garbled line or
    a timeout becomes an ``error`` record (the sweep goes on)."""
    # the effective config (the row's overrides and any R8B*_ variable of
    # the caller's shell), so a polluted environment shows in the record
    cfg = {k: v for k, v in sorted(env.items())
           if k.startswith(("R8B_", "R8BT_"))}
    t0 = time.time()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=str(ROOT), timeout=timeout)
        lines = [ln for ln in r.stdout.strip().splitlines()
                 if ln.startswith("{")]
        try:
            rec = json.loads(lines[-1]) if lines else {}
        except json.JSONDecodeError as e:
            rec = {"error": f"bad json: {e}; line={lines[-1][:200]}"}
        rec["rc"] = r.returncode
        if r.returncode and "error" not in rec and not lines:
            rec["error"] = r.stderr[-500:]
    except subprocess.TimeoutExpired:
        rec = {"rc": -1, "error": f"timeout after {timeout}s"}
    rec["label"] = label
    rec["wall_s"] = round(time.time() - t0, 1)
    if cfg:
        rec["env"] = cfg
    rec["card"] = card
    with open(out_path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(f"{label:26s} {json.dumps(rec)[:160]}", file=sys.stderr)
    return rec


def read_matrix(path):
    """The records of a matrix file, _meta first."""
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--round", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="the first two throughput rows only (smoke)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--commit", default=None,
                    help="the commit to name in _meta (default: git "
                         "rev-parse HEAD)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("torch_bench_matrix: CUDA is not available "
                               "(--device cpu runs the plain versions, for "
                               "the smoke test only)")
    out_path = Path(args.out or ROOT / (
        "BENCHMATRIX_torch_quick.json" if args.quick
        else f"BENCHMATRIX_torch_r{args.round}.json"))
    if PRE_PORT.fullmatch(out_path.name):
        ap.error(f"{out_path.name} is a reference round file")
    commit = args.commit or subprocess.run(
        ["git", "rev-parse", "HEAD"], cwd=str(ROOT), capture_output=True,
        text=True).stdout.strip()
    card = card_of(args.device)
    with open(out_path, "w") as f:
        f.write(json.dumps({"label": "_meta", "commit": commit,
                            "code_sha256": code_sha256(),
                            "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
                            "device": args.device, "card": card,
                            "tool": "tools/torch_bench_matrix.py"}) + "\n")
    for label, tool, tool_args, env_extra, to in rows(args.quick):
        env = os.environ.copy()
        env.update(env_extra)
        run_one(label, [sys.executable, tool, *tool_args, "--device",
                        args.device], env, to, card, out_path)
    print(f"matrix written to {out_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
