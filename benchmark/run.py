#!/usr/bin/env python3
"""Run one cell of the benchmark of r8brain_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout.  Loads the cell's configuration and mix by
the names in ``BENCHMARK.json``, sets up, warms up, measures for
``--seconds`` and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics; with ``--trace 1`` its per-layer ones, read from
``torch.profiler`` over the window), ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number that decided ``correct``
beside its limit, which also end standard error.  An earlier line names
the card and its power limit.  Exits non-zero and prints no result
without CUDA or with fewer cards than the cell asks for, or when
``jax``, ``jaxlib``, ``flax`` or ``r8brain_tpu`` is loaded once the
window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: Top-level module names that the process may not hold: JAX and the
#: JAX package, compared whole (r8brain_torch begins with r8brain).
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "r8brain_tpu"})


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return f"card: {out.splitlines()[0] if out else 'nvidia-smi not readable'}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness.spec import Bench

    chips = Bench(ROOT).workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {args.workload} needs {chips} CUDA "
              f"device(s), found {n}", file=sys.stderr)
        return 2
    from benchmark.harness.cell import execute

    out = execute(ROOT, args.workload, args.seed, args.seconds,
                  bool(args.trace), "cuda", T_START)
    info = out.pop("_info")
    print(card_line())
    print("run: " + json.dumps(info))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {bad} after the window",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
