"""The benchmark of r8brain_torch: ``python3 benchmark/run.py --help``."""
