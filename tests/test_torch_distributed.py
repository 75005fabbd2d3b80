"""The port's sharding across a real process boundary: two processes on
the CPU, one shard each, joined by torch.distributed over gloo.

The counterpart of tests/test_distributed.py (jax.distributed).  Each
process runs one shard of a 2-shard mesh in both orientations: ("ch", "t")
of shape (2, 1), where channel shards cross the boundary, and ("t", "ch")
of shape (2, 1), where the time halos (and the stream's carry and halos)
cross it.  Each rank loads only its own piece of the input
(``shard_slices``) and checks its own piece of the output against the
unsharded port: float64 within -260 dB, float32 within -125 dB (the
bounds of tests/test_sharding.py and tests/test_sharding_f32.py).

Run as a script, this file is the worker: ``python
tests/test_torch_distributed.py RANK PORT``.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sharded_parity():
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), port], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=str(ROOT))
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        assert f"rank {r} PASS" in out, out[-3000:]
        assert "time-halos" in out and "channels" in out, out[-3000:]


def _db(d) -> float:
    import numpy as np

    d = np.asarray(d, np.float64)
    return float(10.0 * np.log10(np.mean(d * d) + 1e-300)) if d.size \
        else -3000.0


def _worker(rank: int, port: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from r8brain_torch import (Mesh, Resampler, ShardedResampler,
                               ShardedStreamResampler)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    try:
        C, n = 4, 20000
        x = np.random.default_rng(0).standard_normal((C, n))
        for names, tag in ((("ch", "t"), "channels"),
                           (("t", "ch"), "time-halos")):
            mesh = Mesh((WORLD, 1), names, group=dist.group.WORLD)
            for src, dst, dtype, bound in (
                    (44100, 96000, torch.float32, -125.0),
                    (44100, 96000, torch.float64, -260.0),
                    (44100, 96001, torch.float64, -260.0)):
                rs = Resampler(src, dst, 2.0, 160.0, 0, dtype=dtype,
                               device="cpu")
                xs = torch.from_numpy(x).to(dtype)
                out_len = rs.default_out_len(n)
                srs = ShardedResampler(rs, mesh)
                rows, t_in, t_out = srs.shard_slices(C, n, out_len)
                y = srs.oneshot(xs[rows, t_in], out_len, n_in=n, channels=C)
                ref = rs.oneshot(xs, out_len)[rows, t_out]
                assert y.shape == ref.shape, (tag, y.shape, ref.shape)
                d = _db((y.double() - ref.double()).numpy())
                assert d < bound, (tag, dst, dtype, d)
                print(f"rank {rank} {tag} {dst} {dtype}: piece "
                      f"{tuple(y.shape)} {d:.1f} dB", flush=True)
            # the stream: each rank pushes its segment of every block
            rs = Resampler(44100, 96000, 2.0, 160.0, 0, dtype=torch.float64,
                           device="cpu")
            ss = ShardedStreamResampler(rs, mesh, seg_len=2048)
            xs = torch.from_numpy(np.random.default_rng(1).standard_normal(
                (C, 2 * ss.block)))
            out_len = rs.default_out_len(xs.shape[1])
            ref = rs.oneshot(xs, out_len)
            rows, t_in = ss.shard_slices(C)
            worst = -3000.0
            for b in range(2):
                y = ss.process_block(xs[rows, b * ss.block + t_in.start :
                                        b * ss.block + t_in.stop])
                before, counts = ss._counts
                pos = before + sum(counts[: mesh.coord(mesh.rank)[1]])
                want = ref[rows, pos : pos + y.shape[1]]
                worst = max(worst, _db((y - want).numpy()))
            assert worst < -260.0, (tag, "stream", worst)
            print(f"rank {rank} {tag} stream: {worst:.1f} dB", flush=True)
        print(f"rank {rank} PASS", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(int(sys.argv[1]), sys.argv[2])
