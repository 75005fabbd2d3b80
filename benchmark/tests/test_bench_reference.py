"""The plain reference against the program's oracle (float64) and the
program's CPU path (float32), on 2 channels of both plans, oneshot and a
5-block stream."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness.check import oneshot_source, stream_source
from benchmark.reference import Chain, make_plan, stage_out_len

RATES = [(44100.0, 96000.0), (44100.0, 96001.0)]


def _x(n, seed=7):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((2, n), generator=g, dtype=torch.float32) * 2 - 1


@pytest.mark.parametrize("src,dst", RATES + [(44100.0, 192000.0),
                                             (192000.0, 44100.0)])
def test_reference_equals_the_oracle(src, dst):
    from r8brain_torch.models.oracle import OracleResampler

    x = _x(5000)
    n = int(np.floor(5000 * dst / src))
    y = Chain(make_plan(src, dst, 2.0, 180.15, 0), "cpu").run(
        oneshot_source(x)(0, 2), 0, n).numpy()
    for r in range(2):
        o = OracleResampler(src, dst, 4096, 2.0, 180.15).oneshot(
            x[r].double().numpy())
        assert np.abs(y[r] - o).max() < 1e-13


@pytest.mark.parametrize("src,dst", RATES)
def test_program_oneshot_within_the_class(src, dst):
    from r8brain_torch import Resampler

    x = _x(8000)
    rs = Resampler(src, dst, 2.0, 180.15, device="cpu")
    y = rs.oneshot(x).double()
    ref = Chain(make_plan(src, dst, 2.0, 180.15, 0), "cpu").run(
        oneshot_source(x)(0, 2), 0, y.shape[1])
    rms = (y - ref).square().mean(dim=1).sqrt().max().item()
    assert rms < 10 ** (-141 / 20)


@pytest.mark.parametrize("src,dst", RATES)
def test_program_stream_blocks_at_their_positions(src, dst):
    from r8brain_torch import Resampler, StreamResampler

    rs = Resampler(src, dst, 2.0, 180.15, device="cpu")
    st = StreamResampler(rs, 1024)
    L = st.block
    g = torch.Generator().manual_seed(11)
    pool = torch.rand((2, 2, L), generator=g) * 2 - 1
    plan = make_plan(src, dst, 2.0, 180.15, 0)
    chain = Chain(plan, "cpu")

    def emitted(n):
        for s in plan.stages:
            n = stage_out_len(s, n)
        return n

    pos = 0
    for j in range(5):
        y = st.process_block_device(pool[j % 2]).double()
        # the polynomial plan re-blocks its suffix: fewer outputs at first
        assert pos + y.shape[1] <= emitted((j + 1) * L)
        ref = chain.run(stream_source(pool)(0, 2), pos, pos + y.shape[1])
        if y.shape[1]:
            assert (y - ref).abs().max().item() < 1e-6
        pos += y.shape[1]
