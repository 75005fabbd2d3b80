"""The port's host tools against the reference package's, on the CPU.

``tools/torch_halo_model.py`` (time sharding's efficiency table),
``tools/torch_hbopt.py`` and ``tools/torch_winopt.py`` (the half-band and
Kaiser table regenerators, on ``tools/torch_optim.py``), and
``tools/torch_calc_error_table.py`` / ``tools/torch_calc_corr_table.py``
(the low-pass design's realised attenuation and its correction table),
each on the port's design and sharding layers, against
``tools/halo_model.py``, ``hbopt.py``, ``winopt.py``,
``calc_error_table.py`` and ``calc_corr_table.py`` on the reference
package: the halo table equal entry for entry; the optimisers' quick rows
(tests/test_tools_opt.py's) within that file's tolerances and equal to
the reference tools' for the same seeds; the table tools' numbers equal
to those of the reference package's design on a 3 x 3 (tb, atten) grid
to 1e-9 dB, and their printed tables equal.
"""

import numpy as np
import pytest

from tools import (torch_calc_corr_table, torch_calc_error_table,
                   torch_halo_model, torch_hbopt, torch_winopt)

#: the table tools' grid: one transition band of each correction table
#: (tb < 10 %, 10-25 %, >= 25 %) and attenuations across the design's range
TBS = (2.0, 10.0, 30.0)
ATTENS = (49.0, 133.5, 218.0)


def _ref_design():
    from r8brain_tpu.design.lpfilter import build_lp_filter
    from r8brain_tpu.utils.scan import response_mag

    return build_lp_filter, response_mag


@pytest.mark.parametrize("dst", [96000.0, 192000.0])
def test_halo_table_equals_reference(dst):
    """Every shard count 2..32 at 1, 10 and 60 s: the same geometry and
    efficiency as tools/halo_model.py."""
    from r8brain_tpu.models.plan import make_plan
    from r8brain_tpu.parallel.sharding import (chain_input_span,
                                               chain_shift_period)
    from tools import halo_model

    shards, seconds = range(2, 33), (1.0, 10.0, 60.0)
    span, rows = torch_halo_model.table(44100.0, dst, 2.0, 180.15, shards,
                                        seconds)
    plan = make_plan(44100.0, dst, 2.0, 180.15, 0)
    period = chain_shift_period(plan)
    assert span == chain_input_span(plan)
    want = [halo_model.efficiency(plan, period, span, n_t, int(sec * 44100))
            for sec in seconds for n_t in shards]
    assert [e for _sec, e in rows] == want
    assert all(0.0 < e["efficiency"] < 1.0 for e in want)


def test_halo_model_polynomial_plan(capsys):
    assert torch_halo_model.table(44100.0, 96001.0, 2.0, 180.15, [2],
                                  [1.0]) is None
    assert torch_halo_model.main(["--dst", "96001"]) == 0
    assert "time sharding unavailable" in capsys.readouterr().out


@pytest.mark.parametrize("taps,frac,cls,third", [(4, 4.0, 0, False),
                                                 (3, 6.0, 0, True)],
                         ids=["class_a_4tap", "third_band_3tap"])
def test_hbopt_quick_row(taps, frac, cls, third):
    """tests/test_tools_opt.py's quick half-band rows: within 0.5 dB of the
    shipped attenuation (the 4-tap row's taps within 1e-9), and equal to
    tools/hbopt.py's for the same seeds."""
    from tools import hbopt

    got = torch_hbopt.optimize_hb(taps, frac)
    ship_taps, ship_att = torch_hbopt.shipped_row(cls, taps, third)
    assert abs(got[2] - ship_att) <= 0.5, (got[2], ship_att)
    if not third:
        assert np.max(np.abs(got[0] - ship_taps)) < 1e-9
    ref = hbopt.optimize_hb(taps, frac)
    assert np.array_equal(got[0], ref[0]) and got[1:] == ref[1:]
    assert np.array_equal(ship_taps, hbopt.shipped_row(cls, taps, third)[0])


@pytest.mark.parametrize("bw,fl", [(2, 8), (3, 6)], ids=["coeffs2", "coeffs3"])
def test_winopt_quick_row(bw, fl):
    """tests/test_tools_opt.py's quick Kaiser rows: within 0.5 dB of the
    shipped attenuation (Coeffs2's beta and power within 0.05), and equal
    to tools/winopt.py's for the same seeds."""
    from tools import winopt

    beta, power, att, lin = torch_winopt.optimize_win(bw, fl)
    base, table = torch_winopt.shipped(bw)
    row = table[(fl - base) // 2]
    assert abs(att - row[2]) <= 0.5
    if bw == 2:
        assert abs(beta - row[0]) < 0.05 and abs(power - row[1]) < 0.05
    assert (beta, power, att, lin) == winopt.optimize_win(bw, fl)
    assert winopt.shipped(bw) == (base, table)


def test_error_table_equals_reference(monkeypatch, capsys):
    """The realised attenuation and -3 dB point on the 3 x 3 grid equal
    the reference package's design measured the same way to 1e-9 dB; the
    printed table equals tools/calc_error_table.py's (both tools' grids
    narrowed to tb 10..30 %)."""
    import r8brain_tpu.design.lpfilter as ref_lp

    import r8brain_torch.design.lpfilter as lp
    from tools import calc_error_table

    rows = torch_calc_error_table.error_rows(TBS, ATTENS)
    ref = torch_calc_error_table.error_rows(TBS, ATTENS, _ref_design())
    assert len(rows) == 9
    for (tb, a, err, dev3), (rtb, ra, rerr, rdev3) in zip(rows, ref):
        assert (tb, a) == (rtb, ra)
        assert abs(err - rerr) <= 1e-9 and abs(dev3 - rdev3) <= 1e-12
        assert err > 0.0  # the design realises at least the request
    for mod in (lp, ref_lp):
        monkeypatch.setattr(mod, "LP_MIN_TRANS_BAND", 10.0)
        monkeypatch.setattr(mod, "LP_MAX_TRANS_BAND", 30.0)
    args = ["--tb-steps", "2", "--atten-steps", "2"]
    assert torch_calc_error_table.main(args) == 0
    out = capsys.readouterr().out
    assert calc_error_table.main(args) == 0
    assert out == capsys.readouterr().out


@pytest.mark.parametrize("tb", TBS)
def test_corr_table_equals_reference(tb, capsys):
    """The fixed-point regeneration from a zero table at three
    attenuations (3 passes): the fresh table and every realised
    attenuation equal those of the reference package's design to 1e-9 dB;
    at 10 % the printed table equals tools/calc_corr_table.py's."""
    from tools import calc_corr_table

    attens = np.linspace(50.0, 217.0, 3)
    ext, rows = torch_calc_corr_table.regenerate(tb, attens, 3)
    rext, rrows = torch_calc_corr_table.regenerate(tb, attens, 3,
                                                   _ref_design())
    assert np.max(np.abs(ext - rext)) <= 1e-9
    assert np.max(np.abs(np.array(rows) - np.array(rrows))) <= 1e-9
    assert all(abs(r - a) < 0.5 for a, r, _f, _b in rows)
    if tb == 10.0:
        args = ["--tb", "10", "--points", "3", "--iters", "3"]
        assert torch_calc_corr_table.main(args) == 0
        out = capsys.readouterr().out
        assert calc_corr_table.main(args) == 0
        assert out == capsys.readouterr().out
