"""The kernel calls of the benchmark's six cells, pinned.

Recorders stand in for ``frac_whole`` and ``ozaki_framed`` wherever the
port holds them, return zeros of the output's shape (so no kernel time is
spent) and keep each call's inputs: every tensor's shape, dtype, strides,
storage offset mod 4 (its alignment) and a digest of its values, the
geometry, the fold width ``kc``, the band's steps, ``frac_whole``'s window
origin ``start``, the seam residual ``x_lo`` and ``emit_pair``.  The
configurations are the cells' (44.1k -> 96k fast, its stream blocks,
44.1k -> 96001 fast, the 44.1k -> 96k guarantee chain, DSD64 -> 176.4k,
44.1k -> DSD64 on the half-band up cascade), at two channels and the
cells' input lengths (DSD64 -> 176.4k at 16384 samples, 44.1k -> DSD64 at
its cell's 0.5 s).  The calls are those the card receives: ``frac_whole``
reads its stage's input in place (``ops/operators.py::_reads_in_place`` taken
as on the card, whatever the device).  A change to how an executor frames
its input or stores its operator that reaches a kernel shows here, and so
does the width of the copies the kernel stages its windows with.

The file imports nothing of JAX.
"""

import hashlib
import sys

import numpy as np
import pytest
import torch

from r8brain_torch import Resampler, StreamResampler
from r8brain_torch.ops import operators, pallas_frac, pallas_ozaki

C = 2
N_ONESHOT = 44100   # 1 s at 44.1 kHz, the oneshot cells' row
BLOCK = 8192        # the stream cell's block, 8232 after the period
N_BLOCKS = 3        # the head block and two steady ones

N_DSD = 16384       # DSD64 samples a row: a short length
N_PCM_DSD = 22050   # 0.5 s at 44.1 kHz, the DSD64 encoding cell's row

CELLS = {
    "cd24_96k_oneshot": (dict(dst_rate=96000), "oneshot"),
    "cd24_96k_stream": (dict(dst_rate=96000), "stream"),
    "cd24_96001_oneshot": (dict(dst_rate=96001), "oneshot"),
    "guarantee24_96k_oneshot": (dict(dst_rate=96000, precision="high",
                                     conv_engine="ozaki",
                                     frac_engine="ozaki"), "oneshot"),
    "cd24_dsd64_176k4_oneshot": (dict(src_rate=2822400, dst_rate=176400),
                                 "oneshot"),
    "cd24_44k1_dsd64_oneshot": (dict(dst_rate=2822400, n_in=N_PCM_DSD),
                                "oneshot"),
}


def _digest(t: torch.Tensor) -> str:
    b = t.detach().contiguous()
    if b.dtype == torch.bfloat16:
        b = b.view(torch.int16)
    return hashlib.sha1(b.numpy().tobytes()).hexdigest()[:12]


def _tensor(t):
    """(shape, dtype, strides, storage offset mod 4, value digest)."""
    if t is None:
        return None
    return (tuple(t.shape), str(t.dtype).rsplit(".", 1)[-1],
            tuple(t.stride()), t.storage_offset() % 4, _digest(t))


def _recorders(calls, widths=None):
    def frac_whole(x, parts, I, D, O, n_win, kc=pallas_frac.KC,
                   band=None, start=0):
        calls.append(("frac_whole", _tensor(x), _tensor(parts),
                      (I, D, O, n_win), kc,
                      None if band is None else band.host, start))
        if widths is not None:
            widths.append(copy_width(x, start, I, D, O))
        return x.new_zeros((x.shape[0], n_win * O))

    def ozaki_framed(xp, sx, T_parts, L_f, hop, Kcols, n_blocks, x_lo=None,
                     emit_pair=False, packed=None):
        calls.append(("ozaki_framed", _tensor(xp), _tensor(sx),
                      _tensor(T_parts), (L_f, hop, Kcols, n_blocks),
                      _tensor(x_lo), emit_pair,
                      None if packed is None
                      else tuple(_tensor(p) for p in packed)))
        y = xp.new_zeros((xp.shape[0], n_blocks * Kcols))
        return (y, y.to(torch.bfloat16)) if emit_pair else y

    return {"frac_whole": (pallas_frac.frac_whole, frac_whole),
            "ozaki_framed": (pallas_ozaki.ozaki_framed, ozaki_framed)}


def copy_width(x, start, I, D, O) -> int:
    """The copy width, in bytes, that the launch hands the float32 kernel
    for this call (``pallas_frac.copy_width``, from the origin the launch
    moves to: start less ``lead_rows``)."""
    s = pallas_frac.lead_rows(x, start, I, D, O)
    return pallas_frac.copy_width(x, start - s, I, O)


def record(cell, monkeypatch, in_place=True, widths=None):
    """Every kernel call of ``cell``'s configuration, in order, as the
    card receives them (``in_place``) or with every input framed first,
    as the CPU runs them; ``widths`` collects each frac_whole call's
    copy_width."""
    kwargs, kind = CELLS[cell]
    monkeypatch.delenv("R8BT_DF_CARRY", raising=False)
    if in_place:
        monkeypatch.setattr(operators, "_reads_in_place",
                            lambda x, dtype: x.dtype == dtype
                            and x.stride(1) == 1)
    calls = []
    for name, (orig, rec) in _recorders(calls, widths).items():
        for mod_name, mod in list(sys.modules.items()):
            if mod_name.startswith("r8brain_torch") \
                    and getattr(mod, name, None) is orig:
                monkeypatch.setattr(mod, name, rec)
    kwargs = dict(kwargs)
    src = kwargs.pop("src_rate", 44100)
    n = kwargs.pop("n_in", N_DSD if src != 44100 else N_ONESHOT)
    rs = Resampler(src, trans_band=2.0, atten=180.15, device="cpu",
                   **kwargs)
    rng = np.random.default_rng(24)
    if kind == "oneshot":
        x = rng.uniform(-1, 1, (C, n)).astype(np.float32)
        rs.oneshot(torch.from_numpy(x))
    else:
        st = StreamResampler(rs, BLOCK)
        for _ in range(N_BLOCKS):
            x = rng.uniform(-1, 1, (C, st.block)).astype(np.float32)
            st.process_block_device(torch.from_numpy(x))
    return calls


@pytest.mark.parametrize("cell", list(CELLS))
def test_kernel_calls_pinned(cell, monkeypatch):
    assert record(cell, monkeypatch) == PINS[cell]


#: Each frac_whole call's copy width, read in place (the card's) and on
#: the framed copy each call had before the kernel read in place.
WIDTHS = {'cd24_96001_oneshot': ([16, 16], [16, 16]),
 'cd24_96k_oneshot': ([8], [8]),
 'cd24_96k_stream': ([8, 8, 8], [8, 8, 8]),
 'cd24_dsd64_176k4_oneshot': ([16, 16, 16, 16], [8, 8, 8, 16]),
 'cd24_44k1_dsd64_oneshot': ([16, 16], [16, 4])}


@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if not c.startswith("guarantee")])
def test_copy_widths_pinned(cell, monkeypatch):
    """No frac_whole call stages its windows with a narrower copy read in
    place than on its framed copy: the fused flagship's odd origin moves
    one row back (8-byte copies, as framed), the half-band decimators'
    origins 1 - 2*nt move up to 3 back and read 16-byte copies (8-byte on
    their framed copies, whose row stride was 2 mod 4), and the half-band
    up cascade reads 16-byte copies (4-byte on its framed copy)."""
    direct, framed = [], []
    record(cell, monkeypatch, widths=direct)
    monkeypatch.undo()
    record(cell, monkeypatch, in_place=False, widths=framed)
    assert len(direct) == len(framed)
    assert all(d >= f for d, f in zip(direct, framed))
    assert (direct, framed) == WIDTHS[cell]


#: The calls at the cells' configurations, in order.
PINS = {'cd24_96001_oneshot': [('frac_whole',
                         ((2, 44600),
                          'float32',
                          (44600, 1),
                          0,
                          'de500c81d551'),
                         ((4, 16, 3, 128, 64),
                          'bfloat16',
                          (393216, 24576, 8192, 64, 1),
                          0,
                          '51e0191f7d73'),
                         (256, 964, 512, 173),
                         32,
                         ((0, 49), (4, 53), (8, 57), (12, 61)),
                         -354),
                        ('frac_whole',
                         ((2, 48256),
                          'float32',
                          (48256, 1),
                          0,
                          '4912370a5828'),
                         ((4, 9, 3, 128, 64),
                          'bfloat16',
                          (221184, 24576, 8192, 64, 1),
                          0,
                          '809efe3ce7d7'),
                         (256, 561, 512, 188),
                         32,
                         ((0, 24), (4, 28), (8, 32), (12, 36)),
                         -152)],
 'cd24_96k_oneshot': [('frac_whole',
                       ((2, 44460), 'float32', (44460, 1), 0, 'd08f0b647aa3'),
                       ((5, 17, 3, 128, 64),
                        'bfloat16',
                        (417792, 24576, 8192, 64, 1),
                        0,
                        'c87f83dcd486'),
                       (294, 1027, 640, 150),
                       32,
                       ((0, 49), (3, 53), (7, 56), (11, 60), (14, 64)),
                       -359)],
 'cd24_96k_stream': [('frac_whole',
                      ((2, 8232), 'float32', (8232, 1), 0, 'f939b1071516'),
                      ((5, 17, 3, 128, 64),
                       'bfloat16',
                       (417792, 24576, 8192, 64, 1),
                       0,
                       'c87f83dcd486'),
                      (294, 1027, 640, 27),
                      32,
                      ((0, 49), (3, 53), (7, 56), (11, 60), (14, 64)),
                      -359),
                     ('frac_whole',
                      ((2, 9114), 'float32', (9114, 1), 0, '54910f104147'),
                      ((5, 17, 3, 128, 64),
                       'bfloat16',
                       (417792, 24576, 8192, 64, 1),
                       0,
                       'c87f83dcd486'),
                      (294, 1027, 640, 30),
                      32,
                      ((0, 49), (3, 53), (7, 56), (11, 60), (14, 64)),
                      -359),
                     ('frac_whole',
                      ((2, 9114), 'float32', (9114, 1), 0, '7e906b483dbb'),
                      ((5, 17, 3, 128, 64),
                       'bfloat16',
                       (417792, 24576, 8192, 64, 1),
                       0,
                       'c87f83dcd486'),
                      (294, 1027, 640, 30),
                      32,
                      ((0, 49), (3, 53), (7, 56), (11, 60), (14, 64)),
                      -359)],
 'cd24_dsd64_176k4_oneshot': [('frac_whole',
                               ((2, 22148),
                                'float32',
                                (22148, 1),
                                0,
                                '13c7c8df2c1e'),
                               ((1, 5, 3, 128, 64),
                                'bfloat16',
                                (122880, 24576, 8192, 64, 1),
                                0,
                                'da04de5e6b2a'),
                               (256, 274, 128, 87),
                               32,
                               ((0, 18),),
                               -9),
                              ('frac_whole',
                               ((2, 11070),
                                'float32',
                                (11136, 1),
                                0,
                                'bc954e68a1fe'),
                               ((1, 5, 3, 128, 64),
                                'bfloat16',
                                (122880, 24576, 8192, 64, 1),
                                0,
                                '3a55a6e49b35'),
                               (256, 278, 128, 44),
                               32,
                               ((0, 18),),
                               -11),
                              ('frac_whole',
                               ((2, 5530),
                                'float32',
                                (5632, 1),
                                0,
                                '9fab14351de6'),
                               ((1, 5, 3, 128, 64),
                                'bfloat16',
                                (122880, 24576, 8192, 64, 1),
                                0,
                                'e12804c7c145'),
                               (256, 298, 128, 22),
                               32,
                               ((0, 19),),
                               -21),
                              ('frac_whole',
                               ((2, 2755),
                                'float32',
                                (2816, 1),
                                0,
                                '3e3d9ad4e008'),
                               ((2, 31, 3, 128, 64),
                                'bfloat16',
                                (761856, 24576, 8192, 64, 1),
                                0,
                                '23a7542ba211'),
                               (512, 1927, 256, 4),
                               32,
                               ((0, 105), (16, 121)),
                               -708)],
 'guarantee24_96k_oneshot': [('ozaki_framed',
                              ((2, 45312),
                               'float32',
                               (45312, 1),
                               0,
                               'b6ca9896b043'),
                              ((2, 1), 'float32', (1, 1), 0, 'b01abf7d0dfa'),
                              ((4, 964, 512),
                               'bfloat16',
                               (493568, 512, 1),
                               0,
                               'a41c5bf82c0d'),
                              (964, 256, 512, 173),
                              None,
                              True,
                              (((16, 16, 4, 32, 64),
                                'bfloat16',
                                (131072, 8192, 2048, 64, 1),
                                0,
                                '28f24a79f78a'),
                               ((16, 2), 'int32', (2, 1), 0, 'dd1989a2241e'))),
                             ('ozaki_framed',
                              ((2, 88587),
                               'float32',
                               (88587, 1),
                               0,
                               '4890914c8787'),
                              ((2, 1), 'float32', (1, 1), 0, 'b01abf7d0dfa'),
                              ((4, 170, 160),
                               'bfloat16',
                               (27200, 160, 1),
                               0,
                               '004005f28666'),
                              (170, 147, 160, 600),
                              ((2, 88587),
                               'bfloat16',
                               (88587, 1),
                               0,
                               '89c333bdb59b'),
                              False,
                              (((5, 3, 4, 32, 64),
                                'bfloat16',
                                (24576, 8192, 2048, 64, 1),
                                0,
                                'a5240ca60c79'),
                               ((5, 2), 'int32', (2, 1), 0, '972a466ebd75')))],
 'cd24_44k1_dsd64_oneshot': [('frac_whole',
                              ((2, 22412),
                               'float32',
                               (22412, 1),
                               0,
                               '87025332ae15'),
                              ((4, 16, 3, 128, 64),
                               'bfloat16',
                               (393216, 24576, 8192, 64, 1),
                               0,
                               '51e0191f7d73'),
                              (256, 964, 512, 87),
                              32,
                              ((0, 49), (4, 53), (8, 57), (12, 61)),
                              -354),
                             ('frac_whole',
                              ((2, 44116),
                               'float32',
                               (44544, 1),
                               0,
                               'fa040d5ec457'),
                              ((32, 3, 3, 128, 64),
                               'bfloat16',
                               (73728, 24576, 8192, 64, 1),
                               0,
                               'd89ad198f9c8'),
                              (128, 157, 4096, 345),
                              32,
                              ((0, 3),
                               (0, 3),
                               (0, 3),
                               (0, 3),
                               (1, 4),
                               (1, 4),
                               (1, 4),
                               (1, 4),
                               (2, 5),
                               (2, 5),
                               (2, 5),
                               (2, 5),
                               (3, 6),
                               (3, 6),
                               (3, 6),
                               (3, 6),
                               (4, 7),
                               (4, 7),
                               (4, 7),
                               (4, 7),
                               (5, 8),
                               (5, 8),
                               (5, 8),
                               (5, 8),
                               (6, 9),
                               (6, 9),
                               (6, 9),
                               (6, 9),
                               (7, 10),
                               (7, 10),
                               (7, 10),
                               (7, 10)),
                              -14)]}
