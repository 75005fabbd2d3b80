"""The kernel calls of the benchmark's four cells, pinned.

Recorders stand in for ``frac_whole`` and ``ozaki_framed`` wherever the
port holds them, return zeros of the output's shape (so no kernel time is
spent) and keep each call's inputs: every tensor's shape, dtype, strides,
storage offset mod 4 (its alignment) and a digest of its values, the
geometry, the fold width ``kc``, the band's steps, the seam residual
``x_lo`` and ``emit_pair``.  The configurations are the cells' (44.1k ->
96k fast, its stream blocks, 44.1k -> 96001 fast, the 44.1k -> 96k
guarantee chain), at two channels and the cells' input lengths.  A change
to how an executor frames its input or stores its operator that reaches a
kernel shows here.

The file imports nothing of JAX.
"""

import hashlib
import sys

import numpy as np
import pytest
import torch

from r8brain_torch import Resampler, StreamResampler
from r8brain_torch.ops import pallas_frac, pallas_ozaki

C = 2
N_ONESHOT = 44100   # 1 s at 44.1 kHz, the oneshot cells' row
BLOCK = 8192        # the stream cell's block, 8232 after the period
N_BLOCKS = 3        # the head block and two steady ones

CELLS = {
    "cd24_96k_oneshot": (dict(dst_rate=96000), "oneshot"),
    "cd24_96k_stream": (dict(dst_rate=96000), "stream"),
    "cd24_96001_oneshot": (dict(dst_rate=96001), "oneshot"),
    "guarantee24_96k_oneshot": (dict(dst_rate=96000, precision="high",
                                     conv_engine="ozaki",
                                     frac_engine="ozaki"), "oneshot"),
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


def _recorders(calls):
    def frac_whole(xp, parts, I, D, O, n_win, kc=pallas_frac.KC,
                   band=None):
        calls.append(("frac_whole", _tensor(xp), _tensor(parts),
                      (I, D, O, n_win), kc,
                      None if band is None else band.host))
        return xp.new_zeros((xp.shape[0], n_win * O))

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


def record(cell, monkeypatch):
    """Every kernel call of ``cell``'s configuration, in order."""
    kwargs, kind = CELLS[cell]
    monkeypatch.delenv("R8BT_DF_CARRY", raising=False)
    calls = []
    for name, (orig, rec) in _recorders(calls).items():
        for mod_name, mod in list(sys.modules.items()):
            if mod_name.startswith("r8brain_torch") \
                    and getattr(mod, name, None) is orig:
                monkeypatch.setattr(mod, name, rec)
    rs = Resampler(44100, trans_band=2.0, atten=180.15, device="cpu",
                   **kwargs)
    rng = np.random.default_rng(24)
    if kind == "oneshot":
        x = rng.uniform(-1, 1, (C, N_ONESHOT)).astype(np.float32)
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


#: The calls at the cells' configurations, in order.
PINS = {'cd24_96001_oneshot': [('frac_whole',
                         ((2, 45312), 'float32', (45312, 1), 0,
                          'b6ca9896b043'),
                         ((4, 16, 3, 128, 64), 'bfloat16',
                          (393216, 24576, 8192, 64, 1), 0, '51e0191f7d73'),
                         (256, 964, 512, 173), 32,
                         ((0, 49), (4, 53), (8, 57), (12, 61))),
                        ('frac_whole',
                         ((2, 48896), 'float32', (48896, 1), 0,
                          '7144b1b1f911'),
                         ((4, 9, 3, 128, 64), 'bfloat16',
                          (221184, 24576, 8192, 64, 1), 0, '809efe3ce7d7'),
                         (256, 561, 512, 188), 32,
                         ((0, 24), (4, 28), (8, 32), (12, 36)))],
 'cd24_96k_oneshot': [('frac_whole',
                       ((2, 45276), 'float32', (45276, 1), 0, '01823586e693'),
                       ((5, 17, 3, 128, 64), 'bfloat16',
                        (417792, 24576, 8192, 64, 1), 0, 'c87f83dcd486'),
                       (294, 1027, 640, 150), 32,
                       ((0, 49), (3, 53), (7, 56), (11, 60), (14, 64)))],
 'cd24_96k_stream': [('frac_whole',
                      ((2, 9114), 'float32', (9114, 1), 0, 'c46b3e512742'),
                      ((5, 17, 3, 128, 64), 'bfloat16',
                       (417792, 24576, 8192, 64, 1), 0, 'c87f83dcd486'),
                      (294, 1027, 640, 27), 32,
                      ((0, 49), (3, 53), (7, 56), (11, 60), (14, 64))),
                     ('frac_whole',
                      ((2, 9996), 'float32', (9996, 1), 0, 'cd4022fbf979'),
                      ((5, 17, 3, 128, 64), 'bfloat16',
                       (417792, 24576, 8192, 64, 1), 0, 'c87f83dcd486'),
                      (294, 1027, 640, 30), 32,
                      ((0, 49), (3, 53), (7, 56), (11, 60), (14, 64))),
                     ('frac_whole',
                      ((2, 9996), 'float32', (9996, 1), 0, 'f3de15069eef'),
                      ((5, 17, 3, 128, 64), 'bfloat16',
                       (417792, 24576, 8192, 64, 1), 0, 'c87f83dcd486'),
                      (294, 1027, 640, 30), 32,
                      ((0, 49), (3, 53), (7, 56), (11, 60), (14, 64)))],
 'guarantee24_96k_oneshot': [('ozaki_framed',
                              ((2, 45312), 'float32', (45312, 1), 0,
                               'b6ca9896b043'),
                              ((2, 1), 'float32', (1, 1), 0, 'b01abf7d0dfa'),
                              ((4, 964, 512), 'bfloat16', (493568, 512, 1), 0,
                               'a41c5bf82c0d'),
                              (964, 256, 512, 173), None, True,
                              (((16, 16, 4, 32, 64), 'bfloat16',
                                (131072, 8192, 2048, 64, 1), 0,
                                '28f24a79f78a'),
                               ((16, 2), 'int32', (2, 1), 0, 'dd1989a2241e'))),
                             ('ozaki_framed',
                              ((2, 88587), 'float32', (88587, 1), 0,
                               '4890914c8787'),
                              ((2, 1), 'float32', (1, 1), 0, 'b01abf7d0dfa'),
                              ((4, 170, 160), 'bfloat16', (27200, 160, 1), 0,
                               '004005f28666'),
                              (170, 147, 160, 600),
                              ((2, 88587), 'bfloat16', (88587, 1), 0,
                               '89c333bdb59b'),
                              False,
                              (((5, 3, 4, 32, 64), 'bfloat16',
                                (24576, 8192, 2048, 64, 1), 0,
                                'a5240ca60c79'),
                               ((5, 2), 'int32', (2, 1), 0, '972a466ebd75')))]}
