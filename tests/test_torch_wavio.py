"""The port's WAV I/O (r8brain_torch.io) against the reference package's.

Files written by the two write_wav / WavWriter are byte-equal (16/24/32-bit
PCM, 32/64-bit IEEE float) and read back equal by both readers; the
incremental reader and writer round-trip the whole-file ones; corrupted
files are refused with ValueError, never struct.error or a numpy buffer
error (the reference's TestMalformedWav cases)."""

import numpy as np
import pytest

from r8brain_tpu.io import wavio as ref_wavio
from r8brain_torch.io import (WavData, WavReader, WavWriter, read_wav,
                              write_wav)

from . import test_wav_cli

FORMATS = [(16, False), (24, False), (32, False), (32, True), (64, True)]
FORMAT_IDS = [f"{b}{'f' if f else 'pcm'}" for b, f in FORMATS]
CASES = test_wav_cli.TestMalformedWav()._cases  # the reference's cases
MALFORMED = sorted(CASES(None))


def _signal(seed, shape):
    rng = np.random.default_rng(seed)
    x = np.clip(rng.standard_normal(shape) * 0.3, -0.999, 0.999)
    x[0, :4] = (-1.0, 0.99999999, -0.99999999, 1.0)  # the clip edges
    return x


@pytest.mark.parametrize("bits,float_fmt", FORMATS, ids=FORMAT_IDS)
def test_write_wav_byte_equal(tmp_path, bits, float_fmt):
    """write_wav: the same bytes as the reference's; read_wav: the same
    WavData (exact) as the reference's, and within the format's
    quantization step of the input."""
    x = _signal(0, (2, 501))  # odd frame count: the data chunk's pad byte
    p, q = tmp_path / "port.wav", tmp_path / "ref.wav"
    write_wav(str(p), 48000, x, bits, float_fmt)
    ref_wavio.write_wav(str(q), 48000, x, bits, float_fmt)
    assert p.read_bytes() == q.read_bytes()
    w, r = read_wav(str(p)), ref_wavio.read_wav(str(q))
    assert isinstance(w, WavData)
    assert (w.rate, w.bits, w.float_fmt, w.channels, w.frames) == \
        (r.rate, r.bits, r.float_fmt, r.channels, r.frames) == \
        (48000, bits, float_fmt, 2, 501)
    assert np.array_equal(w.data, r.data)
    tol = ({32: 2 ** -24, 64: 0.0} if float_fmt else
           {16: 2 ** -15, 24: 2 ** -23, 32: 2 ** -31})[bits]
    assert np.abs(w.data - x).max() <= tol


@pytest.mark.parametrize("bits,float_fmt", FORMATS, ids=FORMAT_IDS)
def test_wav_streaming_io_roundtrip(tmp_path, bits, float_fmt):
    """WavWriter block by block == write_wav == the reference's WavWriter;
    WavReader block by block == read_wav."""
    x = _signal(3, (3, 1777))
    p1, p2, p3 = (tmp_path / f"{k}.wav" for k in ("whole", "port", "ref"))
    write_wav(str(p1), 44100, x, bits, float_fmt)
    for path, cls in ((p2, WavWriter), (p3, ref_wavio.WavWriter)):
        with cls(str(path), 44100, 3, bits, float_fmt) as wr:
            for pos in range(0, x.shape[1], 313):
                wr.write(x[:, pos : pos + 313])
    assert p1.read_bytes() == p2.read_bytes() == p3.read_bytes()
    with WavReader(str(p1)) as rd:
        assert (rd.rate, rd.channels, rd.bits, rd.frames, rd.float_fmt) \
            == (44100, 3, bits, 1777, float_fmt)
        blocks = []
        while True:
            b = rd.read(400)
            if b.shape[1] == 0:
                break
            blocks.append(b)
    assert np.array_equal(np.concatenate(blocks, axis=1),
                          read_wav(str(p1)).data)


def test_writer_refuses(tmp_path):
    """Depths the formats lack, and a block of another channel count."""
    for bits, float_fmt in ((64, False), (16, True), (8, False)):
        with pytest.raises(ValueError):
            write_wav(str(tmp_path / "a.wav"), 44100, np.zeros((1, 4)), bits,
                      float_fmt)
        with pytest.raises(ValueError):
            WavWriter(str(tmp_path / "b.wav"), 44100, 1, bits, float_fmt)
    with WavWriter(str(tmp_path / "c.wav"), 44100, 2) as wr:
        with pytest.raises(ValueError):
            wr.write(np.zeros((3, 4)))


@pytest.mark.parametrize("reader", ("read_wav", "WavReader"))
@pytest.mark.parametrize("case", MALFORMED)
def test_malformed_wav_rejected(tmp_path, reader, case):
    p = tmp_path / f"{case}.wav"
    p.write_bytes(CASES(tmp_path)[case])
    with pytest.raises(ValueError):
        {"read_wav": read_wav, "WavReader": WavReader}[reader](str(p))
