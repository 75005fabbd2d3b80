"""Minimal WAV read/write (PCM 16/24/32-bit and float32/float64).

Counterpart of the reference bench tools' WAV layer: those depend on the
author's unpublished `libvox` support library (bench/r8bfreesrc.cpp:3-15
"pseudo-code" disclaimer), so this package ships its own (the reference package's
format, byte for byte).  Stdlib-only;
samples are exchanged as float64 numpy arrays in [-1, 1), channel-major
[channels, frames] to match the resampler batch layout.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

__all__ = ["WavData", "read_wav", "write_wav", "WavReader", "WavWriter"]

_WAVE_FORMAT_PCM = 1
_WAVE_FORMAT_IEEE_FLOAT = 3
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


@dataclass
class WavData:
    rate: int
    data: np.ndarray  # [channels, frames] float64 in [-1, 1)
    bits: int  # source/target bit depth
    float_fmt: bool = False

    @property
    def channels(self) -> int:
        return int(self.data.shape[0])

    @property
    def frames(self) -> int:
        return int(self.data.shape[1])


def _parse_fmt(path: str, fmt) -> tuple:
    """(tag, channels, rate, bits) of a fmt chunk's payload; ValueError
    for a chunk that is missing, truncated or describes no supported
    format (shared by read_wav / WavReader)."""
    if fmt is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    if len(fmt) < 16:
        raise ValueError(f"{path}: truncated fmt chunk ({len(fmt)} B)")
    (tag, ch, rate, _br, _ba, bits) = struct.unpack("<HHIIHH", fmt[:16])
    if tag == _WAVE_FORMAT_EXTENSIBLE:
        if len(fmt) < 26:
            raise ValueError(
                f"{path}: truncated WAVE_FORMAT_EXTENSIBLE fmt chunk")
        tag = struct.unpack("<H", fmt[24:26])[0]
    if tag not in (_WAVE_FORMAT_PCM, _WAVE_FORMAT_IEEE_FLOAT):
        raise ValueError(f"{path}: unsupported format tag {tag}")
    depths = (32, 64) if tag == _WAVE_FORMAT_IEEE_FLOAT else (16, 24, 32)
    if ch < 1 or rate < 1 or bits not in depths:
        raise ValueError(
            f"{path}: malformed fmt (channels={ch}, rate={rate}, "
            f"bits={bits}, tag={tag})")
    return tag, ch, rate, bits


def _open_riff(f, path: str) -> None:
    head = f.read(12)
    if len(head) < 12:
        raise ValueError(f"{path}: not a RIFF/WAVE file (truncated)")
    riff, _size, wave_ = struct.unpack("<4sI4s", head)
    if riff != b"RIFF" or wave_ != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")


def read_wav(path: str) -> WavData:
    with open(path, "rb") as f:
        _open_riff(f, path)
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", hdr)
            payload = f.read(csize + (csize & 1))[:csize]
            if cid == b"fmt ":
                fmt = payload
            elif cid == b"data":
                data = payload
    if data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    tag, ch, rate, bits = _parse_fmt(path, fmt)
    return WavData(rate, _decode(data, tag, bits, ch), bits,
                   tag == _WAVE_FORMAT_IEEE_FLOAT)


def write_wav(path: str, rate: int, data: np.ndarray, bits: int = 24,
              float_fmt: bool = False) -> None:
    """data: [channels, frames] float64 in [-1, 1)."""
    data = np.atleast_2d(np.asarray(data, dtype=np.float64))
    ch, n = data.shape
    _check_depth(bits, float_fmt)
    tag = _WAVE_FORMAT_IEEE_FLOAT if float_fmt else _WAVE_FORMAT_PCM
    payload = _encode(data, tag, bits)
    ba = ch * bits // 8
    fmt = struct.pack("<HHIIHH", tag, ch, rate, rate * ba, ba, bits)
    chunks = []
    if tag == _WAVE_FORMAT_IEEE_FLOAT:
        # non-PCM WAVE requires the cbSize extension field and a fact chunk
        fmt += struct.pack("<H", 0)
        chunks.append((b"fact", struct.pack("<I", n)))
    chunks.insert(0, (b"fmt ", fmt))
    chunks.append((b"data", payload))
    size = 4 + sum(8 + len(c) + (len(c) & 1) for _, c in chunks)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", size, b"WAVE"))
        for cid, c in chunks:
            f.write(struct.pack("<4sI", cid, len(c)))
            f.write(c)
            if len(c) & 1:  # RIFF chunks are word-aligned
                f.write(b"\x00")


def _check_depth(bits: int, float_fmt: bool) -> None:
    if float_fmt and bits not in (32, 64):
        raise ValueError(
            f"IEEE-float WAV supports bits=32 or 64, got {bits}")
    if not float_fmt and bits not in (16, 24, 32):
        raise ValueError(f"unsupported PCM depth {bits}")


def _decode(payload: bytes, tag: int, bits: int, ch: int) -> np.ndarray:
    """bytes -> [channels, frames] float64 (shared by read_wav/WavReader)."""
    n = len(payload) // (bits // 8) // ch
    if tag == _WAVE_FORMAT_IEEE_FLOAT:
        dt = np.float32 if bits == 32 else np.float64
        x = np.frombuffer(payload, dtype="<" + np.dtype(dt).char,
                          count=n * ch).astype(np.float64)
    elif bits == 16:
        x = np.frombuffer(payload, dtype="<i2", count=n * ch).astype(
            np.float64) / 32768.0
    elif bits == 24:
        raw = np.frombuffer(payload, dtype=np.uint8,
                            count=n * ch * 3).reshape(-1, 3)
        ints = (raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16))
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        x = ints.astype(np.float64) / 8388608.0
    elif bits == 32:
        x = np.frombuffer(payload, dtype="<i4", count=n * ch).astype(
            np.float64) / 2147483648.0
    else:
        raise ValueError(f"unsupported PCM depth {bits}")
    return x.reshape(n, ch).T.copy()


def _encode(data: np.ndarray, tag: int, bits: int) -> bytes:
    """[channels, frames] float64 -> bytes (shared by write_wav/WavWriter)."""
    inter = np.asarray(data, dtype=np.float64).T.reshape(-1)
    if tag == _WAVE_FORMAT_IEEE_FLOAT:
        return inter.astype("<f4" if bits == 32 else "<f8").tobytes()
    if bits == 16:
        q = np.clip(np.round(inter * 32768.0), -32768, 32767)
        return q.astype("<i2").tobytes()
    if bits == 24:
        q = np.clip(np.round(inter * 8388608.0), -8388608,
                    8388607).astype(np.int32)
        b = np.empty((q.shape[0], 3), dtype=np.uint8)
        b[:, 0] = q & 0xFF
        b[:, 1] = (q >> 8) & 0xFF
        b[:, 2] = (q >> 16) & 0xFF
        return b.tobytes()
    if bits == 32:
        q = np.clip(np.round(inter * 2147483648.0), -2147483648,
                    2147483647)
        return q.astype("<i4").tobytes()
    raise ValueError(f"unsupported PCM depth {bits}")


class WavReader:
    """Incremental WAV reader: O(block) host memory regardless of file
    length (the whole-file read_wav caps the 'minutes of audio x 10k
    channels' serving story; streaming pipelines read block-by-block).
    """

    def __init__(self, path: str):
        self._f = open(path, "rb")
        try:
            _open_riff(self._f, path)
            self._data_left = None
            fmt = None
            while True:
                hdr = self._f.read(8)
                if len(hdr) < 8:
                    break
                cid, csize = struct.unpack("<4sI", hdr)
                if cid == b"fmt ":
                    fmt = self._f.read(csize + (csize & 1))[:csize]
                elif cid == b"data":
                    self._data_left = csize
                    break  # stream from here
                else:
                    self._f.seek(csize + (csize & 1), 1)
            if self._data_left is None:
                raise ValueError(f"{path}: missing fmt/data chunk")
            tag, ch, rate, bits = _parse_fmt(path, fmt)
            self.tag, self.rate, self.channels, self.bits = \
                tag, rate, ch, bits
            self.float_fmt = tag == _WAVE_FORMAT_IEEE_FLOAT
            self._bpf = ch * bits // 8  # bytes per frame
            self.frames = self._data_left // self._bpf
        except Exception:
            self._f.close()
            raise

    def read(self, n_frames: int) -> np.ndarray:
        """Next [channels, m] block (m <= n_frames; m == 0 at EOF)."""
        want = min(n_frames * self._bpf, self._data_left)
        payload = self._f.read(want)
        self._data_left -= len(payload)
        payload = payload[: len(payload) - len(payload) % self._bpf]
        return _decode(payload, self.tag, self.bits, self.channels)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class WavWriter:
    """Incremental WAV writer; finalizes RIFF/data (+fact) sizes on
    close()."""

    def __init__(self, path: str, rate: int, channels: int, bits: int = 24,
                 float_fmt: bool = False):
        _check_depth(bits, float_fmt)
        self.rate, self.channels, self.bits = rate, channels, bits
        self.tag = _WAVE_FORMAT_IEEE_FLOAT if float_fmt else _WAVE_FORMAT_PCM
        self._bpf = channels * bits // 8
        self._frames = 0
        self._f = open(path, "wb")
        ba = self._bpf
        fmt = struct.pack("<HHIIHH", self.tag, channels, rate, rate * ba,
                          ba, bits)
        self._f.write(struct.pack("<4sI4s", b"RIFF", 0, b"WAVE"))
        if self.tag == _WAVE_FORMAT_IEEE_FLOAT:
            fmt += struct.pack("<H", 0)
            self._f.write(struct.pack("<4sI", b"fmt ", len(fmt)) + fmt)
            self._fact_pos = self._f.tell() + 8
            self._f.write(struct.pack("<4sII", b"fact", 4, 0))
        else:
            self._f.write(struct.pack("<4sI", b"fmt ", len(fmt)) + fmt)
            self._fact_pos = None
        self._data_pos = self._f.tell()
        self._f.write(struct.pack("<4sI", b"data", 0))

    def write(self, data: np.ndarray) -> None:
        data = np.atleast_2d(np.asarray(data, dtype=np.float64))
        if data.shape[0] != self.channels:
            raise ValueError(
                f"block has {data.shape[0]} channels, writer opened with "
                f"{self.channels}")
        self._f.write(_encode(data, self.tag, self.bits))
        self._frames += data.shape[1]

    def close(self):
        nbytes = self._frames * self._bpf
        if nbytes & 1:
            self._f.write(b"\x00")
        end = self._f.tell()
        self._f.seek(self._data_pos + 4)
        self._f.write(struct.pack("<I", nbytes))
        if self._fact_pos is not None:
            self._f.seek(self._fact_pos)
            self._f.write(struct.pack("<I", self._frames))
        self._f.seek(4)
        self._f.write(struct.pack("<I", end - 8))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
