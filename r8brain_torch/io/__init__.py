"""I/O: WAV file read/write.

Whole-file helpers (`read_wav`/`write_wav`) and incremental streaming
(`WavReader`/`WavWriter`, O(block) host memory) — the role libvox's WAV
helpers play for the reference's bench tools (bench/r8bfreesrc.cpp:3-15).
"""

from .wavio import WavData, WavReader, WavWriter, read_wav, write_wav

__all__ = ["WavData", "WavReader", "WavWriter", "read_wav", "write_wav"]
