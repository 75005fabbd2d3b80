"""The port's WAV converter (r8brain_torch.cli) against the reference
package's (r8brain_tpu.cli), on the CPU.

One seeded stereo 24-bit WAV of 30 000 frames at 44.1 kHz goes through
both CLIs in this process (``--device cpu``, ``--platform cpu``):

* ``--precision oracle`` and ``native`` (the host paths): byte-equal files;
* ``fast`` and ``high`` (``--float --bits 64``): the port within -141 dB
  re full scale of its own oracle, and no more than 1 dB above the
  reference CLI's own distance from that oracle;
* ``--stream`` against the whole file at -135 dB (the reference's bound,
  tests/test_wav_cli.py); ``--max-chunk`` against ``--stream`` within
  float32 rounding (1e-6 absolute);
* the argument errors, and ``--device cuda`` raising without a card.
"""

import shutil

import numpy as np
import pytest
import torch

from r8brain_tpu import cli as ref_cli
from r8brain_torch import cli, native
from r8brain_torch.io import read_wav, write_wav

from .helpers import rms_db

FRAMES = 30000
F64 = ["--float", "--bits", "64"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's small tensor ops on one thread (see
    tests/test_torch_stage_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wav_in(tmp_path_factory):
    rng = np.random.default_rng(11)
    x = np.clip(rng.standard_normal((2, FRAMES)) * 0.3, -0.999, 0.999)
    p = tmp_path_factory.mktemp("cli") / "in.wav"
    write_wav(str(p), 44100, x, 24)
    return p


def run_port(wav_in, out, *flags):
    assert cli.main([str(wav_in), str(out), "96000", "--device", "cpu",
                     *flags]) == 0
    return out


def run_ref(wav_in, out, *flags):
    assert ref_cli.main([str(wav_in), str(out), "96000", "--platform",
                         "cpu", *flags]) == 0
    return out


@pytest.mark.parametrize("precision", ("oracle", "native"))
def test_host_paths_byte_equal(wav_in, tmp_path, monkeypatch, precision):
    if precision == "native":
        if shutil.which("g++") is None:
            pytest.skip("no C++ toolchain")
        # The reference CLI loads the port's lock-serialised build of the
        # same engine sources instead of running make in native/ in place,
        # which races tests/test_native*.py when pytest runs in parallel.
        monkeypatch.setenv("R8BT_LIB", str(native.build_library()))
    a = run_port(wav_in, tmp_path / "port.wav", "--precision", precision)
    b = run_ref(wav_in, tmp_path / "ref.wav", "--precision", precision)
    assert a.read_bytes() == b.read_bytes()
    w = read_wav(str(a))
    assert (w.rate, w.channels, w.bits, w.frames) == \
        (96000, 2, 24, int(np.floor(FRAMES * 96000 / 44100)))


@pytest.mark.parametrize("precision", ("fast", "high"))
def test_device_paths_vs_oracle(wav_in, tmp_path, precision):
    orc = read_wav(str(run_port(wav_in, tmp_path / "orc.wav", "--precision",
                                "oracle", *F64))).data
    port = read_wav(str(run_port(wav_in, tmp_path / "port.wav",
                                 "--precision", precision, *F64))).data
    ref = read_wav(str(run_ref(wav_in, tmp_path / "ref.wav", "--precision",
                               precision, *F64))).data
    assert port.shape == orc.shape == ref.shape
    d_port, d_ref = rms_db(port - orc), rms_db(ref - orc)
    assert d_port <= -141.0, d_port
    assert d_port <= d_ref + 1.0, (d_port, d_ref)


def test_stream_and_max_chunk(wav_in, tmp_path):
    whole = read_wav(str(run_port(wav_in, tmp_path / "whole.wav",
                                  *F64))).data
    stream = read_wav(str(run_port(wav_in, tmp_path / "stream.wav",
                                   "--stream", *F64))).data
    chunk = read_wav(str(run_port(wav_in, tmp_path / "chunk.wav",
                                  "--max-chunk", "8192", *F64))).data
    assert whole.shape == stream.shape == chunk.shape
    assert rms_db(whole - stream) < -135.0
    assert np.abs(chunk - stream).max() <= 1e-6


@pytest.mark.parametrize("flags", (["--bits", "64"],
                                   ["--float", "--bits", "16"],
                                   ["--stream", "--precision", "oracle"],
                                   ["--stream", "--precision", "native"]),
                         ids=("pcm64", "float16", "stream-oracle",
                              "stream-native"))
def test_argument_errors(wav_in, tmp_path, flags):
    with pytest.raises(SystemExit) as e:
        cli.main([str(wav_in), str(tmp_path / "o.wav"), "96000", *flags])
    assert e.value.code == 2


@pytest.mark.parametrize("flags", ([], ["--stream"], ["--precision", "fast"]))
def test_device_cuda_raises_without_card(wav_in, tmp_path, flags):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([str(wav_in), str(tmp_path / "o.wav"), "96000", *flags])
    assert not (tmp_path / "o.wav").exists()
