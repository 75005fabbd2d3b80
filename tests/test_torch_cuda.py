"""The port's CUDA kernel on the card.

The kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a CUDA device.  The file imports nothing of JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from r8brain_torch import Resampler
from r8brain_torch.ops.pallas_frac import frac_whole, frac_whole_ref

# (label, I, D, O): tests/test_pallas.py's two shapes and the flagship's
SHAPES = [("aligned", 64, 772, 128), ("unaligned", 147, 171, 160),
          ("flagship", 294, 1027, 640)]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rms_db(d) -> float:
    return float(10.0 * np.log10(np.mean(np.square(d)) + 1e-300))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_kernel_matches_plain(cuda_device, shape, dtype):
    """The kernel against frac_whole_ref in float64, with skT_lo, C = 13
    (no multiple of 8) and a row-strided view of xp."""
    _label, I, D, O = shape
    C, n_win = 13, 37
    rng = np.random.default_rng(5)
    xp = rng.standard_normal((C, (n_win - 1) * I + D))
    skT = rng.standard_normal((D, O))
    skT_lo = rng.standard_normal((D, O)) * 2.0**-24
    ref = frac_whole_ref(torch.from_numpy(xp), torch.from_numpy(skT), I, D,
                         O, n_win, skT_lo=torch.from_numpy(skT_lo)).numpy()
    dev = dict(dtype=dtype, device=cuda_device)
    big = torch.zeros((C, xp.shape[1] + 3), **dev)
    big[:, 3:] = torch.from_numpy(xp)
    before = frac_whole.launches
    y = frac_whole(big[:, 3:], torch.tensor(skT, **dev), I, D, O, n_win,
                   skT_lo=torch.tensor(skT_lo, **dev))
    torch.cuda.synchronize()
    assert frac_whole.launches == before + 1
    err = np.abs(y.cpu().double().numpy() - ref).max() / np.abs(ref).max()
    assert err < (1e-5 if dtype == torch.float32 else 1e-12), err


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fast", "high"])
def test_resampler_on_card_holds_class(cuda_device, precision):
    """oneshot on the card through the kernel (one launch) against the
    port's float64 CPU path, at the -141 dB class."""
    rng = np.random.default_rng(6)
    x = rng.uniform(-1.0, 1.0, (3, 20000))
    rs = Resampler(44100, 96000, 2.0, 180.15, precision=precision,
                   device=cuda_device)
    before = frac_whole.launches
    y = rs.oneshot(x)
    torch.cuda.synchronize()
    assert frac_whole.launches == before + 1
    assert y.device.type == "cuda" and y.shape == (3, rs.default_out_len(20000))
    x32 = x.astype(np.float32).astype(np.float64)
    ref = Resampler(44100, 96000, 2.0, 180.15, dtype=torch.float64,
                    device="cpu").oneshot(x32).numpy()
    assert _rms_db(y.cpu().double().numpy() - ref) < -141.0
