"""The scouting GEMM (r8brain_torch/ops/scout.py ``dense_gemm``, the
counterpart of the reference's TPU scouting GEMMs
tools/exp_pallas_gemm.py and tools/exp_framed_kernel.py) on the CPU: its
plain version and the wrapper's checks.  The kernel itself runs on the
card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from r8brain_torch.ops.scout import M_TILES, dense_gemm, dense_gemm_ref


@pytest.mark.parametrize("hop", [None, 256])
@pytest.mark.parametrize("mt", M_TILES)
def test_plain_version_is_the_float64_product(mt, hop):
    rng = np.random.default_rng(mt)
    A = rng.standard_normal((301, 700)).astype(np.float32)
    B = rng.standard_normal((700, 130)).astype(np.float32)
    want = A.astype(np.float64) @ B.astype(np.float64)
    r = dense_gemm_ref(torch.from_numpy(A), torch.from_numpy(B), mt, hop)
    assert r.dtype == torch.float64
    assert np.abs(r.numpy() - want).max() < 1e-12 * np.abs(want).max()
    before = dense_gemm.launches
    c = dense_gemm(torch.from_numpy(A), torch.from_numpy(B), mt, hop)
    assert c.dtype == torch.float32 and dense_gemm.launches == before
    assert torch.equal(c, r.float())


def test_argument_checks():
    A, B = torch.zeros((10, 32)), torch.zeros((32, 8))
    with pytest.raises(ValueError, match="mt"):
        dense_gemm(A, B, mt=256)
    with pytest.raises(ValueError, match="hop"):
        dense_gemm(A, B, hop=100)
    with pytest.raises(ValueError, match="A .M, K."):
        dense_gemm(A, torch.zeros((31, 8)))
    with pytest.raises(TypeError, match="float32"):
        dense_gemm(A.double(), B.double())
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        dense_gemm(A.to("meta"), B.to("meta"))
