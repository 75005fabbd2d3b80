"""``sym_conv``'s plain version (r8brain_torch/ops/pallas_symconv.py)
against the reference package's folded TPU kernel
(r8brain_tpu/ops/pallas_symconv.py ``sym_conv_stage_pallas``), on the CPU.

The reference kernel runs as its own test runs it
(tests/test_toeplitz_sym.py::test_pallas_kernel_interpret_matches_xla_fold):
interpret mode, 8 channels.  Bounds: the port's stage within 2^-19 of max
|y| of the kernel's (the kernel sums each dot in one pass, the port folds
every 32 terms; the reference's own bound between its kernel and its XLA
fold is 2e-6 under "high"), and no more than 0.5 dB above it against the
float64 stage.  In float64 the fold equals the unfolded banded product to
1e-13.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r8brain_tpu.ops.stages import ConvExec as RefConvExec
from r8brain_torch.ops.framing import _frames, _framed_matmul
from r8brain_torch.ops.pallas_symconv import (BH, STEP, split_grid, sym_conv,
                                               sym_conv_ref, sym_ops_high,
                                               sym_parts, unpack_sym)
from r8brain_torch.ops.stages import ConvExec

from .helpers import lcg_uniform, rms_db
from .test_torch_toeplitz import IDS, SPECS

jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's small tensor ops on one thread: the suite runs
    several workers at once, and torch's thread pool would spin on each
    tiny op (about 5x the CPU time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("pair", SPECS, ids=IDS)
def test_plain_version_vs_reference_kernel(pair, precision):
    st, rst = pair
    x = np.stack([lcg_uniform(s, 5000) for s in range(8)]).astype(np.float32)
    pal = RefConvExec(rst, jnp.float32, engine="toeplitz_sym",
                      precision=precision)
    pal.sym_pallas_interpret = True
    assert pal._use_sym_pallas(8)  # the Pallas kernel, not the XLA fold
    y_pal = np.asarray(pal.apply(jnp.asarray(x)), np.float64)
    ex = ConvExec(st, torch.float32, precision, engine="toeplitz_sym")
    y = ex.apply(torch.from_numpy(x)).double().numpy()
    y64 = ConvExec(st, torch.float64, engine="toeplitz").apply(
        torch.from_numpy(x.astype(np.float64))).numpy()
    assert y.shape == y_pal.shape == y64.shape
    assert np.abs(y - y_pal).max() <= 2.0**-19 * np.abs(y_pal).max()
    db, ref_db = rms_db(y - y64), rms_db(y_pal - y64)
    assert db < ref_db + 0.5, (db, ref_db)


def _random_stage(rng, up, L_fs, C, nb, hop):
    """A random signal and per-phase centrosymmetric banded operators of
    B = 256 columns (rows palindromic, as a symmetric kernel makes them),
    their folds as sym_parts takes them (float64), and the unfolded
    operators."""
    B = 2 * BH
    xp = rng.uniform(-1, 1, (C, (nb - 1) * hop + max(L_fs) + 5))
    ops = np.zeros((up, 2, (max(L_fs) + 1) // 2, BH))
    Ts = []
    for j, L_f in enumerate(L_fs):
        D = L_f - (B - 1) * (hop // B)
        half = rng.standard_normal((D + 1) // 2)
        row = np.concatenate([half, half[: D // 2][::-1]])
        T = np.zeros((L_f, B))
        for t in range(B):
            T[t * (hop // B) : t * (hop // B) + D, t] = row
        H, Hp = L_f // 2, (L_f + 1) // 2
        Te = np.zeros((Hp, BH))
        To = np.zeros((Hp, BH))
        Te[:H] = 0.5 * (T[:H, :BH] + T[L_f - 1 : L_f - 1 - H : -1, :BH])
        To[:H] = 0.5 * (T[:H, :BH] - T[L_f - 1 : L_f - 1 - H : -1, :BH])
        if L_f % 2:
            Te[Hp - 1] = 0.5 * T[Hp - 1, :BH]
        ops[j, 0, :Hp], ops[j, 1, :Hp] = Te, To
        Ts.append(T)
    return xp, ops, Ts


@pytest.mark.parametrize("up,L_fs,hop", [(1, (300,), 256),
                                         (2, (301, 300), 256),
                                         (1, (811,), 512)],
                         ids=["up1_even", "up2_odd_even", "down2"])
def test_f64_fold_equals_unfolded_product(up, L_fs, hop):
    """The function itself: float64 sym_conv_ref equals the unfolded
    banded product of every phase, interleaved y[(b*256 + t)*up + j], at a
    channel count and frame count that fit no tile."""
    rng = np.random.default_rng(up + hop)
    C, nb = 3, 5
    xp, ops, Ts = _random_stage(rng, up, L_fs, C, nb, hop)
    y = sym_conv_ref(torch.from_numpy(xp), torch.from_numpy(ops), L_fs, nb,
                     hop).numpy()
    want = np.stack([_framed_matmul(torch.from_numpy(xp), torch.from_numpy(T),
                                    nb, hop).numpy() for T in Ts], axis=-1)
    want = want.reshape(C, nb * 2 * BH * up)
    assert y.shape == want.shape
    assert np.abs(y - want).max() < 1e-13 * np.abs(want).max()
    y32 = sym_conv_ref(torch.from_numpy(xp).float(),
                       sym_parts(torch.from_numpy(ops).float()), L_fs, nb,
                       hop)
    assert np.abs(y32.double().numpy() - want).max() \
        < 2.0**-20 * np.abs(want).max()


def test_high_terms_move_the_result_by_their_size():
    """Under "high" the fold-error and residual dots change the float32
    result by about the residual's size (~2^-24 of the operator) and bring
    it nearer, in RMS, the float64 product of the (operator + residual)."""
    rng = np.random.default_rng(4)
    L_fs, hop, C, nb = (301, 300), 256, 2, 4
    xp, ops, Ts = _random_stage(rng, 2, L_fs, C, nb, hop)
    ops32 = ops.astype(np.float32)
    lo = ((ops - ops32.astype(np.float64)).astype(np.float32))[:, :, 10:120]
    rows = (((10, 110), (10, 110)),) * 2
    x32 = torch.from_numpy(xp.astype(np.float32))
    fast = sym_conv_ref(x32, sym_parts(torch.from_numpy(ops32)), L_fs, nb,
                        hop)
    high = sym_conv_ref(x32, sym_parts(
        torch.from_numpy(ops32), torch.from_numpy(np.ascontiguousarray(lo)),
        rows), L_fs, nb, hop)
    ops_eff = ops32.astype(np.float64)
    ops_eff[:, :, 10:120] += lo
    want = sym_conv_ref(x32.double(), torch.from_numpy(ops_eff), L_fs, nb,
                        hop).numpy()
    m = np.abs(want).max()
    assert 0 < np.abs((high - fast).numpy()).max() / m < 2.0**-20
    assert rms_db(high.double().numpy() - want) \
        < rms_db(fast.double().numpy() - want)


@pytest.mark.parametrize("pair", SPECS, ids=IDS)
def test_high_gain_at_every_spec(pair):
    """chip_smoke.py holds the kernel's "high" by its gain: the drop of the
    RMS error against the float64 function of "high" (sym_ops_high) from
    the fast output to the high one, on full-mantissa input.  The model
    gains at least 0.3 dB at every spec, and the fold errors and the
    residual rows each give at least 0.15 of it, so a kernel missing
    either part misses the model's gain by more than the 0.1 dB allowed.
    On samples that are multiples of 2^-24 (float32 ``torch.rand``) the
    fold is exact and the fold errors give nothing."""
    st, _rst = pair
    ex = ConvExec(st, torch.float32, "high", engine="toeplitz_sym")
    C, nb, hop = 13, 37, 256 * st.down
    L = (nb - 1) * hop + max(ex.sym_Lf)
    x64 = np.random.default_rng(5).uniform(-1, 1, (C, L))
    ops, lo, rows = ex.sym_ops, ex.sym_lo, ex.sym_lo_rows
    args = (ex.sym_Lf, nb, hop)
    parts = {"fast": sym_parts(ops), "high": ex.sym_parts,
             "fold": sym_parts(ops, torch.zeros_like(lo), rows)}

    def gains(xp):
        want = sym_conv_ref(xp.double(), sym_ops_high(ops, lo, rows),
                            *args).numpy()
        db = {k: rms_db(sym_conv_ref(xp, p, *args).double().numpy() - want)
              for k, p in parts.items()}
        return db["fast"] - db["high"], db["fast"] - db["fold"]

    full, fold = gains(torch.from_numpy(x64.astype(np.float32)))
    assert full >= 0.3 and fold >= 0.15 and full - fold >= 0.15, (full, fold)
    grid = torch.from_numpy(np.round(x64 * 2.0**23) * 2.0**-23).float()
    assert gains(grid)[1] == 0.0


#: RMS error (dB re full scale) of sym_conv_ref against its own float64
#: function at each spec, (fast, "high"), with the floating lead slices
#: (split3) that summed each big-pair step inexactly, truncated toward zero
FLOATING_LEAD_DB = {"K1417_u2_d1": (-150.38, -151.74),
                    "K611_u2_d1": (-150.26, -151.57),
                    "K1543_u1_d1": (-153.59, -154.84),
                    "K471_u1_d1": (-153.87, -155.23)}


def _bias_case(st):
    """The "high" executor of spec st and 8 channels x 64 frames of
    uniform full-mantissa input (numpy seed 5): at least 131072 outputs."""
    ex = ConvExec(st, torch.float32, "high", engine="toeplitz_sym")
    C, nb, hop = 8, 64, 256 * st.down
    L = (nb - 1) * hop + max(ex.sym_Lf)
    x = np.random.default_rng(5).uniform(-1, 1, (C, L)).astype(np.float32)
    return ex, torch.from_numpy(x), (ex.sym_Lf, nb, hop)


@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("pair", SPECS, ids=IDS)
def test_unbiased_at_every_spec(pair, precision):
    """sym_conv_ref's error against its own float64 function (the fast
    operators as float64, or sym_ops_high under "high") has no sign of
    its own: beta = mean(e * sign(y64)) / rms(e) within 0.02 of 0, where
    a sum truncated toward zero reads clearly negative (-0.21 to -0.30
    with floating lead slices).  Its RMS is no worse than that of the
    floating lead slices (FLOATING_LEAD_DB); with the fixed grids it reads
    fast / "high": K1417_u2_d1 -151.26 / -152.99, K611_u2_d1 -151.48 /
    -153.29, K1543_u1_d1 -155.54 / -157.78, K471_u1_d1 -155.63 / -157.87
    (against -150.38 / -151.74, -150.26 / -151.57, -153.59 / -154.84,
    -153.87 / -155.23)."""
    st, _rst = pair
    ex, x, args = _bias_case(st)
    ops, lo, rows = ex.sym_ops, ex.sym_lo, ex.sym_lo_rows
    if precision == "fast":
        parts, ops64 = sym_parts(ops), ops.double()
    else:
        parts, ops64 = ex.sym_parts, sym_ops_high(ops, lo, rows)
    y = sym_conv_ref(x, parts, *args).double().numpy()
    y64 = sym_conv_ref(x.double(), ops64, *args).numpy()
    e = y - y64
    assert e.size >= 10**5
    beta = np.mean(e * np.sign(y64)) / np.sqrt(np.mean(e**2))
    assert abs(beta) <= 0.02, beta
    floating = FLOATING_LEAD_DB[
        f"K{st.filt.kernel.shape[0]}_u{st.up}_d{st.down}"]
    assert rms_db(e) <= floating[precision == "high"], rms_db(e)


@pytest.mark.parametrize("pair", SPECS, ids=IDS)
def test_big_pair_step_sums_exact(pair):
    """Every big-pair step sum of every output, z0 and w0 against Te's and
    To's lead slices over each 16-row step, is exact in float32: its
    products lie on one grid (split_grid), so the tensor cores' sum has
    nothing to round."""
    st, _rst = pair
    ex, x, (L_fs, nb, hop) = _bias_case(st)
    S0 = unpack_sym(ex.sym_parts)[:, :, 0].double()  # [up, 2, rows, BH]
    n = 0
    for j, L_f in enumerate(L_fs):
        Hp = (L_f + 1) // 2
        fr = _frames(x, nb, hop, L_f)
        a, r = fr[..., :Hp], fr.flip(-1)[..., :Hp]
        for o, v in enumerate((a + r, a - r)):
            v0 = split_grid(v)[0].double()
            for k0 in range(0, Hp, STEP):
                p = v0[..., k0 : k0 + STEP] @ S0[j, o, k0 : min(k0 + STEP,
                                                                 Hp)]
                assert torch.equal(p.float().double(), p)
                n += p.numel()
    assert n >= 10**6


def test_argument_checks():
    ops = torch.zeros((1, 2, 10, BH))
    parts = sym_parts(ops)
    x = torch.zeros((2, 1000))
    with pytest.raises(ValueError, match="another tiling"):
        sym_conv(x, parts[:, :2].contiguous(), (19,), 3, 256)
    with pytest.raises(TypeError, match="packed bfloat16"):
        sym_conv(x, ops, (19,), 3, 256)
    with pytest.raises(TypeError, match="float32 or float64"):
        sym_conv(x.half(), parts, (19,), 3, 256)
    with pytest.raises(ValueError, match="frame lengths"):
        sym_conv(x.double(), ops.double(), (21,), 3, 256)
    with pytest.raises(ValueError, match="samples"):
        sym_conv(x, parts, (19,), 5, 256)
    with pytest.raises(ValueError, match="phases"):
        sym_conv(x, sym_parts(torch.zeros((9, 2, 10, BH))), (19,) * 9, 3,
                 256)
    with pytest.raises(ValueError, match="multiple of 256"):
        sym_conv(x, parts, (19,), 3, 200)
    with pytest.raises(ValueError, match="go together"):
        sym_parts(ops, lo=torch.zeros((1, 2, 4, BH)))
    with pytest.raises(ValueError, match="lo_rows"):
        sym_parts(ops, torch.zeros((1, 2, 4, BH)), (((0, 5), (0, 1)),))
    with pytest.raises(TypeError, match="float32 only"):
        sym_parts(ops.double(), torch.zeros((1, 2, 4, BH),
                                            dtype=torch.float64),
                  (((0, 4), (0, 4)),))


def test_cpu_call_launches_nothing():
    parts = sym_parts(torch.zeros((1, 2, 10, BH)))
    before = sym_conv.launches
    y = sym_conv(torch.ones((2, 1000)), parts, (19,), 3, 256)
    assert y.shape == (2, 3 * 2 * BH) and sym_conv.launches == before
