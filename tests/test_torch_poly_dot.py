"""The polynomial stage's ``poly_dot`` (r8brain_torch/ops/poly_dot.py) and
where ``FracPolyExec`` takes it, on the CPU.

The kernel runs only on a card (tests/test_torch_cuda.py holds it against
its plain version there); here the plain version stands in for it:

* the per-length state (window starts, taps) equals the banded operators'
  nonzero entries at their offsets, bit for bit;
* the wrapper's argument checks, the plain version against a float64 sum
  within ``abs_bound``, its adjoint against the dense transpose;
* the executor takes ``poly_dot`` exactly on float32 "fast" banded calls
  without a seam residual or a pair (``FracPolyExec._dot_math``; a
  recorder in place of the kernel, the card's device test lifted so the
  CPU takes it), counted in ``poly.kernel`` / ``poly.banded``; the CPU
  keeps the banded contraction by default, so its outputs do not move;
* the kernel path's chain against the banded one, and its gradient, jvp
  and vmap through ``resample_fn``.

The file imports nothing of JAX.
"""

import functools

import numpy as np
import pytest
import torch
from torch.func import grad, jvp, vmap

from r8brain_torch import Resampler, resample_fn
from r8brain_torch.models.plan import make_plan
from r8brain_torch.ops import poly_dot as pd
from r8brain_torch.ops import stages
from r8brain_torch.ops.stages import FracPolyExec, place_operator
from r8brain_torch.utils import trace

CPU = torch.device("cpu")
ACTS = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's small tensor ops on one thread (see
    tests/test_torch_stage_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _spec(src, dst, atten=180.15):
    spec, = [s for s in make_plan(src, dst, 2.0, atten, 0).stages
             if s.kind == "frac" and not s.is_whole]
    return spec


def _x(C, n, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((C, n), generator=g, dtype=torch.float32) * 2 - 1


def _kernel_on_cpu(monkeypatch):
    """The executors take poly_dot on the CPU too (its plain version):
    ``_takes_kernel`` without its device test."""
    monkeypatch.setattr(FracPolyExec, "_takes_kernel",
                        FracPolyExec._dot_math)


# 44.1k -> 96001 (the benchmark's cell) and 96001 -> 44.1k; the seam
# path's M' = ceil(M/G)*G columns and the non-seam path's M
STATE_CASES = [(44100, 96001, 4096, True), (44100, 96001, 4096, False),
               (96001, 44100, 5000, True), (96001, 44100, 5000, False)]


@pytest.mark.parametrize("src,dst,n_in,seam", STATE_CASES)
def test_state_equals_banded_operators(src, dst, n_in, seam):
    """starts and taps are the banded operators' nonzero entries at their
    offsets, bit for bit: each chunk's R rebuilt from them equals the
    executor's R on every column of an output below M."""
    ex = FracPolyExec(_spec(src, dst), torch.float32)
    M = ex.out_len(n_in)
    if seam:
        M = -(-M // ex.G) * ex.G
    starts, taps, width = ex._dot_state(M, CPU)
    start, _fti, _t = ex.host_positions(M)
    assert starts.dtype == torch.int32 and taps.dtype == torch.float32
    assert tuple(taps.shape) == (M, ex.fl)
    assert np.array_equal(starts.numpy(), start)
    assert width == pd.tile_width(start, ex.fl)
    chunks, _need, pad_l = ex._banded_state(M, CPU)
    G, S, fl = ex.G, ex.S, ex.fl
    g0 = 0
    for A, nloc, ops in chunks:
        R = ops["R"]
        n = (g0 + np.arange(nloc))[:, None] * G + np.arange(G)
        live = n < M
        nn = np.minimum(n, M - 1)
        off = (start[nn] + pad_l - A - np.arange(nloc)[:, None] * S)
        assert off.min() >= 0 and off.max() + fl <= ex.W
        vals = taps[torch.from_numpy(nn)]
        rebuilt = place_operator(vals, torch.from_numpy(off), ex.W)
        keep = torch.from_numpy(live)[:, None, :].expand_as(R)
        assert torch.equal(rebuilt[keep], R[keep])
        g0 += nloc
    assert g0 * G >= M


def test_tile_width_by_brute_force():
    rng = np.random.default_rng(5)
    starts = np.cumsum(rng.integers(0, 4, 1000)) - 50
    starts[300] -= 7  # not monotone
    want = max(int(starts[i : i + pd.POLY_TILE].max()
                   - starts[i : i + pd.POLY_TILE].min())
               for i in range(0, 1000, pd.POLY_TILE)) + 24
    assert pd.tile_width(starts, 24) == want
    assert pd.tile_width(np.zeros(0, np.int32), 24) == 24


def _case(C=3, N=500, M=300, fl=24, seed=7):
    """x [C, N], starts from below 0 to windows past N, taps."""
    rng = np.random.default_rng(seed)
    starts = (np.arange(M) * (N + 50 - fl)) // M - 30
    x = rng.standard_normal((C, N)).astype(np.float32)
    taps = rng.standard_normal((M, fl)).astype(np.float32)
    return (torch.from_numpy(x), torch.from_numpy(starts.astype(np.int32)),
            torch.from_numpy(taps))


def _dense(starts, fl, N):
    """The [M, N] float64 matrix of the map: row n holds taps' positions
    starts[n] + i that lie in [0, N)."""
    M = starts.shape[0]
    A = np.zeros((M, fl, N))
    for n in range(M):
        for i in range(fl):
            p = int(starts[n]) + i
            if 0 <= p < N:
                A[n, i, p] = 1.0
    return A


def test_plain_version_against_float64():
    x, starts, taps = _case()
    y = pd.poly_dot(x, starts, taps)
    assert y.dtype == torch.float32 and tuple(y.shape) == (3, 300)
    A = _dense(starts.numpy(), taps.shape[1], x.shape[1])
    exact = np.einsum("mip,mi,cp->cm", A, taps.double().numpy(),
                      x.double().numpy())
    bound = pd.abs_bound(x, starts, taps).numpy()
    assert (np.abs(y.double().numpy() - exact) <= bound / 2).all()
    assert int(starts.min()) < 0 and int(starts.max()) + 24 > x.shape[1]


def test_plain_version_reads_zeros_outside():
    """Windows wholly outside [0, N) read zeros; none of x's samples past
    its logical width in a wider buffer leak in when the view is cut."""
    x = torch.ones((2, 10))
    starts = torch.tensor([-30, -5, 8, 40], dtype=torch.int32)
    taps = torch.ones((4, 4))
    y = pd.poly_dot(x, starts, taps)
    assert y.tolist() == [[0.0, 0.0, 2.0, 0.0]] * 2
    big = torch.ones((2, 20))
    assert torch.equal(pd.poly_dot(big[:, :10], starts, taps), y)


def test_adjoint_is_the_transpose():
    x, starts, taps = _case(C=2, N=200, M=120, fl=8)
    gy = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 120)).astype(np.float32))
    gx = pd._adjoint(gy, starts, taps, 200)
    A = _dense(starts.numpy(), 8, 200)
    want = np.einsum("mip,mi,cm->cp", A, taps.double().numpy(),
                     gy.double().numpy())
    assert np.abs(gx.double().numpy() - want).max() <= 1e-5


@pytest.mark.parametrize("how", ["backward", "grad", "jvp", "vmap"])
def test_poly_dot_transforms(how):
    """poly_dot under autograd and torch.func: its backward is the
    adjoint, its jvp the map on the tangent, vmap folds rows."""
    x, starts, taps = _case(C=2, N=200, M=120, fl=8)
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 120)).astype(np.float32))
    f = functools.partial(pd.poly_dot, starts=starts, taps=taps)
    if how == "backward":
        xr = x.clone().requires_grad_()
        (w * f(xr)).sum().backward()
        assert torch.equal(xr.grad, pd._adjoint(w, starts, taps, 200))
    elif how == "grad":
        g = grad(lambda z: (w * f(z)).sum())(x)
        assert torch.equal(g, pd._adjoint(w, starts, taps, 200))
    elif how == "jvp":
        _y, dy = jvp(f, (x,), (x * 2,))
        assert torch.equal(dy, f(x * 2))
    else:
        xb = torch.stack([x, -x, x * 3])
        yb = vmap(f)(xb)
        for b in range(3):
            assert torch.equal(yb[b], f(xb[b]))


BAD = [
    ("x 1-D", lambda x, s, t: (x[0], s, t), ValueError),
    ("x float64", lambda x, s, t: (x.double(), s, t), TypeError),
    ("taps float64", lambda x, s, t: (x, s, t.double()), TypeError),
    ("starts int64", lambda x, s, t: (x, s.long(), t), TypeError),
    ("starts 2-D", lambda x, s, t: (x, s[None], t), ValueError),
    ("lengths differ", lambda x, s, t: (x, s[:-1], t), ValueError),
    ("fl 0", lambda x, s, t: (x, s, t[:, :0]), ValueError),
    ("starts strided", lambda x, s, t: (x, torch.stack([s, s], 1)[:, 0], t),
     ValueError),
    ("taps strided", lambda x, s, t: (x, s, t.t().contiguous().t()),
     ValueError),
]


@pytest.mark.parametrize("label,make,exc", BAD, ids=[b[0] for b in BAD])
def test_wrapper_refuses(label, make, exc):
    x, starts, taps = _case()
    with pytest.raises(exc):
        pd.poly_dot(*make(x, starts, taps))


@pytest.mark.parametrize("width", [23, 2**20 + 1, 30.0, None],
                         ids=["below fl", "past 2^20", "float", "fl accepted"])
def test_wrapper_checks_width(width):
    """A given width is an int in [fl, 2^20] (fl = 24 here); within that,
    any width gives the same outputs (it sizes the kernel's rows only)."""
    x, starts, taps = _case()
    if width is None:
        assert torch.equal(pd.poly_dot(x, starts, taps, 24),
                           pd.poly_dot(x, starts, taps))
        return
    with pytest.raises(ValueError, match="width"):
        pd.poly_dot(x, starts, taps, width)


def test_wrapper_refuses_other_devices():
    x, starts, taps = _case()
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        pd.poly_dot(x.to("meta"), starts.to("meta"), taps.to("meta"))
    with pytest.raises(ValueError, match="device"):
        pd.poly_dot(x, starts.to("meta"), taps)


def test_no_launch_on_the_cpu():
    x, starts, taps = _case()
    before = pd.poly_dot.launches
    pd.poly_dot(x, starts, taps)
    assert pd.poly_dot.launches == before


def _recorder(calls):
    real = stages.poly_dot

    def rec(x, starts, taps, width=None):
        calls.append((tuple(x.shape), x.dtype, tuple(starts.shape), width))
        return real(x, starts, taps, width)
    return rec


#: (label, FracPolyExec keywords, call, takes the kernel): the executor's
#: calls on a float32 44.1k -> 96001 stage; "df" is apply_df with the
#: seam residual l and/or emit_pair
ENGAGE = [
    ("fast apply", {}, "apply", True),
    ("fast apply_v", {}, "apply_v", True),
    ("fast apply_df, no l, no pair", {}, ("df", False, False), True),
    ("fast apply_df with l", {}, ("df", True, False), False),
    ("fast apply_df with the pair", {}, ("df", False, True), False),
    ("high apply_v", dict(precision="high"), "apply_v", False),
    ("split products", dict(precision="high", oz_products=True), "apply_v",
     False),
    ("float64 banded", dict(dtype=torch.float64, engine="banded"),
     "apply_v", False),
    ("gather", dict(engine="gather"), "apply_v", None),
]


@pytest.mark.parametrize("label,kw,call,kernel", ENGAGE,
                         ids=[e[0] for e in ENGAGE])
def test_engagement(label, kw, call, kernel, monkeypatch):
    """poly_dot exactly on float32 "fast" banded calls without a seam
    residual or a pair; poly.kernel / poly.banded one a call by the path
    taken (the gather engine counts neither)."""
    _kernel_on_cpu(monkeypatch)
    calls = []
    monkeypatch.setattr(stages, "poly_dot", _recorder(calls))
    kw = dict(kw)
    dtype = kw.pop("dtype", torch.float32)
    ex = FracPolyExec(_spec(44100, 96001), dtype, **kw)
    x = _x(2, 3000).to(dtype)
    with torch.profiler.profile(activities=ACTS):
        trace.reset_counters()
        if call == "apply":
            y = ex.apply(x)
        elif call == "apply_v":
            y, _m = ex.apply_v(x, 2900)
        else:
            _, has_l, pair = call
            lo = (x * 2**-24).to(torch.bfloat16) if has_l else None
            y = ex.apply_df(x, lo, 2900, emit_pair=pair)[0]
        got = {k: v for k, v in trace.counters().items()
               if k.startswith("poly.")}
    trace.reset_counters()
    assert torch.isfinite(y).all()
    if kernel is None:
        assert calls == [] and got == {}
    elif kernel:
        assert len(calls) == 1 and calls[0][3] is not None
        assert got == {"poly.kernel": 1}
    else:
        assert calls == [] and got == {"poly.banded": 1}


def test_cpu_keeps_the_banded_contraction(monkeypatch):
    """By default the CPU never takes poly_dot: a 44.1k -> 96001 oneshot
    counts poly.banded, and the recorder sees no call."""
    calls = []
    monkeypatch.setattr(stages, "poly_dot", _recorder(calls))
    rs = Resampler(44100, 96001, 2.0, 180.15, device="cpu")
    ex = next(e for e in rs.execs if isinstance(e, FracPolyExec))
    x32 = _x(2, 3000)
    assert ex._dot_math(x32, None, False)
    assert not ex._takes_kernel(x32, None, False)
    with torch.profiler.profile(activities=ACTS):
        trace.reset_counters()
        rs.oneshot(_x(2, 4410))
        got = trace.counters()
    trace.reset_counters()
    assert calls == []
    assert got.get("poly.banded") == 1 and "poly.kernel" not in got


def test_kernel_state_built_once_a_length(monkeypatch):
    _kernel_on_cpu(monkeypatch)
    ex = FracPolyExec(_spec(44100, 96001), torch.float32)
    x = _x(1, 3000)
    y = ex.apply(x)
    st = next(iter(ex._state.values()))
    assert list(ex._state) == [("dot", ex.out_len(3000), CPU)]
    assert torch.equal(ex.apply(x), y)
    assert next(iter(ex._state.values())) is st


@pytest.mark.parametrize("n_in", [4410, 44100])
def test_kernel_path_chain_matches_banded(n_in, monkeypatch):
    """The 44.1k -> 96001 oneshot through the kernel path's plain version
    against the banded contraction: the same shape, the same 24 products
    summed in another order (-140 dB relative and below)."""
    rs = Resampler(44100, 96001, 2.0, 180.15, device="cpu")
    x = _x(2, n_in)
    y_band = rs.oneshot(x)
    _kernel_on_cpu(monkeypatch)
    y_kern = rs.oneshot(x)
    assert y_kern.shape == y_band.shape
    d = (y_kern - y_band).double()
    rel = 10 * torch.log10(d.square().mean() / y_band.double().square()
                           .mean())
    assert float(rel) < -140.0
    assert float(d.abs().max()) <= 4e-6 * float(y_band.abs().max())


@pytest.mark.parametrize("how", ["grad", "jvp", "vmap"])
def test_kernel_path_transforms_through_resample_fn(how, monkeypatch):
    """resample_fn at 44.1k -> 96001 on the kernel path: its gradient is
    the banded path's (an adjoint of the same map, summed in another
    order), its jvp the chain on the tangent, vmap the per-item calls."""
    rs = Resampler(44100, 96001, atten=109.56, device="cpu")
    n = 2048
    x = _x(1, n, seed=7)
    w = _x(1, rs.default_out_len(n), seed=8)

    def vdot_grad(f):
        return grad(lambda z: (w * f(z)).sum())

    g_band = vdot_grad(resample_fn(rs, n))(x)
    _kernel_on_cpu(monkeypatch)
    f = resample_fn(rs, n)
    if how == "grad":
        g = vdot_grad(f)(x)
        assert float((g - g_band).abs().max()) <= 1e-5 * float(
            g_band.abs().max())
        lhs = float((w.double() * f(x).double()).sum())
        rhs = float((g.double() * x.double()).sum())
        assert abs(lhs - rhs) <= 1e-4 * max(1.0, abs(lhs))
    elif how == "jvp":
        _y, dy = jvp(f, (x,), (x * 0.5,))
        assert torch.equal(dy, f(x * 0.5))
    else:
        xb = torch.stack([x, -x])
        yb = vmap(f)(xb)
        assert torch.equal(yb[0], f(x)) and torch.equal(yb[1], f(-x))
