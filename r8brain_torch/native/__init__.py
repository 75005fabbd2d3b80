"""ctypes binding + plan serialization for the native C++ engine.

The reference ships a flat C DLL (DLL/r8bsrc.h) so hosts without C++ can
stream-convert; here the native engine (the repository's ``native/``
directory: native/r8bt.cpp and its designer, built to libr8bt.so) executes
plans designed by this package's design layer -- host-side float64
streaming with no Python in the audio path.  The engine is shared with
the reference package; this module is the port's own binding of it:

  * build_plan_blob(plan) -- serialize a planned stage chain (a plan of
    this package, or one carried across by ``convert.plan_from_reference``)
    and all its designed coefficients into the engine's binary format,
    byte for byte what the reference package's binding writes;
  * native_design_blob -- the engine's own (C++) designer's blob;
  * NativeResampler -- one-channel streaming handle (the reference's
    one-object-per-channel contract) over ctypes;
  * load_library / build_library -- the library is resolved from the
    R8BT_LIB override, then this package's own build of the in-tree
    sources (built on demand), then the system linker path.

The in-tree build copies the engine's sources and Makefile into
``_build/native-<hash>/`` inside the package (keyed on a hash of them) and
runs ``make`` there, under an ``fcntl`` lock, so concurrent processes
build it once and the library that ``make -C native`` writes in place is
left as it is.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import fcntl
import hashlib
import math
import os
import shutil
import struct
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from ..models.plan import (ConvStage, FracStage, HBDownStage, HBUpStage,
                           Plan, make_plan)

__all__ = ["build_plan_blob", "native_design_blob", "NativeResampler",
           "load_library", "build_library"]

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
#: what the library is built from: the Makefile's libr8bt.so rule's inputs
_SOURCES = ("Makefile", "r8bt.cpp", "r8bt_design.cpp", "r8bt_dd.cpp",
            "r8bt_dd.h", "r8bt.h", "r8bt_tables.inc")
_lib = None


def _lib_path() -> Path:
    h = hashlib.sha256(b"".join((_NATIVE_DIR / f).read_bytes()
                                for f in _SOURCES)).hexdigest()[:16]
    return _BUILD_DIR / f"native-{h}" / "libr8bt.so"


def build_library() -> Path:
    """This package's build of libr8bt.so from the in-tree sources (the
    Makefile's rule, g++), built once under a lock; returns its path."""
    out = _lib_path()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.parent.with_suffix(f".{os.getpid()}.tmp")
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir()
            for f in _SOURCES:
                shutil.copy2(_NATIVE_DIR / f, tmp / f)
            r = subprocess.run(["make", "-C", str(tmp), "-j3", out.name],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"native engine build failed (make exited "
                                   f"{r.returncode}):\n{r.stderr[-4000:]}")
            shutil.rmtree(out.parent, ignore_errors=True)
            os.replace(tmp, out.parent)
    return out


def _locate_library(build_if_missing: bool) -> str:
    """Resolve libr8bt.so: R8BT_LIB override (empty == unset), then the
    in-tree build (compiled on demand when the engine's Makefile is
    present: a repository checkout), then the system linker path (an
    installed package, where the engine is deployed separately)."""
    override = os.environ.get("R8BT_LIB") or None
    if override:
        return override
    if (_NATIVE_DIR / "Makefile").exists():
        out = _lib_path()
        if out.exists():
            return str(out)
        if build_if_missing:
            return str(build_library())
    found = ctypes.util.find_library("r8bt")
    if found:
        return found
    raise OSError(
        "libr8bt.so not found: set R8BT_LIB, build it with "
        "r8brain_torch.native.build_library() (repository checkout), or "
        "install it on the system linker path")


def load_library(build_if_missing: bool = True) -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_locate_library(build_if_missing))
    lib.r8bt_create_from_blob.restype = ctypes.c_void_p
    lib.r8bt_create_from_blob.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.r8bt_delete.argtypes = [ctypes.c_void_p]
    lib.r8bt_clear.argtypes = [ctypes.c_void_p]
    lib.r8bt_process.restype = ctypes.c_long
    lib.r8bt_process.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_double),
                                 ctypes.c_long,
                                 ctypes.POINTER(ctypes.POINTER(
                                     ctypes.c_double))]
    lib.r8bt_in_required_for_out.restype = ctypes.c_long
    lib.r8bt_in_required_for_out.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.r8bt_latency_frac.restype = ctypes.c_double
    lib.r8bt_latency_frac.argtypes = [ctypes.c_void_p]
    lib.r8bt_version.restype = ctypes.c_char_p
    # Standalone native designer (native/r8bt_design.cpp)
    lib.r8bt_create.restype = ctypes.c_void_p
    lib.r8bt_create.argtypes = [ctypes.c_double, ctypes.c_double,
                                ctypes.c_double, ctypes.c_int]
    lib.r8bt_create_ex.restype = ctypes.c_void_p
    lib.r8bt_create_ex.argtypes = [ctypes.c_double, ctypes.c_double,
                                   ctypes.c_double, ctypes.c_double,
                                   ctypes.c_int]
    lib.r8bt_design_blob.restype = ctypes.c_long
    lib.r8bt_design_blob.argtypes = [ctypes.c_double, ctypes.c_double,
                                     ctypes.c_double, ctypes.c_double,
                                     ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_long]
    _lib = lib
    return lib


def native_design_blob(src_rate: float, dst_rate: float,
                       trans_band: float = 2.0, atten: float = 206.91,
                       phase: int = 0) -> bytes:
    """Run the NATIVE (C++) designer and return its serialized plan blob —
    same format as build_plan_blob, designed without Python
    (native/r8bt_design.cpp, r8bt_design_blob)."""
    lib = load_library()
    n = lib.r8bt_design_blob(src_rate, dst_rate, trans_band, atten, phase,
                             None, 0)
    if n < 0:
        raise ValueError(
            f"native designer rejected {src_rate}->{dst_rate} "
            f"tb={trans_band} atten={atten} phase={phase}")
    buf = ctypes.create_string_buffer(n)
    lib.r8bt_design_blob(src_rate, dst_rate, trans_band, atten, phase,
                         ctypes.cast(buf, ctypes.c_void_p), n)
    return bytes(buf.raw)


def build_plan_blob(plan: Plan) -> bytes:
    out = bytearray()
    out += b"R8BT"
    out += struct.pack("<I", 1)
    out += struct.pack("<ddd", plan.src_rate, plan.dst_rate,
                       plan.latency_frac)
    out += struct.pack("<I", len(plan.stages))
    for s in plan.stages:
        if isinstance(s, ConvStage):
            k = np.asarray(s.filt.kernel, dtype="<f8")
            out += struct.pack("<I", 0)
            out += struct.pack("<qqqq", s.up, s.down, s.offset, k.shape[0])
            out += k.tobytes()
        elif isinstance(s, (HBUpStage, HBDownStage)):
            t = np.asarray(s.hb.taps, dtype="<f8")
            out += struct.pack("<I", 1 if isinstance(s, HBUpStage) else 2)
            out += struct.pack("<qq", t.shape[0], s.out_latency)
            out += t.tobytes()
        elif isinstance(s, FracStage) and s.is_whole:
            tab = np.asarray(s.bank.table, dtype="<f8")
            out += struct.pack("<I", 3)
            out += struct.pack("<qqqqq", s.in_step, s.out_step,
                               s.init_frac_pos_w, s.in_latency,
                               s.filter_len)
            out += tab.tobytes()
        elif isinstance(s, FracStage):
            tab = np.asarray(s.bank.table, dtype="<f8")
            out += struct.pack("<I", 4)
            out += struct.pack("<ddd", s.src_rate, s.dst_rate,
                               s.init_frac_pos)
            out += struct.pack("<qqqq", s.in_latency, s.filter_len,
                               s.bank.fracs, tab.shape[0])
            out += tab.tobytes()
        else:
            raise TypeError(s)
    return bytes(out)


class NativeResampler:
    """Single-channel push-mode resampler over the native engine.

    design="python" (default) plans/designs the filter chain in the Python
    design layer and ships it as a plan blob; design="native" runs the C++
    designer inside libr8bt (r8bt_create_ex — the reference DLL's
    r8b_create shape, DLL/r8bsrc.h:68-71) so no Python design work happens
    at all (self.plan is None in that mode)."""

    def __init__(self, src_rate: float, dst_rate: float,
                 trans_band: float = 2.0, atten: float = 206.91,
                 phase: int = 0, plan: Optional[Plan] = None,
                 design: str = "python", blob: Optional[bytes] = None):
        self._src_rate = float(src_rate)
        self._dst_rate = float(dst_rate)
        self._lib = load_library()
        if blob is not None:
            # One design, many engines: instantiate directly from a plan
            # blob (build_plan_blob / native_design_blob) — the natbench
            # pattern; avoids re-running the designer per channel.
            if plan is not None:
                raise ValueError("plan= conflicts with blob=")
            # oneshot()'s default out_len uses the constructor rates, so a
            # blob designed for different rates must fail loudly here, not
            # produce a silently wrong-length output.
            if len(blob) < 24 or blob[:4] != b"R8BT":
                raise ValueError("not a plan blob (bad magic/size)")
            b_src, b_dst = struct.unpack_from("<dd", blob, 8)
            # Positive-form check: NaN/Inf header rates make every
            # comparison False, so require the match to *hold* rather
            # than testing for a mismatch (a NaN rate then fails here
            # instead of slipping past both layers).
            if not (math.isfinite(b_src) and math.isfinite(b_dst)
                    and abs(b_src - self._src_rate) <= 1e-9 * abs(b_src)
                    and abs(b_dst - self._dst_rate) <= 1e-9 * abs(b_dst)):
                raise ValueError(
                    f"blob is a {b_src:g}->{b_dst:g} design but the "
                    f"resampler was constructed for "
                    f"{self._src_rate:g}->{self._dst_rate:g}")
            self.plan = None
            self._blob = blob  # keep alive
            self._h = self._lib.r8bt_create_from_blob(
                ctypes.cast(ctypes.c_char_p(blob), ctypes.c_void_p),
                len(blob))
            if not self._h:
                raise RuntimeError("native engine rejected the plan blob")
            return
        if design == "native":
            if plan is not None:
                raise ValueError("plan= conflicts with design='native'")
            self.plan = None
            self._h = self._lib.r8bt_create_ex(
                float(src_rate), float(dst_rate), float(trans_band),
                float(atten), int(phase))
            if not self._h:
                raise ValueError(
                    f"native designer rejected {src_rate}->{dst_rate} "
                    f"tb={trans_band} atten={atten} phase={phase}")
            return
        if design != "python":
            raise ValueError(f"unknown design mode {design!r}")
        self.plan = plan if plan is not None else make_plan(
            src_rate, dst_rate, trans_band, atten, phase)
        blob = build_plan_blob(self.plan)
        self._blob = blob  # keep alive
        self._h = self._lib.r8bt_create_from_blob(
            ctypes.cast(ctypes.c_char_p(blob), ctypes.c_void_p), len(blob))
        if not self._h:
            raise RuntimeError("native engine rejected the plan blob")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.r8bt_delete(h)
            self._h = None

    def clear(self):
        self._lib.r8bt_clear(self._h)

    def process(self, x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, dtype=np.float64)
        outp = ctypes.POINTER(ctypes.c_double)()
        n = self._lib.r8bt_process(
            self._h, x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            x.shape[0], ctypes.byref(outp))
        if n < 0:
            raise RuntimeError("r8bt_process failed")
        if n == 0:
            return np.zeros(0, dtype=np.float64)
        return np.ctypeslib.as_array(outp, shape=(n,)).copy()

    def get_input_required_for_output(self, m: int) -> int:
        return int(self._lib.r8bt_in_required_for_out(self._h, m))

    @property
    def latency_frac(self) -> float:
        return float(self._lib.r8bt_latency_frac(self._h))

    def oneshot(self, x: np.ndarray, out_len: Optional[int] = None
                ) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        if out_len is None:
            out_len = int(np.floor(
                x.shape[0] * self._dst_rate / self._src_rate))
        self.clear()
        out = []
        total = 0
        pos = 0
        chunk = 4096
        while total < out_len:
            if pos < x.shape[0]:
                c = x[pos : pos + chunk]
                pos += c.shape[0]
            else:
                c = np.zeros(chunk, dtype=np.float64)
            y = self.process(c)
            out.append(y)
            total += y.shape[0]
        self.clear()
        y = np.concatenate(out) if out else np.zeros(0)
        return y[:out_len]
