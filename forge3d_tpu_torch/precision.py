# forge3d_tpu_torch/precision.py
# Double-float (float32 pair) arithmetic of forge3d_tpu/precision.py: the
# error-free transformations, the four DD operations (kernel E9,
# csrc/leaf.cuh:dd_op, launched by csrc/leaf.cu:dd_kernel; plain versions
# beside them here), the float64 error-bound self-test, the one-op harness
# and the camera-anchor demo.
#
# Every float32 operation is rounded on its own, in the JAX functions'
# order (JAX runs them eagerly, one jnp operation at a time); square roots
# go through `sqrt32`, which is correctly rounded on every CPU. CPU tensors
# run the plain versions, CUDA tensors launch the kernel (built with
# -fmad=false: a contracted product would break Dekker's split).

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import _kernels
from .ops.shading import sqrt32

__all__ = ["DD", "dd_from_f64", "dd_to_f64", "dd_add", "dd_mul", "dd_div",
           "dd_sqrt", "two_sum", "two_prod", "dd_selftest", "dd_harness",
           "dd_jitter_demo"]

_F32 = torch.float32
_U = 2.0 ** -24  # f32 unit roundoff

# the op codes of csrc/leaf.cuh (F3D_DD_*)
_OPS = {"add": 0, "mul": 1, "div": 2, "sqrt": 3}


class DD(NamedTuple):
    """Unevaluated sum hi + lo with |lo| <= ulp(hi)/2 (float32 tensors)."""

    hi: torch.Tensor
    lo: torch.Tensor


def two_sum(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Knuth two-sum: s + e == a + b exactly (f32)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    """Dekker split of f32 into hi/lo 12-bit halves (2^12+1 factor)."""
    c = 4097.0 * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dekker two-product: p + e == a*b exactly (barring overflow)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dd_from_f64(x, device="cuda") -> DD:
    """Split f64 host values into a DD pair on `device` (the card unless
    device="cpu")."""
    from .pt.terrain_ref import resolve_device

    dev = resolve_device(device)
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return DD(torch.as_tensor(hi, device=dev), torch.as_tensor(lo, device=dev))


def dd_to_f64(d: DD) -> np.ndarray:
    return (d.hi.cpu().numpy().astype(np.float64) + d.lo.cpu().numpy().astype(np.float64))


def _add_plain(a: DD, b: DD) -> DD:
    s, e = two_sum(a.hi, b.hi)
    e = e + (a.lo + b.lo)
    return DD(*two_sum(s, e))


def _mul_plain(a: DD, b: DD) -> DD:
    p, e = two_prod(a.hi, b.hi)
    e = e + (a.hi * b.lo + a.lo * b.hi)
    return DD(*two_sum(p, e))


def _div_plain(a: DD, b: DD) -> DD:
    q1 = a.hi / b.hi
    # residual r = a - q1*b computed in DD
    p, e = two_prod(q1, b.hi)
    r_hi, r_e = two_sum(a.hi, -p)
    r = r_hi + (r_e + a.lo - e - q1 * b.lo)
    q2 = r / b.hi
    return DD(*two_sum(q1, q2))


def _sqrt_plain(a: DD) -> DD:
    q1 = sqrt32(a.hi)
    safe = q1 > 0
    q1s = torch.where(safe, q1, 1.0)
    p, e = two_prod(q1s, q1s)
    r_hi, r_e = two_sum(a.hi, -p)
    r = r_hi + (r_e + a.lo - e)
    q2 = r / (2.0 * q1s)
    hi, lo = two_sum(q1s, q2)
    return DD(torch.where(safe, hi, 0.0), torch.where(safe, lo, 0.0))


def _dd_kernel(op: str, a: DD, b=None) -> DD:
    ts = [a.hi.contiguous(), a.lo.contiguous()]
    if b is not None:
        ts += [b.hi.contiguous(), b.lo.contiguous()]
        if b.hi.shape != a.hi.shape:
            raise ValueError(f"dd_{op}: the kernel takes pairs of one shape, got "
                             f"{tuple(a.hi.shape)} and {tuple(b.hi.shape)}")
    _kernels.require_cuda(f"E9 dd_{op}", *ts)
    if any(t.dtype != _F32 for t in ts):
        raise ValueError(f"dd_{op}: the kernel takes float32 pairs")
    hi = torch.empty_like(ts[0])
    lo = torch.empty_like(ts[0])
    err = _kernels.lib().f3d_dd(_OPS[op], *(_kernels.ptr(t) for t in ts[:2]),
                                *((_kernels.ptr(t) for t in ts[2:]) if b is not None
                                  else (None, None)),
                                hi.numel(), _kernels.ptr(hi), _kernels.ptr(lo),
                                _kernels.stream_ptr(hi.device))
    _kernels.check(err, f"E9 dd_{op}")
    globals()[f"dd_{op}"].launches += 1
    return DD(hi, lo)


def dd_add(a: DD, b: DD) -> DD:
    """(hi, lo) of a + b (kernel E9 on CUDA tensors)."""
    if a.hi.device.type == "cpu":
        return _add_plain(a, b)
    return _dd_kernel("add", a, b)


def dd_mul(a: DD, b: DD) -> DD:
    """(hi, lo) of a * b (kernel E9 on CUDA tensors)."""
    if a.hi.device.type == "cpu":
        return _mul_plain(a, b)
    return _dd_kernel("mul", a, b)


def dd_div(a: DD, b: DD) -> DD:
    """(hi, lo) of a / b (kernel E9 on CUDA tensors)."""
    if a.hi.device.type == "cpu":
        return _div_plain(a, b)
    return _dd_kernel("div", a, b)


def dd_sqrt(a: DD) -> DD:
    """(hi, lo) of sqrt(a), (0, 0) where hi <= 0 (kernel E9 on CUDA
    tensors)."""
    if a.hi.device.type == "cpu":
        return _sqrt_plain(a)
    return _dd_kernel("sqrt", a)


for _fn in (dd_add, dd_mul, dd_div, dd_sqrt):
    _fn.launches = 0

#: the plain version of each op, by name (any device)
PLAIN = {"add": _add_plain, "mul": _mul_plain, "div": _div_plain, "sqrt": _sqrt_plain}


# ---------------------------------------------------------------------------
# proofs


_BOUNDS_U2 = {"add": 3.0, "mul": 7.0, "div": 15.0, "sqrt": 15.0}


def dd_selftest(n: int = 1_000_000, seed: int = 0, device="cuda") -> dict:
    """Measure DD op error against f64 oracle over random vectors; verify
    the committed u^2 bounds (reference seam: dd_selftest; bounds mirror
    CHANGELOG 1.34.0 gates). Returns per-op {max_err_u2, bound_u2, ok}."""
    rng = np.random.default_rng(seed)
    a64 = rng.uniform(-1e3, 1e3, n)
    b64 = rng.uniform(-1e3, 1e3, n)
    b64 = np.where(np.abs(b64) < 1e-3, 1.0, b64)
    a = dd_from_f64(a64, device)
    b = dd_from_f64(b64, device)

    report = {}

    def check(name, got_dd, want64, denom=None):
        got = dd_to_f64(got_dd)
        # relative error in units of u^2; for add the bound is relative to
        # |a|+|b| (cancellation makes result-relative error unbounded)
        denom = np.maximum(np.abs(want64) if denom is None else denom, 1e-300)
        rel = np.abs(got - want64) / denom
        max_u2 = float(rel.max() / (_U * _U))
        report[name] = {"max_err_u2": max_u2,
                        "bound_u2": _BOUNDS_U2[name],
                        "ok": bool(max_u2 <= _BOUNDS_U2[name])}

    check("add", dd_add(a, b), a64 + b64, denom=np.abs(a64) + np.abs(b64))
    check("mul", dd_mul(a, b), a64 * b64)
    check("div", dd_div(a, b), a64 / b64)
    pos = np.abs(a64)
    check("sqrt", dd_sqrt(dd_from_f64(pos, device)), np.sqrt(pos))
    report["n"] = n
    report["ok"] = all(report[k]["ok"] for k in _BOUNDS_U2)
    return report


def dd_harness(op: str, a, b=None, device="cuda") -> dict:
    """Run one DD op on-device and return hi/lo + f64 oracle comparison
    (reference seam: dd_harness, mirroring the WGSL lockstep harness)."""
    a64 = np.asarray(a, np.float64)
    ad = dd_from_f64(a64, device)
    if op == "add":
        b64 = np.asarray(b, np.float64)
        out = dd_add(ad, dd_from_f64(b64, device))
        want = a64 + b64
    elif op == "mul":
        b64 = np.asarray(b, np.float64)
        out = dd_mul(ad, dd_from_f64(b64, device))
        want = a64 * b64
    elif op == "div":
        b64 = np.asarray(b, np.float64)
        out = dd_div(ad, dd_from_f64(b64, device))
        want = a64 / b64
    elif op == "sqrt":
        out = dd_sqrt(ad)
        want = np.sqrt(a64)
    else:
        raise ValueError(f"unknown dd op: {op}")
    got = dd_to_f64(out)
    return {"op": op, "hi": out.hi.cpu().numpy().tolist(),
            "lo": out.lo.cpu().numpy().tolist(),
            "result_f64": got.tolist(),
            "oracle_f64": np.asarray(want).tolist(),
            "max_abs_err": float(np.max(np.abs(got - want)))}


def dd_jitter_demo(anchor: float = 1.0e7, extent: float = 2.0,
                   n: int = 1024, seed: int = 3, device="cuda") -> dict:
    """Camera-anchor precision demo: positions near a large world anchor
    lose sub-meter detail in plain f32; DD keeps it (reference seam:
    dd_jitter_demo — the MENSURA f64-anchor motivation)."""
    rng = np.random.default_rng(seed)
    offsets = rng.uniform(-extent, extent, n)
    world = anchor + offsets

    # plain f32 path: world positions stored in f32, camera-relative delta
    f32_rel = (world.astype(np.float32)
               - np.float32(anchor)).astype(np.float64)
    f32_err = np.abs(f32_rel - offsets)

    # DD path: world stored as DD, subtract DD anchor
    w = dd_from_f64(world, device)
    a = dd_from_f64(np.full(n, anchor), device)
    rel = dd_add(w, DD(-a.hi, -a.lo))
    dd_err = np.abs(dd_to_f64(rel) - offsets)

    return {
        "anchor": anchor,
        "extent": extent,
        "f32_max_err": float(f32_err.max()),
        "dd_max_err": float(dd_err.max()),
        "improvement": float(f32_err.max() / max(dd_err.max(), 1e-300))
        if dd_err.max() > 0 else math.inf,
    }
