# forge3d_tpu_torch/assurance/ed25519.py
# Pure-Python Ed25519 (RFC 8032) sign/verify: a copy of
# forge3d_tpu/assurance/ed25519.py (field arithmetic over 2^255-19, point
# compression, SHA-512 key expansion). Slow but correct Python ints:
# certificate signing is a cold path.

from __future__ import annotations

import hashlib
import secrets
from typing import Tuple

__all__ = ["generate_keypair", "sign", "verify", "public_key_from_seed"]

_p = 2**255 - 19
_L = 2**252 + 27742317777372353535851937790883648493
_d = (-121665 * pow(121666, _p - 2, _p)) % _p
_I = pow(2, (_p - 1) // 4, _p)


def _sha512(*parts: bytes) -> bytes:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return h.digest()


def _inv(x: int) -> int:
    return pow(x, _p - 2, _p)


def _recover_x(y: int, sign_bit: int) -> int:
    if y >= _p:
        raise ValueError("invalid point encoding")
    x2 = (y * y - 1) * _inv(_d * y * y + 1) % _p
    if x2 == 0:
        if sign_bit:
            raise ValueError("invalid point encoding")
        return 0
    x = pow(x2, (_p + 3) // 8, _p)
    if (x * x - x2) % _p != 0:
        x = x * _I % _p
    if (x * x - x2) % _p != 0:
        raise ValueError("invalid point encoding")
    if (x & 1) != sign_bit:
        x = _p - x
    return x


_By = 4 * _inv(5) % _p
_Bx = _recover_x(_By, 0)
_B = (_Bx, _By, 1, _Bx * _By % _p)   # extended coords (X, Y, Z, T)


def _edwards_add(P, Q):
    X1, Y1, Z1, T1 = P
    X2, Y2, Z2, T2 = Q
    A = (Y1 - X1) * (Y2 - X2) % _p
    Bv = (Y1 + X1) * (Y2 + X2) % _p
    C = 2 * T1 * T2 * _d % _p
    D = 2 * Z1 * Z2 % _p
    E, F, G, H = Bv - A, D - C, D + C, Bv + A
    return (E * F % _p, G * H % _p, F * G % _p, E * H % _p)


def _scalar_mult(P, s: int):
    Q = (0, 1, 1, 0)  # identity
    while s > 0:
        if s & 1:
            Q = _edwards_add(Q, P)
        P = _edwards_add(P, P)
        s >>= 1
    return Q


def _compress(P) -> bytes:
    X, Y, Z, _ = P
    zi = _inv(Z)
    x = X * zi % _p
    y = Y * zi % _p
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def _decompress(data: bytes):
    if len(data) != 32:
        raise ValueError("invalid point encoding")
    y = int.from_bytes(data, "little")
    sign_bit = y >> 255
    y &= (1 << 255) - 1
    x = _recover_x(y, sign_bit)
    return (x, y, 1, x * y % _p)


def _secret_expand(seed: bytes) -> Tuple[int, bytes]:
    h = _sha512(seed)
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def public_key_from_seed(seed: bytes) -> bytes:
    """32-byte public key from a 32-byte seed."""
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    a, _ = _secret_expand(seed)
    return _compress(_scalar_mult(_B, a))


def generate_keypair(seed: bytes = None) -> Tuple[bytes, bytes]:
    """(seed, public_key); seed is the RFC 8032 private key."""
    seed = seed if seed is not None else secrets.token_bytes(32)
    return seed, public_key_from_seed(seed)


def sign(seed: bytes, message: bytes) -> bytes:
    """64-byte Ed25519 signature."""
    a, prefix = _secret_expand(seed)
    A = _compress(_scalar_mult(_B, a))
    r = int.from_bytes(_sha512(prefix, message), "little") % _L
    R = _compress(_scalar_mult(_B, r))
    k = int.from_bytes(_sha512(R, A, message), "little") % _L
    s = (r + k * a) % _L
    return R + int.to_bytes(s, 32, "little")


def verify(public_key: bytes, message: bytes, signature: bytes) -> bool:
    """Constant-structure verification; returns False on any failure."""
    try:
        if len(signature) != 64:
            return False
        R = _decompress(signature[:32])
        A = _decompress(public_key)
        s = int.from_bytes(signature[32:], "little")
        if s >= _L:
            return False
        k = int.from_bytes(_sha512(signature[:32], public_key, message),
                           "little") % _L
        sB = _scalar_mult(_B, s)
        kA = _scalar_mult(A, k)
        RkA = _edwards_add(R, kA)
        return _compress(sB) == _compress(RkA)
    except (ValueError, TypeError):
        return False
