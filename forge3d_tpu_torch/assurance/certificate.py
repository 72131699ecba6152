# forge3d_tpu_torch/assurance/certificate.py
# Render-execution certificates: signed, canonical-JSON records of what a
# render executed. A copy of forge3d_tpu/assurance/certificate.py with the
# same schema, engine stamp, development key and Ed25519 signature, so a
# render of the port carries the certificate the JAX package would write.

from __future__ import annotations

import hashlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .._version import __version__

_SCHEMA = "forge3d-tpu/certificate/v1"

_local = threading.local()


def canonical_json(obj: Any) -> str:
    """Deterministic JSON: sorted keys, no whitespace drift, repr-stable
    floats (reference: python/forge3d/_canonical_json.py semantics)."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"), allow_nan=False)


@dataclass
class RenderCapture:
    label: str
    started_at: float = field(default_factory=time.time)
    passes: List[Dict[str, Any]] = field(default_factory=list)
    meta: Dict[str, Any] = field(default_factory=dict)
    finished: bool = False

    def record_pass(self, name: str, millis: float, **extra) -> None:
        self.passes.append({"name": name, "ms": float(millis), **extra})

    def finish(self) -> None:
        self.finished = True
        if getattr(_local, "capture", None) is self:
            _local.capture = None

    def abort(self) -> None:
        self.finished = False
        if getattr(_local, "capture", None) is self:
            _local.capture = None


def begin_render_capture(label: str) -> RenderCapture:
    cap = RenderCapture(label)
    _local.capture = cap
    return cap


def current_capture() -> Optional[RenderCapture]:
    return getattr(_local, "capture", None)


def render_execution_report(capture: RenderCapture, inputs_digest: str = "") -> dict:
    body = {
        "schema": _SCHEMA,
        "engine": {"name": "forge3d_tpu", "version": __version__},
        "label": capture.label,
        "passes": capture.passes,
        "inputs_digest": inputs_digest,
        "meta": capture.meta,
    }
    digest = hashlib.sha256(canonical_json(body).encode()).hexdigest()
    return {**body, "digest": digest}


_DEV_SEED = hashlib.sha256(b"forge3d-tpu dev certificate key v1").digest()


def certificate_public_key_hex(seed: Optional[bytes] = None) -> str:
    from .ed25519 import public_key_from_seed

    return public_key_from_seed(seed or _DEV_SEED).hex()


def sign_render_certificate_digest(digest: str,
                                   seed: Optional[bytes] = None) -> str:
    """Ed25519 signature (hex) over the certificate digest."""
    from .ed25519 import sign

    return sign(seed or _DEV_SEED, digest.encode()).hex()


def verify_render_certificate(report: dict,
                              public_key_hex: Optional[str] = None) -> bool:
    """Check digest integrity + Ed25519 signature of a certificate dict."""
    from .ed25519 import verify

    body = {k: v for k, v in report.items()
            if k not in ("digest", "signature")}
    digest = hashlib.sha256(canonical_json(body).encode()).hexdigest()
    if digest != report.get("digest"):
        return False
    pk = bytes.fromhex(public_key_hex or certificate_public_key_hex())
    try:
        sig = bytes.fromhex(report.get("signature", ""))
    except ValueError:
        return False
    return verify(pk, digest.encode(), sig)


def emit_certificate(target, label: str, render_output: dict) -> None:
    """Write a certificate next to a render. `target` is a path or a dict to
    fill in place (mirrors the reference's certificate= kwarg contract)."""
    cap = current_capture() or RenderCapture(label)
    digest_src = {
        "frames": render_output.get("frames"),
        "variance": render_output.get("variance"),
        "shape": list(render_output.get("rgba", b"").shape) if hasattr(render_output.get("rgba", None), "shape") else None,
    }
    report = render_execution_report(cap, inputs_digest=hashlib.sha256(
        canonical_json(digest_src).encode()).hexdigest())
    report["signature"] = sign_render_certificate_digest(report["digest"])
    if isinstance(target, dict):
        target.update(report)
    else:
        with open(target, "w") as f:
            f.write(canonical_json(report))
