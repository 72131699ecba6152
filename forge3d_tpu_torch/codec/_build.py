# forge3d_tpu_torch/codec/_build.py
# Native build helper of forge3d_tpu/codec/_build.py: compile a host .cpp
# source with g++ into a shared object at first use, cached by a hash of the
# source in the port's build directory (build/forge3d_tpu_torch/ beside the
# package, listed in .gitignore), never in the source tree.

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path

from .._kernels import BUILD_DIR

_LOCK = threading.Lock()
_CACHE: dict = {}


class NativeBuildError(RuntimeError):
    pass


def build_native(name: str, source: Path) -> Path:
    """Compile `source` to a cached .so; returns the library path."""
    key = str(source)
    with _LOCK:
        if key in _CACHE:
            return _CACHE[key]
        digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib = BUILD_DIR / f"lib{name}-{digest}.so"
        if not lib.exists():
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                   "-fno-fast-math", str(source), "-o", tmp]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise NativeBuildError(f"g++ failed for {name}:\n{proc.stderr[-4000:]}")
            os.replace(tmp, lib)  # atomic: a concurrent builder never loads a partial file
        _CACHE[key] = lib
        return lib
