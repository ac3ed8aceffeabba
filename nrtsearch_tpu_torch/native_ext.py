"""Build and load the native postings accumulator (counterpart:
nrtsearch_tpu/native_ext.py).

``csrc/host/nrt_tokenize.cpp`` is a byte-for-byte copy of the reference's
``native/nrt_tokenize.cpp``: a CPython extension with the standard
analyzer's ASCII tokenizer and ``PostingsAccumulator``, which builds a
field's term-major packed postings (with positions) in C++ as documents
stream in. It is host code; the segment builder (core/segment.py) uses it
when it loads.

At first use ``get()`` compiles it with g++ against the running CPython's
headers into ``_native_build/`` beside the package (rebuilt when the source
is newer), writing a temporary file and renaming it, so that processes
building at once never load a partial library. ``NRT_NATIVE=0``, a missing
toolchain or a failed build leave ``get()`` returning None, and the builder
takes its pure-Python path, as the reference's does.
"""

from __future__ import annotations

import importlib.util
import logging
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

log = logging.getLogger("nrtsearch_tpu_torch.native")

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc" / "host" / "nrt_tokenize.cpp"
_BUILD_DIR = _PKG / "_native_build"

_module = None
_tried = False
_LOCK = threading.Lock()


def _so_path() -> Path:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return _BUILD_DIR / f"nrt_native{suffix}"


def _build() -> bool:
    _BUILD_DIR.mkdir(exist_ok=True)
    include = sysconfig.get_paths()["include"]
    so = _so_path()
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", f"-I{include}", str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError,
            subprocess.TimeoutExpired) as e:
        log.warning("native extension build failed (%s); using the Python builder", e)
        tmp.unlink(missing_ok=True)
        return False


def get() -> object | None:
    """The nrt_native module, or None if unavailable (or NRT_NATIVE=0)."""
    global _module, _tried
    with _LOCK:
        if _module is not None or _tried:
            return _module
        _tried = True
        if os.environ.get("NRT_NATIVE", "1") == "0":
            return None
        so = _so_path()
        try:
            if not so.exists() or so.stat().st_mtime < _SRC.stat().st_mtime:
                if not _build():
                    return None
            # loaded from its path; sys.modules keeps what it held under the
            # name (the reference's build of the same module may be there)
            before = sys.modules.get("nrt_native")
            spec = importlib.util.spec_from_file_location("nrt_native", so)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            if before is None:
                sys.modules.pop("nrt_native", None)
            else:
                sys.modules["nrt_native"] = before
            _module = module
        except Exception as e:
            log.warning("native extension unavailable: %s", e)
            _module = None
        return _module
