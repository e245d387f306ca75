"""Native (C++) host-runtime components, loaded via ctypes.

The reference's runtime outside the compute kernels is C++; here the
host-side preprocessing that cannot ride XLA (sequential chain tracing,
graph surgery) has a C++ fast path compiled on first use with g++.
Python implementations remain as behavior-defining fallbacks.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(__file__), "extraction.cpp")
_SO = os.path.join(os.path.dirname(__file__), "_extraction.so")


def _build() -> str | None:
    """Compile the library if it is missing or stale.  A failed build
    warns once with the compiler's output: extraction then falls back
    to the Python twin, whose chains differ (PARITY_EXTRACTION.md)."""
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return _SO
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-std=c++17", _SRC, "-o", _SO + ".tmp"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=120)
    except subprocess.CalledProcessError as e:
        detail = e.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        detail = str(e)
    else:
        os.replace(_SO + ".tmp", _SO)
        return _SO
    warnings.warn("native extraction build failed; using the Python "
                  f"extraction twin instead:\n{detail}", RuntimeWarning,
                  stacklevel=3)
    return None


def get_extraction_lib():
    """ctypes handle to the native extraction library, or None."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
            fn = lib.eg3d_extract_chains
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ]
            _LIB = lib
        except (OSError, AttributeError) as e:
            warnings.warn(f"native extraction library failed to load: {e}",
                          RuntimeWarning, stacklevel=2)
            _LIB = None
        return _LIB
