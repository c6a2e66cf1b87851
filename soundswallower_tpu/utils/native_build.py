"""Build-on-demand loader for the native (C++) helper libraries.

The .so binaries are not vendored in git: each is rebuilt from its
source via the checked-in Makefile whenever the binary is missing or
older than the .cpp, so a stale binary can never silently diverge from
the source it claims to implement.  ``load_native`` returns None when
the library cannot be produced (no toolchain, unsupported platform) and
logs why.  The I/O, pitch and segment-extraction callers fall back to
Python with identical results; the aligner's host front end refuses to
start without its library (see TpuAligner).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess

LOG = logging.getLogger(__name__)


def native_dir() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native")


def load_native(soname: str) -> ctypes.CDLL | None:
    """Load native/<soname>, (re)building it from source if needed."""
    d = native_dir()
    so = os.path.join(d, soname)
    # libsst_fe.so -> sst_fe.cpp; ISA variants (libsst_fe_avx512.so)
    # build from the same source
    base = soname[3:-3]
    for suffix in ("_avx512",):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
    src = os.path.join(d, base + ".cpp")
    try:
        stale = not os.path.exists(so) or (
            os.path.exists(src)
            and os.path.getmtime(src) > os.path.getmtime(so))
        if stale and os.path.exists(src):
            subprocess.run(["make", "-C", d, soname], check=True,
                           capture_output=True, timeout=300)
        return ctypes.CDLL(so)
    except subprocess.CalledProcessError as e:
        LOG.warning("building native/%s failed: %s", soname,
                    (e.stderr or b"").decode(errors="replace")[-2000:])
    except (OSError, subprocess.SubprocessError) as e:
        LOG.warning("native/%s unavailable: %s", soname, e)
    return None
