"""Virtual file IO: local paths plus remote filesystem URIs.

The port's copy of lightgbm_tpu/utils/vfile.py. Any ``scheme://`` path
(``hdfs://``, ``s3://``, ``gs://``, ``memory://``, ...) opens through
fsspec, imported lazily; everything else through the builtin ``open``. The
serving registry reads model text through ``vopen``, so a remote URI works
wherever a path does, and fails at call time with a clear error when fsspec
(or the scheme's driver) is unavailable.
"""
from __future__ import annotations

import os
import re

from . import log

_SCHEME_RE = re.compile(r"^[A-Za-z][A-Za-z0-9+.-]*://")


def is_remote(path: str) -> bool:
    """True for scheme-prefixed URIs (``file://`` counts: fsspec handles it)."""
    return isinstance(path, str) and bool(_SCHEME_RE.match(path))


def vopen(path: str, mode: str = "r"):
    """Open a local path or a remote URI; file-like object either way."""
    if not is_remote(path):
        return open(path, mode)
    try:
        import fsspec
    except ImportError:
        log.fatal(
            "Remote path %r needs the fsspec package (the reference gates "
            "hdfs:// behind USE_HDFS the same way)" % (path,)
        )
    try:
        return fsspec.open(path, mode).open()
    except Exception as e:  # unknown scheme / missing driver / auth
        log.fatal("Cannot open %r: %s: %s" % (path, type(e).__name__, e))


def vexists(path: str) -> bool:
    if not is_remote(path):
        return os.path.exists(path)
    try:
        import fsspec
    except ImportError:
        log.warning(
            "Cannot check existence of remote path %r: fsspec is not "
            "installed; treating as absent" % (path,)
        )
        return False
    try:
        fs, rel = fsspec.core.url_to_fs(path)
        return fs.exists(rel)
    except Exception as e:
        # fs.exists() is False for a missing path; an exception here is a
        # transient, auth or driver failure: say so instead of "absent"
        log.warning(
            "Could not check existence of %r (%s: %s); treating as absent"
            % (path, type(e).__name__, e)
        )
        return False
