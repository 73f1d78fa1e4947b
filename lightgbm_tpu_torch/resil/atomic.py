"""Atomic text publication: temp file + fsync + rename.

Counterpart of lightgbm_tpu/resil/atomic.py ``atomic_write_text`` for local
paths. A process killed at any point leaves either the previous complete
file or the new complete file, never a prefix; the temp name carries the
pid, the thread and a sequence number, so two writers never share one.
"""
from __future__ import annotations

import itertools
import os
import threading

_seq = itertools.count()


def atomic_write_text(path: str, text: str, fsync: bool = True) -> str:
    """Publish ``text`` at ``path`` atomically; returns ``path``."""
    tmp = "%s.%d.%x.%d.tmp" % (path, os.getpid(), threading.get_ident(), next(_seq))
    try:
        with open(tmp, "wb") as fh:
            fh.write(text.encode("utf-8"))
            fh.flush()
            if fsync:
                os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if fsync:
        _fsync_dir(os.path.dirname(os.path.abspath(path)))
    return path


def _fsync_dir(dirname: str) -> None:
    """Make the rename durable; not every filesystem allows directory fds."""
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
