"""Import-time environment knobs (lightgbm_tpu/utils/platform.py env_choice)."""
from __future__ import annotations

import os
import warnings


def env_choice(name: str, allowed) -> str:
    """The env var's lowercased value if it is in ``allowed``, else "" with a
    warning: a typo or another package's vocabulary is ignored loudly."""
    val = os.environ.get(name, "").lower()
    if val and val not in allowed:
        warnings.warn(
            "%s=%r not recognized (expected one of %s); ignoring"
            % (name, val, "/".join(sorted(allowed)))
        )
        return ""
    return val
