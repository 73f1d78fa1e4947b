from . import log
from .log import LightGBMError

__all__ = ["log", "LightGBMError"]
