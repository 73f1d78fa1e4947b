"""lightgbm_tpu_torch: the PyTorch and CUDA port of lightgbm_tpu.

The JAX package ``lightgbm_tpu`` stays the reference; this package imports
nothing of it and no JAX. Its training path runs two hand-written Hopper
kernels on CUDA tensors — the leaf histogram (csrc/histogram.cu) and the
two-child split scan (csrc/split_pair.cu) — and their plain PyTorch
versions on CPU tensors. Its serving path (``serve/``, ``Booster.to_packed``)
runs the packed-ensemble kernels of csrc/packed_predict.cu. Entry points run
on the card unless the caller asks for ``device="cpu"``.
"""
from .basic import Booster, Dataset
from .callback import early_stopping, print_evaluation, record_evaluation, reset_parameter
from .engine import CVBooster, cv, train

__version__ = "0.1.0"

__all__ = ["Booster", "CVBooster", "Dataset", "cv", "early_stopping", "print_evaluation", "record_evaluation",
           "reset_parameter", "train", "__version__"]
