"""GOSS boosting (Gradient-based One-Side Sampling) for the PyTorch port.

Counterpart of lightgbm_tpu/models/goss.py (goss.hpp:91-146): keep the
``top_rate`` share of rows with the largest ``sum_k |grad_k * hess_k|``,
sample ``other_rate`` of the rest, and amplify the sampled rows' gradients
and hessians by ``(n - top_k) / other_k``; the subset is the bag mask the
split loops already read. No sampling for the first ``1 / learning_rate``
iterations, nor when ``top_rate`` leaves no row to sample.

The sample's permutation depends on (``bagging_seed``, iteration) alone:
it is drawn between replays (:meth:`GOSS._prepare_bag`, the JAX package's
threefry permutation, models/gbdt.py ``draw_permutation``) into a buffer
the iteration reads. The score, its stable sort, the bag and the
amplification depend on the gradients and run inside the iteration
(:func:`goss_mask_amp`), in the captured graph on CUDA; the JAX package
computes them in XLA, outside any Pallas kernel, and so do these torch ops.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import log
from .gbdt import GBDT, draw_permutation


def goss_mask_amp(grad: torch.Tensor, hess: torch.Tensor, perm: torch.Tensor, top_k: int,
                  other_k: int, mask: Optional[torch.Tensor] = None,
                  amp: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GOSS subset of ``grad``/``hess`` ([K, N] f32) as an [N] f32 bag
    ``mask`` and an [N] f32 amplification ``amp``, bit for bit the JAX
    package's ``_goss_mask_amp``: the score ``sum_k |g * h|`` (a left fold
    over the classes in f32), rows in the order of a stable sort of
    ``-score``, the first ``top_k`` kept, the rest taken in the order of
    ``perm`` ([N - top_k] int64, :func:`draw_permutation`) and the first
    ``other_k`` of them kept with ``amp`` = f32((N - top_k) / other_k).
    Written into ``mask`` and ``amp`` when given; reads nothing back."""
    n = grad.shape[1]
    score = (grad[0] * hess[0]).abs()
    for k in range(1, grad.shape[0]):
        score = score + (grad[k] * hess[k]).abs()
    order = torch.sort(-score, stable=True).indices
    other = order[top_k:][perm[:other_k]]
    if mask is None:
        mask = torch.empty(n, dtype=torch.float32, device=grad.device)
    if amp is None:
        amp = torch.empty(n, dtype=torch.float32, device=grad.device)
    mask.zero_().index_fill_(0, order[:top_k], 1.0).index_fill_(0, other, 1.0)
    amp.fill_(1.0).index_fill_(0, other, float(np.float32((n - top_k) / other_k)))
    return mask, amp


class GOSS(GBDT):
    def _setup_train(self, train_set) -> None:
        super()._setup_train(train_set)
        cfg = self.config
        if cfg.top_rate + cfg.other_rate > 1.0:
            log.fatal("top_rate + other_rate must be <= 1.0 in GOSS")
        if cfg.top_rate <= 0 or cfg.other_rate <= 0:
            log.fatal("top_rate and other_rate must be positive in GOSS")
        if cfg.bagging_freq > 0 and cfg.bagging_fraction != 1.0:
            log.fatal("Cannot use bagging in GOSS")
        #: the sample's buffers: the bag (``_bag`` while sampling), the
        #: amplification and the permutation of the rows past ``top_k``
        self._goss_mask = self._goss_amp = self._goss_perm = None
        self._goss_k = (0, 0)  # (top_k, other_k) the iteration samples with
        log.info("Using GOSS")

    def _prepare_bag(self, iteration: int) -> None:
        """Before iteration ``iteration``: no bag in the warm-up (the first
        ``int(1 / learning_rate)`` iterations, goss.hpp:143-146) or when no
        row is left to sample; else the bag is the sample's mask buffer and
        the permutation of the ``N - top_k`` rows past the top is drawn
        into its buffer (``fold_in(PRNGKey(bagging_seed), iteration)``)."""
        cfg = self.config
        n = self.num_data
        top_k = max(1, int(n * cfg.top_rate))
        other_k = min(max(1, int(n * cfg.other_rate)), n - top_k)
        if iteration < int(1.0 / cfg.learning_rate) or other_k <= 0:
            self._bag = None
            return
        if self._goss_perm is None or self._goss_perm.numel() != n - top_k:
            self._goss_mask = torch.empty(n, dtype=torch.float32, device=self.device)
            self._goss_amp = torch.empty(n, dtype=torch.float32, device=self.device)
            self._goss_perm = torch.empty(n - top_k, dtype=torch.int64, device=self.device)
        self._goss_k = (top_k, other_k)
        self._bag = self._goss_mask
        self._goss_perm.copy_(draw_permutation(cfg.bagging_seed, iteration, n - top_k, self.device))

    def _bagging(self, grad: torch.Tensor, hess: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """While sampling: the bag and the amplification written into their
        buffers, the gradients and hessians times the amplification."""
        if self._bag is None:
            return grad, hess
        _, amp = goss_mask_amp(grad, hess, self._goss_perm, *self._goss_k,
                               mask=self._goss_mask, amp=self._goss_amp)
        return grad * amp, hess * amp

    def _iteration_key(self) -> tuple:
        return super()._iteration_key() + (self._goss_k if self._bag is not None else None,
                                           id(self._goss_perm), id(self._goss_amp))
