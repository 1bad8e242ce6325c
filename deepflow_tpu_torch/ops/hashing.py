"""Vectorized 64-bit fingerprints built from u32 lanes (port of
deepflow_tpu/ops/hashing.py).

The group-by key is a pair of u32 lanes produced by two murmur3-style
column folds with different seeds. Lanes follow the port's u32 rule
(ops/u32.py): int64 tensors holding u32 values; the murmur multiplies go
through `u32.mul`, so no intermediate overflows int64. Hash values are
bit-equal to the JAX package's for the same inputs.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .u32 import add, mul, rotl

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_FMIX1 = 0x85EBCA6B
_FMIX2 = 0xC2B2AE35

SEED_HI = 0x9747B28C
SEED_LO = 0x3C6EF372


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer (avalanche)."""
    h = h ^ (h >> 16)
    h = mul(h, _FMIX1)
    h = h ^ (h >> 13)
    h = mul(h, _FMIX2)
    return h ^ (h >> 16)


def _fold(cols: Sequence[torch.Tensor], seed: int) -> torch.Tensor:
    """murmur3_32 body over a list of [N] u32 lanes."""
    h = None
    for c in cols:
        k = mul(rotl(mul(c, _C1), 15), _C2)
        if h is None:
            h = torch.full_like(k, seed)
        h = rotl(h ^ k, 13)
        h = add(mul(h, 5), 0xE6546B64)
    return fmix32(h ^ (len(cols) * 4))


def fingerprint64(tags: torch.Tensor):
    """[N, T] u32 tag matrix → (hi, lo) pair of [N] u32 fingerprints."""
    cols = [tags[:, j] for j in range(tags.shape[1])]
    return _fold(cols, SEED_HI), _fold(cols, SEED_LO)


def fingerprint64_t(tags_t: torch.Tensor):
    """Column-major twin: [T, N] u32 → (hi, lo) [N] u32."""
    cols = [tags_t[j] for j in range(tags_t.shape[0])]
    return _fold(cols, SEED_HI), _fold(cols, SEED_LO)


def fingerprint64_words(words: Sequence[torch.Tensor]):
    """Fold a pre-packed word list (datamodel.code.pack_tag_words) into
    the (hi, lo) pair — both seeds over the same words."""
    return _fold(words, SEED_HI), _fold(words, SEED_LO)
