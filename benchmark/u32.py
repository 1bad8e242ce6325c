"""u32 arithmetic on int64 tensors, and frozen copies of the hash
functions the rollup and its sketch plane key on.

A u32 value rides an int64 tensor in [0, 2^32); a product with a 32-bit
constant is split into 16-bit halves so that no intermediate passes
2^49. The same code runs on the CPU and on the card and gives the same
bits on both, which is what makes the benchmark's traffic identical for
a seed wherever it is generated.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF

_C1, _C2 = 0xCC9E2D51, 0x1B873593
_FMIX1, _FMIX2 = 0x85EBCA6B, 0xC2B2AE35
SEED_HI, SEED_LO = 0x9747B28C, 0x3C6EF372
CMS_MIX = 0x2C1B3C6D
TOPK_MIX_A, TOPK_MIX_B = 0x7FEB352D, 0x846CA68B


def mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for a u32 lane and a u32 constant."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def shl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) & MASK if r else x


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer."""
    h = h ^ (h >> 16)
    h = mul(h, _FMIX1)
    h = h ^ (h >> 13)
    h = mul(h, _FMIX2)
    return h ^ (h >> 16)


def murmur_fold(words, seed: int) -> torch.Tensor:
    """murmur3_32 over a list of [N] u32 lanes, one word each."""
    h = None
    for c in words:
        k = mul(rotl(mul(c, _C1), 15), _C2)
        if h is None:
            h = torch.full_like(k, seed)
        h = rotl(h ^ k, 13)
        h = (mul(h, 5) + 0xE6546B64) & MASK
    return fmix32(h ^ (len(words) * 4))


def fingerprint(words):
    """The (hi, lo) 64-bit fingerprint: both seeds over the same words."""
    return murmur_fold(words, SEED_HI), murmur_fold(words, SEED_LO)


def pack_words(cols: dict, wide, packed):
    """Wide columns as words, narrow ones packed by (field, shift, width)
    spans, then the excess word: each value's bits above its width,
    rotated by a period-31 walk and xor-folded."""
    words = [cols[f] for f in wide]
    excess = None
    rot = 1
    for spans in packed:
        word = None
        for f, shift, width in spans:
            c = cols[f]
            part = shl(c & ((1 << width) - 1), shift)
            word = part if word is None else word | part
            e = rotl(c >> width, rot)
            excess = e if excess is None else excess ^ e
            rot = (rot + 7) % 31 + 1
        words.append(word)
    if excess is not None:
        words.append(excess)
    return words


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of a u32 lane, 0..32."""
    x = x & MASK
    zero = x == 0
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        has = x < (1 << (32 - s))
        n = torch.where(has, n + s, n)
        x = torch.where(has, (x << s) & MASK, x)
    return torch.where(zero, 32, n)


def cms_cols(hi: torch.Tensor, lo: torch.Tensor, depth: int, width: int) -> torch.Tensor:
    """[depth, N] count-min columns (Kirsch–Mitzenmacher base + one
    avalanche round per row)."""
    out = []
    for d in range(depth):
        h = (hi + mul(lo, d)) & MASK
        h = h ^ (h >> 15)
        h = mul(h, CMS_MIX)
        h = h ^ (h >> 12)
        out.append(h & (width - 1))
    return torch.stack(out)


def topk_cols(hi: torch.Tensor, lo: torch.Tensor, row: int, cols: int) -> torch.Tensor:
    """The heavy-hitter bucket column of hash row `row`."""
    h = (hi + mul(lo, row + 1)) & MASK
    h = h ^ (h >> 16)
    h = mul(h, TOPK_MIX_A)
    h = h ^ (h >> 15)
    h = mul(h, TOPK_MIX_B)
    h = h ^ (h >> 16)
    return h & (cols - 1)
