"""One-shot packed-key argsort (port of spark_rapids_tpu/utils/packed_sort).

The caller's order-preserving integer key components (each holding
values < 2^width) concatenate, conceptually, into one big-endian bit
string.  The row id fills the low r = log2(capacity) bits of every sort
word, so one sort of distinct words yields both the order and the
permutation, and ties break by original index: the permutation equals a
stable lexsort over the same components.  Keys wider than 64 - r bits run
a stable LSD radix over (64 - r)-bit chunks, one word sort a pass.

Words are int64 tensors holding uint64 bit patterns: right shifts are
made logical by masking, and left shifts, ors and multiplies wrap the
same way as uint64 arithmetic.  The word sort (`_sort_words`) is kernel
K3 on the card; it is told which bits hold the pass's key (above them
every word is zero, below them the row id is already ascending), so it
sorts only those.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..ops.kernels import sort_words


def _mask(bits: int) -> int:
    """int64 value of the low-`bits` mask."""
    m = (1 << bits) - 1 if bits < 64 else (1 << 64) - 1
    return m - (1 << 64) if m >= 1 << 63 else m


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64-stored uint64 values."""
    if s == 0:
        return x
    if s >= 64:
        return torch.zeros_like(x)
    return (x >> s) & _mask(64 - s)


def shl(x: torch.Tensor, s: int) -> torch.Tensor:
    if s >= 64:
        return torch.zeros_like(x)
    return x << s


def plan_passes(total_bits: int, cap: int) -> int:
    """Word-sort passes a packed argsort of `total_bits` key bits over
    `cap` rows needs (cap a power of two)."""
    chunk = 64 - (cap.bit_length() - 1)
    return max(1, -(-total_bits // chunk))


def _sort_words(words: torch.Tensor, bits: Tuple[int, int]) -> torch.Tensor:
    """Ascending unsigned sort of distinct int64 words whose key lies in
    `bits` (K3 on the card)."""
    return sort_words(words, bits)


def packed_argsort(components: Sequence[Tuple[torch.Tensor, int]],
                   cap: int) -> torch.Tensor:
    """Stable argsort by `components`, most significant first: `(int64
    tensor of uint64 values, width)` pairs, every value < 2^width.
    Returns the int32 permutation a stable lexsort would give."""
    assert cap and (cap & (cap - 1)) == 0, f"capacity {cap} not a power of 2"
    device = components[0][0].device if components else None
    r = cap.bit_length() - 1
    chunk = 64 - r
    total = sum(w for _, w in components)
    if total == 0:
        return torch.arange(cap, dtype=torch.int32, device=device)
    iota = torch.arange(cap, dtype=torch.int64, device=device)

    # pack the components into 64-bit words, LSB first: bit 0 of the
    # conceptual key is the LSB of the LAST component
    nwords = (total + 63) // 64
    words: List[Optional[torch.Tensor]] = [None] * nwords
    pos = 0
    for arr, w in reversed(list(components)):
        a = arr.long()
        lo, sh = pos // 64, pos % 64
        part = shl(a, sh)
        words[lo] = part if words[lo] is None else words[lo] | part
        if sh + w > 64:
            hi = shr(a, 64 - sh)
            words[lo + 1] = hi if words[lo + 1] is None \
                else words[lo + 1] | hi
        pos += w
    zeros = torch.zeros(cap, dtype=torch.int64, device=device)
    words = [w if w is not None else zeros for w in words]

    def width(p: int) -> int:
        return min(chunk, total - p * chunk)

    def extract(p: int) -> torch.Tensor:
        """Key bits [p*chunk, p*chunk + width(p)), counted from the LSB."""
        start = p * chunk
        cw = width(p)
        lo, sh = start // 64, start % 64
        v = shr(words[lo], sh)
        if sh + cw > 64 and lo + 1 < nwords:
            v = v | shl(words[lo + 1], 64 - sh)
        return v & _mask(cw)

    perm = None
    for p in range(plan_passes(total, cap)):  # least significant first
        bits = extract(p)
        if perm is not None:
            bits = bits[perm]
        s = _sort_words(shl(bits, r) | iota, (r, r + width(p)))
        step = (s & _mask(r)).to(torch.int32)
        perm = step if perm is None else perm[step.long()]
    return perm


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable argsort by int64 `keys` compared as signed, most significant
    first (the multi-key path when the packed sort is switched off): one
    stable sort per key, least significant first."""
    n = keys[0].numel()
    order = torch.arange(n, device=keys[0].device)
    for k in reversed(list(keys)):
        order = order[torch.sort(k[order], stable=True).indices]
    return order.to(torch.int32)
