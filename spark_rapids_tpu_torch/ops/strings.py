"""String predicates and Substring over byte-matrix columns (port of the
slice's part of spark_rapids_tpu/ops/strings.py): StartsWith, EndsWith,
Contains, Like and Substring.

A string column is uint8[capacity, max_len] of padded UTF-8 plus int32
lengths (columnar/column.py).  Each class computes what its JAX namesake
computes, as torch ops on the batch's device; there is no kernel of the
JAX package to port here.  Positions are bytes, not characters: on
multi-byte UTF-8 text both packages differ from Spark, which counts
characters.  A result's validity is the child's.

The pattern of StartsWith, EndsWith, Contains and Like must be a string
literal.  The JAX package sends any other pattern to its CPU executor
(plan/overrides.py, `_tag_literal_pattern`); the port has none, so it
raises NotImplementedError when the tree is built, at planning time.
"""
from __future__ import annotations

import numpy as np
import torch

from ..columnar import Column
from ..types import BooleanType, NullType, StringType
from .expressions import Expression, Literal, _word_view


# Like's escape byte (the JAX package's default; the DSL sets no other)
_ESCAPE = ord("\\")


def _literal_bytes(e: Expression) -> bytes:
    if isinstance(e, Literal) and isinstance(e.value, str):
        return e.value.encode("utf-8")
    raise NotImplementedError(
        f"a pattern that is not a string literal ({e!r}) is not ported: the "
        "JAX package runs it on its CPU executor")


def _check_string(e: Expression, what: str) -> None:
    if not e.dtype.is_string:
        # the JAX package fails to slice a one-dimensional column
        raise TypeError(f"{what} of a {e.dtype.name} column")


def _constant(c: Column, value: bool) -> Column:
    fill = torch.ones if value else torch.zeros
    return Column(fill(c.capacity, dtype=torch.bool, device=c.device),
                  c.valid, BooleanType)


class Substring(Expression):
    """Spark substring(str, pos, len), 1-based: a negative pos counts from
    the end, pos 0 is taken as 1, and the start is clipped to the string,
    so a negative pos past the start begins at the first byte (Spark
    would give fewer bytes).  `pos` and `len` may be columns; their nulls
    are ignored, as the JAX package ignores them.  The output keeps the
    child's max_len."""

    def __init__(self, child: Expression, pos: Expression,
                 length: Expression):
        _check_string(child, "Substring")
        for arg in (pos, length):
            if not (arg.dtype.is_integral or arg.dtype is NullType):
                raise NotImplementedError(
                    f"a {arg.dtype.name} substring position or length is "
                    "not ported")
        self.child, self.pos, self.length = child, pos, length
        self.children = (child, pos, length)

    @property
    def dtype(self):
        return StringType

    def eval(self, batch):
        c = self.child.eval(batch)
        p = self.pos.eval(batch).data.to(torch.int32)
        n = self.length.eval(batch).data.to(torch.int32)
        L, lens = c.max_len, c.lengths
        zero = torch.zeros((), dtype=torch.int32, device=c.device)
        start = torch.where(p > 0, p - 1, torch.where(p < 0, lens + p, zero))
        start = torch.minimum(torch.maximum(start, zero), lens)
        stop = torch.minimum(torch.maximum(start + torch.clamp(n, min=0),
                                           start), lens)
        new_lens = stop - start
        pos = torch.arange(L, dtype=torch.int32, device=c.device)
        first = self.pos.value if isinstance(self.pos, Literal) else -1
        if first is None or 0 <= first < 2 ** 31:
            # one start for every row that keeps a byte (a row whose
            # start is clipped to its length keeps none): a slice, which
            # needs none of the gather's int64 index of capacity x
            # max_len (tools/substring_routes.py times both)
            s = min(max((first or 1) - 1, 0), L)
            shifted = torch.nn.functional.pad(c.data[:, s:], (0, s))
        else:
            idx = torch.clamp(pos[None, :] + start[:, None], 0, L - 1)
            shifted = torch.gather(c.data, 1, idx.long())
        data = torch.where(pos[None, :] < new_lens[:, None], shifted, 0)
        return Column(data, c.valid, StringType, new_lens)


class _PatternPredicate(Expression):
    def __init__(self, child: Expression, pattern: Expression):
        _check_string(child, type(self).__name__)
        self.pat = _literal_bytes(pattern)
        self.child, self.pattern = child, pattern
        self.children = (child, pattern)

    @property
    def dtype(self):
        return BooleanType

    def eval(self, batch):
        c = self.child.eval(batch)
        m = len(self.pat)
        if m == 0:
            return _constant(c, True)
        if m > c.max_len:
            return _constant(c, False)
        return Column(self.match(c), c.valid, BooleanType)

    def match(self, c: Column) -> torch.Tensor:
        """bool[capacity] for a pattern of 1 to max_len bytes."""
        raise NotImplementedError


class StartsWith(_PatternPredicate):
    def match(self, c):
        # the first m bytes as int64 words, each compared (under a mask
        # for a last partial word) with a scalar: no reduction over bytes
        m = len(self.pat)
        nw = -(-m // 8)
        pat = np.zeros(nw * 8, np.uint8)
        pat[:m] = np.frombuffer(self.pat, np.uint8)
        mask = (np.arange(nw * 8) < m).astype(np.uint8) * np.uint8(0xFF)
        words = _word_view(c, -(-c.max_len // 8) * 8)
        hit = c.lengths >= m
        for k, (want, keep) in enumerate(zip(pat.view("<i8").tolist(),
                                             mask.view("<i8").tolist())):
            w = words[:, k] if keep == -1 else words[:, k] & keep
            hit = hit & (w == want)
        return hit


class EndsWith(_PatternPredicate):
    def match(self, c):
        # the m bytes that end at each row's length, one gathered byte
        # column at a time
        m = len(self.pat)
        start = torch.clamp(c.lengths - m, min=0).long()[:, None]
        hit = c.lengths >= m
        for j, b in enumerate(self.pat):
            hit = hit & (torch.gather(c.data, 1, start + j)[:, 0] == b)
        return hit


class Contains(_PatternPredicate):
    def match(self, c):
        # the byte matrix as one flat row, so each pattern byte is a
        # compare of a contiguous slice, ANDed in place; a start whose
        # bytes run into the next row lies past its own row's length - m,
        # where the mask drops it
        m = len(self.pat)
        c = c.pad_strings_to(-(-c.max_len // 8) * 8)
        cap, L = c.capacity, c.max_len
        flat = c.data.reshape(-1)
        n = flat.numel() - m + 1
        acc = torch.zeros(cap * L, dtype=torch.bool, device=c.device)
        head = acc[:n]
        torch.eq(flat[:n], self.pat[0], out=head)
        for j in range(1, m):
            head &= flat[j:j + n] == self.pat[j]
        at = torch.arange(L, dtype=torch.int32, device=c.device)
        acc = acc.view(cap, L) & (at[None, :] <= (c.lengths - m)[:, None])
        # any over each row as a reduction over its 8-byte words
        return acc.view(torch.int64).any(dim=1)


class Like(_PatternPredicate):
    r"""SQL LIKE: `%` any run of bytes, `_` any one byte, and `\` makes
    the next byte literal; a `\` that is the last byte is a literal `\`.
    The empty pattern matches only the empty string.  Run as the JAX
    package runs it: reach[p] says the pattern's tokens so far match the
    first p bytes, one vector op per token, read at each row's length.
    The JAX package also masks every step to the positions within the
    string; the port does not, since reach only flows forward, so what
    lies past a row's length never reaches the position that is read."""

    def eval(self, batch):
        # no shortcut: the empty pattern matches the empty string only,
        # and a pattern of `%` may be longer than every value
        c = self.child.eval(batch)
        return Column(self.match(c), c.valid, BooleanType)

    def tokens(self):
        """("char", byte) | ("any1",) | ("many",), in pattern order."""
        pat = self.pat
        out, i = [], 0
        while i < len(pat):
            b = pat[i]
            if b == _ESCAPE and i + 1 < len(pat):
                out.append(("char", pat[i + 1]))
                i += 2
                continue
            if b == ord("%"):
                out.append(("many",))
            elif b == ord("_"):
                out.append(("any1",))
            else:
                out.append(("char", b))
            i += 1
        return out

    def match(self, c):
        cap, dev = c.capacity, c.device
        width = c.max_len + 1  # reach's positions 0..max_len
        # reach as one flat row of `width` positions a string, so a step
        # is a contiguous shifted AND.  What shifts out of one string's
        # last position into the next string's position 0 is dropped: by
        # the zero byte padded after every string for a nonzero byte, by a
        # reset for `_` and a zero byte
        data = torch.nn.functional.pad(c.data, (0, 1)).reshape(-1)
        reach = torch.zeros(cap * width, dtype=torch.bool, device=dev)
        reach.view(cap, width)[:, 0] = True
        pos = torch.arange(width, device=dev)
        for i, tok in enumerate(self.tokens()):
            if tok[0] == "many":
                if i == 0:
                    reach.fill_(True)  # from position 0: every position
                    continue
                # a running OR along each string: true from its first
                # reached position on
                rows = reach.view(cap, width)
                first = torch.argmax(rows.view(torch.uint8), dim=1,
                                     keepdim=True)
                reach = ((pos[None, :] >= first)
                         & torch.gather(rows, 1, first)).view(-1)
                continue
            nxt = torch.empty_like(reach)
            nxt[0] = False
            if tok[0] == "any1":
                nxt[1:] = reach[:-1]
            else:
                torch.logical_and(reach[:-1], data[:-1] == tok[1],
                                  out=nxt[1:])
            if tok[0] == "any1" or tok[1] == 0:
                nxt.view(cap, width)[:, 0] = False
            reach = nxt
        return torch.gather(reach.view(cap, width), 1,
                            c.lengths.long()[:, None])[:, 0]


# the classes `resolve` builds, by the DSL's op names
STRING_EXPRESSIONS = {c.__name__: c for c in (
    Substring, StartsWith, EndsWith, Contains, Like)}
