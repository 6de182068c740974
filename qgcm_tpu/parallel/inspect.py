"""Collective-communication instrumentation.

Compiles a jitted function and reports the communication ops XLA
actually emitted -- the analogue of inspecting the reference's OpenMP
schedule (src/Structure:60-85). Used by the sharding tests to pin the
expected halo-exchange counts of the shard_map path
(parallel/halo.py) and by tools/bench_halo.py.

Counts are per compiled module: for a `lax.scan` step program the
while-loop body appears once, so counts are per STEP regardless of
scan length.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import NamedTuple

import jax

# HLO opcodes that move data between devices. The -start/-done async
# forms are folded onto their base opcode.
_COLLECTIVES = ("collective-permute", "all-reduce", "all-gather",
                "all-to-all", "reduce-scatter", "collective-broadcast")


class CollectiveStats(NamedTuple):
    counts: dict           # base opcode -> count
    bytes_moved: dict      # base opcode -> total output bytes
    lines: list            # the matching HLO lines (trimmed)

    @property
    def total(self) -> int:
        return sum(self.counts.values())


_SHAPE_RE = re.compile(r"(bf16|f16|f32|f64|s8|s16|s32|s64|u8|u16|u32"
                       r"|u64|pred|c64|c128)\[([0-9,]*)\]")
_BYTES = {"bf16": 2, "f16": 2, "f32": 4, "f64": 8, "s8": 1, "s16": 2,
          "s32": 4, "s64": 8, "u8": 1, "u16": 2, "u32": 4, "u64": 8,
          "pred": 1, "c64": 8, "c128": 16}


def _shape_bytes(line: str) -> int:
    """Bytes of the output shape(s) on an HLO instruction line: the
    segment between '=' and the opcode's '(' -- a single shape, or a
    tuple of shapes for multi-operand collectives (tuple-form
    all-to-all), which are summed."""
    eq = line.find("=")
    par = line.find("(", eq + 1)
    seg = line[eq + 1 :]
    if par > eq and line[eq + 1 : par].strip().startswith("("):
        close = line.find(")", par)
        seg = line[eq + 1 : close if close > 0 else None]
    else:
        seg = line[eq + 1 : line.find("(", eq + 1)]
    total = 0
    for m in _SHAPE_RE.finditer(seg):
        n = 1
        if m.group(2):
            for d in m.group(2).split(","):
                n *= int(d)
        total += n * _BYTES[m.group(1)]
    return total


def collective_stats(fn, *args, static_argnames=(),
                     **kwargs) -> CollectiveStats:
    """Compile `fn(*args, **kwargs)` under jit and scan the optimized
    HLO for collective ops. `fn` may already be jitted."""
    jfn = fn if hasattr(fn, "lower") else jax.jit(
        fn, static_argnames=static_argnames)
    txt = jfn.lower(*args, **kwargs).compile().as_text()
    counts = Counter()
    nbytes = Counter()
    lines = []
    for line in txt.splitlines():
        s = line.strip()
        # opcode appears as "<shape> opcode(" after the = sign; the
        # shape may be a tuple "(f32[..], ..)" for multi-operand
        # collectives (tuple-form all-to-all), so skip over it first
        m = re.search(r"=\s+(?:\([^)]*\)|\S*)\s*([a-z-]+)"
                      r"(?:-start|-done)?\(", s)
        if not m:
            continue
        op = m.group(1)
        for base in _COLLECTIVES:
            if op == base or op == base + "-start":
                counts[base] += 1
                nbytes[base] += _shape_bytes(s)
                lines.append(s[:200])
                break
    return CollectiveStats(dict(counts), dict(nbytes), lines)
