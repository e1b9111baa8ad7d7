"""Level shapes of a tensor grid, by the rule of MGARD's
TensorMeshHierarchy (the yardstick's own copy, which the byte counts of
``kernels/`` read): each dim of n > 1 nodes has floor(log2(n - 1)) dyadic
levels; the grid has the least of them, one more where some dim is not
2^k + 1, and below the finest level the dims double as 2 m - 1 from
their dyadic floor."""

from __future__ import annotations

import math

# Levels whose dims all have at most this many nodes take the dense
# correction matrices (cuBLAS); the others solve with S1 along each dim.
MATMUL_MAX_N = 4096


def level_shapes(shape) -> list:
    """The shape of each level, coarsest first (L + 1 of them)."""
    shape = tuple(int(n) for n in shape)
    dyadic = {n: (n - 1).bit_length() - 1 for n in shape if n > 1}
    least = min(dyadic.values())
    uneven = any((1 << l) + 1 != n for n, l in dyadic.items())
    L = least + 1 if uneven else least
    cur = [1 if n == 1 else (((1 << dyadic[n]) + 1 - 1) >> least) + 1
           for n in shape]
    shapes = []
    for _ in range(L):
        shapes.append(tuple(cur))
        cur = [1 if n == 1 else 2 * n - 1 for n in cur]
    shapes.append(shape)
    return shapes


def solved_levels(shape) -> list:
    """The levels l >= 1 whose correction solves along each dim (some
    dim over MATMUL_MAX_N nodes), each with the shape it solves on: that
    of level l - 1."""
    shapes = level_shapes(shape)
    return [(l, shapes[l - 1]) for l in range(1, len(shapes))
            if any(n > MATMUL_MAX_N for n in shapes[l] if n > 1)]


def numel(shape) -> int:
    return math.prod(int(n) for n in shape)
