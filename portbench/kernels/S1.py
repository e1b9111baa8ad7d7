"""S1, ``mass_solve`` (csrc/tridiag.cuh: ``solve_lines``,
``solve_short``, ``solve_runs`` and their bound checks): the Thomas solve
of each level whose correction takes the per-dim form, once along each
dim in an encode.  Bytes it must move: the right-hand side read once,
the solution written once, and its two tables (off-diagonal and
divisors, 2 n - 1 values) read once."""

from portbench import grid


def solve_bytes(n, values, itemsize):
    """One solve along a dim of ``n`` nodes of an array of ``values``."""
    return itemsize * (2 * values + 2 * n - 1)


def bytes_per_call(shape, itemsize, launches):
    total = 0
    for _, coarse in grid.solved_levels(shape):
        for n in coarse:
            if n > 1:
                total += solve_bytes(n, grid.numel(coarse), itemsize)
    return total or None
