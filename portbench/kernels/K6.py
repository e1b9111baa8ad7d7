"""K6, ``gpk_prolong_add_tiled_kernel`` (csrc/stencil.cu): the finest
level of a 3-D float32 field rebuilt from its coarse level and detail,
which the decode launches once a call.  Bytes it must move: the coarse
level and the detail read once, the level written once."""

from portbench import grid


def bytes_per_call(shape, itemsize, launches):
    if len(shape) != 3 or launches != 1:
        return None
    coarse = grid.level_shapes(shape)[-2]
    return itemsize * (grid.numel(coarse) + 2 * grid.numel(shape))
