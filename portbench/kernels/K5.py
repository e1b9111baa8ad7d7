"""K5, ``gpk_detail_kernel`` (csrc/stencil.cu): the detail of the finest
level of a 3-D float32 field, which the encode launches once a call.
Bytes it must move: the field read once and the detail written once."""

from portbench import grid


def bytes_per_call(shape, itemsize, launches):
    if len(shape) != 3 or launches != 1:
        return None
    return 2 * itemsize * grid.numel(shape)
