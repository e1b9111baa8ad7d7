"""Host ms a call inside the port's span ``mgard.decode``: the host's
enqueue of a decompress, under the profiler."""

from portbench import spans


def read(t):
    return spans.span_ms(t, "decompress", "mgard.decode")
