"""Host ms a call inside the port's span ``mgard.encode``: the host's
enqueue of a compress, under the profiler."""

from portbench import spans


def read(t):
    return spans.span_ms(t, "compress", "mgard.encode")
