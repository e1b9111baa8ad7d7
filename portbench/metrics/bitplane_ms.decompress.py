"""Device ms a call of the kernels and copies launched inside the port's
span ``mgard.bitplane`` (every codec's decode: ``decode_segments``,
``decode``, ``decode_pergroup``, the wide ``decode64``) in the
decompress."""

from portbench import spans


def read(t):
    return spans.launched_ms(t, "decompress", "mgard.bitplane")
