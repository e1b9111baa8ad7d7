"""Device idle ms a call in the gaps whose middle lies inside the port's
span ``mgard.decode`` (a gap under the harness's synchronize is not)."""

from portbench import spans


def read(t):
    return spans.paced_ms(t, "decompress", "mgard.decode")
