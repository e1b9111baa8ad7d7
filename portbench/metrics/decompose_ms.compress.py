"""Device ms a call of the operations launched inside the port's span
``mgard.decompose`` (``transform.decompose``; in float64 the dense
matrices' DGEMMs and PyTorch's passes at every level)."""

from portbench import spans


def read(t):
    return spans.launched_ms(t, "compress", "mgard.decompose")
