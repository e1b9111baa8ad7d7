"""The yardstick's data and its plain reference, in plain PyTorch.

Imports nothing of the program.  ``make_field`` builds a configuration's
fields from ``--seed`` on the device (the benchmark hands the same fields
to the program); after the window the reference builds them again from
the seed and judges each decoded field the program returned by what it
says: its largest distance from the field, against the L-infinity bound
that the traffic states.  ``control_output`` is the reference put in the
program's place one precision lower (bfloat16 for float32), which has to
come out as not correct.
"""

from __future__ import annotations

import hashlib
import math

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}
# values checked a block at a time, in float64
BLOCK = 1 << 26


def field_seed(seed: int, index: int) -> int:
    """The generator seed of field ``index`` of a run seeded ``seed``: 63
    bits of a hash of both, so that any whole number is a seed."""
    digest = hashlib.sha256(f"{int(seed)}:{int(index)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_field(cfg: dict, seed: int, index: int, device) -> torch.Tensor:
    """Field ``index`` of configuration ``cfg``: a sum of separable cosine
    modes ``cos(pi k x + phase k (d + 1)) / k`` on [0, 1] in each dim, plus
    Gaussian noise of ``noise`` drawn on ``device`` from the field's seed;
    in the configuration's dtype, made in a few large calls."""
    gen = cfg["generator"]
    shape = tuple(int(n) for n in cfg["shape"])
    dtype = DTYPES[cfg["dtype"]]
    f = torch.zeros(shape, dtype=dtype, device=device)
    for k in gen["modes"]:
        term = None
        for d, n in enumerate(shape):
            x = torch.linspace(0.0, 1.0, n, dtype=dtype, device=device)
            c = torch.cos(math.pi * k * x + gen["phase"] * k * (d + 1))
            view = [1] * len(shape)
            view[d] = n
            c = c.reshape(view)
            term = c if term is None else term * c
        f += term / k
    g = torch.Generator(device=device).manual_seed(field_seed(seed, index))
    f += gen["noise"] * torch.randn(shape, generator=g, dtype=dtype,
                                    device=device)
    return f


def max_abs_error(field: torch.Tensor, out) -> float:
    """max |out - field| in float64, a block of values at a time on the
    field's device; infinite where ``out`` (a tensor on any device, or a
    NumPy array) has another shape or holds a value that is not finite."""
    out = torch.as_tensor(out)
    if tuple(out.shape) != tuple(field.shape):
        return math.inf
    a, b = field.reshape(-1), out.reshape(-1)
    worst = 0.0
    for i in range(0, a.numel(), BLOCK):
        d = (b[i:i + BLOCK].to(a.device).double()
             - a[i:i + BLOCK].double()).abs()
        m = float(d.max()) if d.numel() else 0.0
        if not math.isfinite(m):
            return math.inf
        worst = max(worst, m)
    return worst


def value_range(field: torch.Tensor) -> float:
    """max - min of the field, in float64: the scale of a value-range
    relative error bound."""
    lo, hi = torch.aminmax(field)
    return float(hi.double() - lo.double())


def control_output(field: torch.Tensor) -> torch.Tensor:
    """The control: the field kept in the precision below the
    configuration's (bfloat16 for float32, float32 for float64) and
    returned in its own dtype."""
    lower = torch.bfloat16 if field.dtype == torch.float32 else torch.float32
    return field.to(lower).to(field.dtype)
