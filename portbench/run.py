"""Run one cell of the port's benchmark once, on the card of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and ``mgard_tpu_torch/``.  With ``--trace 0`` the last line of standard
output is the result with the cell's end-to-end metrics, with
``--trace 1`` with its per-layer metrics; the numbers that decide
``correct`` close standard error, each beside its limit.  Without CUDA,
with fewer cards than the cell asks for, or with ``jax``, ``jaxlib``,
``flax``, ``mgard_tpu`` or ``zstandard`` loaded once the window has
closed, it prints no result and exits with 1.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _power_limit() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    return proc.stdout.strip() or f"not read (exit {proc.returncode})"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, ROOT)
    from portbench import harness
    bench = harness.Bench(ROOT)
    chips = int(bench.workload(args.workload)["chips"])
    knobs = harness.pin_knobs()
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    try:
        result = harness.run(bench, args.workload, args.seed, args.seconds,
                             bool(args.trace), device="cuda", t0=T0)
    finally:
        knobs.cleanup()
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules loaded that the run may not hold: "
              f"{found}", file=sys.stderr)
        return 1
    print(f"portbench: card and power limit: {_power_limit()}",
          file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
