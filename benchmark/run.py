"""Run one cell of the benchmark on the CUDA device and print its result.

    python3 -m benchmark.run --workload garment200.playback --seed 7 \\
        --seconds 30 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number that decided ``correct``
with its limit.  The same numbers end standard error.  Without a CUDA
device, or with fewer than the cell asks for, it exits with 2 and
prints no result; so it does if JAX or the JAX package is loaded once
the window has closed.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# the program's libraries must not bring JAX into this process
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# one thread of host work: a run's load is this process alone, and
# spinning worker threads would share the host's cores with the launches
os.environ["OMP_NUM_THREADS"] = "1"

FORBIDDEN = ("jax", "jaxlib", "flax", "mpmavatar_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is JAX's, jaxlib's, flax's
    or the JAX package's (compared whole: ``mpmavatar_tpu_torch`` is
    not ``mpmavatar_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from . import harness
    torch.set_num_threads(1)
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in spec["workloads"]}.get(args.workload)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device, STARTED, spec=spec)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 2
    readings = result.pop("readings")
    print(f"card: {power_limit()}", file=sys.stderr)
    print(f"readings: {json.dumps(readings)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
