"""The benchmark of the PyTorch/CUDA port, one cell a run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for.  The last line of standard output is the run's JSON result; the
numbers that decided ``correct`` are the last lines of standard error.
Exits non-zero, with no result, when there is no card, when the port
cannot be imported, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the port's logger appends to LOGFILE (default oip.log in the
    # working directory): give it a file of its own under TMPDIR
    fd, log = tempfile.mkstemp(prefix="portbench-", suffix=".log")
    os.close(fd)
    os.environ["LOGFILE"] = log
    # run as a script, the path's first entry is portbench/ itself, whose
    # modules (trace.py) would shadow the standard library's
    sys.path[0] = str(ROOT)
    try:
        return _run(args)
    finally:
        os.unlink(log)


def _run(args) -> int:
    import torch

    from portbench import harness

    bench = harness.load_benchmark()
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, checks = harness.run(args.workload, args.seed, args.seconds,
                                 bool(args.trace), T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    sys.stderr.write("\n".join(checks) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
