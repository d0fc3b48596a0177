#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on cuda:0.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository root. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number compared beside its limit, which the last lines of standard error
repeat. Without a CUDA card, or when the JAX package or JAX is loaded once
the window has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        print("--seed must be a whole number of 0 or more", file=sys.stderr)
        return 2
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    import cdlrm_tpu_torch  # noqa: F401  the program under test: its checkout's
    from perfbench import harness

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("perfbench: no CUDA device; the benchmark runs on a card only", file=sys.stderr)
        return 1
    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.resolve(spec, args.workload)
    harness.log(f"{args.workload} seed {args.seed}, {args.seconds} s, trace {args.trace}; "
                f"card: {harness.card_line()}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, entry in out["check"].items():
        print(f"check {name} = {entry['value']!r} (limit {entry['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
