"""Run one cell of the benchmark of the PyTorch/CUDA port.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the compared numbers beside their limits
as the last lines of standard error and one JSON result as the last line of
standard output. Exits non-zero, with no result, when no card (or fewer
than the cell asks for) is visible, and when JAX or the JAX package was
loaded in this process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# The program shuffles epochs with hash(("epoch", e)), which Python salts
# per process; a fixed salt makes a seed's run repeat itself.
HASH_SEED = "0"


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark.run", description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    if os.environ.get("PYTHONHASHSEED") != HASH_SEED:
        env = dict(os.environ, PYTHONHASHSEED=HASH_SEED)
        os.execve(sys.executable, [sys.executable, "-m", "benchmark.run", *argv], env)

    import torch

    from benchmark import harness

    spec = harness.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark.run: {args.workload} needs {spec.chips} CUDA device(s), "
              f"{n} visible", file=sys.stderr)
        return 2
    out = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), device="cuda")
    found = harness.forbidden_loaded()
    if found:
        print(f"benchmark.run: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"correct {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
