"""CLI dispatcher of the PyTorch port.

Commands (reference counterparts in parentheses):

  infer      overlap+yaw for one scan pair          (demo2_infer.py)

The other commands of the JAX package's CLI come with later slices of the
port.
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "infer":
        from overlapnet_torch.cli.infer_pair import main as run
    else:
        print(f"Unknown command: {cmd}\n{__doc__}")
        return 2
    return run(rest) or 0


if __name__ == "__main__":
    sys.exit(main())
