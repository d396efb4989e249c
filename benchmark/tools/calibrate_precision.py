r"""``calibrate.py`` with the cell's configuration at another precision
tier: the program one tier up or down, read against the cell's own
reference (a limit of the cell must fail it).

    python3 benchmark/tools/calibrate_precision.py highest \
        --workload pvoc16_fast.streams --seeds 3 --control 0 --seconds 2

The first argument is the tier (``highest``, ``bf16x3``, ``default``);
the rest are ``calibrate.py``'s.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    precision, load = argv[0], harness.load_cell

    def load_at(name):
        spec = load(name)
        spec["config"] = {**spec["config"], "precision": precision}
        return spec

    harness.load_cell = load_at
    try:
        return harness._module(harness.ROOT / "tools"
                               / "calibrate.py").main(argv[1:])
    finally:
        harness.load_cell = load


if __name__ == "__main__":
    sys.exit(main())
