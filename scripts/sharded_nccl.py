"""chip_smoke.py's phase 13c over NCCL, one process a card.

The sharded Schur step, the sharded PCG at C = 192 and the sharded
inertial BA (on the synthetic chain) at a world of every visible card,
each against rank 0's world-1 solve at the JAX tests' tolerances, their
clocks, then the racing global BA with dist_gba while the other ranks
serve. It needs two cards or more:

    python scripts/sharded_nccl.py

Prints the card's name and power limit, 13c's log line, and its record
as one JSON object on the last line; exits non-zero if a gate fails.
"""
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"sharded_nccl: needs two cards or more, found {n}",
              file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        end="", flush=True)
    rec = chip_smoke.sharded_path(torch.device("cuda"), world=n,
                                  backend="nccl")
    print(json.dumps(rec, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
