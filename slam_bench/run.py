"""Run one benchmark cell once on the card and print its result line:

    python3 slam_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cells, their configurations, traffic
mixes and metrics are named in BENCHMARK.json.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slam_bench import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.run())
