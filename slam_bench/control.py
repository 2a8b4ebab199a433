"""The correctness check's readings at a cell's own size, for setting its
limits: the program's numbers and the control's (the plain reference in
the next precision below the configuration's, put in the program's
place) on each seed, one process for all seeds:

    python3 slam_bench/control.py --workload <cell> --seconds <s> --seeds <n> ...

prints one JSON line a seed. The benchmark's own runs never run the
control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slam_bench import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from orb_slam3_detailed_comments_tpu_torch import host_native, native
    native.lib()
    host_native.lib()
    spec = core.load_cell(args.workload)
    for seed in args.seeds:
        out = core.execute(spec, seed, args.seconds, False,
                           torch.device("cuda:0"), time.time(), control=True)
        print(json.dumps(dict(seed=seed, checks=out["checks"],
                              control=out["control"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
