"""The readings that the limits of ``correct`` are set from: one cell run
in one process on several seeds, as the program (the sound readings) or
as the control (``--control fp8``: the reference in float8 in the
program's place), each run printing its checks as one JSON line.

    python3 gstbench/study.py --workload gen.gst_enc_dec.cc12m \\
        --seeds 1,2,3 --seconds 10 --control fp8
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--control", choices=("fp8",))
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from gstbench import harness

    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = harness.run(cell, seed, args.seconds, False, t,
                          control=args.control)
        print(json.dumps({"seed": seed, "control": args.control,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()},
                          "checks": {k: v["value"] for k, v in
                                     out["checks"].items()},
                          "window": out["window"],
                          "wall_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
