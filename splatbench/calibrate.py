"""The readings that a cell's limits are set from, in one process on the card:
the compared numbers of the program on ``--seeds`` seeds (the lower
reading: their largest), of the control on ``--control-seeds`` (the program
with its own lower-precision path switched on, bf16 accumulation: the upper
reading, their smallest), and of each planted fault (``--faults``).

    python3 -m splatbench.calibrate --workload garden-5m.view --seeds 12 \
        --control-seeds 3 --seconds 2 [--faults altered half_batch] [--first-seed N]

Each run is a whole run of the cell (set-up, a window of ``--seconds``, the
comparison); one JSON line a run, then one with the readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

CONTROL = {"accum_dtype": "bfloat16"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=4_000_000_000)
    args = ap.parse_args(argv)
    import torch

    from splatbench import faults, run

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    plan = [("program", None, args.seeds), ("control", None, args.control_seeds)]
    plan += [(f"fault:{f}", f, args.fault_seeds) for f in args.faults]
    readings = {}
    seed = args.first_seed
    for kind, fault, count in plan:
        for _ in range(count):
            seed += 7919
            t0 = time.perf_counter()
            with faults.planted(fault):
                line = run.run_cell(args.workload, seed, args.seconds, False, dev, t_start=t0,
                                    overrides=CONTROL if kind == "control" else None)
            values = {k: c["value"] for k, c in line["checks"].items()}
            readings.setdefault(kind, []).append(values)
            print(json.dumps({"kind": kind, "seed": seed, "checks": values,
                              "failed": line["failed"], "attempted": line["attempted"],
                              "seconds": time.perf_counter() - t0}), flush=True)
    summary = {}
    for kind, rows in readings.items():
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(r[k] for r in rows) for k in rows[0]}
    print(json.dumps({"workload": args.workload, "device": torch.cuda.get_device_name(0),
                      "lower (program, largest)": summary.get("program"),
                      "upper (smallest)": {k: v for k, v in summary.items() if k != "program"}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
