"""The readings the checks' limits are set from, in one process per cell:
the program's checks on many seeds (short windows) and the control's (the
reference in TF32 in the program's place) on a few. The benchmark's own
runs do not run this.

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 3 \
        --control-seeds 4 5 6 --seconds 2 [--out FILE]

Prints one JSON line per run, then each check's largest program reading
and smallest control reading.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    spec = harness.cell_spec(harness.load_benchmark(), args.workload)
    rows = []
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            res = harness.run_cell(spec, seed, args.seconds, False,
                                   args.device, t0, control=control)
            row = {"seed": seed, "control": control,
                   "correct": res["correct"],
                   "checks": {k: c["value"] for k, c in
                              res["checks"].items()},
                   "seconds": time.perf_counter() - t0}
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {}
    for k in spec["limits"]:
        prog = [r["checks"][k] for r in rows if not r["control"]]
        ctrl = [r["checks"][k] for r in rows if r["control"]]
        summary[k] = {"program_max": max(prog) if prog else None,
                      "control_min": min(ctrl) if ctrl else None,
                      "limit": spec["limits"][k]}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"rows": rows, "summary": summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
