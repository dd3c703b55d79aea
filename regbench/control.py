"""The readings that the limits of ``correct`` are set from.

    python3 regbench/control.py --workload <cell> --seeds 1,2,3 --seconds 3
        [--out FILE.json]

For each seed, in one process: a short window of the cell at its own size
and load, the program's numbers against the float64 reference (the lower
readings), and the control's: the plain reference put in the program's
place and computed in float32 with TF32 matrix products on (the precision
below the configuration's float32 with TF32 off), judged the same way on
the same sampled registrations (the upper readings). Needs a CUDA device;
the benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ["PMTPU_CACHE_DIR"] = str(HERE.parent / ".torch_ext_build")
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from regbench import run
    from regbench.reference import Precision

    out = {"workload": args.workload, "card": run.card_note(), "seeds": {}}
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(args.workload, seed, args.seconds, False,
                           control=Precision(torch.float32, True, "cuda"))
        row = {"program": {k: v["value"] for k, v in res["checks"].items()},
               "control": res["control"], "correct": res["correct"],
               "attempted": res["attempted"], "failed": res["failed"]}
        out["seeds"][seed] = row
        print(json.dumps({seed: row}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
