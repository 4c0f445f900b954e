"""The control of a cell's comparison, at the cell's own size.

    python3 benchmark/control.py --workload CELL --seeds 11,12,13

For each seed: the cell's inputs as a run makes them, the reference's
answer for the cell's query, and the answer of the control named in the
configuration (the reference with one of the configuration's guarantees
broken, benchmark/reference/krep_ref.py), put in the program's place and
judged by the run's own check (run.check, with its limits). One JSON line
a seed: `correct` and the numbers compared for one query answered by the
control; each query of a run would read the same. Exits 0 when every seed
reads not correct. Benchmark runs do not run this; it shows that the
comparison fails the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    from reference import krep_ref

    cell = run.Cell(args.workload)
    control = cell.config["control"]
    wrong = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        here, inputs = run.prepare(cell, seed % (1 << 63))
        argv_q = [a.format(**inputs) for a in cell.traffic["argv"]]
        home = os.getcwd()
        os.chdir(here)
        try:
            ans = run.reference(here, cell.entry["traffic"], argv_q)
            t0 = time.perf_counter()
            ctl = krep_ref.answer(argv_q, control=control)
            seconds = time.perf_counter() - t0
        finally:
            os.chdir(home)
        # the control's answer in the program's place, judged by the run's own check
        as_query = SimpleNamespace(sha256=ctl.stdout_sha256, bytes=ctl.stdout_bytes,
                                   stderr=ctl.stderr, raised="", rc=ctl.rc)
        compared = run.check([as_query], ans)
        correct = all(v["value"] <= v["limit"] for v in compared.values())
        line = {"workload": args.workload, "seed": seed, "control": control,
                "correct": correct, "check": compared,
                "reference": [ans["stdout_bytes"], ans["stdout_lines"], ans["rc"]],
                "control_answer": [ctl.stdout_bytes, ctl.stdout_lines, ctl.rc],
                "control_s": seconds}
        wrong += not correct
        print(json.dumps(line), flush=True)
    return 0 if wrong == len(args.seeds.split(",")) else 1

if __name__ == "__main__":
    sys.exit(main())
