"""Readings that a cell's correctness limit is set from, on the card, at
the cell's own size and load:

    python3 gpubench/calibrate.py --workload NAME --seconds S \
        --seeds 11,12,13 [--control 3] [--fault 3]

One set-up; per seed new weights are copied into the captured programs'
parameters, the emission bias is bisected again and a short window runs at
the cell's load. The seeded sample of served transcripts is then judged:
``program`` is the mean gap of the program's decisions below the float32
reference's best logit (the number a run compares with its limit, the
family's ``judge_one``); ``control``, on the first ``--control`` seeds, is
the same reading for the reference computed with float8 operands (the next
precision below the configuration's bfloat16) at the same positions. The
widest single gaps are printed beside them (``program_widest``,
``control_widest``). On the first ``--fault`` seeds each item is judged
once more with one token altered (the family's ``altered``):
``fault_least`` is the smallest widest gap that a single wrong token gives,
the reading the widest gap's limit stays below.
The mean's limit goes above every ``program`` reading and below every
``control`` one; the widest gap's above every ``program_widest`` and below
every ``fault_least``.
"""

import sys
import time


async def calibrate(args):
    import json
    from gpubench import harness
    from gpubench.reference import judge
    cell, m, serving, spec, override, device = harness.prepare(args)
    config = cell["config"]
    args.seed = args.seeds[0]
    system = await harness.build(args, m, serving, spec, device,
                                 cell["family"])
    try:
        for i, seed in enumerate(args.seeds):
            if i:
                system.reseed(seed)
                bias = system.bisect_blank_bias(spec)
            else:
                bias = {"blank_bias": system.blank_bias}
            gen = harness.Generator()
            await gen.start(cell["traffic_path"], seed, args.seconds,
                            config["name"], override)
            try:
                await gen.ready()
                w = await harness.window(system, gen, args.seconds, None)
            finally:
                await gen.stop()
            await system.unserve()
            t = time.monotonic()
            readings = harness.judge_sample(
                w["records"], spec, cell["check"], m, seed, device,
                cell["family"], system.judge_args(),
                control=i < args.control, fault=i < args.fault)
            row = {"seed": seed, **bias,
                   "program": judge.mean_gap(readings),
                   "program_widest": max(r["gap"] for r in readings),
                   "items": [[r["audio_s"], r["tokens"], r["decisions"],
                              r["gap_sum"], r.get("control_gap_sum")]
                             for r in readings],
                   "failed": len(harness.errors(w["records"])),
                   "judge_s": time.monotonic() - t}
            if i < args.fault:
                row["fault_least"] = min(r["fault_gap"] for r in readings
                                         if "fault_gap" in r)
            if i < args.control:
                row["control"] = judge.mean_gap(readings,
                                                "control_gap_sum")
                row["control_widest"] = max(r["control_gap"]
                                            for r in readings)
            print(json.dumps(row), flush=True)
    finally:
        await system.close()


def main():
    import argparse
    import asyncio
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True,
                    type=lambda s: [int(x) for x in s.split(",")])
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", type=int, default=3)
    ap.add_argument("--rehearse-cpu", action="store_true")
    args = ap.parse_args()
    args.trace = 0
    asyncio.run(calibrate(args))


if __name__ == "__main__":
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    main()
