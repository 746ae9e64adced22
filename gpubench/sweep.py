"""Find the knee of an open-loop cell: the highest arrival rate the port
sustains without a growing backlog, or for a stream cell the most
concurrent streams (``--rates`` then counts clients). One set-up, then one
window per rate, each with a fresh load generator at that rate:

    python3 gpubench/sweep.py --workload NAME --seed N --seconds S \
        --rates 10,20,30

Per rate it prints one JSON line: requests offered, completed and failed,
the latency's median and p95 over the window and the median of its first
and last thirds (a backlog that grows makes the last third slower), and
how late the generator ran. The cell's traffic file keeps the rate chosen
from it, as a number.
"""

import sys


def _stream_stats(records, t0, t1):
    import numpy as np
    third = (t1 - t0) / 3
    part = [(due - t0, (t - due) * 1e3) for r in records
            for due, t in r.get("partials", []) if t0 <= due < t1]
    fin = [(r["complete"] - r["end_due"]) * 1e3 for r in records
           if "complete" in r and t0 <= r["end_due"] < t1]

    def med(a, b):
        x = [v for o, v in part if a <= o < b]
        return float(np.median(x)) if x else None
    started = [r for r in records if t0 <= r["start_due"] < t1]
    return {"streams": len(started),
            "failed": sum("error" in r for r in started),
            "finals": len(fin),
            "final_p95_ms": float(np.percentile(fin, 95)) if fin else None,
            "partial_p95_ms": (float(np.percentile([v for _, v in part], 95))
                               if part else None),
            "first_third_partial_p50_ms": med(0, third),
            "last_third_partial_p50_ms": med(2 * third, 3 * third)}


def _stats(records, t0, t1):
    import numpy as np
    due = [r for r in records if t0 <= r["due"] < t1]
    ok = [r for r in due if r.get("status") == 200]
    lat = np.asarray([(r["done"] - r["due"]) * 1e3 for r in ok])
    third = (t1 - t0) / 3

    def med(a, b):
        x = [(r["done"] - r["due"]) * 1e3 for r in ok
             if a <= r["due"] - t0 < b]
        return float(np.median(x)) if x else None
    return {"offered": len(due), "completed": len(ok),
            "failed": len(due) - len(ok),
            "p50_ms": float(np.median(lat)) if lat.size else None,
            "p95_ms": float(np.percentile(lat, 95)) if lat.size else None,
            "first_third_p50_ms": med(0, third),
            "last_third_p50_ms": med(2 * third, 3 * third)}


async def sweep(args):
    import json
    from gpubench import harness
    cell, m, serving, spec, override, device = harness.prepare(args)
    system = await harness.build(args, m, serving, spec, device,
                                 cell["family"])
    try:
        key = "clients" if spec["kind"] == "ws_streams" else "rate_per_s"
        stats = _stream_stats if key == "clients" else _stats
        for rate in args.rates:
            gen = harness.Generator()
            over = dict(override, **{key: int(rate) if key == "clients"
                                     else rate})
            await gen.start(cell["traffic_path"], args.seed, args.seconds,
                            cell["config"]["name"], over)
            try:
                await gen.ready()
                w = await harness.window(system, gen, args.seconds, None)
            finally:
                await gen.stop()
            await system.unserve()
            row = {key: rate, **stats(w["records"], w["t0"], w["t1"]),
                   "generator_late_ms": w["late"],
                   "errors": harness.errors(w["records"])}
            print(json.dumps(row), flush=True)
    finally:
        await system.close()


def main():
    import argparse
    import asyncio
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True,
                    type=lambda s: [float(x) for x in s.split(",")])
    ap.add_argument("--rehearse-cpu", action="store_true")
    args = ap.parse_args()
    asyncio.run(sweep(args))


if __name__ == "__main__":
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    main()
