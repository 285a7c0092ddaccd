"""Run tools/bench.py in fresh processes and report how its numbers spread:
a batch sweep, and repeats of one setting.

    python -m detectron_tpu_torch.tools.bench_spread [--mode infer|train] \\
        [--bs 2 8 16 32 64] [--repeats 5] [--device cuda|cpu] \\
        [--canvas H W] [--iters N] [--out FILE] [--logs DIR]

For each batch size of --bs, --repeats times, it starts
`python -m detectron_tpu_torch.tools.bench` with BENCH_BS (BENCH_TRAIN_BS
and BENCH_MODE=train with --mode train) set and the other BENCH_*
variables as they stand, and reads its JSON line and its stderr's
"# run" line (bench.parse_stderr): the window rates, the peak device
memory and the card. A run that fails (at a batch that does not fit, say)
is reported with the last line of its stderr; the sweep goes on, and the
script exits 1 at the end.

Prints one JSON row a run, then one a setting (mode, batch): the min,
median and max of the runs' `value` (their best windows), the spread
across processes, (max - min) / median of `value`, and the spread within
each process, (max - min) / median of its windows.
--out writes the rows as a JSON list too, --logs each run's stderr.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

from detectron_tpu_torch.tools import bench

RUN_TIMEOUT_S = 900


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", choices=["infer", "train"], default="infer")
    p.add_argument("--bs", type=int, nargs="+", default=[bench.DEFAULT_BS])
    p.add_argument("--repeats", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--canvas", type=int, nargs=2, default=None)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--out")
    p.add_argument("--logs", help="directory for each run's stderr")
    return p.parse_args(argv)


def _spread(values):
    return (max(values) - min(values)) / statistics.median(values)


def run_once(args, B, rep=0):
    """One fresh process of tools/bench.py; its row."""
    env = dict(os.environ)
    if args.mode == "train":
        env.update(BENCH_MODE="train", BENCH_TRAIN_BS=str(B))
    else:
        env.pop("BENCH_MODE", None)
        env["BENCH_BS"] = str(B)
    cmd = [sys.executable, "-m", "detectron_tpu_torch.tools.bench",
           "--device", args.device]
    if args.canvas:
        cmd += ["--canvas", *map(str, args.canvas)]
    if args.iters:
        cmd += ["--iters", str(args.iters)]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=RUN_TIMEOUT_S)
    if args.logs:
        os.makedirs(args.logs, exist_ok=True)
        name = "{}_b{}_{}.err".format(args.mode, B, rep)
        with open(os.path.join(args.logs, name), "w") as f:
            f.write(proc.stderr)
    row = {"mode": args.mode, "bs": B, "rc": proc.returncode}
    lines = proc.stdout.splitlines()
    if proc.returncode == 0 and len(lines) == 1:
        run = bench.parse_stderr(proc.stderr)
        row.update(card=run["card"], windows=run["windows"],
                   peak_gib=run["peak_gib"], record=json.loads(lines[0]),
                   window_spread=_spread(run["windows"]))
    else:
        tail = proc.stderr.strip().splitlines()
        row["error"] = tail[-1] if tail else "no output"
    return row


def summary(rows):
    """The setting's row over its runs that gave a record."""
    ok = [r for r in rows if "record" in r]
    first = rows[0]
    out = {"mode": first["mode"], "bs": first["bs"], "runs": len(rows),
           "failed": len(rows) - len(ok)}
    if ok:
        vals = [r["record"]["value"] for r in ok]
        out.update(
            value_min=min(vals), value_median=statistics.median(vals),
            value_max=max(vals), process_spread=_spread(vals),
            window_spreads=[r["window_spread"] for r in ok],
            peak_gib=max((r["peak_gib"] for r in ok
                          if r["peak_gib"] is not None), default=None))
    return out


def main(argv=None):
    """Returns the rows (each run's, then each setting's summary)."""
    args = parse_args(argv)
    rows, settings = [], {}
    for B in args.bs:
        for rep in range(args.repeats):
            row = run_once(args, B, rep)
            print(json.dumps(row), flush=True)
            rows.append(row)
            settings.setdefault(B, []).append(row)
    for runs in settings.values():
        rows.append(summary(runs))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    rows = main()
    sys.exit(1 if any(r.get("rc", 0) != 0 for r in rows) else 0)
