"""CLI surface of the obs layer.

    python -m repro_torch.obs summarize run_trace.json     # Chrome trace
    python -m repro_torch.obs summarize run_trace.jsonl    # JSONL trace
    python -m repro_torch.obs summarize --json trace.json  # machine-readable

Reads either export format (sniffed by content, not extension) and
prints the paper's quantities — wait fraction, DSSP threshold timeline,
staleness percentiles — for the whole merged run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.obs.export import read_trace
from repro_torch.obs.summarize import format_summary, summarize


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("summarize",
                        help="print wait fraction, threshold timeline and "
                             "staleness percentiles from a trace file")
    sp.add_argument("trace", metavar="TRACE",
                    help="Chrome trace JSON or JSONL trace file")
    sp.add_argument("--json", action="store_true",
                    help="emit the summary as JSON instead of text")
    args = ap.parse_args(argv)

    try:
        events = read_trace(args.trace)
    except OSError as e:
        print(f"cannot read {args.trace}: {e}", file=sys.stderr)
        return 1
    if not events:
        print(f"no events in {args.trace}", file=sys.stderr)
        return 1
    summary = summarize(events)
    try:
        if args.json:
            print(json.dumps(summary, indent=2, sort_keys=True,
                             default=str))
        else:
            print(format_summary(summary))
        sys.stdout.flush()
    except BrokenPipeError:
        # ``summarize trace | head`` closed the pipe — not an error.
        # Unhook stdout so the interpreter's exit flush stays quiet.
        sys.stdout = open(os.devnull, "w")
    return 0


if __name__ == "__main__":
    sys.exit(main())
