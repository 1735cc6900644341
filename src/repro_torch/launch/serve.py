"""Train-and-serve CLI: train and serve the SAME parameters in one run.

Counterpart of ``repro/launch/serve.py``.  One ``RunSpec`` stands up
the whole loop — a DSSP training fleet pushing gradients at the
parameter server while ``repro_torch.serve`` replicas subscribe to it
over the same transport, keep a resident packed buffer fresh via
version-delta pulls, and decode continuously-batched requests behind
the ``serve.staleness_bound`` admission gate (the ``ps-transport``
engine with replicas).  Workers and replicas run on ``--device``
(``cuda:0`` by default; without CUDA the run raises unless it names
another device).

CLI:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch h2o-danube-1.8b --transport tcp --workers 2 --replicas 2 \\
      --steps 40 --requests 16 --prompt-len 8 --max-new 4
"""

from __future__ import annotations

import argparse
import json


def build_spec(args) -> "RunSpec":
    from repro_torch.api import (
        DataSpec,
        ModelSpec,
        ObsSpec,
        RunSpec,
        ServeSpec,
        ServerSpec,
        SyncSpec,
        TransportSpec,
        WireSpec,
    )
    return RunSpec(
        model=ModelSpec(arch=args.arch, smoke=args.smoke),
        data=DataSpec(seq_len=args.seq_len, global_batch=args.batch),
        ps=ServerSpec(kind="sharded", shards=args.shards,
                      workers=args.workers, apply="fused"),
        sync=SyncSpec(mode=args.sync),
        wire=WireSpec(format="packed", delta_pull=True),
        transport=TransportSpec(kind=args.transport, endpoint=True),
        obs=ObsSpec(trace=bool(args.trace), trace_path=args.trace),
        serve=ServeSpec(replicas=args.replicas,
                        refresh_every_s=args.refresh_every_s,
                        staleness_bound=args.staleness_bound,
                        batch_window_ms=args.batch_window_ms,
                        max_batch=args.max_batch,
                        requests=args.requests,
                        request_every_ms=args.request_every_ms,
                        start_at_version=args.start_at_version,
                        prompt_len=args.prompt_len,
                        max_new=args.max_new))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="train + serve one parameter store over a live "
                    "transport (repro_torch.serve)")
    ap.add_argument("--device", default=None,
                    help="torch device of the server, workers and "
                         "replicas (default cuda:0; without CUDA the run "
                         "raises unless this names another device)")
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--transport", default="tcp",
                    choices=("tcp", "shmem"))
    ap.add_argument("--sync", default="dssp",
                    choices=("bsp", "ssp", "dssp", "asp"))
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--requests", type=int, default=16,
                    help="closed-loop requests per replica")
    ap.add_argument("--request-every-ms", type=float, default=100.0)
    ap.add_argument("--start-at-version", type=int, default=1,
                    help="hold requests until the server has applied "
                         "this many updates (serving overlaps live "
                         "training, not worker start-up)")
    ap.add_argument("--refresh-every-s", type=float, default=0.05)
    ap.add_argument("--staleness-bound", type=int, default=4)
    ap.add_argument("--batch-window-ms", type=float, default=2.0)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--trace", default="",
                    help="write the merged run trace here (.jsonl or "
                         "chrome .json)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from repro_torch.api import build_session
    spec = build_spec(args)
    with build_session(spec, device=args.device) as session:
        metrics = session.run(steps=args.steps)

    serve = metrics.get("serve", {})
    print(f"\narch={args.arch} transport={args.transport} "
          f"workers={args.workers} replicas={args.replicas}")
    print(f"train: pushes={metrics['pushes']} "
          f"applied_updates={metrics['applied_updates']} "
          f"final_loss={metrics['final_loss']}")
    print("serve:", json.dumps(serve, indent=2, sort_keys=True))
    if serve.get("violations", 0):
        raise SystemExit(
            f"{serve['violations']} staleness-bound violations — the "
            "admission gate failed")


if __name__ == "__main__":
    main()
