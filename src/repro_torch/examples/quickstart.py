"""Quickstart: the DSSP idea in 60 seconds.

1. Virtual-time cluster: watch DSSP grant extra iterations to fast
   workers and beat SSP's waiting time.
2. Real training: a tiny LM trained with the DSSP delayed-gradient
   pipeline (the SPMD engine), wired declaratively through
   ``repro_torch.api`` — a ``RunSpec`` in, a ``TrainingSession`` out;
   the paradigm is one field, not a rewiring.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--smoke]
      [--device cpu]
"""

import argparse

from repro_torch.api import (DataSpec, ModelSpec, OptimizerSpec, RunSpec,
                             SyncSpec, build_session)
from repro_torch.core.policies import make_policy
from repro_torch.ps.metrics import compare
from repro_torch.ps.simulator import run_policy


def virtual_cluster(max_pushes: int = 2000) -> None:
    print("=" * 70)
    print(f"1. Virtual 4-worker cluster, one 3x straggler, "
          f"{max_pushes} pushes")
    print("=" * 70)
    intervals = [1.0, 1.1, 1.2, 3.0]
    runs = []
    for name, kw in (("bsp", {}), ("asp", {}),
                     ("ssp", dict(staleness=3)),
                     ("dssp", dict(s_lower=3, s_upper=15))):
        runs.append(run_policy(make_policy(name, n_workers=4, **kw),
                               intervals, max_pushes=max_pushes))
    print(compare(runs))
    print("\nDSSP: less waiting than SSP(s_L), bounded staleness "
          "(unlike ASP).\n")


def tiny_training(steps: int = 60, device=None) -> None:
    print("=" * 70)
    print(f"2. DSSP-SPMD delayed-gradient training (tiny LM, "
          f"{steps} steps)")
    print("=" * 70)
    from repro_torch.data.synthetic import DataConfig, loss_floor

    data = DataSpec(seq_len=32, global_batch=8)
    floor = None
    for sync in ("bsp", "dssp"):
        spec = RunSpec(model=ModelSpec(arch="h2o-danube-1.8b"),
                       data=data,
                       optimizer=OptimizerSpec(lr=5e-3),
                       sync=SyncSpec(mode=sync, s_lower=1, s_upper=3))
        with build_session(spec, device=device) as session:
            m = session.run(steps)
            if floor is None:
                cfg = session.trainer.cfg
                floor = loss_floor(DataConfig(
                    vocab_size=cfg.vocab_size, seq_len=data.seq_len,
                    global_batch=data.global_batch))
        print(f"  sync={sync:<5} loss {m['first_loss']:.3f} -> "
              f"{m['final_loss']:.3f}  (floor ~{floor:.3f},"
              f" mean delay {m['mean_delay']:.1f})")
    print("\nDelayed gradients (bounded staleness) converge like BSP;")
    print("on a pod the delay hides the gradient all-reduce.")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (fewer pushes/steps)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    args = ap.parse_args(argv)
    virtual_cluster(max_pushes=300 if args.smoke else 2000)
    tiny_training(steps=12 if args.smoke else 60, device=args.device)


if __name__ == "__main__":
    main()
