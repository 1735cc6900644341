"""End-to-end LM training with DSSP, checkpoints and restart.

Presets:
  tiny   ~0.5M params — seconds on a CPU (default)
  20m    ~20M params  — minutes on a CPU
  100m   ~100M params — the brief's reference workload (a few hundred
         steps; practical on the card)

Demonstrates: synthetic data pipeline, DSSP delayed-gradient pipeline
with the run-time controller, async atomic checkpoints, and
crash-restart (--resume continues bit-exact w.r.t. the data stream).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --preset tiny \\
          --steps 150
      PYTHONPATH=src python -m repro_torch.examples.train_lm --preset tiny \\
          --resume
(``--device cpu`` to run on the CPU.)
"""

import argparse
import os
import tempfile

import numpy as np

from repro_torch.api import (DataSpec, ModelSpec, OptimizerSpec, RunSpec,
                             SyncSpec, build_session)
from repro_torch.data.synthetic import DataConfig, loss_floor
from repro_torch.models.config import ModelConfig

PRESETS = {
    "tiny": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                 d_ff=384, vocab_size=512, seq=64, batch=8),
    "20m": dict(n_layers=6, d_model=384, n_heads=8, n_kv_heads=4,
                d_ff=1152, vocab_size=8192, seq=128, batch=8),
    "100m": dict(n_layers=12, d_model=512, n_heads=8, n_kv_heads=8,
                 d_ff=2048, vocab_size=32000, seq=256, batch=8),
}


def build_config(preset: str) -> ModelConfig:
    p = dict(PRESETS[preset])
    p.pop("seq"), p.pop("batch")
    return ModelConfig(name=f"lm-{preset}", family="dense",
                       dtype="float32", remat="none", **p)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--sync", default="dssp",
                    choices=["bsp", "ssp", "dssp"])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    args = ap.parse_args(argv)

    cfg = build_config(args.preset)
    preset = PRESETS[args.preset]
    data_cfg = DataConfig(vocab_size=cfg.vocab_size,
                          seq_len=preset["seq"],
                          global_batch=preset["batch"])
    # The spec describes the run; the hand-built ModelConfig rides in as
    # a build-time override (spec archs name the registry).
    spec = RunSpec(model=ModelSpec(arch="custom"),
                   data=DataSpec(seq_len=preset["seq"],
                                 global_batch=preset["batch"]),
                   optimizer=OptimizerSpec(name="adamw", lr=args.lr),
                   sync=SyncSpec(mode=args.sync, s_lower=1, s_upper=3))
    with build_session(spec, model_config=cfg, verbose=True,
                       checkpoint_dir=args.checkpoint_dir,
                       save_every=50, resume=args.resume,
                       device=args.device) as session:
        session.start()
        if args.resume and session.resumed:
            print(f"resumed from step {session.trainer.step_idx}")
        from repro_torch.models.registry import count_params
        print(f"model {cfg.name}: {count_params(cfg):,} params; "
              f"data floor ~{loss_floor(data_cfg):.3f} nats")
        session.run(args.steps)
        log = session.trainer.log
    print(f"done: loss {log.losses[0]:.3f} -> {log.losses[-1]:.3f}, "
          f"mean step {np.mean(log.step_times[1:]) * 1e3:.0f} ms, "
          f"mean DSSP delay {np.mean(log.delays):.2f}")
    print(f"checkpoints in {args.checkpoint_dir}: rerun with --resume")


if __name__ == "__main__":
    main()
