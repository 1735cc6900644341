"""The paper's headline experiment: a heterogeneous cluster.

Four workers train one shared model through the parameter server; worker
3 is 4x slower (the paper's GTX1060 next to GTX1080Ti).  Each paradigm
runs the same SGD steps — only the synchronization policy differs, and
with ``repro_torch.api`` a paradigm (or the server kind) is one spec
field: the example builds every run through
``build_session(RunSpec(...))`` with a custom toy problem (softmax
regression, its loss and gradient written in torch) injected as
build-time overrides.  Reported: updates applied, waiting time,
staleness profile, final loss, plus the virtual-time Table-I
composition.

Run:  PYTHONPATH=src python -m repro_torch.examples.heterogeneous_ps
      PYTHONPATH=src python -m repro_torch.examples.heterogeneous_ps \\
          --ps-shards 4
(``--device cpu`` to run on the CPU.)

With ``--ps-shards N > 1`` the same experiment runs through the
partitioned ``ShardedParameterServer``: per-shard locks/versions and
per-shard DSSP gating, so pushes to different shards proceed
concurrently (ps/sharded/).
"""

import argparse

import numpy as np
import torch

from repro_torch.api import (ModelSpec, OptimizerSpec, RunSpec, ServerSpec,
                             SyncSpec, build_session)
from repro_torch.device import resolve_device
from repro_torch.ps.metrics import compare
from repro_torch.ps.sharded import run_sharded_policy
from repro_torch.ps.simulator import run_policy

# one grid for the threaded AND virtual-time views — keep in lockstep
POLICIES = (("bsp", {}), ("asp", {}),
            ("ssp", dict(staleness=3)),
            ("dssp", dict(s_lower=3, s_upper=15)))


def make_problem(seed=0, dim=16, n=2048, classes=4):
    rng = np.random.RandomState(seed)
    w = rng.randn(dim, classes).astype(np.float32)
    x = rng.randn(n, dim).astype(np.float32)
    y = np.argmax(x @ w + rng.gumbel(size=(n, classes)), -1).astype(np.int32)
    return x, y, classes


def sync_spec(name: str, kw: dict) -> SyncSpec:
    return SyncSpec(mode=name, staleness=kw.get("staleness", 1),
                    s_lower=kw.get("s_lower", 0),
                    s_upper=kw.get("s_upper", 3))


def step(params, batch):
    """Softmax regression: the loss and its gradient w.r.t. ``w``, ``b``."""
    bx, by = batch
    w = params["w"].detach().requires_grad_()
    b = params["b"].detach().requires_grad_()
    logp = torch.log_softmax(bx @ w + b, dim=-1)
    loss = -logp.gather(1, by[:, None]).mean()
    gw, gb = torch.autograd.grad(loss, (w, b))
    return {"w": gw, "b": gb}, {"loss": loss.detach()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ps-shards", type=int, default=1, metavar="N",
                    help="partition the weights across N server shards "
                         "(1 = the monolithic server)")
    ap.add_argument("--ps-apply", default="tree",
                    choices=["tree", "fused"])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (fewer iterations/pushes)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n_shards = max(1, args.ps_shards)
    iters = 10 if args.smoke else 80
    vpushes = 300 if args.smoke else 2000

    x, y, classes = make_problem()
    tx = torch.from_numpy(x).to(device)
    ty = torch.from_numpy(y).long().to(device)

    def batches(w, n_workers=4, bs=64):
        sx, sy = tx[w::n_workers], ty[w::n_workers]
        rng = np.random.RandomState(w)
        while True:
            i = torch.from_numpy(rng.randint(0, len(sx), bs)).to(device)
            yield sx[i], sy[i]

    speeds = [1.0, 1.0, 1.0, 4.0]
    print(f"4 workers, speed factors {speeds}, {iters} iterations each, "
          f"{n_shards} server shard(s)\n")
    if n_shards > 1:
        server_spec = ServerSpec(kind="sharded", shards=n_shards,
                                 workers=4, apply=args.ps_apply)
    else:
        server_spec = ServerSpec(kind="mono", shards=1, workers=4)
    runs = []
    shard_runs = []
    for name, kw in POLICIES:
        params = {"w": torch.zeros((x.shape[1], classes), device=device),
                  "b": torch.zeros((classes,), device=device)}
        spec = RunSpec(model=ModelSpec(arch="custom"),
                       optimizer=OptimizerSpec(lr=0.3),
                       sync=sync_spec(name, kw),
                       ps=server_spec)
        with build_session(spec, params=params, step_fn=step,
                           batches=batches, speed_factors=speeds,
                           device=device) as session:
            session.run(iters * 4)
            server = session.server
            final = server.params
            logits = x @ final["w"].cpu().numpy() + final["b"].cpu().numpy()
            acc = float((np.argmax(logits, -1) == y).mean())
            server.metrics.policy += f"  acc={acc:.3f}"
            runs.append(server.metrics)
            if n_shards > 1:
                shard_runs.append((name, server.shard_metrics()))
    print(compare(runs))
    if shard_runs:
        print("\nPer-shard view (threaded):")
        for name, sms in shard_runs:
            print(compare(sms))

    print(f"\nVirtual-time view (same speeds, {vpushes} pushes):")
    if n_shards > 1:
        vruns = [run_sharded_policy(
                     sync_spec(n, kw).policy_factory(4), speeds,
                     n_shards, max_pushes=vpushes).metrics
                 for n, kw in POLICIES]
    else:
        vruns = [run_policy(sync_spec(n, kw).policy_factory(4)(), speeds,
                            max_pushes=vpushes)
                 for n, kw in POLICIES]
    print(compare(vruns))
    print("\nReading: with a PERSISTENT straggler the steady-state rate "
          "of every bounded\nscheme converges to the straggler's (BSP ~ "
          "SSP ~ DSSP here) — DSSP's edge is\nless waiting per sync and "
          "front-loaded updates under finite budgets or\ntransient skew "
          "(see benchmarks: finite_budget_*, transient_*, tableI_*),\n"
          "while keeping staleness bounded (<= s_U) unlike ASP.")


if __name__ == "__main__":
    main()
