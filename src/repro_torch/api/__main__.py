"""CLI surface of the spec layer.

    python -m repro_torch.api --dump-schema          # the API-surface lock
    python -m repro_torch.api --validate run.json    # lint a spec file
    python -m repro_torch.api --example              # a ready-to-edit spec

Counterpart of ``repro/api/__main__.py``.  ``--dump-schema`` prints
``dump_schema()``, which equals the shared ``schema.json``;
``--validate`` also refuses what the port has not ported yet (each
message names its ROADMAP item).  ``--example`` prints the port's main
path (DSSP, sharded server, fused apply, packed wire with delta pulls,
h2o-danube-1.8b's smoke config): the reference's example is
``RunSpec()``, whose default ``ps.kind='none'`` (the SPMD pipeline)
comes with item 11.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.api.spec import (ModelSpec, RunSpec, ServerSpec, SpecError,
                                  WireSpec, dump_schema)


def example_spec() -> RunSpec:
    """The port's main path at smoke size."""
    return RunSpec(model=ModelSpec(arch="h2o-danube-1.8b"),
                   ps=ServerSpec(kind="sharded", shards=4, workers=2,
                                 apply="fused"),
                   wire=WireSpec(format="packed", delta_pull=True))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.api",
                                 description=__doc__)
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--dump-schema", action="store_true",
                       help="print the RunSpec schema as canonical JSON")
    group.add_argument("--validate", metavar="SPEC.json",
                       help="parse + validate a spec file; exit 1 with "
                            "the SpecError message if invalid")
    group.add_argument("--example", action="store_true",
                       help="print the main path's RunSpec as editable "
                            "JSON")
    args = ap.parse_args(argv)

    if args.dump_schema:
        print(json.dumps(dump_schema(), indent=2, sort_keys=True))
        return 0
    if args.example:
        print(example_spec().to_json())
        return 0
    try:
        with open(args.validate) as f:
            spec = RunSpec.from_json(f.read())
    except OSError as e:
        print(f"cannot read {args.validate}: {e}", file=sys.stderr)
        return 1
    except SpecError as e:
        print(f"invalid spec: {e}", file=sys.stderr)
        return 1
    print(f"ok: {args.validate} is a valid RunSpec "
          f"(engine={spec.engine})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
