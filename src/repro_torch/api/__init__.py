"""repro_torch.api — the declarative session layer.

    from repro_torch.api import RunSpec, SyncSpec, ServerSpec, build_session

One frozen ``RunSpec`` (the reference's schema) describes the run;
``build_session`` turns it into a context-managed session on the card.
"""

from repro_torch.api.protocol import DeltaPull, ParameterServerProtocol
from repro_torch.api.session import (TrainingSession, build_server,
                                     build_session)
from repro_torch.api.spec import (DataSpec, FtSpec, ModelSpec, ObsSpec,
                                  OptimizerSpec, RunSpec, ServerSpec,
                                  ServeSpec, SpecError, SyncSpec,
                                  TransportSpec, WireSpec, dump_schema)

__all__ = [
    "RunSpec", "ModelSpec", "DataSpec", "OptimizerSpec", "SyncSpec",
    "ServerSpec", "WireSpec", "TransportSpec", "ObsSpec", "FtSpec",
    "ServeSpec", "SpecError", "dump_schema", "build_session",
    "build_server", "TrainingSession", "ParameterServerProtocol",
    "DeltaPull",
]
