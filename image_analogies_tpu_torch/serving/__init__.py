"""Synthesis as a service on the port: a request-queue daemon over the
runners, with executable-cache accounting, continuous batching and
admission control.  `python -m image_analogies_tpu_torch.cli serve` is
the front door; serving/daemon.py documents the architecture.  The
reference's exports, less the fleet's (ROADMAP Queue 1 step 13b: the
lattice, the disk tier, the router, the fleet trace and the
observatory)."""

from .daemon import SynthDaemon
from .excache import (
    ExecutableCache,
    compression_mode,
    config_fingerprint,
    exec_key,
    load_warmup_manifest,
    run_warmup,
)
from .queueing import (
    AdmissionController,
    BatchingPolicy,
    RequestQueue,
    ServeRequest,
    coalesce,
    demux,
)

__all__ = [
    "SynthDaemon",
    "ExecutableCache",
    "compression_mode",
    "config_fingerprint",
    "exec_key",
    "load_warmup_manifest",
    "run_warmup",
    "AdmissionController",
    "BatchingPolicy",
    "RequestQueue",
    "ServeRequest",
    "coalesce",
    "demux",
]
