"""repro_torch.serve — the APU serving subsystem, in PyTorch.

Turns the one-shot ``APU.offload`` pipeline into a long-lived serving
engine, as the JAX package's ``repro.serve`` does:

* :class:`GraphCache` — memoized captured :class:`CommandGraph`\\ s across
  offloads (LRU, hit/miss/eviction counters), keyed on torch shapes,
  dtypes and devices;
* :class:`BucketBatcher` — shape-bucketed dynamic batching (pad-to-bucket,
  coalesce, crop back), and :func:`batched_stages`, which lifts a
  per-request pipeline over the batch axis with ``torch.func.vmap`` (each
  card kernel's custom op folds the batch into one launch);
* :class:`MultiQueueDispatcher` / :class:`QueueWorker` — load-balanced
  multi-queue dispatch with in-flight-depth backpressure (a retirement
  waits on the launch's own ``torch.cuda.Event``), deterministic fault
  injection (:class:`FaultPlan`) with retries and circuit breakers, power
  budgets (:class:`PowerBudget`) and per-queue machine-model accounting;
* :class:`Server` / :class:`ServeReport` — the front end tying them
  together: submit -> batch -> cached graph launch -> per-request results,
  admission control, deadline flushes, tracing and metrics.

Every entry point runs on the card unless the caller asks for the CPU
(``Server(..., device="cpu")``, ``QueueWorker(config, device="cpu")``).

* the continuous-batching decode engine — :class:`DecodeEngine` serves
  autoregressive decode JetStream style: per-request ``prefill`` ->
  ``insert`` into a slot of a persistent batched decode state resident on
  the engine's device -> ``generate`` advancing ALL occupied slots one
  token per step in ONE cached ``CommandGraph`` launch (the cache leaves
  are donated and written in place), bit-identical to whole-batch greedy
  decoding under staggered arrival.  ``Server(engine=...)`` opens the
  streaming front (``submit_decode`` / per-rid ``stream``), and
  :class:`EngineHTTPServer` puts an asyncio streaming HTTP ingress in
  front of it.  Engine classes load lazily — pipeline-only servers keep
  the model stack off their import path.

* sharded serving — :class:`ShardedWorker` is a lane spanning a device
  mesh slice (:func:`data_mesh`): each micro-batch's rows split over the
  mesh's data axes by the :mod:`repro_torch.distributed.sharding` rules, one
  launch a shard on its position, the modeled totals scaled by
  :func:`shard_breakdown`; the cache keys on the lane's placement, so
  sharded and plain entries never collide.
"""

from .batching import (BucketBatcher, MicroBatch, ServeRequest,
                       batched_stages, pad_to)
from .cache import (GraphCache, input_signature, stage_signature,
                    stages_signature)
from .dispatch import (CircuitBreaker, DispatchError, LaunchTicket,
                       MultiQueueDispatcher, PowerBudgetError, QueueStats,
                       QueueWorker)
from .faults import (Blackout, FaultDecision, FaultPlan, InjectedFault,
                     apply_spike, env_seed)
from .power import LanePrice, PowerBudget
from .server import (DECOMP_PERCENTILES, DECOMP_PHASES, PERCENTILES,
                     AdmissionError, Server, ServeReport)
from .sharded import (BATCH_AXIS, ShardedWorker, data_mesh, mesh_signature,
                      shard_breakdown)

#: engine symbols resolved lazily (PEP 562): importing them pulls the model
#: stack (repro_torch.models / repro_torch.train), which pipeline-only
#: servers avoid
_ENGINE_EXPORTS = ("DecodeEngine", "DecodeState", "EngineRoofline", "Prefix",
                   "batch_axes", "engine_roofline", "graph_traffic")
_HTTP_EXPORTS = ("EngineHTTPServer",)


def __getattr__(name: str):
    if name in _ENGINE_EXPORTS:
        from . import engine
        return getattr(engine, name)
    if name in _HTTP_EXPORTS:
        from . import http
        return getattr(http, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BucketBatcher", "MicroBatch", "ServeRequest", "batched_stages", "pad_to",
    "GraphCache", "input_signature", "stage_signature", "stages_signature",
    "CircuitBreaker", "DispatchError", "LaunchTicket", "MultiQueueDispatcher",
    "PowerBudgetError", "QueueStats", "QueueWorker",
    "Blackout", "FaultDecision", "FaultPlan", "InjectedFault", "apply_spike",
    "env_seed",
    "LanePrice", "PowerBudget",
    "DECOMP_PERCENTILES", "DECOMP_PHASES", "PERCENTILES",
    "AdmissionError", "Server", "ServeReport",
    "BATCH_AXIS", "ShardedWorker", "data_mesh", "mesh_signature",
    "shard_breakdown",
    *_ENGINE_EXPORTS, *_HTTP_EXPORTS,
]
