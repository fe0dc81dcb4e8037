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

Not ported yet: the sharded lanes of the JAX package (``ShardedWorker`` and
its helpers, ``ROADMAP.md`` queue 1 step 9, slice D) and the decode engine
with its HTTP ingress (``DecodeEngine`` and friends, ``EngineHTTPServer``,
queue 1 step 2).  Their names resolve to an error naming the step.
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

#: names of the JAX package's serve exports this package does not have yet,
#: and the ROADMAP.md step that brings each
_NOT_PORTED = {
    **{name: "queue 1 step 9 (slice D, sharded serving)"
       for name in ("BATCH_AXIS", "ShardedWorker", "data_mesh",
                    "mesh_signature", "shard_breakdown")},
    **{name: "queue 1 step 2 (the DecodeEngine)"
       for name in ("DecodeEngine", "DecodeState", "EngineRoofline", "Prefix",
                    "batch_axes", "engine_roofline", "graph_traffic",
                    "EngineHTTPServer")},
}


def __getattr__(name: str):
    step = _NOT_PORTED.get(name)
    if step is not None:
        raise NotImplementedError(
            f"repro_torch.serve.{name} is not ported yet (ROADMAP.md {step})")
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
]
