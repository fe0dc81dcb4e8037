"""Dynamic batching — bucket-by-shape, pad-to-bucket, coalesce, crop back.

Serving traffic arrives one request at a time with ragged sizes; the e-GPU
only amortizes Tiny-OpenCL startup + scheduling when work is chained and
batched (paper §IV-B / §VIII-B).  The batcher closes the gap:

1. each request's arrays are padded along ``pad_axis`` up to the smallest
   configured *bucket* length that fits (so a handful of shape classes cover
   arbitrary traffic);
2. requests sharing a bucket accumulate until ``max_batch`` (or an explicit
   flush) and are stacked on a new leading batch axis — the batch dimension
   is itself padded to ``max_batch`` so every launch of a bucket has
   *identical* shapes and hits one :class:`~repro_torch.serve.cache.GraphCache`
   entry;
3. :func:`batched_stages` lifts the pipeline's per-request kernels over the
   batch axis with ``torch.func.vmap`` (constants broadcast, work counts
   scaled by the batch size so the machine model stays honest).  Plain
   PyTorch executors batch as they are; a card kernel's wrapper reaches
   its launch through a custom op whose vmap rule folds the batch into
   the kernel's own batch axis, so a lifted stage is still one launch;
4. after launch, :meth:`MicroBatch.crop` slices each request's true extent
   back out.

Correctness contract: pipeline kernels must be *pad-stable* — zero-padding a
request along ``pad_axis`` must not change the outputs at the request's
valid indices (true for row-independent kernels: elementwise ops, per-row
GeMM, gather/embedding, causal FIR).  Kernels that reduce over the padded
axis (global softmax, whole-signal statistics) need an explicit mask stage
or exact-fit buckets (``bucket_sizes`` containing every admissible length):
TinyBio's features reduce over the whole signal, so it is served with
``bucket_sizes=(65536,)``.  Batching must also keep each request's bits:
every lifted stage gives row ``i`` the bits of request ``i`` run alone.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.apu import Stage
from ..core.machine import WorkCounts
from ..core.runtime import Kernel


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One in-flight request: payload arrays + bookkeeping."""

    rid: int
    arrays: Tuple[torch.Tensor, ...]
    t_submit: float
    #: true (un-padded) extent of each array along the batcher's pad axis
    lengths: Tuple[int, ...] = ()
    #: ABSOLUTE completion deadline on the submitter's clock timeline
    #: (``t_submit + budget``), or ``None`` for best-effort requests;
    #: drives deadline-aware flushing and violation accounting
    deadline_s: Optional[float] = None
    #: scheduling priority (higher wins): under overload a higher-priority
    #: request may preempt a lower-priority *pending* one instead of being
    #: shed itself
    priority: int = 0


@dataclasses.dataclass
class MicroBatch:
    """A coalesced launch unit: ``inputs`` are the stacked padded arrays
    (leading axis == ``capacity``, the bucket's max batch), ``requests``
    the live entries occupying its first rows."""

    bucket_key: Tuple[Any, ...]
    inputs: Tuple[torch.Tensor, ...]
    requests: Tuple[ServeRequest, ...]
    capacity: int
    pad_axis: int = 0
    crop_outputs: bool = True
    #: input positions to DONATE on launch (``CommandGraph.launch_prefix``
    #: ``donate=``): the serve engine marks its persistent decode-state
    #: buffers here so every generate step reuses them in place instead of
    #: allocating a fresh cache per token.  Donated inputs are consumed —
    #: the submitter must replace them with the launch's outputs.
    donate: Tuple[int, ...] = ()

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    def crop(self, outputs: Sequence[Any]) -> List[Tuple[torch.Tensor, ...]]:
        """Slice each live request's true extent out of the batched outputs.

        Every output is expected to carry the batch on axis 0; the request's
        ``pad_axis`` (an axis of the *un-batched* row, so axis ``pad_axis``
        of ``row = out[i]``) is cropped back to its true length when the
        output kept the padded extent, else returned whole (reduced
        outputs).  ``ServeRequest.lengths`` has one entry per request
        *array*: output ``j`` crops against input ``j``'s true length and
        padded extent (pipelines emitting one output per input — the
        multi-input case where extents differ), with extra outputs falling
        back to the first input's.

        Caveat: "kept the padded extent" is detected by shape — an output
        dimension that *coincidentally* equals the bucket size (a fixed
        64-bin histogram served with a 64-bucket, say) would be wrongly
        cropped.  Pipelines with such outputs must set
        ``crop_outputs=False`` on the batcher/server and slice results
        themselves using ``ServeRequest.lengths``.
        """
        if not self.crop_outputs:
            return [tuple((o.data if hasattr(o, "data") else o)[i]
                          for o in outputs)
                    for i in range(len(self.requests))]
        ax = self.pad_axis

        def padded_len(j: int) -> Optional[int]:
            src = self.inputs[j if j < len(self.inputs) else 0] \
                if self.inputs else None
            return (src.shape[ax + 1]
                    if src is not None and src.ndim > ax + 1 else None)

        per_request: List[Tuple[torch.Tensor, ...]] = []
        for i, req in enumerate(self.requests):
            rows = []
            for j, out in enumerate(outputs):
                arr = out.data if hasattr(out, "data") else out
                row = arr[i]
                length = (req.lengths[j if j < len(req.lengths) else 0]
                          if req.lengths else None)
                padded = padded_len(j)
                if (length is not None and padded is not None
                        and row.ndim > ax and row.shape[ax] == padded
                        and row.shape[ax] >= length):
                    sl = [slice(None)] * row.ndim
                    sl[ax] = slice(0, length)
                    row = row[tuple(sl)]
                rows.append(row)
            per_request.append(tuple(rows))
        return per_request


def pad_to(arr: torch.Tensor, size: int, axis: int = 0,
           fill: float | int = 0) -> torch.Tensor:
    """Pad ``arr`` along ``axis`` up to ``size`` with ``fill``."""
    cur = arr.shape[axis]
    if cur == size:
        return arr
    if cur > size:
        raise ValueError(f"array extent {cur} along axis {axis} exceeds "
                         f"pad target {size}")
    shape = list(arr.shape)
    shape[axis] = size - cur
    return torch.cat([arr, torch.full(shape, fill, dtype=arr.dtype,
                                      device=arr.device)], dim=axis)


class BucketBatcher:
    """Accumulate requests into shape buckets; emit full micro-batches.

    ``bucket_sizes`` are the admissible padded lengths (ascending); a request
    lands in the smallest bucket covering its ``pad_axis`` extent.  ``add``
    returns a :class:`MicroBatch` when a bucket fills to ``max_batch``;
    ``drain()`` flushes every partial bucket (batch-dim padded to
    ``max_batch`` so shapes — and hence cached graphs — never vary).
    """

    def __init__(self, bucket_sizes: Sequence[int], max_batch: int = 8,
                 pad_axis: int = 0, fill: float | int = 0,
                 crop_outputs: bool = True, device: Any = "cuda"):
        # Loud construction-time validation: a canonicalization such as
        # sorted(set(...)) would silently paper over unsorted and duplicate
        # bucket lists — a typo like (256, 64, 1024) would then surface only
        # as a wrong bucket choice deep in traffic.  Reject malformed inputs
        # here, where the caller can see them.
        sizes = [int(b) for b in bucket_sizes]
        if not sizes:
            raise ValueError("need at least one bucket size")
        bad = [b for b in sizes if b <= 0]
        if bad:
            raise ValueError(
                f"bucket sizes must be positive, got {bad} in {sizes}")
        if len(set(sizes)) != len(sizes):
            raise ValueError(f"duplicate bucket sizes: {sizes}")
        if sizes != sorted(sizes):
            raise ValueError(
                f"bucket_sizes must be strictly ascending, got {sizes}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.bucket_sizes = tuple(sizes)
        self.max_batch = max_batch
        self.pad_axis = pad_axis
        self.fill = fill
        self.crop_outputs = crop_outputs
        #: torch device every request's tensors are moved to at intake
        self.device = torch.device(device)
        self._pending: Dict[Tuple[Any, ...], List[ServeRequest]] = {}
        self._rid = itertools.count()
        # counters (surfaced in ServeReport)
        self.n_submitted = 0
        self.n_batches = 0
        self.padded_elements = 0   # request elements added purely by padding
        self.deadline_flushes = 0  # partial buckets launched by tick()

    def mint_rid(self) -> int:
        """Claim the next request id from the server-wide sequence.

        The decode-engine path (``Server.submit_decode``) mints here too,
        so engine and pipeline requests share ONE rid space — results,
        sheds and trace trees can never collide across the two fronts.
        """
        return next(self._rid)

    # -- bucketing ----------------------------------------------------------
    def bucket_size_for(self, length: int) -> int:
        for b in self.bucket_sizes:
            if length <= b:
                return b
        raise ValueError(
            f"request length {length} exceeds largest bucket "
            f"{self.bucket_sizes[-1]}")

    def bucket_key_for(self, arrays: Sequence[torch.Tensor]) -> Tuple[Any, ...]:
        """Padded (shape, dtype) per array — the bucket identity."""
        key = []
        for a in arrays:
            if a.ndim <= self.pad_axis:    # nothing to pad: exact-shape key
                key.append((tuple(a.shape), str(a.dtype)))
                continue
            shape = list(a.shape)
            shape[self.pad_axis] = self.bucket_size_for(shape[self.pad_axis])
            key.append((tuple(shape), str(a.dtype)))
        return tuple(key)

    def _check_oversize(self, arrays: Sequence[torch.Tensor]) -> None:
        """One loud, uniform oversize error at intake.

        Both historical failure paths — :meth:`bucket_size_for` (a bare
        "length exceeds largest bucket" with no array context) and
        :func:`pad_to` (a generic extent/target mismatch) — are preempted
        here with a single message naming the array index, the pad axis,
        the offending extent and the largest configured bucket, so a
        client submitting an oversize request learns exactly which input
        to split (or which bucket to add) instead of decoding an internal
        padding error.
        """
        largest = self.bucket_sizes[-1]
        for j, a in enumerate(arrays):
            if a.ndim <= self.pad_axis:
                continue                 # exact-shape keyed: never padded
            extent = a.shape[self.pad_axis]
            if extent > largest:
                raise ValueError(
                    f"oversize request: array {j} has extent {extent} "
                    f"along pad_axis {self.pad_axis}, which exceeds the "
                    f"largest configured bucket {largest} (buckets: "
                    f"{self.bucket_sizes}); configure a larger bucket or "
                    "split the request")

    # -- request intake -----------------------------------------------------
    def submit(self, *arrays: Any, t_submit: float = 0.0,
               deadline_s: Optional[float] = None,
               priority: int = 0) -> ServeRequest:
        """Wrap ``arrays`` into a request and stage it in its bucket.

        ``deadline_s`` is the request's ABSOLUTE deadline on the caller's
        clock timeline (the server passes ``t_submit + budget``);
        ``priority`` is its scheduling priority (higher wins under
        overload).  ``arrays`` are numpy arrays or tensors, moved onto the
        batcher's device; host data is copied, so a later edit of the
        caller's array never reaches the request.  Raises a uniform
        :class:`ValueError` naming the offending array, axis, extent and
        largest bucket when any array cannot fit a configured bucket (see
        :meth:`_check_oversize`).
        """
        arrs = tuple(a.to(self.device) if isinstance(a, torch.Tensor)
                     else torch.tensor(a, device=self.device) for a in arrays)
        self._check_oversize(arrs)
        req = ServeRequest(rid=next(self._rid), arrays=arrs,
                           t_submit=t_submit,
                           lengths=tuple(
                               a.shape[self.pad_axis]
                               if a.ndim > self.pad_axis else 1
                               for a in arrs),
                           deadline_s=deadline_s, priority=int(priority))
        self.n_submitted += 1
        key = self.bucket_key_for(arrs)
        self._pending.setdefault(key, []).append(req)
        return req

    def pop_full(self) -> List[MicroBatch]:
        """Micro-batches for every bucket that reached ``max_batch``."""
        out = []
        for key, reqs in list(self._pending.items()):
            while len(reqs) >= self.max_batch:
                take, self._pending[key] = (reqs[: self.max_batch],
                                            reqs[self.max_batch:])
                reqs = self._pending[key]
                out.append(self._collate(key, take))
            if not reqs:
                del self._pending[key]
        return out

    def drain(self) -> List[MicroBatch]:
        """Flush every pending bucket (partial batches padded to capacity)."""
        out = self.pop_full()
        for key, reqs in list(self._pending.items()):
            if reqs:
                out.append(self._collate(key, reqs))
        self._pending.clear()
        return out

    def tick(self, now: float, slack_s: float = 0.0) -> List[MicroBatch]:
        """Deadline-aware flush: launch partial buckets whose
        budget is at risk.

        A bucket flushes when its OLDEST deadline-carrying request has
        ``deadline_s - now <= slack_s`` — i.e. waiting any longer for the
        bucket to fill would spend budget the launch itself still needs
        (``slack_s`` is the caller's estimate of queueing + service time).
        Buckets holding only best-effort requests never deadline-flush;
        they wait for capacity or an explicit :meth:`drain`.
        """
        out = []
        for key, reqs in list(self._pending.items()):
            deadlines = [r.deadline_s for r in reqs
                         if r.deadline_s is not None]
            if not deadlines or min(deadlines) - now > slack_s:
                continue
            out.append(self._collate(key, reqs))
            self.deadline_flushes += 1
            del self._pending[key]
        return out

    def remove(self, rid: int) -> Optional[ServeRequest]:
        """Un-stage a pending request by id (admission-control preemption);
        returns it, or ``None`` when ``rid`` is not pending."""
        for key, reqs in list(self._pending.items()):
            for i, r in enumerate(reqs):
                if r.rid == rid:
                    reqs.pop(i)
                    if not reqs:
                        del self._pending[key]
                    return r
        return None

    def lowest_priority_pending(self) -> Optional[ServeRequest]:
        """The pending request overload shedding would evict first: lowest
        priority, newest submission among equals (least sunk wait)."""
        victim: Optional[ServeRequest] = None
        for reqs in self._pending.values():
            for r in reqs:
                if victim is None or (r.priority, -r.t_submit) < (
                        victim.priority, -victim.t_submit):
                    victim = r
        return victim

    @property
    def n_pending(self) -> int:
        return sum(len(v) for v in self._pending.values())

    # -- collation ----------------------------------------------------------
    def _collate(self, key: Tuple[Any, ...],
                 reqs: Sequence[ServeRequest]) -> MicroBatch:
        self.n_batches += 1
        n_arrays = len(key)
        stacked = []
        for j in range(n_arrays):
            shape, _dtype = key[j]
            rows = []
            for r in reqs:
                a = r.arrays[j]
                if a.ndim > self.pad_axis:
                    padded = pad_to(a, shape[self.pad_axis], self.pad_axis,
                                    self.fill)
                    self.padded_elements += int(padded.numel() - a.numel())
                    rows.append(padded)
                else:
                    rows.append(a)
            batch = torch.stack(rows)
            if len(reqs) < self.max_batch:          # pad the batch dim too:
                extra = self.max_batch - len(reqs)  # one shape per bucket
                batch = torch.cat(
                    [batch, torch.full((extra,) + tuple(batch.shape[1:]),
                                       self.fill, dtype=batch.dtype,
                                       device=batch.device)])
                self.padded_elements += extra * math.prod(batch.shape[1:])
            stacked.append(batch)
        return MicroBatch(bucket_key=key, inputs=tuple(stacked),
                          requests=tuple(reqs), capacity=self.max_batch,
                          pad_axis=self.pad_axis,
                          crop_outputs=self.crop_outputs)


# ---------------------------------------------------------------------------
# Lifting a per-request pipeline over the batch axis
# ---------------------------------------------------------------------------
def _batched_executor(executor: Callable[..., Any],
                      n_consts: int) -> Callable[..., Any]:
    def batched(*arrays: Any, **params: Any) -> Any:
        n_data = len(arrays) - n_consts
        in_dims = (0,) * n_data + (None,) * n_consts
        return torch.func.vmap(lambda *a: executor(*a, **params),
                               in_dims=in_dims)(*arrays)
    return batched


def _batched_counts(counts: Optional[Callable[..., WorkCounts]],
                    batch: int) -> Optional[Callable[..., WorkCounts]]:
    if counts is None:
        return None

    def scaled(**kw: Any) -> WorkCounts:
        return counts(**kw).scaled(batch)
    return scaled


def batched_stages(stages: Sequence[Stage], batch: int) -> List[Stage]:
    """Lift per-request :class:`Stage`\\ s to operate on a ``batch``-stacked
    leading axis: data flows through ``torch.func.vmap`` (constants
    broadcast), and each kernel's ``counts`` are scaled by ``batch`` so the
    modeled time/energy describes the whole micro-batch."""
    out = []
    for st in stages:
        kern = Kernel(
            name=st.kernel.name,
            executor=_batched_executor(st.kernel.executor, len(st.consts)),
            counts=_batched_counts(st.kernel.counts, batch),
            # registry identity survives batching (with the batch size as an
            # extra variant axis), keeping serve cache keys stable across
            # rebuilt pipelines of Program-created kernels
            family=st.kernel.family,
            config=st.kernel.config,
            variant=st.kernel.variant + (("__batched__", batch),),
        )
        out.append(Stage(kern, params=dict(st.params),
                         counts_params=dict(st.counts_params),
                         consts=tuple(st.consts), n_inputs=st.n_inputs))
    return out
