"""Multi-rank helpers for the port's distribution tests (no JAX here: the
ranks import only torch and ``repro_torch``).

:func:`run` starts ``world`` processes with ``torch.multiprocessing``
(forkserver: a fresh server process imports torch once and each rank forks
from it), one thread each, starts a gloo group in each from a file under
the test's ``tmp_path`` (never a TCP port: xdist workers run side by side),
calls one of the rank functions below, destroys the group and returns the
ranks' results in rank order; :func:`run_groups` starts several such
worlds side by side, and :func:`start_groups` returns before they end, so
that the test's own work overlaps them.  No process group is ever left in the pytest
process.
"""

from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import threading
import time
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in the test process for a module's tests (imported
    by each distribution test file): their tensors are small, and the
    default of one thread a core, in every worker of a parallel run and
    beside the ranks, spends its time contending (a sharded TinyBio lane
    took ~20x longer on eight threads than on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rank_main(group, rank, world, init_file, fn_name, args, out):
    import sys
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        try:
            result = globals()[fn_name](rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((group, rank, "ok", result))
    except BaseException:
        out.put((group, rank, "error", traceback.format_exc()))
        raise


def _context():
    """The forkserver start method, torch, the port's distribution layer
    and this module preloaded: the server process imports them once (a
    fresh interpreter, no thread started), and every rank forks from it
    instead of importing them anew."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "torch.distributed",
                                "torch.distributed.tensor",
                                "repro_torch.distributed",
                                "repro_torch.checkpoint",
                                "repro_torch.launch.mesh", __name__])
    return ctx


def start_groups(tmp_path, groups, timeout: float = 180.0):
    """Start every group of ``groups`` — (world, rank function name, args)
    — at once, each its own gloo world, and return ``collect()``, which
    waits for them and returns each group's results in rank order (raising
    with the first failing rank's traceback).  Work done between the two
    (a JAX reference) overlaps the ranks; call ``collect`` in a ``finally``
    so that no rank outlives the test.  Groups that hand each other files
    (a checkpoint one writes and another restores) run side by side."""
    ctx = _context()
    out = ctx.Queue()
    procs = []
    for g, (world, fn_name, args) in enumerate(groups):
        # a fresh store file for every group: a FileStore left by an earlier
        # group would hand the new ranks the old ranks' addresses
        fd, init_file = tempfile.mkstemp(prefix=f"pg_{fn_name}_{world}_",
                                         dir=str(tmp_path))
        os.close(fd)
        os.unlink(init_file)
        procs += [ctx.Process(target=_rank_main,
                              args=(g, r, world, init_file, fn_name, args,
                                    out))
                  for r in range(world)]
    # the first start waits for the forkserver to import its preloads:
    # start from a thread, so that the caller's own work overlaps that too
    start_error: list = []

    def start_all():
        try:
            for p in procs:
                p.start()
        except BaseException as e:               # raised by collect()
            start_error.append(e)

    starter = threading.Thread(target=start_all)
    starter.start()

    def collect():
        got = {}
        deadline = time.monotonic() + timeout
        try:
            starter.join()
            if start_error:
                raise start_error[0]
            while len(got) < len(procs):
                try:
                    g, rank, status, value = out.get(timeout=1.0)
                except queue_mod.Empty:
                    # a rank that died before it could report (as in its
                    # bootstrap) fails the run now, not at the deadline
                    dead = [p.name for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead or time.monotonic() > deadline:
                        why = (f"died: {dead}" if dead
                               else f"timed out after {timeout} s")
                        raise AssertionError(
                            f"ranks {why}; results from {sorted(got)}")
                    continue
                if status != "ok":
                    raise AssertionError(
                        f"group {g} rank {rank} failed:\n{value}")
                got[(g, rank)] = value
        finally:
            # one 30 s grace for all ranks, not each: after a failure the
            # others may wait in a collective that never completes
            stop = time.monotonic() + 30
            for p in procs:
                if p.pid is not None:            # started
                    p.join(timeout=max(0.0, stop - time.monotonic()))
            for p in procs:
                if p.pid is not None and p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        assert all(p.pid is not None and not p.is_alive() for p in procs)
        return [[got[(g, r)] for r in range(world)]
                for g, (world, _fn, _args) in enumerate(groups)]

    return collect


def run_groups(tmp_path, groups, timeout: float = 180.0):
    """:func:`start_groups` and wait: each group's results in rank
    order."""
    return start_groups(tmp_path, groups, timeout)()


def run(world: int, tmp_path, fn_name: str, *args, timeout: float = 180.0):
    """Results of ``fn_name(rank, world, *args)`` on ``world`` gloo ranks,
    in rank order."""
    return run_groups(tmp_path, [(world, fn_name, args)], timeout)[0]


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------
def _mesh(shape, names):
    """A gloo ``DeviceMesh``; every constant the models make replicated on
    it is checked to be alike on all ranks (``sharding.CHECK_REPLICATED``)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import sharding
    sharding.CHECK_REPLICATED = True
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def layout(rank, world, cases):
    """Each case (mesh shape, axis names, spec entries, tensor shape): this
    rank's local block of ``arange`` under ``placements_for``, and whether
    the DTensor gathers back whole; then :func:`constrain_case`."""
    from repro_torch.distributed.sharding import (P, distribute_tree,
                                                  placements_for)
    out = []
    meshes = {}
    for shape, names, spec, tshape in cases:
        key = (tuple(shape), tuple(names))
        if key not in meshes:
            meshes[key] = _mesh(shape, names)
        mesh = meshes[key]
        x = torch.arange(int(np.prod(tshape)), dtype=torch.float32).reshape(
            tshape)
        dt = distribute_tree(x, placements_for(P(*spec), mesh), mesh)
        out.append((dt.to_local().numpy(),
                    bool(torch.equal(dt.full_tensor(), x))))
    return {"layout": out,
            "constrain": constrain_case(rank, meshes[((2, 2, 2), (
                "pod", "data", "model"))])}


def constrain_case(rank, mesh):
    """``constrain`` on the (pod, data, model) mesh: the DTensor itself
    when no rules are active; under ``activate(TRAIN_FSDP_RULES)`` a
    redistribute of a replicated (8, 6) batch to the rule's placements
    (its batch spans ("data", "model", "pod"), in that order)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.distributed.sharding import (TRAIN_FSDP_RULES, activate,
                                                  constrain, placements_for,
                                                  shard_slices, spec_for)
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    dt = distribute_tensor(x, mesh, [Replicate()] * 3, src_data_rank=None)
    plain = constrain(dt, "batch", None) is dt
    with activate(TRAIN_FSDP_RULES, mesh):
        got = constrain(dt, "batch", None)
        local_x = constrain(x, "batch", None) is x
    spec = spec_for(("batch", None), TRAIN_FSDP_RULES, mesh, (8, 6))
    pos = np.unravel_index(rank, (2, 2, 2))
    want = x[shard_slices(spec, mesh, (8, 6))[pos]]
    return {"plain": plain, "local_x": local_x, "spec": tuple(spec),
            "placements": tuple(got.placements)
            == placements_for(spec, mesh),
            "local": got.to_local().numpy(),
            "whole": bool(torch.equal(got.full_tensor(), x))}


def psum(rank, world, cases, steps):
    """For each case (mesh shape, axis names, grads, errs): this rank's
    ``compressed_psum`` over the mesh's last axis (named "data") of its
    slice of the stacked ``grads`` (name -> (world, ...) array) with error
    feedback from ``errs`` over ``steps`` steps, and the gathered payloads'
    dtypes and sizes."""
    import torch.distributed as dist
    from repro_torch.distributed.compression import compressed_psum
    out = []
    for shape, names, grads, errs in cases:
        mesh = _mesh(shape, names)
        dtypes = []
        orig = dist.all_gather_into_tensor

        def wrapped(output, input, *a, **kw):
            dtypes.append((str(input.dtype), tuple(input.shape)))
            return orig(output, input, *a, **kw)

        dist.all_gather_into_tensor = wrapped
        try:
            g = {k: torch.from_numpy(v[rank].copy()) for k, v in grads.items()}
            e = {k: torch.from_numpy(v[rank].copy()) for k, v in errs.items()}
            means = []
            for _ in range(steps):
                mean, e = compressed_psum(g, e, "data", mesh)
                means.append({k: v.numpy() for k, v in mean.items()})
        finally:
            dist.all_gather_into_tensor = orig
        out.append({"means": means,
                    "errs": {k: v.numpy() for k, v in e.items()},
                    "dtypes": dtypes})
    return out


def _elastic_tree():
    from repro_torch.models.params import ParamSpec, init_params
    spec = {"embed": ParamSpec((16, 8), ("vocab", "embed")),
            "blocks": {"w": ParamSpec((2, 8, 12), ("layers", "embed", "mlp")),
                       "norm": ParamSpec((2, 8), ("layers", None), "ones")},
            "head": ParamSpec((8, 16), ("embed", "vocab"))}
    tree = init_params(spec, seed=3, device="cpu")
    tree["blocks"]["w"] = tree["blocks"]["w"].to(torch.bfloat16)
    return spec, tree


def _bits(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _wait_for(path, timeout=150.0):
    """Wait for a checkpoint another group writes (it appears whole:
    ``save_checkpoint`` renames a finished directory into place)."""
    import time
    t0 = time.monotonic()
    while not os.path.exists(os.path.join(path, "manifest.json")):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no checkpoint at {path} after {timeout} s")
        time.sleep(0.05)


def elastic(rank, world, mesh_shape, read_path, write_path, write_first):
    """On a (data, model) mesh of ``mesh_shape`` under TRAIN_FSDP_RULES:
    with ``write_first``, distribute the seed's tree, gather it and write
    it to ``write_path`` from rank 0; restore ``read_path`` (written by
    another group, waited for) through both ``restore_sharded`` and
    ``CheckpointManager.restore_latest(mesh=)``, check every rank's block
    and the gathered bits against the tree the checkpoint was written from,
    and that ``restore_sharded`` moved no tensor larger than a block to the
    device (``Tensor.to`` is wrapped);
    without ``write_first``, then gather and write that to ``write_path``;
    last, reshard the tree between a (world,) mesh and this one."""
    import torch.distributed as dist
    from repro_torch.checkpoint import (CheckpointManager, restore_sharded,
                                        save_checkpoint)
    from repro_torch.distributed import reshard_arrays
    from repro_torch.distributed.elastic import gather_tree
    from repro_torch.distributed.sharding import (TRAIN_FSDP_RULES,
                                                  distribute_tree,
                                                  param_shardings,
                                                  param_specs, shard_slices)
    from repro_torch.models.params import leaves_with_path, map_tree
    spec, tree = _elastic_tree()
    mesh = _mesh(mesh_shape, ("data", "model"))
    specs = dict(leaves_with_path(param_specs(spec, TRAIN_FSDP_RULES, mesh)))
    pos = np.unravel_index(rank, mesh_shape)

    def write(t):
        whole_t = gather_tree(t)              # a collective: every rank
        if rank == 0:
            save_checkpoint(write_path, whole_t, step=world)
        dist.barrier()

    if write_first:
        write(distribute_tree(tree, param_shardings(spec, TRAIN_FSDP_RULES,
                                                    mesh), mesh))
    _wait_for(read_path)
    like = map_tree(lambda t: None, tree)
    moved = []                       # elements of each tensor moved by .to
    orig_to = torch.Tensor.to

    def to(self, *a, **kw):
        moved.append(self.numel())
        return orig_to(self, *a, **kw)

    torch.Tensor.to = to
    try:
        placed, manifest = restore_sharded(read_path, like, spec,
                                           TRAIN_FSDP_RULES, mesh)
    finally:
        torch.Tensor.to = orig_to
    mgr = CheckpointManager(os.path.dirname(read_path))
    latest, _ = mgr.restore_latest(like, spec_tree=spec,
                                   rules=TRAIN_FSDP_RULES, mesh=mesh)
    whole = dict(leaves_with_path(tree))
    ok_local, ok_whole = True, True
    for (path, dt), (_, dt2) in zip(leaves_with_path(placed),
                                    leaves_with_path(latest)):
        block = whole[path][shard_slices(specs[path], mesh,
                                         tuple(whole[path].shape))[pos]]
        ok_local &= _bits(dt.to_local()) == _bits(block)
        ok_local &= _bits(dt2.to_local()) == _bits(block)
        ok_whole &= _bits(dt.full_tensor()) == _bits(whole[path])
    blocks = {p: dt.to_local().numel() for p, dt in leaves_with_path(placed)}
    report = {"step": manifest["step"], "local": ok_local, "whole": ok_whole,
              "sharded": any(blocks[p] < whole[p].numel() for p in blocks),
              # only blocks reach the device: the largest tensor moved is
              # the largest block, smaller than the largest (sharded) leaf
              "blocks_moved": max(moved) == max(blocks.values()) < max(
                  t.numel() for t in whole.values())}
    if not write_first:
        write(placed)
    # reshard between a (world,) data mesh and this one
    flat = _mesh((world,), ("data",))
    on_flat = reshard_arrays(placed, param_shardings(spec, TRAIN_FSDP_RULES,
                                                     flat), flat)
    back = reshard_arrays(on_flat, param_shardings(spec, TRAIN_FSDP_RULES,
                                                   mesh), mesh)
    report["reshard"] = all(
        _bits(a.full_tensor()) == _bits(whole[p])
        for p, a in leaves_with_path(back))
    return report


# ---------------------------------------------------------------------------
# sharded execution through the models
# ---------------------------------------------------------------------------
def _reduced(arch, **over):
    """An arch's reduced config in f32 (MoE capacity 8: no drops, so a
    sharded step routes as the unsharded one), as the JAX package's
    mini-mesh test builds it."""
    import dataclasses
    from repro_torch import configs
    cfg = configs.get(arch).reduced()
    kw = {"dtype": "float32", **over}
    if cfg.n_experts:
        kw.setdefault("capacity_factor", 8.0)
    return dataclasses.replace(cfg, **kw)


def _placed_state(state, spec, rules, mesh):
    """A train state placed as the JAX test's ``state_sh``: params, m and v
    by ``param_shardings``, the step replicated."""
    from torch.distributed.tensor import Replicate
    from repro_torch.distributed.sharding import (distribute_tree,
                                                  param_shardings)
    psh = param_shardings(spec, rules, mesh)
    opt = state["opt"]
    return {"params": distribute_tree(state["params"], psh, mesh),
            "opt": {"m": distribute_tree(opt["m"], psh, mesh),
                    "v": distribute_tree(opt["v"], psh, mesh),
                    "step": distribute_tree(opt["step"],
                                            (Replicate(),) * mesh.ndim,
                                            mesh)}}


def _placed_batch(batch, rules, mesh):
    from repro_torch.distributed.sharding import (distribute_tree,
                                                  placements_for, spec_for)
    return {k: distribute_tree(v, placements_for(spec_for(
        ("batch", None), rules, mesh, tuple(v.shape)), mesh), mesh)
        for k, v in batch.items()}


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _train_pair(arch, rules, mesh, ref=True, **over):
    """One step of ``arch`` (reduced, batch 8 x 32) under ``rules`` on
    ``mesh`` from a placed copy of the seed's state, and (``ref``) the same
    step unsharded from the same state: -> ((metrics, state) sharded
    gathered, (metrics, state) unsharded or None, the placed state), the
    metrics the loss and the gradient's global norm, the sharded leaves as
    whole tensors."""
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.distributed.sharding import activate
    from repro_torch.models.params import map_tree
    from repro_torch.models.transformer import model_spec
    from repro_torch.optim.schedule import constant_schedule
    from repro_torch.train.step import (TrainConfig, clone_train_state,
                                        init_train_state, make_train_step)
    cfg = _reduced(arch, **over)
    spec = model_spec(cfg)
    tcfg = TrainConfig(remat="none", microbatches=1)
    state = init_train_state(cfg, tcfg, 0, device="cpu")
    state_ref = clone_train_state(state)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMData(
        DataConfig(8, 32, cfg.vocab, seed=0), cfg).batch_at(0).items()}
    placed = _placed_state(state, spec, rules, mesh)
    with activate(rules, mesh):
        step = make_train_step(cfg, tcfg, constant_schedule(1e-3))
        placed, metrics = step(placed, _placed_batch(batch, rules, mesh))
    got = ({k: _full(metrics[k]) for k in ("loss", "grad_norm")},
           map_tree(_full, placed))
    if not ref:
        return got, None, placed
    state, ref_metrics = make_train_step(cfg, tcfg, constant_schedule(1e-3))(
        state_ref, batch)
    return got, ({k: ref_metrics[k] for k in ("loss", "grad_norm")},
                 state), placed


def sharded_train(rank, world, arch, shape=(2, 4), names=("data", "model")):
    """The JAX package's mini-mesh train check on a (data=2, model=4)
    mesh (or ``shape`` over ``names``) under TRAIN_FSDP_RULES: -> on rank 0
    the sharded and unsharded losses and gradient norms, every parameter
    and both moments of every parameter (part -> path -> (sharded,
    unsharded; the bf16 moments as f32); after one AdamW step m is 0.1 g
    and v 0.001 g^2, each rounded to bf16, so a
    gradient summed over too many ranks shows in them, where the
    parameter's sign-like first step hides it), whether the placed state
    was sharded at all and the batch's placements (by type name); None
    elsewhere."""
    from repro_torch.distributed.sharding import (TRAIN_FSDP_RULES,
                                                  placements_for, spec_for)
    from repro_torch.models.params import leaves_with_path
    mesh = _mesh(shape, names)
    (metrics, state), pair, placed = _train_pair(arch, TRAIN_FSDP_RULES,
                                                 mesh, ref=rank == 0)
    if rank:
        return None
    ref_metrics, ref = pair
    trees = {"params": (state["params"], ref["params"]),
             "m": (state["opt"]["m"], ref["opt"]["m"]),
             "v": (state["opt"]["v"], ref["opt"]["v"])}
    out = {}
    for part, (got, want) in trees.items():
        want = dict(leaves_with_path(want))
        out[part] = {p: (t.float().numpy(), want[p].float().numpy())
                     for p, t in leaves_with_path(got)}
    return {**{k: float(metrics[k]) for k in ("loss", "grad_norm")},
            **{"ref_" + k: float(ref_metrics[k])
               for k in ("loss", "grad_norm")},
            **out,
            "sharded": any(t.to_local().numel() < t.numel()
                           for _, t in leaves_with_path(placed["params"])),
            "batch": [type(pl).__name__ for pl in placements_for(spec_for(
                ("batch", None), TRAIN_FSDP_RULES, mesh, (8, 32)), mesh)]}


def _serve_pair(arch, rules, mesh, cache_dtype, ref=True, **over):
    """Prefill (batch 8 x 16, max_len 20) and one greedy decode step of
    ``arch`` (reduced) under ``rules`` on ``mesh`` on a placed copy of the
    seed's tree, and (``ref``) the same unsharded: -> (logits, step
    logits, cache) sharded, (logits, step logits) unsharded or None."""
    from repro_torch.distributed.sharding import (activate, distribute_tree,
                                                  param_shardings)
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import (Transformer, decode_step,
                                                model_spec, prefill)
    cfg = _reduced(arch, **over)
    spec = model_spec(cfg)
    tree = init_params(spec, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (8, 16))).to(torch.int32)
    placed = distribute_tree(tree, param_shardings(spec, rules, mesh), mesh)
    with activate(rules, mesh):
        model = Transformer(cfg, placed)
        t = _placed_batch({"tokens": toks}, rules, mesh)["tokens"]
        logits, cache = prefill(model, {"tokens": t}, 20,
                                cache_dtype=cache_dtype)
        l2, cache = decode_step(model, cache, logits.argmax(-1), 16)
    got = (_full(logits), _full(l2), cache)
    if not ref:
        return got, None
    ref_model = Transformer(cfg, tree)
    rl, rc = prefill(ref_model, {"tokens": toks}, 20, cache_dtype=cache_dtype)
    rl2, _ = decode_step(ref_model, rc, rl.argmax(-1), 16)
    return got, (rl, rl2)


def sharded_serve(rank, world, arch):
    """The JAX package's mini-mesh serving check on a (data=2, model=4)
    mesh under SERVE_RULES (f32 cache): -> on rank 0 both runs' prefill
    and decode logits and the attention cache's layout: its placements
    name a shard of the T axis, and this rank's block holds fewer than
    max_len positions."""
    from repro_torch.distributed.sharding import SERVE_RULES
    mesh = _mesh((2, 4), ("data", "model"))
    (logits, l2, cache), pair = _serve_pair(arch, SERVE_RULES, mesh,
                                            torch.float32, ref=rank == 0)
    k = cache["pos0"]["k"]                   # (G, B, KVH, max_len, hd)
    if rank:
        return None
    rl, rl2 = pair
    return {"logits": (logits.numpy(), rl.numpy()),
            "step": (l2.numpy(), rl2.numpy()),
            "t_split": any(getattr(pl, "dim", None) == 3
                           for pl in k.placements),
            "local_t": int(k.to_local().shape[3])}


def world_one(rank, world, arch):
    """On a world-1 (data=1, model=1) mesh, the reduced ``arch`` with the
    card's bf16 compute dtype (f32 masters, so the FSDP gather casts before
    it gathers): one step under TRAIN_FSDP_RULES and a prefill + decode
    step under SERVE_RULES (bf16 cache), each against the unsharded run:
    -> whether every loss, parameter, moment and logit is equal bit for
    bit.  (In an f32 compute dtype a norm's plain version reads its input
    several times, and autograd adds those gradient terms at the leaf
    together with the residual's in its own order, where on each rank's
    block they are added first: the steps then part by an ulp.)"""
    from repro_torch.distributed.sharding import SERVE_RULES, TRAIN_FSDP_RULES
    from repro_torch.models.params import leaves_with_path
    mesh = _mesh((1, 1), ("data", "model"))
    (metrics, state), (ref_metrics, ref), _ = _train_pair(
        arch, TRAIN_FSDP_RULES, mesh, dtype="bfloat16")
    out = {k: _bits(metrics[k]) == _bits(ref_metrics[k])
           for k in ("loss", "grad_norm")}
    for part in ("params", "m", "v"):
        got = state["params"] if part == "params" else state["opt"][part]
        want = ref["params"] if part == "params" else ref["opt"][part]
        out[part] = all(_bits(a) == _bits(b) for (_, a), (_, b) in zip(
            leaves_with_path(got), leaves_with_path(want)))
    (logits, l2, _), (rl, rl2) = _serve_pair(arch, SERVE_RULES, mesh,
                                             torch.bfloat16, dtype="bfloat16")
    out["prefill"] = _bits(logits) == _bits(rl)
    out["decode"] = _bits(l2) == _bits(rl2)
    return out


def context_parallel(rank, world, seq, cp_min_seq):
    """Causal attention of a reduced config with 6 heads (which the model
    axis of 4 does not divide) on a (data=1, model=4) mesh under
    TRAIN_RULES with the port's ``CP_MIN_SEQ`` set to ``cp_min_seq``
    (this process's copy): -> on rank 0 whether the context-parallel path
    ran, and the output and the gradients of x and of every weight, each
    as (sharded, unsharded)."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import (TRAIN_RULES, activate,
                                                  distribute_tree,
                                                  param_shardings)
    from repro_torch.models import attention
    from repro_torch.models.attention import attend_full, attn_spec
    from repro_torch.models.params import init_params
    sharding.CP_MIN_SEQ = cp_min_seq
    taken = []
    cp = attention._context_parallel_attention

    def recorded(*a):
        taken.append(a[0].shape[2])
        return cp(*a)

    attention._context_parallel_attention = recorded
    mesh = _mesh((1, 4), ("data", "model"))
    cfg = _reduced("qwen2.5-3b", n_heads=6, n_kv_heads=2)
    spec = attn_spec(cfg)
    tree = init_params(spec, 0, device="cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, seq, cfg.d_model, generator=g)
    dy = torch.randn(2, seq, cfg.d_model, generator=g)

    def run(p, xx):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        xx = xx.detach().requires_grad_()
        y = attend_full(leaves, xx, cfg)
        (y * sharding.replicated(dy, y)).sum().backward()
        return y, xx.grad, {k: v.grad for k, v in leaves.items()}

    ref = run(tree, x)
    with activate(TRAIN_RULES, mesh):
        placed = distribute_tree(tree, param_shardings(spec, TRAIN_RULES,
                                                       mesh), mesh)
        xs = _placed_batch({"x": x}, TRAIN_RULES, mesh)["x"]
        got = run(placed, xs)
    full = (_full(got[0]), _full(got[1]),
            {k: _full(v) for k, v in got[2].items()})
    if rank:
        return None
    return {"taken": taken,
            "y": (full[0].detach().numpy(), ref[0].detach().numpy()),
            "dx": (full[1].numpy(), ref[1].numpy()),
            "dw": {k: (full[2][k].numpy(), ref[2][k].numpy())
                   for k in ref[2]}}
