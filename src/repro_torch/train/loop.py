"""Training loop, in PyTorch: gradient accumulation, checkpoint/restart,
straggler watchdog, metrics logging.

The port's copy of ``repro.train.loop``.  Family-agnostic: pass any
(loss_fn, params) pair.  Gradients come from ``torch.autograd.grad`` over
the parameter leaves; the step runs eagerly (the reference jits it).  The
loop runs on ``device`` (default: the card): the initial parameters go
there, batches (numpy from ``LMDataPipeline``, or tensors) are copied
there, and a restored checkpoint is placed there.

``make_mesh_train_step`` is the data-parallel step of the mesh launcher
(``launch.train``): state as DTensors on a ``DeviceMesh``, each rank's
rows of the global batch, gradients averaged over the data-parallel axes.

As in the reference, a resumed run draws from a fresh ``iter(data)``: step
``start`` sees the iterator's first batch.  One difference in mechanics,
none in what is written: a save first waits for the previous async save
to finish, and ``train`` waits for it before it returns or raises, so two
writers never share the ``.tmp_step_*`` directory of one step and a
checkpoint that was begun is published.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.packing import resolve_device
from repro_torch.dist.fault_tolerance import InjectedFault, StepWatchdog
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    grad_accum: int = 1
    async_checkpoint: bool = True
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads) of loss_fn(params, batch); grads has the params' tree
    and dtypes (a leaf the loss does not reach gets zeros)."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True,
                                    materialize_grads=True)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), leaves)


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig, grad_accum: int = 1):
    """loss_fn(params, batch) -> scalar.  grad_accum > 1 runs microbatches
    (microbatch i is rows ``reshape(grad_accum, -1)[i]`` of every batch
    entry; gradients summed in float32 and divided, as the loss)."""

    def step(params, opt_state, batch):
        if grad_accum == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                           params)
            loss = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
            for i in range(grad_accum):
                micro = tree_map(lambda x: x.reshape(grad_accum, -1, *x.shape[1:])[i], batch)
                l, g = value_and_grad(loss_fn, params, micro)
                acc = tree_map(lambda a, gg: a + gg.float(), acc, g)
                loss = loss + l
            grads = tree_map(lambda g: g / grad_accum, acc)
            loss = loss / grad_accum
        new_p, new_s, metrics = adamw_update(grads, opt_state, params, opt_cfg)
        metrics["loss"] = loss
        return new_p, new_s, metrics

    return step


def _dims_over(placements, mesh) -> list:
    """The mesh dims of more than one rank that ``placements`` shard."""
    return [i for i, pl in enumerate(placements) if pl.is_shard() and mesh.size(i) > 1]


def _local(t):
    """A DTensor's local shard (an undistributed tensor as it is)."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def whole(t):
    """A DTensor's whole value: gathered where it is sharded over more than
    one rank, its local shard otherwise; any other tensor as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    return t.full_tensor() if _dims_over(t.placements, t.device_mesh) else t.to_local()


def make_mesh_train_step(loss_fn: Callable, opt_cfg: AdamWConfig, mesh, batch_specs):
    """A data-parallel train step over ``mesh`` (a ``DeviceMesh`` whose
    "model" axis has one rank): ``step(params, opt_state, batch)`` with
    params and AdamW state as DTensors (placed by
    ``dist.sharding.lm_param_specs`` / ``opt_state_specs``, or any specs
    over the data-parallel axes) and ``batch`` the global batch, which
    every rank holds whole.

    Each rank takes its rows of the batch by ``batch_specs``, gathers the
    parameters where they are sharded (``zero_dp``), and computes
    ``loss_fn(params, rows)`` and its gradients.  Where the batch is
    sharded over more than one rank, the gradients (in float32, one
    all-reduce of all of them) and the loss are averaged over the axes it
    is sharded on: the global batch's token mean when every rank holds the
    same number of rows.  The
    global gradient norm sums each leaf's squares over its shards, and
    AdamW updates each rank's shards.  On a mesh of one rank the step
    equals ``make_train_step``'s bit for bit."""
    from repro_torch.dist import compat

    axes = list(mesh.mesh_dim_names)
    # the axes the batch is sharded on (none: every rank runs the whole batch)
    named = {a for spec in batch_specs.values() for e in spec for a in compat.entry_axes(e)}
    dp = tuple(a for a in axes if a in named)
    ranks = compat.axis_size(dp, mesh=mesh) if dp else 1

    def step(params, opt_state, batch):
        rows = {k: v[compat.local_slices(v.shape, mesh, compat.placements_of(mesh, batch_specs[k]))]
                for k, v in batch.items()}
        loss, grads = value_and_grad(loss_fn, tree_map(whole, params), rows)
        if ranks > 1:
            flat = torch.cat([g.float().reshape(-1) for g in tree_leaves(grads)])
            flat = compat.psum(flat, dp, mesh=mesh) / ranks
            loss = compat.psum(loss, dp, mesh=mesh) / ranks
            parts = iter(torch.split(flat, [g.numel() for g in tree_leaves(grads)]))
            grads = tree_map(lambda g: next(parts).reshape(g.shape).to(g.dtype), grads)
        # each rank's shards of the gradients, and the global norm
        sq = []
        shards = []
        for g, p in zip(tree_leaves(grads), tree_leaves(params)):
            pl = p.placements
            gl = g[compat.local_slices(g.shape, mesh, pl)]
            s2 = torch.sum(torch.square(gl.float()))
            over = [axes[i] for i in _dims_over(pl, mesh)]
            sq.append(compat.psum(s2, tuple(over), mesh=mesh) if over else s2)
            shards.append(gl)
        norm = torch.sqrt(sum(sq))
        it = iter(shards)
        local_g = tree_map(lambda _: next(it), grads)
        new_p, new_s, metrics = adamw_update(local_g, tree_map(_local, opt_state),
                                             tree_map(_local, params), opt_cfg, grad_norm=norm)
        metrics["loss"] = loss
        placed = lambda new, old: compat.from_local(new, mesh, old.placements, tuple(old.shape))
        return (tree_map(placed, new_p, params),
                type(opt_state)(*tree_map(placed, tuple(new_s), tuple(opt_state))), metrics)

    return step


def batch_to(batch, device):
    """A batch (numpy arrays or tensors, in a dict) on ``device``."""
    if isinstance(batch, Mapping):
        return {k: batch_to(v, device) for k, v in batch.items()}
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    return torch.from_numpy(np.asarray(batch)).to(device)


class AsyncSaver:
    """Checkpoint saves with at most one async writer in flight: each save
    first joins the previous writer."""

    def __init__(self, directory, keep: int):
        self.directory, self.keep = directory, keep
        self._pending = None

    def save(self, tree, step: int, *, async_: bool) -> None:
        self.wait()
        self._pending = ckpt.save(tree, self.directory, step, keep=self.keep, async_=async_)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None


def train(
    loss_fn: Callable,
    init_params,
    data: Iterable,
    cfg: TrainConfig,
    *,
    watchdog: Optional[StepWatchdog] = None,
    fault_at_step: Optional[int] = None,
    log: Callable[[str], None] = print,
    device=None,
):
    """Returns (params, opt_state, history).  Resumes from cfg.ckpt_dir if a
    checkpoint exists; `fault_at_step` injects a crash (restart tests)."""
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev), init_params)
    opt_state = adamw_init(params)
    start = 0
    if cfg.ckpt_dir and ckpt.latest_step(cfg.ckpt_dir) is not None:
        (params, opt_state), start = ckpt.restore((params, opt_state), cfg.ckpt_dir, device=dev)
        log(f"resumed from step {start}")

    step_fn = make_train_step(loss_fn, cfg.opt, cfg.grad_accum)
    saver = AsyncSaver(cfg.ckpt_dir, cfg.keep_ckpts) if cfg.ckpt_dir else None
    history = []
    data_it = iter(data)
    try:
        for step in range(start, cfg.steps):
            if watchdog:
                watchdog.start_step(step)
            batch = batch_to(next(data_it), dev)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if fault_at_step is not None and step == fault_at_step:
                raise InjectedFault(f"injected node failure at step {step}")
            if watchdog:
                action = watchdog.end_step()
                if action == "checkpoint" and saver:
                    saver.save((params, opt_state), step + 1, async_=False)
            loss = float(metrics["loss"])
            history.append(loss)
            if step % cfg.log_every == 0:
                log(f"step {step}: loss={loss:.4f} gnorm={float(metrics['grad_norm']):.3f}")
            if saver and (step + 1) % cfg.ckpt_every == 0:
                saver.save((params, opt_state), step + 1, async_=cfg.async_checkpoint)
        if saver:
            saver.save((params, opt_state), cfg.steps, async_=False)
    finally:
        if saver:
            saver.wait()
    return params, opt_state, history
