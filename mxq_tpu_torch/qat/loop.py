"""The QAT training loop with checkpoints (port of ``mxq_tpu/qat/loop.py``).

A checkpoint is a directory ``<output_dir>/<N>``, N the number of steps
completed: the student's params through ``utils.checkpoint.save_params``
(``params.safetensors`` and ``mxq_config.json``) and the optimizer's state
in ``optimizer.safetensors`` (both AdamW moments of every parameter and
the update count, which also sets the schedule). It is written under a
temporary name and renamed when whole. The teacher is never saved.
``mxq_tpu`` writes orbax checkpoints instead, so neither package resumes
from the other's.

On a mesh (``run_training(mesh=)``, every rank under torchrun) the student
and the KD teacher train as ``parallel.fsdp.ShardedLlama`` (FSDP2): each
rank takes its rows of every batch, logs and metrics come from the
coordinator (rank 0), and a checkpoint holds whole tensors in the same
files, gathered from the shards and written by the coordinator, so that a
sharded run resumes from an unsharded run's checkpoint and the other way
round.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Iterator, Optional

import numpy as np
import torch

from mxq_tpu_torch import resolve_device
from mxq_tpu_torch.models import llama
from mxq_tpu_torch.parallel import fsdp, multihost
from mxq_tpu_torch.qat import train as train_mod
from mxq_tpu_torch.utils import checkpoint, profiling, safetensors_io
from mxq_tpu_torch.utils.metrics import MetricsWriter

OPTIMIZER = "optimizer.safetensors"


@dataclasses.dataclass
class LoopConfig:
    output_dir: str = "out/qat"
    save_steps: int = 1000
    save_total_limit: int = 1
    log_steps: int = 10
    max_steps: Optional[int] = None
    # TensorBoard events and metrics.jsonl: None writes none, "auto"
    # writes them under <output_dir>/logs
    logdir: Optional[str] = "auto"


def saved_steps(output_dir: str) -> list[int]:
    """The labels of the checkpoints in ``output_dir``, oldest first."""
    if not os.path.isdir(output_dir):
        return []
    return sorted(int(n) for n in os.listdir(output_dir) if n.isdigit())


def save_checkpoint(lc: LoopConfig, step: int, params,
                    cfg: llama.LlamaConfig,
                    opt: train_mod.Optimizer) -> None:
    """Write checkpoint ``step`` of ``params`` (a params dict or a
    ``ShardedLlama``), then drop the oldest beyond
    ``lc.save_total_limit``. Sharded, the tensors are gathered whole (a
    collective) and the coordinator writes them."""
    tensors, state = opt.state_tensors(), {}
    if isinstance(params, torch.nn.Module):
        params = fsdp.params_dict(fsdp.stack_full(params.named_leaves()))
        state = fsdp.stack_full({k: v for k, v in tensors.items()
                                 if k != "count"})
        state["count"] = tensors["count"]
        tensors = state
    if multihost.is_coordinator():
        final = os.path.join(lc.output_dir, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        checkpoint.save_params(tmp, params, cfg)
        safetensors_io.save_file(tensors, os.path.join(tmp, OPTIMIZER))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in saved_steps(lc.output_dir)[:-lc.save_total_limit]:
            shutil.rmtree(os.path.join(lc.output_dir, str(old)))
    multihost.sync_global_devices("save_checkpoint")


@torch.no_grad()
def restore_checkpoint(output_dir: str, params,
                       opt: train_mod.Optimizer) -> int:
    """Load the newest checkpoint of ``output_dir`` into ``params`` (a
    params dict or a ``ShardedLlama``, in place: a rank keeps its shards)
    and ``opt``; returns its label, the steps completed (0 when there is
    none)."""
    steps = saved_steps(output_dir)
    if not steps:
        return 0
    d = os.path.join(output_dir, str(steps[-1]))
    tensors = safetensors_io.iter_tensors(os.path.join(d, checkpoint.TENSORS))
    state = dict(safetensors_io.iter_tensors(os.path.join(d, OPTIMIZER)))
    if isinstance(params, torch.nn.Module):
        named = params.named_leaves()
        fsdp.load_full(named, dict(tensors))
        state = {"count": state["count"], **fsdp.shards_of(
            {k: v for k, v in state.items() if k != "count"},
            {f"{m}.{n}": t for n, t in named.items()
             for m in ("exp_avg", "exp_avg_sq")})}
        opt.load_state_tensors(state)
        return steps[-1]
    named = train_mod.leaves(params)
    seen = set()
    for name, t in tensors:
        if name not in named or named[name].shape != t.shape:
            raise ValueError(f"{d}: tensor {name!r} {tuple(t.shape)} does "
                             "not fit the parameters")
        named[name].copy_(t)
        seen.add(name)
    if seen != set(named):
        raise ValueError(f"{d}: no tensor for {sorted(set(named) - seen)}")
    opt.load_state_tensors(state)
    return steps[-1]


def run_training(params, teacher_params, cfg: llama.LlamaConfig,
                 tc: train_mod.TrainConfig, lc: LoopConfig,
                 data_iter: Iterator[dict], mesh=None, resume: bool = True,
                 log=print, val_batches=None,
                 device: str | torch.device = "cuda") -> dict:
    """Train ``params`` (in place: each tensor becomes a leaf that requires
    grad) until the data or ``lc.max_steps`` runs out, the teacher's
    logits the target when ``tc.use_kd``. With ``resume`` and a checkpoint
    in ``lc.output_dir``, training restarts from it and skips as many
    batches of ``data_iter`` as steps were completed. Every ``log_steps``
    steps the loss, the gradient norm and the seconds per step are logged
    and written to the metrics backends; with ``val_batches`` the end
    reports ``eval_ppl``, exp of the mean validation loss. Returns
    ``params``, ``opt_state`` (the :class:`train.Optimizer`),
    ``last_step``, the logged ``losses`` and ``eval_ppl``.

    ``mesh`` (from ``parallel.sharding.make_mesh`` or
    ``multihost.make_hybrid_mesh``; every rank calls this with the same
    arguments and whole batches) trains FSDP2 shards of the student and
    the teacher instead: each rank takes its rows of every batch
    (``multihost.local_batch``), the loss logged is the mean over the
    ranks, and ``params`` is left as it was: the trained params come back
    whole in the result (a collective gathers them)."""
    dev = resolve_device(device)
    llama.check_params_device(params, dev)
    if teacher_params is not None:
        llama.check_params_device(teacher_params, dev)
    coordinator = multihost.is_coordinator()
    if not coordinator:
        log = lambda *_a, **_k: None  # noqa: E731 -- log once, on rank 0
    logdir = lc.logdir
    if logdir == "auto":
        logdir = os.path.join(lc.output_dir, "logs")
    writer = MetricsWriter(logdir if coordinator else None)
    if mesh is not None:
        student = fsdp.ShardedLlama(params, cfg, mesh)
        params = None     # the shards hold the weights now
        if teacher_params is not None:
            teacher_params = fsdp.ShardedLlama(
                teacher_params, dataclasses.replace(
                    cfg, w_bits=32, a_bits=32, kv_bits=32), mesh,
                requires_grad=False)
        rows = lambda b: multihost.local_batch(b, mesh)  # noqa: E731
        mean = fsdp.all_mean
    else:
        student = params
        for p in train_mod.leaves(params).values():
            p.requires_grad_(True)
        rows = mean = lambda x: x  # noqa: E731
    opt = train_mod.make_optimizer(tc, student)

    start_step = 0
    if resume:
        start_step = restore_checkpoint(lc.output_dir, student, opt)
        if start_step:
            # the same shuffle on restart: skip the batches already trained
            for _ in range(start_step):
                if next(data_iter, None) is None:
                    break
            log(f"resumed from step {start_step}")

    step_fn = train_mod.make_train_step(cfg, tc, opt)
    losses = []
    t0 = time.time()
    step = start_step                 # = steps completed so far
    for batch in data_iter:
        if lc.max_steps is not None and step >= lc.max_steps:
            break
        with profiling.annotate("train_step"):
            metrics = step_fn(student, teacher_params, rows(batch))
        step += 1
        if step % lc.log_steps == 0:
            loss = float(mean(metrics["loss"]))    # waits for the step
            gnorm = float(metrics["grad_norm"])
            losses.append(loss)
            s_per_step = (time.time() - t0) / lc.log_steps
            log(f"step {step}: loss={loss:.4f} gnorm={gnorm:.3f} "
                f"({s_per_step:.2f}s/step)")
            writer.log(step, **{"train/loss": loss,
                                "train/grad_norm": gnorm,
                                "train/seconds_per_step": s_per_step})
            t0 = time.time()
        if step % lc.save_steps == 0:
            save_checkpoint(lc, step, student, cfg, opt)

    if step == 0 or step % lc.save_steps != 0:
        save_checkpoint(lc, step, student, cfg, opt)
    if mesh is not None:
        params = fsdp.params_dict(fsdp.stack_full(student.named_leaves()))
    out = {"params": params, "opt_state": opt, "last_step": step,
           "losses": losses}
    if val_batches:
        tot = sum(float(mean(train_mod.eval_ppl_step(student, rows(vb),
                                                     cfg)))
                  for vb in val_batches)
        out["eval_ppl"] = float(np.exp(tot / len(val_batches)))
        log(f"eval ppl (exp of mean val loss): {out['eval_ppl']:.4f}")
        writer.log(step, **{"eval/ppl": out["eval_ppl"]})
    writer.close()
    return out
