"""QAT with knowledge distillation (port of ``mxq_tpu/qat/train.py``).

* The KD loss is KL(softmax(teacher) ‖ log_softmax(student)) averaged over
  the unmasked tokens and scaled, with no CE mixed in.
* The teacher runs under ``torch.no_grad`` at full precision.
* The student's weights take the MXQ fake-quant with its straight-through
  backward on every forward (``llama.forward(train=True)``), and with
  ``remat`` each decoder layer is recomputed in the backward.
* The optimizer follows ``optax.chain(clip_by_global_norm, adamw(cosine
  schedule))`` step for step: :class:`Optimizer`.

The parameters are the model's dict with every tensor a leaf that requires
grad; a train step updates them in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from mxq_tpu_torch.models import llama


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    warmup_steps: int = 0
    total_steps: int = 1000
    use_kd: bool = True
    kd_loss_scale: float = 1.0
    temperature: float = 1.0
    grad_clip: float = 1.0
    remat: bool = True


def leaves(params: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """The tensors of a parameter dict by dotted path, in the dict's
    order."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def lr_multiplier(tc: TrainConfig) -> Callable[[int], float]:
    """The learning rate of update ``count`` (0 for the first) over
    ``tc.learning_rate``: optax's ``cosine_decay_schedule(lr,
    total_steps)``, or with warmup ``warmup_cosine_decay_schedule(0, lr,
    warmup_steps, total_steps)`` (a linear ramp from 0, then the cosine
    over the remaining steps)."""
    w, total = tc.warmup_steps, tc.total_steps
    decay = total - w if w > 0 else total
    if decay <= 0:
        raise ValueError(f"the cosine decay needs total_steps > "
                         f"warmup_steps, got {total} and {w}")

    def cosine(count):
        return 0.5 * (1 + math.cos(math.pi * min(count, decay) / decay))

    if w <= 0:
        return cosine
    return lambda count: count / w if count < w else cosine(count - w)


class Optimizer:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule,
    weight_decay))`` over the leaves of ``params``: the gradients are
    scaled to ``(g / norm) * grad_clip`` when their global norm reaches
    ``grad_clip``, as optax does (``torch.nn.utils.clip_grad_norm_``
    divides by ``norm + 1e-6``), then ``torch.optim.AdamW`` (betas 0.9,
    0.999, eps 1e-8 outside the square root, bias correction, decoupled
    decay) steps at the schedule's rate for update ``count``."""

    def __init__(self, tc: TrainConfig, params: dict):
        self.tc = tc
        self.named = leaves(params)
        self.multiplier = lr_multiplier(tc)
        self.count = 0                   # updates made so far
        self.adamw = torch.optim.AdamW(
            list(self.named.values()), lr=tc.learning_rate,
            betas=(0.9, 0.999), eps=1e-8, weight_decay=tc.weight_decay)

    def step(self) -> torch.Tensor:
        """Clip the gradients the backward left in ``.grad``, update the
        parameters and clear the gradients. Returns the global norm of the
        unclipped gradients (a 0-dim tensor on their device)."""
        grads = [p.grad for p in self.named.values()]
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        keep, clip = norm < self.tc.grad_clip, self.tc.grad_clip
        for g in grads:
            g.copy_(torch.where(keep, g, (g / norm) * clip))
        for group in self.adamw.param_groups:
            group["lr"] = self.tc.learning_rate * self.multiplier(self.count)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1
        return norm

    def state_tensors(self) -> dict[str, torch.Tensor]:
        """Both moments of every leaf by path, and the update count."""
        out = {"count": torch.tensor(self.count, dtype=torch.int64)}
        for name, p in self.named.items():
            st = self.adamw.state.get(p)
            if st:
                out[f"exp_avg.{name}"] = st["exp_avg"]
                out[f"exp_avg_sq.{name}"] = st["exp_avg_sq"]
        return out

    def load_state_tensors(self, tensors: dict[str, torch.Tensor]) -> None:
        """Restore what :meth:`state_tensors` gave."""
        self.count = int(tensors["count"])
        for name, p in self.named.items():
            if f"exp_avg.{name}" in tensors:
                self.adamw.state[p] = {
                    "step": torch.tensor(float(self.count)),
                    "exp_avg": tensors[f"exp_avg.{name}"].to(p.device),
                    "exp_avg_sq": tensors[f"exp_avg_sq.{name}"].to(p.device)}


def make_optimizer(tc: TrainConfig, params: dict) -> Optimizer:
    return Optimizer(tc, params)


def kd_loss_fn(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
               mask: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Mean over the unmasked tokens of KL(softmax(teacher) ‖
    log_softmax(student)), times ``scale``."""
    t = torch.softmax(teacher_logits, dim=-1)
    ls = torch.log_softmax(student_logits, dim=-1)
    lt = torch.log_softmax(teacher_logits, dim=-1)
    kl = (t * (lt - ls)).sum(-1)                         # [B, T]
    m = mask.to(kl.dtype)
    return scale * (kl * m).sum() / m.sum().clamp_min(1.0)


def loss_fn(params, teacher_params, batch, cfg: llama.LlamaConfig,
            teacher_cfg: llama.LlamaConfig, tc: TrainConfig) -> torch.Tensor:
    """The student's training loss on ``batch`` (``input_ids`` and
    optionally ``labels`` [B, T]): the KD loss against the teacher's logits
    with ``tc.use_kd`` and a teacher, else the shifted CE."""
    dev = params["embed_tokens"].device
    ids = torch.as_tensor(batch["input_ids"], device=dev)
    labels = torch.as_tensor(batch.get("labels", ids), device=dev)
    logits, _ = llama.forward(params, ids, cfg, device=dev, train=True,
                              remat=tc.remat)
    if tc.use_kd and teacher_params is not None:
        with torch.no_grad():
            t_logits, _ = llama.forward(teacher_params, ids, teacher_cfg,
                                        device=dev)
        return kd_loss_fn(logits, t_logits, labels != -100,
                          tc.kd_loss_scale)
    return llama.cross_entropy_loss(logits, labels)


def make_train_step(cfg: llama.LlamaConfig, tc: TrainConfig,
                    optimizer: Optimizer,
                    teacher_cfg: Optional[llama.LlamaConfig] = None):
    """Returns ``train_step(params, teacher_params, batch) -> metrics``: one
    forward and backward of :func:`loss_fn` and one optimizer update of
    ``params`` in place; ``metrics`` holds the ``loss`` and the unclipped
    ``grad_norm`` as 0-dim tensors on the device (read them when needed:
    each read waits for the card)."""
    teacher_cfg = teacher_cfg or dataclasses.replace(
        cfg, w_bits=32, a_bits=32, kv_bits=32)

    def train_step(params, teacher_params, batch):
        loss = loss_fn(params, teacher_params, batch, cfg, teacher_cfg, tc)
        loss.backward()
        return {"loss": loss.detach(), "grad_norm": optimizer.step()}

    return train_step


@torch.no_grad()
def eval_ppl_step(params, batch, cfg: llama.LlamaConfig) -> torch.Tensor:
    """The CE loss of ``batch``; the loop's perplexity is exp of its mean."""
    dev = params["embed_tokens"].device
    logits, _ = llama.forward(params, batch["input_ids"], cfg, device=dev)
    return llama.cross_entropy_loss(
        logits, torch.as_tensor(batch.get("labels", batch["input_ids"]),
                                device=dev))
