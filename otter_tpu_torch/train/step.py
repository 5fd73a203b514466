"""SFT training step (counterpart of `otter_tpu/train/step.py`): freezing
policy, weight-decay mask, schedules, optimizer, losses and the step.

The same semantics as the JAX module, in PyTorch:

  - freezing: only the perceiver, the gated-xattn blocks and the input
    embedding (tied with the head) train; `split_params` sets
    `requires_grad` so the frozen towers build no autograd graph.
  - weight decay only on gated-xattn weights, not gates/norms/biases.
  - warmup then constant/linear/cosine, step for step optax's
    `join_schedules`.
  - clip_by_global_norm(1.0) -> AdamW(b1 0.9, b2 0.95, eps 1e-8), with
    optax `MultiSteps` gradient accumulation. The optimizer keeps f32
    master copies of the trainable parameters and f32 moments (the JAX
    package's f32-master policy, `parallel/precision.py`) and writes the
    masters back into the modules' (bf16) parameters after each update.
    `make_optimizer(state_bits=8)` gives the 8-bit Adam of `opt8.py`
    instead (int8 moments, no masters).
  - the HF shift-by-one loss with -100 masking, and the chunked fused
    cross-entropy that never builds the [B, S, V] logits: each chunk runs
    under `torch.utils.checkpoint`, so its logits are recomputed in the
    backward pass (the JAX `jax.checkpoint` + `lax.scan`).
  - the <answer>-row embedding-gradient mask.
  - under a mesh (`parallel/`): self-attention runs as the ring over the
    "seq" axis, the loss is the mean over the global batch's tokens (every
    data rank's), the global norm counts each element once over the
    sharded gradients, and the optimizer updates each rank's local
    shards.

PyTorch updates in place: `step(state, batch)` returns the same state
object with its parameters, optimizer state and step count advanced.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from otter_tpu_torch.parallel.sharding import local_tensor

Params = Dict[str, nn.Parameter]


def flax_path(name: str) -> str:
    """Module parameter name -> the flax path the JAX package uses."""
    return name.replace(".", "/")


def path_is_trainable(path: str, text_tied: bool,
                      idefics: bool = False) -> bool:
    parts = path.split("/")
    if "perceiver" == parts[0]:
        return True
    if any(p.startswith("xattn_") for p in parts):
        return True
    # LoRA adapters train (modeling_otter.py:895-898)
    if parts[-1] in ("lora_a", "lora_b"):
        return True
    if idefics:
        return parts[0] in ("additional_embedding", "additional_fc")
    if parts[-2:] and "wte" in parts:
        return True
    if not text_tied and "lm_head" in parts:
        return True
    return False


def split_params(model: nn.Module, cfg) -> Tuple[Params, Params]:
    """-> (trainable, frozen), {flax path: parameter} each. Sets
    `requires_grad` on every parameter to match."""
    tied = cfg.text.tie_embeddings
    idefics = hasattr(cfg, "additional_vocab_size")
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        path = flax_path(name)
        train = path_is_trainable(path, tied, idefics)
        p.requires_grad_(train)
        (trainable if train else frozen)[path] = p
    return trainable, frozen


def weight_decay_mask(trainable: Iterable[str]) -> Dict[str, bool]:
    """True only for gated-xattn weights that are not gates/norms/biases
    (train_utils.py:167-183)."""
    def decay(path):
        parts = path.split("/")
        in_xattn = any(p.startswith("xattn_") for p in parts)
        is_excluded = any(("gate" in p and "gate_proj" not in p)
                          or "norm" in p or p == "bias" for p in parts)
        return in_xattn and not is_excluded

    return {k: decay(k) for k in trainable}


def make_schedule(name: str, lr: float, warmup_steps: int,
                  total_steps: int) -> Callable[[int], float]:
    """step -> learning rate: a linear warmup from 0, then the named
    schedule, as optax.join_schedules([warmup, rest], [warmup_steps])."""
    warm_n = max(warmup_steps, 1)
    rest_n = max(total_steps - warmup_steps, 1)
    if name not in ("constant", "linear", "cosine"):
        raise ValueError(f"unknown schedule {name!r}")

    def linear(init, end, n, count):
        frac = 1 - min(max(count, 0), n) / n
        return (init - end) * frac + end

    def rest(count):
        if name == "constant":
            return lr
        if name == "linear":
            return linear(lr, 0.0, rest_n, count)
        count = min(count, rest_n)
        return lr * 0.5 * (1 + math.cos(math.pi * count / rest_n))

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return linear(0.0, lr, warm_n, step)
        return rest(step - warmup_steps)

    return schedule


_STATE_TENSORS = ("master", "mu", "nu", "mu_s", "nu_s", "acc")


@dataclass
class OptState:
    """AdamW state with f32 masters, and the MultiSteps accumulator. The
    8-bit Adam of `train/opt8.py` keeps no masters and stores `mu` / `nu`
    as int8 blocks with their f32 scales in `mu_s` / `nu_s`."""
    master: Dict[str, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int = 0            # inner (applied) updates
    mini_step: int = 0        # MultiSteps position inside an accumulation
    acc: Dict[str, torch.Tensor] = field(default_factory=dict)
    mu_s: Dict[str, torch.Tensor] = field(default_factory=dict)
    nu_s: Dict[str, torch.Tensor] = field(default_factory=dict)

    def state_dict(self) -> dict:
        return dict({k: getattr(self, k) for k in _STATE_TENSORS},
                    count=self.count, mini_step=self.mini_step)

    def load_state_dict(self, sd: dict) -> None:
        for key in _STATE_TENSORS:
            mine = getattr(self, key)
            for k, t in sd.get(key, {}).items():
                mine[k].copy_(t)
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for key in _STATE_TENSORS
                   for t in getattr(self, key).values())


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


def _local_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    return global_norm(grads.values())


class AdamW:
    """optax.chain(clip_by_global_norm, adamw(mask=...)), optionally inside
    optax.MultiSteps, updating the modules' parameters in place from f32
    masters. Tensors are updated one at a time, so the scratch memory is
    that of the largest parameter, not of all of them."""

    def __init__(self, schedule: Callable[[int], float], decay: Dict[str,
                 bool], *, weight_decay: float, grad_clip: float,
                 grad_accum_steps: int = 1, mu_dtype=None,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8):
        self.schedule, self.decay = schedule, decay
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        self.accum = grad_accum_steps
        self.mu_dtype = mu_dtype or torch.float32
        self.b1, self.b2, self.eps = b1, b2, eps
        # {path: ShardLayout} and the groups that hold the shards, once
        # `shard` is called for a sharded model
        self.layouts, self.groups = {}, ()
        self.norm_fn = _local_norm

    def shard(self, layouts, groups) -> None:
        """Update local shards: the global norm sums each element once
        over `groups` (`parallel.sharding.sharded_sq_sum`)."""
        from otter_tpu_torch.parallel.sharding import sharded_sq_sum
        self.layouts, self.groups = layouts, tuple(groups)
        self.norm_fn = lambda grads: sharded_sq_sum(
            layouts, grads, self.groups).sqrt()

    def init(self, params: Params) -> OptState:
        with torch.no_grad():
            master = {k: p.detach().to(torch.float32, copy=True)
                      for k, p in params.items()}
        zeros = lambda dt: {k: torch.zeros_like(m, dtype=dt)
                            for k, m in master.items()}
        return OptState(master=master, mu=zeros(self.mu_dtype),
                        nu=zeros(torch.float32),
                        acc=zeros(torch.float32) if self.accum > 1 else {})

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: OptState,
               params: Params) -> None:
        if self.accum > 1:
            # MultiSteps: running mean of the mini-step gradients; the
            # inner update applies on the last one
            n = state.mini_step
            for k, g in grads.items():
                acc = state.acc[k]
                acc.add_((g.float() - acc) / (n + 1))
            if n < self.accum - 1:
                state.mini_step = n + 1
                return
            grads = {k: a.clone() for k, a in state.acc.items()}
            for a in state.acc.values():
                a.zero_()
            state.mini_step = 0
        self._apply(grads, state, params)

    def _apply(self, grads, state: OptState, params: Params) -> None:
        g_norm = self.norm_fn(grads)
        clip = g_norm < self.grad_clip
        lr = self.schedule(state.count)
        state.count += 1
        bc1 = 1 - self.b1 ** state.count
        bc2 = 1 - self.b2 ** state.count
        for k, p in params.items():
            g = grads[k].float()
            g = torch.where(clip, g, g / g_norm * self.grad_clip)
            mu = (1 - self.b1) * g + self.b1 * state.mu[k].float()
            nu = state.nu[k]
            nu.mul_(self.b2).add_((1 - self.b2) * g.square())
            upd = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
            state.mu[k].copy_(mu)
            master = state.master[k]
            if self.decay.get(k, False):
                upd.add_(master, alpha=self.weight_decay)
            master.add_(upd, alpha=-lr)
            p.copy_(master)


def make_optimizer(trainable: Iterable[str], *, lr: float = 1e-5,
                   schedule: str = "constant", warmup_steps: int = 0,
                   total_steps: int = 10000, weight_decay: float = 0.1,
                   grad_clip: float = 1.0, grad_accum_steps: int = 1,
                   mu_dtype=None, state_bits: Optional[int] = None
                   ) -> AdamW:
    """`trainable`: the trainable paths (the keys of `split_params`'s first
    dict). mu_dtype=torch.bfloat16 stores Adam's first moment in bf16.

    state_bits=8 switches to blockwise int8 Adam states (`train/opt8.py`,
    ~2.02 bytes a parameter and no f32 masters), in the JAX chain's order:
    clip, 8-bit Adam, decoupled decay on the parameter, learning rate."""
    if state_bits == 8:
        from otter_tpu_torch.train.opt8 import Adam8
        return Adam8(make_schedule(schedule, lr, warmup_steps, total_steps),
                     weight_decay_mask(trainable), weight_decay=weight_decay,
                     grad_clip=grad_clip, grad_accum_steps=grad_accum_steps)
    if state_bits is not None:
        raise ValueError(f"state_bits must be None or 8, not {state_bits}")
    return AdamW(make_schedule(schedule, lr, warmup_steps, total_steps),
                 weight_decay_mask(trainable), weight_decay=weight_decay,
                 grad_clip=grad_clip, grad_accum_steps=grad_accum_steps,
                 mu_dtype=mu_dtype)


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF convention: predict labels[t+1] from logits[t]; -100 = ignored.
    Returns (mean loss, token count)."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:].long()
    valid = targets != -100
    safe = torch.where(valid, targets, torch.zeros_like(targets))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    n = valid.sum().clamp(min=1)
    return nll.sum() / n, n


def _chunk_nll(hc, head, tc, tied: bool, logit_scale):
    logits = hc @ head.t() if tied else hc @ head
    if logit_scale is not None:
        logits = logits * logit_scale
    logits = logits.float()
    valid = tc != -100
    safe = torch.where(valid, tc, torch.zeros_like(tc))
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, safe[..., None])[..., 0]
    return torch.where(valid, lse - tgt, torch.zeros_like(lse)).sum()


def chunked_causal_lm_loss(hidden: torch.Tensor, head: torch.Tensor,
                           labels: torch.Tensor, *, tied: bool = True,
                           logit_scale=None, chunk: int = 256
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused cross-entropy over final hidden states: the [B, S, V] logits
    (and their gradient) are never built whole. Each `chunk`-token slice
    is projected against the head and reduced to its summed NLL under
    `torch.utils.checkpoint`, which keeps only the slice and recomputes
    its logits in the backward pass.

    hidden [B, S, D] = final-norm decoder output (model skip_head=True);
    head = embedding [V, D] when tied else lm_head kernel [D, V]. Same
    math and shift convention as `causal_lm_loss`.
    """
    h = hidden[:, :-1]
    targets = labels[:, 1:].long()
    total = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, h.shape[1], chunk):
        total = total + checkpoint(
            _chunk_nll, h[:, i:i + chunk], head, targets[:, i:i + chunk],
            tied, logit_scale, use_reentrant=False)
    n_tok = (targets != -100).sum().clamp(min=1)
    return total / n_tok, n_tok


@dataclass
class TrainState:
    step: int
    model: nn.Module
    trainable: Params
    frozen: Params
    opt_state: OptState

    @classmethod
    def create(cls, model: nn.Module, cfg, tx: AdamW) -> "TrainState":
        """The optimizer's state of the trainable parameters (of each
        rank's local shards, after `parallel.sharding.shard_params`)."""
        trainable, frozen = split_params(model, cfg)
        if hasattr(model, "_shard_layouts"):
            tx.shard(model._shard_layouts, model._shard_groups)
        return cls(step=0, model=model, trainable=trainable, frozen=frozen,
                   opt_state=tx.init(local_params(trainable)))

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """{flax path: tensor} of every parameter, the trainable ones from
        their f32 masters where the optimizer keeps them (local shards
        under a mesh: `runtime.checkpoint.full_params` gathers them)."""
        master = getattr(self.opt_state, "master", None) or {}
        out = {k: local_tensor(p).detach() for k, p in self.frozen.items()}
        out.update({k: master.get(k, local_tensor(p)).detach()
                    for k, p in self.trainable.items()})
        return out



def local_params(params: Params) -> Dict[str, torch.Tensor]:
    return {k: local_tensor(p) for k, p in params.items()}


def embedding_grad_mask(cfg, device=None) -> torch.Tensor:
    """Row mask [V, 1] for the embedding gradient: only the <answer> row
    trains (`mask_embedding`, instruction_following.py:228-238)."""
    ids = [cfg.answer_token_id if cfg.answer_token_id is not None
           else cfg.eoc_token_id]
    mask = torch.zeros((cfg.text.total_vocab, 1), dtype=torch.float32,
                       device=device)
    mask[ids] = 1.0
    return mask


def _on_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
        out[k] = t.to(device, non_blocking=True)
    return out


def make_train_step(model: nn.Module, cfg, tx: AdamW, *,
                    mask_embedding: bool = False,
                    attend_previous: bool = True,
                    fused_ce_chunk: int = 0, mesh=None):
    """Returns step(state, batch) -> (state, metrics).

    batch: {vision_x [B,T,F,C,H,W], input_ids [B,S], attention_mask [B,S],
    labels [B,S]}, numpy or tensors. metrics: loss, tokens, grad_norm
    (0-d tensors on the model's device: reading them waits for the step).

    fused_ce_chunk > 0 routes the loss through `chunked_causal_lm_loss`
    (model forward with skip_head=True). The idefics model has no
    skip_head (its head is decoupled: the loss trains `additional_fc`
    through the concatenated logits), so it takes fused_ce_chunk=0, as in
    the JAX package, whose forward refuses the argument. Gradient
    checkpointing is the model's `remat`.

    mesh: the model's mesh (`parallel.sharding.shard_params`); the batch
    is this rank's rows (`parallel.mesh.shard_batch`). Self-attention
    runs as the ring where the "seq" axis is > 1; loss and tokens are the
    global batch's.
    """
    if fused_ce_chunk and hasattr(cfg, "additional_vocab_size"):
        raise ValueError("the idefics model has no fused cross-entropy "
                         "(no skip_head): pass fused_ce_chunk=0")
    tcfg = cfg.text
    device = next(model.parameters()).device
    emb_mask = embedding_grad_mask(cfg, device) if mask_embedding else None

    def loss_fn(batch):
        kw = dict(attention_mask=batch["attention_mask"],
                  attend_previous=attend_previous)
        if fused_ce_chunk:
            hidden, _, _ = model(batch["vision_x"], batch["input_ids"],
                                 skip_head=True, **kw)
            if hasattr(model, "unshard"):
                # fully_shard: the head is read outside the forward, as its
                # gathered tensor (whose gradient the backward reduces)
                model.unshard()
            head = model.lang_encoder.wte.embedding
            return chunked_causal_lm_loss(
                hidden, head, batch["labels"], tied=tcfg.tie_embeddings,
                logit_scale=tcfg.logit_scale, chunk=fused_ce_chunk)
        logits, _, _ = model(batch["vision_x"], batch["input_ids"], **kw)
        return causal_lm_loss(logits, batch["labels"])

    global_loss = GlobalLoss(mesh)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        batch = _on_device(batch, device)
        batch["input_ids"] = batch["input_ids"].long()
        for p in state.trainable.values():
            p.grad = None
        with global_loss.context():
            loss, n = loss_fn(batch)
        loss, report, n = global_loss(loss, batch["labels"], n)
        loss.backward()
        global_loss.sync_grads(state.trainable)
        grad_norm = apply_grads(state, tx, emb_mask)
        return state, {"loss": report, "tokens": n,
                       "grad_norm": grad_norm}

    return step


class GlobalLoss:
    """The mesh's part of a train step: the ring context, the loss as the
    mean over the global batch's tokens, and the gradient sum of the
    parameters `fully_shard` does not manage. Without a mesh, or at one
    data rank, the loss passes through."""

    def __init__(self, mesh):
        from torch.distributed.device_mesh import DeviceMesh
        from otter_tpu_torch.parallel.mesh import batch_sharding, data_group
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh "
                            f"(parallel.mesh.create_mesh), not {mesh!r}")
        self.mesh = mesh
        self.group = data_group(mesh)
        self.world = batch_sharding(mesh)[1]

    def context(self):
        import contextlib
        if self.mesh is None:
            return contextlib.nullcontext()
        from otter_tpu_torch.ops.attention import sequence_parallel
        return sequence_parallel(self.mesh)

    def __call__(self, loss, labels, n):
        """(loss to differentiate, loss to report, global tokens) from
        this rank's mean `loss` over its tokens. `fully_shard` averages
        gradients over the data ranks, so each rank's loss is its token sum
        over the global count, times their number."""
        if self.group is None:
            return loss, loss.detach(), n
        from otter_tpu_torch.parallel.collectives import all_reduce_sum
        n_local = (labels[:, 1:] != -100).sum().float()
        total = loss * n_local.clamp(min=1)
        n_global = all_reduce_sum(n_local, self.group).clamp(min=1)
        report = all_reduce_sum(total.detach(), self.group) / n_global
        return total / n_global * self.world, report, n_global

    def sync_grads(self, params: Params) -> None:
        """Average the gradients of the parameters outside `fully_shard`
        (whole on every rank) over the data ranks, as it averages its
        own."""
        if self.group is None:
            return
        from otter_tpu_torch.parallel.collectives import all_reduce_sum
        for p in params.values():
            if p.grad is not None and not hasattr(p.grad, "to_local"):
                p.grad = all_reduce_sum(p.grad, self.group) / self.world


def apply_grads(state: TrainState, tx, emb_mask=None) -> torch.Tensor:
    """The update after a backward pass: every trainable tensor's gradient
    (zeros where none reached it; with `emb_mask`, the embedding's rows
    outside it zeroed), `tx.update`, the gradients cleared and the step
    counted. Returns the gradients' global norm (before clipping)."""
    params = local_params(state.trainable)
    grads = {k: (local_tensor(p.grad) if p.grad is not None
                 else torch.zeros_like(params[k]))
             for k, p in state.trainable.items()}
    if emb_mask is not None:
        for k in grads:
            if k.endswith("wte/embedding"):
                grads[k] = grads[k] * emb_mask.to(grads[k].dtype)
    # (a stand-in for the optimizer without a mesh may have no norm_fn)
    grad_norm = getattr(tx, "norm_fn", _local_norm)(grads)
    tx.update(grads, state.opt_state, params)
    del grads
    for p in state.trainable.values():
        p.grad = None
    state.step += 1
    return grad_norm
