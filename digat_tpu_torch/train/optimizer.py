"""Optimizer: Adam with L2 weight decay off for some groups, after a clip
by global norm.

Counterpart of `digat_tpu.train.optimizer` (`make_optimizer`, the chain of
`optax.clip_by_global_norm`, a masked `optax.add_decayed_weights` and
`optax.scale_by_adam(0.9, 0.999, eps=1e-8)`, and `lr_at_epoch`), with the
same arithmetic in the same order:

  * clip by global norm first: a gradient whose norm n is at least
    max_norm becomes (g / n) * max_norm (optax); `torch_compat_clip`
    scales by min(max_norm / (n + 1e-6), 1) instead, as
    `torch.nn.utils.clip_grad_norm_` does;
  * then weight decay into the gradient (torch Adam's L2, not AdamW),
    masked off for parameters whose name holds `bias`, `embed` or
    `graph_encoder`;
  * then Adam with bias correction, and params -= lr * update, the
    learning rate given per step.

The moments live beside the parameters, in their dtype and on their
device. The update runs under no_grad and changes the parameters in
place.

`shards` names the parameters that are one rank's rows of a row-sharded
table (`parallel.sharded_table.tables(model)`): their moments are the
rows' alone, their squared sums enter the clip norm through one sum over
the model group (the replicated parameters' squares are taken once), and
`state_dict` / `load_state_dict` gather and slice their moments, so a
state holds the whole table's, whatever the grid."""

from __future__ import annotations

import torch

NO_DECAY_SUBSTRINGS = ("bias", "embed", "graph_encoder")


def decays(name: str) -> bool:
    """Whether weight decay applies to the parameter `name`."""
    return not any(s in name.lower() for s in NO_DECAY_SUBSTRINGS)


def lr_at_epoch(base_lr: float, epoch: int, lr_decay_epoch: int) -> float:
    """lr/10 from the decay epoch on (1-indexed epochs)."""
    return base_lr / 10.0 if epoch >= lr_decay_epoch else base_lr


class Adam:
    def __init__(self, named_parameters, weight_decay: float = 0.0,
                 gradient_clip_norm: float = 1.0, torch_compat_clip: bool = False,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, shards=None):
        self.names, self.params = zip(*[(n, p) for n, p in named_parameters if p.requires_grad])
        self.shards = dict(shards or {})
        if set(self.shards) - set(self.names):
            raise ValueError(f"shards {sorted(set(self.shards) - set(self.names))} are not "
                             "parameters")
        self.weight_decay = weight_decay
        self.gradient_clip_norm = gradient_clip_norm
        self.torch_compat_clip = torch_compat_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, lr: float) -> None:
        """One update from the parameters' `.grad` (None counts as 0)."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        max_norm = self.gradient_clip_norm
        if max_norm > 0:
            norm = torch.sqrt(self._squared_sum(grads))
            if self.torch_compat_clip:
                coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
                grads = [g * coef for g in grads]
            else:
                keep = norm < max_norm
                grads = [torch.where(keep, g, (g / norm) * max_norm) for g in grads]
        if self.weight_decay > 0:
            grads = [g + self.weight_decay * p if decays(n) else g
                     for n, p, g in zip(self.names, self.params, grads)]
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * (g * g) + self.b2 * nu)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.add_(-lr * update)

    def _squared_sum(self, grads):
        """The squared global norm: every gradient's squares, the shards'
        summed over their model group."""
        if not self.shards:
            return sum((g * g).sum() for g in grads)
        whole = [(g * g).sum() for n, g in zip(self.names, grads) if n not in self.shards]
        rows = torch.stack([(g * g).sum() for n, g in zip(self.names, grads)
                            if n in self.shards]).sum().reshape(1)
        table = next(iter(self.shards.values()))
        table.dist.all_reduce_sum_([rows], group=table.dist.model_group)
        return sum(whole) + rows[0]

    def state_dict(self) -> dict:
        """count and the moments by name; a shard's moments gathered whole
        (a collective over its model group)."""
        def whole(name, t):
            return self.shards[name].gather(t) if name in self.shards else t

        return {"count": self.count,
                "mu": {n: whole(n, t) for n, t in zip(self.names, self.mu)},
                "nu": {n: whole(n, t) for n, t in zip(self.names, self.nu)}}

    def load_state_dict(self, state: dict) -> None:
        """A state of any grid: a shard takes its rows of the whole
        moments."""
        def own(name, t):
            return self.shards[name].own_rows(t) if name in self.shards else t

        self.count = int(state["count"])
        for name, mu, nu in zip(self.names, self.mu, self.nu):
            mu.copy_(own(name, state["mu"][name]))
            nu.copy_(own(name, state["nu"][name]))
