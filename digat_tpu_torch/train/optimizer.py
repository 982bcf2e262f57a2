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
place."""

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
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.names, self.params = zip(*[(n, p) for n, p in named_parameters if p.requires_grad])
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
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
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

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for name, mu, nu in zip(self.names, self.mu, self.nu):
            mu.copy_(state["mu"][name])
            nu.copy_(state["nu"][name])
