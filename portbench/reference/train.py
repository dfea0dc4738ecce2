"""A flow-matching training step in float32: the loss, its gradients,
global-norm clipping and optax's AdamW.

Loss of a batch of normalized latents x with noise n and times t (B,):
rows whose caption is dropped see a zero context with every row real;
z_t = (1 - t) x + t n; the target is x - n; the loss is the mean over the
batch of each row's mean squared error over every latent value.

The update (optax.chain(clip_by_global_norm(c), adamw(lr, b1, b2, eps,
wd))): g <- g min(1, c / |g|) (no epsilon; |g| over every leaf), mu <- b1
mu + (1 - b1) g, nu <- b2 nu + (1 - b2) g^2, p <- p - lr (mu / (1 - b1^n)
/ (sqrt(nu / (1 - b2^n)) + eps) + wd p) at update n = 1, 2, ...
"""

from __future__ import annotations

import torch


def loss(model, latents, context, mask, drop, t, noise):
    context = torch.where(drop[:, None, None], torch.zeros_like(context), context)
    mask = mask | drop[:, None]
    tt = t.float()[:, None, None, None]
    x = latents.float()
    z_t = (1.0 - tt) * x + tt * noise.float()
    pred = model(z_t, context.float(), mask, t.float())
    return ((pred - (x - noise.float())) ** 2).mean(dim=(1, 2, 3)).mean()


class AdamW:
    def __init__(self, params: dict, lr: float, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.01, max_grad_norm=1.0):
        self.params = params
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.max_norm = weight_decay, max_grad_norm
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Apply one update; returns each leaf's clipped gradient norm."""
        norm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads.values())).float()
        factor = torch.clamp(self.max_norm / norm, max=1.0)
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        norms = {}
        for k, p in self.params.items():
            g = grads[k] * factor
            norms[k] = float(g.norm())
            self.mu[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (self.mu[k] / bc1) / ((self.nu[k] / bc2).sqrt() + self.eps)
            p.sub_(self.lr * (upd + self.wd * p))
        return norms
