"""TF1 Adam and AdamW written leaf by leaf: the rule the port's multi-tensor
``Optimizer._adam`` must give bit for bit (each leaf's elementwise ops in
the same order), with adamw's per-leaf multipliers. Tests hold the port's
optimizer against it on the CPU and on the card."""

import torch

from fcn8s_tensorflow_tpu_torch import bridge
from fcn8s_tensorflow_tpu_torch.parallel import steps as S


class PerLeafAdam(S.Optimizer):
    """``make_optimizer(name, **hyper)``'s adam or adamw, its update a loop
    over the leaves (no clip)."""

    def __init__(self, name: str, **hyper):
        opt = S.make_optimizer(name, **hyper)
        super().__init__(opt.name, None, opt.hyper)

    @torch.no_grad()
    def update(self, params, grads, opt_state, learning_rate, lr_scale=None, *, mesh=None,
               tensor_parallel=False):
        b1, b2 = self.hyper.get("b1", 0.9), self.hyper.get("b2", 0.999)
        eps, wd = self.hyper.get("eps", 1e-8), self.hyper.get("weight_decay", 1e-4)
        state = opt_state.inner
        leaves = bridge.param_leaves(params)
        mults = self.multipliers(params) or [(1.0, 1.0)] * len(leaves)
        for p, g, m, v, (lm, dm) in zip(leaves, grads, state.mu, state.nu, mults):
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * (1 - b2) * g)
            u = (m * lr_scale) / (v.sqrt() + eps)
            if self.name == "adamw" and dm:
                u.add_(p * (wd * dm))
            lr = -learning_rate
            p.add_(u * (lr if lm == 1.0 else S._scaled_lr(lr, lm)))
