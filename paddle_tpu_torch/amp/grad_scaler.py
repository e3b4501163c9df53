"""GradScaler (port of paddle_tpu/amp/grad_scaler.py).

Dynamic loss scaling with the reference's bookkeeping
(update_loss_scaling_op.cc): the scale, ``found_inf`` and the good/bad
step counters are tensors that stay on the device of the first loss the
scaler scales, and every decision is a ``torch.where`` on them, never a
host branch, so a step that uses the scaler can be captured as a CUDA
graph. A step with a non-finite grad is skipped the reference's way:
every parameter and accumulator is snapshotted, the optimizer steps, and
each is then selected back where ``found_inf`` is set, including the
accumulators created by that same step (reset to their initial values;
a new f32 master to its restored parameter). ``enable=False`` makes every
method a passthrough.

Under fleet's tensor parallelism and ZeRO-1 each rank checks only its
shard of the gradients, where the reference's one controller checks them
all. Such an optimizer names the group its ranks span
(``_found_inf_group``), and ``found_inf`` is reduced over it with MAX, so
every rank skips the step, and moves its scale, together. A skipped step
then restores every trainable parameter, not only the ones this rank
updated: ZeRO-1's broadcast of the others has run inside the step.
"""
from __future__ import annotations

import torch

__all__ = ["AmpScaler", "GradScaler"]


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = torch.tensor(float(init_loss_scaling),
                                   dtype=torch.float32)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._use_dynamic = use_dynamic_loss_scaling
        self._good_steps = torch.tensor(0, dtype=torch.int32)
        self._bad_steps = torch.tensor(0, dtype=torch.int32)
        self._found_inf = torch.tensor(False)
        self._unscaled_opts = set()  # ids of optimizers already unscaled

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._use_dynamic

    def _to(self, device):
        """Move the scaler's state to ``device`` once, before its first
        use there (a captured step then reads it in place)."""
        if self._scale.device != device:
            self._scale, self._good_steps, self._bad_steps, \
                self._found_inf = (t.to(device) for t in (
                    self._scale, self._good_steps, self._bad_steps,
                    self._found_inf))

    def scale(self, var):
        if not self._enable:
            return var
        self._to(var.device)
        return var * self._scale.to(var.dtype)

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide the grads by the scale in place and set ``found_inf``
        where any of them is not finite."""
        if not self._enable or id(optimizer) in self._unscaled_opts:
            return
        self._unscaled_opts.add(id(optimizer))
        grads = [g for _, g in optimizer._collect_params_grads()
                 if g is not None]
        group = getattr(optimizer, "_found_inf_group", None)
        if not grads and group is None:
            return
        if grads:
            self._to(grads[0].device)
        inv = 1.0 / self._scale
        found = torch.zeros((), dtype=torch.bool, device=inv.device)
        for g in grads:
            g.mul_(inv.to(g.dtype))
            found = found | ~torch.isfinite(g).all()
        if group is not None:
            # every rank of the group takes the same decision
            from ..distributed.collective import ReduceOp, all_reduce
            flag = found.to(torch.float32).reshape(1)
            all_reduce(flag, op=ReduceOp.MAX, group=group)
            found = flag[0] > 0
        self._found_inf.copy_(found)

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()
        optimizer.clear_grad()

    @torch.no_grad()
    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        self._unscaled_opts.discard(id(optimizer))
        found = self._found_inf
        params = [p for p in optimizer._parameter_list or ()
                  if p.requires_grad]
        state = params + [t for by_param in optimizer._accumulators.values()
                          for t in by_param.values()]
        snapshot = [(t, t.detach().clone()) for t in state]
        optimizer.step()
        for t, old in snapshot:
            t.copy_(torch.where(found, old, t))
        # accumulators created during this step were not in the snapshot
        seen = {id(t) for t in state}
        params_by_id = {id(p): p for p in params}
        for name, by_param in optimizer._accumulators.items():
            init = optimizer._acc_inits.get(name, 0.0)
            for pid, t in by_param.items():
                if id(t) in seen:
                    continue
                if name == "master_weight" and pid in params_by_id:
                    # made from the parameter, which is rolled back already
                    restore = params_by_id[pid].to(t.dtype)
                else:
                    restore = torch.full_like(t, init)
                t.copy_(torch.where(found, restore, t))

    @torch.no_grad()
    def update(self):
        if not (self._enable and self._use_dynamic):
            return
        found = self._found_inf
        good = torch.where(found, 0, self._good_steps + 1)
        bad = torch.where(found, self._bad_steps + 1, 0)
        decr = bad >= self._decr_every_n_nan_or_inf
        scale = torch.where(
            decr, torch.clamp(self._scale * self._decr_ratio, min=1.0),
            self._scale)
        bad = torch.where(decr, 0, bad)
        incr = good >= self._incr_every_n_steps
        scale = torch.where(incr, scale * self._incr_ratio, scale)
        good = torch.where(incr, 0, good)
        self._good_steps.copy_(good)
        self._bad_steps.copy_(bad)
        self._scale.copy_(scale)

    def get_loss_scaling(self):
        return self._scale.clone()

    def set_init_loss_scaling(self, v):
        self._scale.fill_(float(v))

    def state_dict(self):
        return {"scale": self._scale.clone(),
                "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n_steps,
                "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
                "good_steps": self._good_steps.clone(),
                "bad_steps": self._bad_steps.clone()}

    def load_state_dict(self, sd):
        """Copies into the scaler's tensors in place."""
        for name in ("scale", "good_steps", "bad_steps"):
            dst = getattr(self, f"_{name}")
            dst.copy_(torch.as_tensor(sd[name]).to(dst.dtype))


class GradScaler(AmpScaler):
    """paddle.amp.GradScaler."""
