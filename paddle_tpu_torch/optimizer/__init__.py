"""paddle.optimizer: SGD, Momentum, Adam, AdamW, Adagrad, Adadelta,
Adamax, RMSProp, Lamb, Lars (LarsMomentum) and Ftrl, and the schedulers
in ``optimizer.lr``.

Port of paddle_tpu/optimizer/__init__.py with the reference's update rules
(operators/optimizers/*_op.h), each written once, as ``torch._foreach_*``
passes over a bucket of parameters (optimizer.py), in the op order of
the reference's per-parameter rule: Adam's bias correction folded into
the step, lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t) and
eps_t = eps * sqrt(1 - beta2^t), with f32 beta powers for every parameter
dtype; AdamW's decoupled decay applied to the weight (the master, with
multi_precision) before the Adam update, its learning rate scaled by
``lr_ratio(param)`` where given (Paddle's adamw op; the reference accepts
and ignores it, ROADMAP C-ref-12); Lamb's and Lars's per-parameter norms
from ``torch._foreach_norm``. Sparse gradients: SGD updates only the
gradient's rows, Adam and AdamW with ``lazy_mode`` update (and AdamW
decays) only the merged rows, every other case densifies. torch.optim is
not used: it has no master weights and places epsilon differently, which
rounds otherwise. Each optimizer keeps the reference's accumulator names,
so ``state_dict`` keys cross both ways.
"""
from __future__ import annotations

import torch

from ..core import selected_rows as sr
from . import lr
from .optimizer import Optimizer, _Bucket, _one_minus

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "Adadelta", "Adamax", "RMSProp", "Lamb", "Lars", "LarsMomentum",
           "Ftrl", "lr"]

_f = torch._foreach_mul


def _c(x, ts):
    """The Python scalar ``x`` as the lists' dtype holds it: rounded to
    bf16 (f16) for bf16 (f16) lists, as the reference's weak-typed
    scalars are. torch itself adds a scalar to a bf16 tensor in bf16 on
    the host and in f32 on the card; rounding it first makes both
    devices compute the same update."""
    dtype = ts[0].dtype
    if dtype in (torch.float32, torch.float64):
        return x
    return float(torch.tensor(x, dtype=dtype))


def _sq_scaled(xs, a):
    """[a * x * x], rounded as the reference's ``a * x * x``."""
    t = _f(xs, _c(a, xs))
    torch._foreach_mul_(t, xs)
    return t


def _ema_(accs, beta, xs, sq=False):
    """accs <- beta * accs + (1 - beta) * xs (or * xs * xs)."""
    torch._foreach_mul_(accs, _c(beta, accs))
    torch._foreach_add_(accs, _sq_scaled(xs, 1 - beta) if sq
                        else _f(xs, _c(1 - beta, xs)))


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _update(self, b):
        torch._foreach_sub_(b.work, _f(b.grads, self._lr_as(b.dtype)))

    def _apply_sparse_update(self, p, g):
        # sgd_op.h's SelectedRows kernel: only the gradient's rows move,
        # duplicates accumulating
        p.index_add_(0, sr.rows(g),
                     sr.value(g).to(p.dtype) * -self._lr_as(p.dtype))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._use_nesterov = use_nesterov
        self._multi_precision = multi_precision

    def _update(self, b):
        vel = self._accs("velocity", b)
        lr_ = self._lr_as(b.dtype)
        mom = _c(self._momentum, vel)
        torch._foreach_mul_(vel, mom)
        torch._foreach_add_(vel, b.grads)
        if self._use_nesterov:
            step = _f(vel, mom)
            torch._foreach_add_(step, b.grads)
            torch._foreach_mul_(step, lr_)
        else:
            step = _f(vel, lr_)
        torch._foreach_sub_(b.work, step)
        self._store(b)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lazy_mode = lazy_mode
        self._multi_precision = multi_precision

    def _lrs(self, params):
        """Each parameter's learning rate (None: the lr tensor for all)."""
        return None

    def _update(self, b):
        self._adam(b.work, b.grads, self._accs("moment1", b),
                   self._accs("moment2", b), self._beta_pows("beta1_pow", b),
                   self._beta_pows("beta2_pow", b), self._lrs(b.params))
        self._store(b)

    def _adam(self, work, grads, m, v, b1p, b2p, lrs):
        """The Adam rule over lists; beta powers and bias corrections in
        f32 for every parameter dtype (bf16 rounds beta2 = 0.999 to 1.0
        and 1 - beta2^t to 0)."""
        dtype = work[0].dtype
        torch._foreach_mul_(b1p, self._beta1)
        torch._foreach_mul_(b2p, self._beta2)
        _ema_(m, self._beta1, grads)
        _ema_(v, self._beta2, grads, sq=True)
        # adam_op.h: lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t),
        # update = lr_t * m / (sqrt(v) + eps * sqrt(1 - beta2^t))
        root = torch._foreach_sqrt(_one_minus(b2p))
        lr_t = _f(root, self._lr if lrs is None else lrs)
        torch._foreach_div_(lr_t, _one_minus(b1p))
        eps_t = _f(root, self._epsilon)
        if dtype != torch.float32:
            lr_t = [t.to(dtype) for t in lr_t]
            eps_t = [t.to(dtype) for t in eps_t]
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, eps_t)
        step = torch._foreach_div(m, denom)
        torch._foreach_mul_(step, lr_t)
        torch._foreach_sub_(work, step)

    def _apply_sparse_update(self, p, g):
        """adam_op.h's lazy_mode: the moments decay and the parameter
        moves only at the merged gradient's rows; without lazy_mode (or
        under multi_precision) the dense rule."""
        if not self._lazy_mode or self._mp_active(p):
            return super()._apply_sparse_update(p, g)
        g = sr.merge(g)
        rows = sr.rows(g)
        self._lazy_rows(p, rows, [p[rows]], [sr.value(g).to(p.dtype)])

    def _lazy_rows(self, p, rows, w_rows, g_rows):
        """The Adam rule on the gathered rows ``w_rows`` of ``p``, written
        back with the moments' rows."""
        b = _Bucket([p], g_rows)
        m, v = self._accs("moment1", b)[0], self._accs("moment2", b)[0]
        m_rows, v_rows = [m[rows]], [v[rows]]
        self._adam(w_rows, g_rows, m_rows, v_rows,
                   self._beta_pows("beta1_pow", b),
                   self._beta_pows("beta2_pow", b), self._lrs([p]))
        m.index_copy_(0, rows, m_rows[0])
        v.index_copy_(0, rows, v_rows[0])
        p.index_copy_(0, rows, w_rows[0])


class AdamW(Adam):
    """Decoupled weight decay: the weight (the f32 master with
    multi_precision) is scaled by 1 - lr * coeff before the Adam update,
    for the parameters ``apply_decay_param_fun(name)`` selects (all when it
    is None). ``lr_ratio(param)`` scales the learning rate of both, per
    parameter, as Paddle's adamw op does (ROADMAP C-ref-12)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode=lazy_mode,
                         multi_precision=multi_precision)
        self._coeff = float(weight_decay) if weight_decay is not None \
            else 0.0
        self._lr_ratio = lr_ratio
        self._apply_decay_param_fun = apply_decay_param_fun

    def _lrs(self, params):
        if self._lr_ratio is None:
            return None
        return [self._lr * float(self._lr_ratio(p)) for p in params]

    def _decay(self, params, work):
        """work <- work * (1 - lr * coeff) for the selected parameters."""
        if not self._coeff:
            return
        pick = [i for i, p in enumerate(params)
                if self._apply_decay_param_fun is None
                or self._apply_decay_param_fun(getattr(p, "name", None))]
        if not pick:
            return
        dtype = work[0].dtype
        lrs = self._lrs([params[i] for i in pick])
        if lrs is None:
            factor = 1.0 - self._lr_as(dtype) * self._coeff
            torch._foreach_mul_([work[i] for i in pick], factor)
        else:
            factors = [1.0 - t.to(dtype) * self._coeff for t in lrs]
            torch._foreach_mul_([work[i] for i in pick], factors)

    def _update(self, b):
        self._decay(b.params, b.work)
        super()._update(b)

    def _apply_sparse_update(self, p, g):
        if not self._lazy_mode or self._mp_active(p):
            # under multi_precision the dense rule decays the master
            return Optimizer._apply_sparse_update(self, p, g)
        # lazy decoupled decay: only the merged rows decay
        g = sr.merge(g)
        rows = sr.rows(g)
        w_rows = [p[rows]]
        self._decay([p], w_rows)
        self._lazy_rows(p, rows, w_rows, [sr.value(g).to(p.dtype)])


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _update(self, b):
        acc = self._accs("moment", b, init=self._init_acc)
        torch._foreach_add_(acc, _f(b.grads, b.grads))
        denom = torch._foreach_sqrt(acc)
        torch._foreach_add_(denom, _c(self._epsilon, denom))
        step = _f(b.grads, self._lr_as(b.dtype))
        torch._foreach_div_(step, denom)
        torch._foreach_sub_(b.work, step)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._rho = rho

    def _update(self, b):
        avg_sq = self._accs("avg_squared_grad", b)
        avg_upd = self._accs("avg_squared_update", b)
        rho, eps = self._rho, _c(self._epsilon, b.work)
        _ema_(avg_sq, rho, b.grads, sq=True)
        # update = -sqrt((avg_upd + eps) / (avg_sq + eps)) * g
        update = torch._foreach_add(avg_upd, eps)
        torch._foreach_div_(update, torch._foreach_add(avg_sq, eps))
        torch._foreach_sqrt_(update)
        torch._foreach_neg_(update)
        torch._foreach_mul_(update, b.grads)
        _ema_(avg_upd, rho, update, sq=True)
        torch._foreach_mul_(update, self._lr_as(b.dtype))
        torch._foreach_add_(b.work, update)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _update(self, b):
        m = self._accs("moment", b)
        inf_norm = self._accs("inf_norm", b)
        b1p = self._beta_pows("beta1_pow", b)
        torch._foreach_mul_(b1p, self._beta1)
        _ema_(m, self._beta1, b.grads)
        # inf_norm = max(beta2 * inf_norm, |g| + eps)
        torch._foreach_mul_(inf_norm, _c(self._beta2, inf_norm))
        bound = torch._foreach_abs(b.grads)
        torch._foreach_add_(bound, _c(self._epsilon, bound))
        torch._foreach_maximum_(inf_norm, bound)
        # p -= (lr / (1 - beta1^t)) * m / inf_norm
        lr_t = torch._foreach_div([self._lr] * len(b1p), _one_minus(b1p))
        if b.dtype != torch.float32:
            lr_t = [t.to(b.dtype) for t in lr_t]
        step = _f(m, lr_t)
        torch._foreach_div_(step, inf_norm)
        torch._foreach_sub_(b.work, step)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _update(self, b):
        ms = self._accs("mean_square", b)
        mom = self._accs("momentum", b)
        rho, eps = self._rho, _c(self._epsilon, ms)
        _ema_(ms, rho, b.grads, sq=True)
        if self._centered:
            mg = self._accs("mean_grad", b)
            _ema_(mg, rho, b.grads)
            # sqrt(ms - mg * mg + eps)
            denom = torch._foreach_sub(ms, _f(mg, mg))
        else:
            denom = list(ms)
        denom = torch._foreach_add(denom, eps)
        torch._foreach_sqrt_(denom)
        # mom = momentum * mom + lr * g / denom; p -= mom
        step = _f(b.grads, self._lr_as(b.dtype))
        torch._foreach_div_(step, denom)
        torch._foreach_mul_(mom, _c(self._momentum, mom))
        torch._foreach_add_(mom, step)
        torch._foreach_sub_(b.work, mom)


class Lamb(Optimizer):
    """Adam's moments, f32, bias-corrected; the update r + wd * p (wd 0 for
    the parameters ``exclude_from_weight_decay_fn(param)`` picks) scaled by
    the trust ratio ||p|| / ||update|| (1 where either norm is 0)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-06, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update(self, b):
        m = self._accs("moment1", b, f32=True)
        v = self._accs("moment2", b, f32=True)
        b1p = self._beta_pows("beta1_pow", b)
        b2p = self._beta_pows("beta2_pow", b)
        f32 = b.dtype == torch.float32
        pv = b.work if f32 else [p.float() for p in b.work]
        g = b.grads if f32 else [t.float() for t in b.grads]
        torch._foreach_mul_(b1p, self._beta1)
        torch._foreach_mul_(b2p, self._beta2)
        _ema_(m, self._beta1, g)
        _ema_(v, self._beta2, g, sq=True)
        # r = m_hat / (sqrt(v_hat) + eps)
        update = torch._foreach_div(m, _one_minus(b1p))
        denom = torch._foreach_div(v, _one_minus(b2p))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        torch._foreach_div_(update, denom)
        decay = [i for i, p in enumerate(b.params)
                 if self._lamb_wd and not (self._exclude_fn is not None
                                           and self._exclude_fn(p))]
        if decay:
            torch._foreach_add_([update[i] for i in decay],
                                _f([pv[i] for i in decay], self._lamb_wd))
        w_norm = torch.stack(torch._foreach_norm(pv))
        u_norm = torch.stack(torch._foreach_norm(update))
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            1.0)
        torch._foreach_mul_(update, (self._lr * trust).unbind(0))
        torch._foreach_sub_(pv, update)
        if not f32:
            torch._foreach_copy_(b.work, pv)


class Lars(Optimizer):
    """LARS momentum (reference operators/optimizers/lars_momentum_op.cc):
    the layer-wise local learning rate
    lr * coeff * ||p|| / (||g|| + wd * ||p|| + eps) (lr where either norm
    is 0), wd 0 for parameters whose name contains an entry of
    ``exclude_from_weight_decay``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, weight_decay=None,
                 grad_clip=None, epsilon=1e-9, exclude_from_weight_decay=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._epsilon = epsilon
        self._exclude = list(exclude_from_weight_decay or [])
        self._wd_cache = {}

    def _weight_decays(self, params, device):
        """Each parameter's LARS weight decay as one f32 vector on the
        device, made once per parameter list (eagerly, in a captured
        step's discovery pass: the capture may not copy from the host)."""
        key = (device, tuple(id(p) for p in params))
        wd = self._wd_cache.get(key)
        if wd is None:
            wd = torch.tensor(
                [0.0 if any(s in (getattr(p, "name", None) or "")
                            for s in self._exclude) else self._lars_wd
                 for p in params], dtype=torch.float32, device=device)
            self._wd_cache[key] = wd
        return wd

    def _update(self, b):
        vel = self._accs("velocity", b)
        f32 = b.dtype == torch.float32
        pf = b.work if f32 else [p.float() for p in b.work]
        gf = b.grads if f32 else [t.float() for t in b.grads]
        wd = self._weight_decays(b.params, pf[0].device)
        p_norm = torch.stack(torch._foreach_norm(pf))
        g_norm = torch.stack(torch._foreach_norm(gf))
        local_lr = torch.where(
            (p_norm > 0) & (g_norm > 0),
            self._lr * self._lars_coeff * p_norm
            / (g_norm + wd * p_norm + self._epsilon), self._lr)
        # v = momentum * v + local_lr * (g + wd * p); p -= v
        step = _f(pf, wd.unbind(0))
        torch._foreach_add_(step, gf)
        torch._foreach_mul_(step, local_lr.unbind(0))
        vf = vel if f32 else [t.float() for t in vel]
        torch._foreach_mul_(vf, self._momentum)
        torch._foreach_add_(vf, step)
        torch._foreach_sub_(pf, vf)
        if not f32:
            torch._foreach_copy_(vel, vf)
            torch._foreach_copy_(b.work, pf)


LarsMomentum = Lars


class Ftrl(Optimizer):
    """FTRL-proximal (reference operators/optimizers/ftrl_op.h): the
    per-coordinate adaptive update with L1/L2 shrinkage over the
    accumulators ``squared`` (n) and ``linear`` (z)."""

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _update(self, b):
        sq = self._accs("squared", b)
        lin = self._accs("linear", b)
        f32 = b.dtype == torch.float32
        pf = b.work if f32 else [p.float() for p in b.work]
        gf = b.grads if f32 else [t.float() for t in b.grads]
        nf = sq if f32 else [t.float() for t in sq]
        zf = lin if f32 else [t.float() for t in lin]
        new_n = torch._foreach_add(nf, _f(gf, gf))
        if self._lr_power == -0.5:
            new_root, old_root = (torch._foreach_sqrt(new_n),
                                  torch._foreach_sqrt(nf))
        else:
            new_root, old_root = (torch._foreach_pow(new_n, -self._lr_power),
                                  torch._foreach_pow(nf, -self._lr_power))
        # sigma = (n_new^-lp - n^-lp) / lr; y = n_new^-lp / lr + 2 * l2
        sigma = torch._foreach_sub(new_root, old_root)
        torch._foreach_div_(sigma, self._lr)
        y = torch._foreach_div(new_root, self._lr)
        torch._foreach_add_(y, 2.0 * self._l2)
        # z += g - sigma * p
        torch._foreach_add_(zf, gf)
        torch._foreach_sub_(zf, _f(sigma, pf))
        # p = (l1 * sign(z) - z) / y where |z| > l1, else 0
        pre = torch._foreach_sign(zf)
        torch._foreach_mul_(pre, self._l1)
        torch._foreach_sub_(pre, zf)
        torch._foreach_div_(pre, y)
        keep = torch._foreach_abs(zf)
        torch._foreach_sub_(keep, self._l1)
        torch._foreach_sign_(keep)
        torch._foreach_clamp_min_(keep, 0.0)
        torch._foreach_mul_(pre, keep)
        torch._foreach_copy_(b.work, pre)
        torch._foreach_copy_(sq, new_n)
        if not f32:
            torch._foreach_copy_(lin, zf)
