"""paddle.Model: fit, evaluate and predict (port of
paddle_tpu/hapi/model.py).

One path, as in the reference: eager semantics with the train step
compiled. ``train_batch`` runs the step (forward, loss, backward,
optimizer update) through ``jit.compiled_step.CompiledTrainStep``, which
captures it as a CUDA graph per input signature on the card
(``FLAGS_compiled_step=0`` runs it eagerly, through a plain
``StaticFunction``). ``fit(steps_per_execution=K)`` hands K batches,
stacked on the card, to the step's ``run_steps``. A batch moves to the
network's device before the step reads it: in ``fit`` the input
prefetcher (hapi/prefetch.py) stages it from pinned memory on a side
stream; elsewhere ``_as_tensor`` copies it. A ragged last batch is a new
signature and gets its own capture, under
``FLAGS_compiled_step_max_retraces``.

``prepare`` accepts ``amp_configs`` and does not read it, as the
reference does (ROADMAP C-ref-7). At world size > 1 ``prepare`` wraps
the network in ``DataParallel``, as the reference does, and the loaders
take this rank's shard (``DistributedBatchSampler``); such a step runs
eagerly, since its collectives cannot be captured in a CUDA graph
(``DataParallel.captures``).

``prepare(spec_layout=...)`` takes a ``distributed.SpecLayout`` over the
current mesh: its ``shard_params`` shards the network's parameters
(ZeRO-3, distributed/spec_layout.py), and every batch of ``train_batch``
and every ``run_steps`` group is cut to this data rank's slice at the
host-to-device seam (``shard_batch``, ``shard_stacked_batch``), the
loaders handing every rank the whole batch, as the reference's single
controller sees it; the loss is averaged over the data ranks, the
reference's one logical loss. At world size > 1 the network's
``DataParallel`` Reducer then averages over the data group only (none
where the data axis has degree 1): a shard's gradient is averaged over
its fsdp group by its own backward. Such a step runs eagerly, as a
data-parallel one does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.io_utils import tensor_from_numpy
from ..io import DataLoader
from ..jit.to_static import StaticFunction
from ..metric import Metric
from ..metric import _np as _host
from ..profiler import steptimer as _steptimer

__all__ = ["Model"]

def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _network_device(network):
    for t in network.parameters():
        return t.device
    for t in network.buffers():
        return t.device
    return torch.device("cpu")


def _as_tensor(x, device):
    """One batch leaf as a tensor on ``device`` (a copy if it lies
    elsewhere)."""
    if not isinstance(x, torch.Tensor):
        x = tensor_from_numpy(np.asarray(x))
    return x if x.device == device else x.to(device)


def _batch_sig(b):
    """Shape signature of one (inputs, labels) pair: a group of steps run
    together must share it."""
    ins, labs = b
    leaves = _to_list(ins) + _to_list(labs)

    def one(x):
        if not hasattr(x, "shape"):
            x = np.asarray(x)
        return (tuple(x.shape), str(getattr(x, "dtype", "")))
    return tuple(one(x) for x in leaves)


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False
        self._compiled_train_step = None
        self._step_guard = None  # set by fit() under FLAGS_check_nan_inf
        self._spec_layout = None  # set by prepare(spec_layout=...)

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, spec_layout=None):
        """Set the optimizer, the loss (a layer or a function of the
        outputs and labels) and the metrics. ``amp_configs`` is accepted
        and not read, as in the reference. ``spec_layout``: a SpecLayout
        (module docstring)."""
        from ..distributed import env as _dist_env
        from ..distributed.parallel import DataParallel
        wrap, group = _dist_env.get_world_size() > 1, None
        if spec_layout is not None:
            from ..distributed.mesh import get_mesh
            from ..distributed.spec_layout import SpecLayout, shard_params
            if not isinstance(spec_layout, SpecLayout):
                raise TypeError(f"spec_layout must be a "
                                f"distributed.SpecLayout, got "
                                f"{type(spec_layout).__name__}")
            self._spec_layout = spec_layout
            shard_params(self.network, spec_layout)
            mesh = get_mesh()
            axis = spec_layout.data_axis
            wrap = wrap and mesh.shape.get(axis, 1) > 1
            group = mesh.group(axis) if wrap else None
        if wrap and not isinstance(self.network, DataParallel):
            self.network = DataParallel(self.network, group=group)
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            assert isinstance(m, Metric)
        return self

    @property
    def _device(self):
        return _network_device(self.network)

    def _captures(self):
        """Whether the step may be captured: not while it communicates."""
        from ..distributed import env as _dist_env
        if self._spec_layout is not None and \
                _dist_env.get_world_size() > 1:
            return False
        return getattr(self.network, "captures", True)

    def _data_slice(self, tensors, stacked=False):
        """This data rank's slice of each tensor's batch dim under the
        layout (dim 1 of a stacked group); the tensors without one."""
        if self._spec_layout is None or not tensors:
            return tensors
        from ..distributed import spec_layout as _sl
        fn = _sl.shard_stacked_batch if stacked else _sl.shard_batch
        out = fn(self._spec_layout, *tensors)
        return [out] if len(tensors) == 1 else list(out)

    def _global_loss(self, loss):
        """The loss averaged over the layout's data ranks (the reference's
        one logical loss); the loss itself without a layout."""
        if self._spec_layout is None:
            return loss
        from ..distributed.collective import ReduceOp, all_reduce
        from ..distributed.mesh import get_mesh
        mesh, axis = get_mesh(), self._spec_layout.data_axis
        if mesh.shape.get(axis, 1) <= 1:
            return loss
        return all_reduce(loss.detach().clone(), op=ReduceOp.AVG,
                          group=mesh.group(axis))

    # -- single-batch entry points ---------------------------------------
    def _build_train_step(self):
        def _step(ins, labs):
            outs = self.network(*ins)
            losses = _to_list(self._loss(*(_to_list(outs) + labs)))
            total = losses[0]
            for extra in losses[1:]:
                total = total + extra
            total.backward()
            self._optimizer.step()
            self._optimizer.clear_grad()
            return total
        from ..jit.compiled_step import CompiledTrainStep, \
            compiled_step_enabled
        if compiled_step_enabled() and self._captures():
            self._compiled_train_step = CompiledTrainStep(
                _step, label="hapi.train_step")
        else:
            self._compiled_train_step = StaticFunction(_step)
            # a data-parallel or sharded step's collectives run eagerly
            self._compiled_train_step._enabled = self._captures()

    def train_batch(self, inputs, labels=None, update=True):
        """One optimizer step on one batch; returns [loss]."""
        self.network.train()
        if self._compiled_train_step is None:
            self._build_train_step()
        st = _steptimer.get_steptimer()
        device = self._device
        with st.phase("step/h2d"):
            ins = self._data_slice([_as_tensor(i, device)
                                    for i in _to_list(inputs)])
            labs = self._data_slice([_as_tensor(lab, device)
                                     for lab in _to_list(labels)])
        with st.phase("step/compute"):
            loss = self._global_loss(self._compiled_train_step(ins, labs))
            st.sync(loss)
        # the scalar is read outside the compute phase: .item() waits for
        # the card, which would charge the phase with execution time
        return [float(loss.item())]

    def _train_steps(self, batches):
        """len(batches) optimizer steps in one ``run_steps`` call of the
        compiled step, the batches stacked on the device. batches: a list
        of (inputs, labels). Returns one [loss] per step."""
        self.network.train()
        head = []
        if self._compiled_train_step is None:
            # build the step train_batch uses; its loss is step 0
            head = [self.train_batch(*batches[0])]
            batches = batches[1:]
            if not batches:
                return head
        device = self._device
        st = _steptimer.get_steptimer()
        with st.phase("step/h2d"):
            pairs = [([_as_tensor(i, device) for i in _to_list(ins)],
                      [_as_tensor(lab, device) for lab in _to_list(labs)])
                     for ins, labs in batches]
            ins_stacked = [torch.stack([p[0][j] for p in pairs])
                           for j in range(len(pairs[0][0]))]
            labs_stacked = [torch.stack([p[1][j] for p in pairs])
                            for j in range(len(pairs[0][1]))]
            ins_stacked = self._data_slice(ins_stacked, stacked=True)
            labs_stacked = self._data_slice(labs_stacked, stacked=True)
        with st.phase("step/compute"):
            losses = self._global_loss(self._compiled_train_step.run_steps(
                ins_stacked, labs_stacked))
            st.sync(losses)
        return head + [[float(v)]
                       for v in losses.detach().float().cpu().reshape(-1)]

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        device = self._device
        ins = [_as_tensor(i, device) for i in _to_list(inputs)]
        labs = [_as_tensor(lab, device) for lab in _to_list(labels)]
        with torch.no_grad():
            outs = _to_list(self.network(*ins))
            loss_vals = []
            if self._loss is not None:
                losses = _to_list(self._loss(*(outs + labs)))
                loss_vals = [float(loss.item()) for loss in losses]
            metric_results = []
            for m in self._metrics:
                res = m.compute(*(outs + labs))
                m.update(*_to_list(res))
                metric_results.append(m.accumulate())
        return loss_vals, metric_results

    def predict_batch(self, inputs):
        self.network.eval()
        device = self._device
        ins = [_as_tensor(i, device) for i in _to_list(inputs)]
        with torch.no_grad():
            outs = self.network(*ins)
        return [_host(o) for o in _to_list(outs)]

    # -- loops ------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None,
            steps_per_execution=1):
        """The training loop. ``steps_per_execution=K`` runs K optimizer
        steps per ``run_steps`` call of the compiled step; callbacks still
        fire once per step, after the group has run, and a group whose
        batches differ in shape runs step by step."""
        from .callbacks import CallbackList, ProgBarLogger
        loader = self._make_loader(train_data, batch_size, shuffle, drop_last,
                                   num_workers,
                                   whole=self._spec_layout is not None)
        # save() captures this loader's cursor, so that a restored run
        # replays no batch (resilience/snapshot.py)
        self._active_loader = loader
        cb_list = _to_list(callbacks) or [ProgBarLogger(log_freq, verbose)]
        from ..resilience import preempt as _preempt
        if _preempt.installed() and not any(
                isinstance(c, _preempt.PreemptionCallback) for c in cb_list):
            cb_list = list(cb_list) + [_preempt.PreemptionCallback()]
        cbs = CallbackList(cb_list)
        cbs.set_model(self)
        from ..framework.flags import get_flag
        guard = None
        if get_flag("FLAGS_check_nan_inf"):
            from ..resilience.guard import StepGuard
            guard = StepGuard([self.network, self._optimizer])
            self._step_guard = guard
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbs.on_train_begin({"epochs": epochs, "steps": steps,
                            "metrics": self._metric_names()})
        self.stop_training = False
        spe = max(1, int(steps_per_execution))
        it = 0
        logs = {}
        for epoch in range(epochs):
            cbs.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            step = 0
            group = []
            _prefetch = None  # set below when FLAGS_input_prefetch is on

            def run_group(group, step0):
                nonlocal logs, it
                st = _steptimer.get_steptimer()
                # the cursor counts a prefetched batch once its step has
                # run (a step the guard rolled back consumed its batch too)
                if _prefetch is not None:
                    loader.note_consumed(len(group))
                if len(group) == 1:
                    cbs.on_train_batch_begin(step0)
                    with st.step(n_steps=1):
                        if guard is not None:
                            guard.before_step()
                        loss = self.train_batch(*group[0])
                        logs = {"loss": loss, "step": step0}
                        if guard is not None:
                            with st.phase("step/integrity"):
                                kept = guard.after_step(loss)
                            if not kept:
                                logs["skipped"] = True
                    cbs.on_train_batch_end(step0, logs)
                    it += 1
                    return
                # a group: every begin fires, the steps run in one call,
                # then every end reports its step's loss
                for k in range(len(group)):
                    cbs.on_train_batch_begin(step0 + k)
                with st.step(n_steps=len(group)):
                    if guard is not None:
                        # one call: the guard keeps or restores the group
                        guard.before_step()
                    losses = self._train_steps(group)
                    group_skipped = False
                    if guard is not None:
                        with st.phase("step/integrity"):
                            group_skipped = not guard.after_step(losses)
                for k, loss in enumerate(losses):
                    s = step0 + k
                    logs = {"loss": loss, "step": s}
                    if group_skipped:
                        logs["skipped"] = True
                    cbs.on_train_batch_end(s, logs)
                    it += 1

            group_sig = None
            _st = _steptimer.get_steptimer()
            if get_flag("FLAGS_input_prefetch", True) and \
                    hasattr(loader, "iter_uncounted"):
                # double-buffered read-ahead: the thread stages step N+1's
                # batch on the device while step N runs
                from .prefetch import InputPrefetcher
                _prefetch = InputPrefetcher(loader, self._split_batch,
                                            device=self._device)
                _loader_it = None
            else:
                _loader_it = iter(loader)
            _done = object()
            try:
                while True:
                    # the time left waiting for the next batch, after the
                    # overlap, is step/input_wait
                    with _st.phase("step/input_wait"):
                        if _prefetch is not None:
                            item = _prefetch.get()
                            if item is InputPrefetcher.DONE:
                                item = _done
                        else:
                            batch = next(_loader_it, _done)
                            item = batch if batch is _done \
                                else self._split_batch(batch)
                    if item is _done:
                        break
                    ins, labs = item
                    sig = _batch_sig((ins, labs)) if spe > 1 else None
                    if group and spe > 1 and sig != group_sig:
                        # a ragged boundary: run what we have step by step
                        for g in group:
                            run_group([g], step)
                            step += 1
                        group = []
                    if not group:
                        group_sig = sig
                    group.append((ins, labs))
                    # never run past num_iters: cap the group to what's left
                    remaining = (None if num_iters is None
                                 else max(0, num_iters - it))
                    if len(group) == spe or (remaining is not None
                                             and len(group) >= remaining):
                        if remaining is not None:
                            group = group[:remaining]
                        if group:
                            run_group(group, step)
                            step += len(group)
                        group = []
                    if num_iters is not None and it >= num_iters:
                        break
                if group:  # the tail, in one call (its shapes agree)
                    run_group(group, step)
                    step += len(group)
            finally:
                if _prefetch is not None:
                    _prefetch.close()
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                eval_result = self.evaluate(eval_data, batch_size=batch_size,
                                            verbose=0, num_workers=num_workers,
                                            callbacks=callbacks)
                # eval metrics join the epoch logs, where monitoring
                # callbacks (EarlyStopping, ModelCheckpoint) read them
                for k, v in eval_result.items():
                    logs[k] = v[0] if isinstance(v, list) and len(v) == 1 else v
            # epoch logs carry scalars (batch logs carry lists)
            if isinstance(logs.get("loss"), list) and len(logs["loss"]) == 1:
                logs["loss"] = logs["loss"][0]
            cbs.on_epoch_end(epoch, logs)
            if save_dir is not None and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/{epoch}")
            if self.stop_training or (num_iters is not None and it >= num_iters):
                break
        cbs.on_train_end(logs)
        if save_dir is not None:
            self.save(f"{save_dir}/final")

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        from .callbacks import CallbackList
        loader = self._make_loader(eval_data, batch_size, False, False,
                                   num_workers)
        cbs = CallbackList(_to_list(callbacks))
        cbs.set_model(self)
        cbs.on_eval_begin({})
        for m in self._metrics:
            m.reset()
        losses = []
        for step, batch in enumerate(loader):
            cbs.on_eval_batch_begin(step)
            ins, labs = self._split_batch(batch)
            loss_vals, _ = self.eval_batch(ins, labs)
            if loss_vals:
                losses.append(loss_vals[0])
            cbs.on_eval_batch_end(step, {"loss": loss_vals, "step": step})
        result = {}
        if losses:
            result["loss"] = [float(np.mean(losses))]
        for m in self._metrics:
            res = m.accumulate()
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = res if isinstance(res, list) else [res]
            for n, v in zip(names, vals):
                result[n] = v
        cbs.on_eval_end(result)
        return result

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        loader = test_data if isinstance(test_data, DataLoader) else \
            DataLoader(test_data, batch_size=batch_size,
                       num_workers=num_workers)
        import inspect
        try:
            sig = inspect.signature(type(self.network).forward)
            max_ins = sum(1 for p in sig.parameters.values()
                          if p.kind in (p.POSITIONAL_ONLY,
                                        p.POSITIONAL_OR_KEYWORD)
                          and p.name != "self")
        except (TypeError, ValueError):
            max_ins = None
        outputs = []
        for batch in loader:
            ins, _ = self._split_batch(batch, has_labels=False)
            if max_ins is not None:
                ins = ins[:max_ins]
            outputs.append(self.predict_batch(ins))
        if stack_outputs and outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(n_out)]
        return outputs

    # -- persistence -------------------------------------------------------
    def save(self, path, training=True):
        """The hardened save (resilience.snapshot.save_model): ``path``
        .pdparams, .pdopt and .pdstate with sha256 sidecars and a
        committed manifest, restorable by manifest discovery."""
        from ..resilience.snapshot import capture_train_state, save_model
        with _steptimer.get_steptimer().phase("step/ckpt_io"):
            save_model(
                self.network,
                self._optimizer if training else None, path,
                train_state=capture_train_state(
                    loader=getattr(self, "_active_loader", None)))

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Load ``path``.pdparams into the network in place, and
        ``path``.pdopt into the optimizer when there is one and the file
        exists. As in the reference's ``set_state_dict``, a name only one
        side has is skipped and a shape that differs raises ValueError.
        ``skip_mismatch=True`` skips such a parameter instead, and its
        optimizer state with it: a backbone loads under a new head. The
        reference accepts that option and does not read it (ROADMAP
        C-ref-9)."""
        import os
        from ..framework.io_utils import load as _load
        from ..framework.io_utils import load_numpy_state_dict
        state = _load(path + ".pdparams")
        own = self.network.state_dict()
        skipped = {n for n, v in state.items() if n in own and
                   tuple(np.shape(v)) != tuple(own[n].shape)}
        if skip_mismatch:
            state = {n: v for n, v in state.items() if n not in skipped}
        load_numpy_state_dict(self.network, state, strict=False)
        if reset_optimizer or self._optimizer is None or \
                not os.path.exists(path + ".pdopt"):
            return
        opt_state = _load(path + ".pdopt")
        if skipped and skip_mismatch:
            params = dict(self.network.named_parameters())
            ids = {id(params[n]) for n in skipped if n in params}
            names = {name for name, p in zip(
                self._optimizer._param_names(),
                self._optimizer._parameter_list or []) if id(p) in ids}
            opt_state = {k: v for k, v in opt_state.items()
                         if k.rsplit("__", 1)[0] not in names}
        self._optimizer.set_state_dict(opt_state)

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from .model_summary import summary
        return summary(self.network, input_size, dtypes=dtype)

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _make_loader(data, batch_size, shuffle, drop_last, num_workers,
                     whole=False):
        """A DataLoader over ``data`` (a DataLoader passes through). At
        world size > 1 it takes this rank's shard through a
        DistributedBatchSampler, as the reference's does; with ``whole``
        (under a layout) every rank takes the whole batch, in one order
        (the sampler's epoch seeds it), and train_batch cuts its data
        slice."""
        if isinstance(data, DataLoader):
            return data
        from ..distributed import env as _dist_env
        if _dist_env.get_world_size() > 1:
            from ..io import DistributedBatchSampler
            one = {"num_replicas": 1, "rank": 0} if whole else {}
            sampler = DistributedBatchSampler(
                data, batch_size=batch_size, shuffle=shuffle,
                drop_last=drop_last, **one)
            return DataLoader(data, batch_sampler=sampler,
                              num_workers=num_workers)
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers)

    def _metric_names(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names += n if isinstance(n, list) else [n]
        return names

    @staticmethod
    def _split_batch(batch, has_labels=True):
        if isinstance(batch, (list, tuple)):
            if has_labels and len(batch) >= 2:
                return list(batch[:-1]), [batch[-1]]
            return list(batch), []
        return [batch], []
