"""The shared body of the vision model families' parity tests
(tests/test_torch_zoo_*.py): a family's test class subclasses ``Zoo``
(or ``ZooBlocks``) and names its entry of tests/test_torch_zoo_stages.py
(constructor, keywords, input size, blocks), and gets:

- state-dict names and shapes, and the parameter order, equal to the
  reference's (weights carried into the port by name);
- eval logits within relative L2 1e-5 of the reference's (each output of
  GoogLeNet's three);
- one training forward and backward with batch statistics (every
  dropout set to p = 0 in both packages, since they draw different
  masks): the loss within 1e-5; every grad and the moved running
  statistics within 1e-4 (1e-5 for the statistics) of the reference's
  plus NOISE_FACTOR x the port's own f32 noise on that tensor (its f32
  value against the same step in f64), as tests/test_torch_mobile_nets.py
  holds MobileNet: at these sizes the deep BatchNorms normalise over a
  handful of values, where f32 grads are rounding noise in both
  packages. (The optimizer's update is held elsewhere, in
  tests/test_torch_optimizers.py; the card's lane takes the whole
  Momentum + L2Decay step.) The sizes are the reference test's
  (tests/test_vision_models.py) or smaller; where a BatchNorm sees only a
  few values a channel the loss itself is ill-conditioned in f32
  (DenseNet-121 at 2 x 32 x 32: the port's own f32 loss is 0.9% from its
  f64 loss, and at 4 x 48 x 48 the reference's is 4.7e-5 from it; at
  the reference test's 2 x 64 x 64 both are within 1.3e-6);
- the NHWC (channels-last) port against the NCHW port in f64: training
  loss, eval logits and every grad.

The reference is eager and slow on the host, so a class builds its
reference model and runs its reference steps once (class-scoped
fixtures); the families are spread over several files so that
pytest-xdist's workers (``-n``, ``--dist loadfile``) run them in
parallel.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from test_torch_zoo_stages import FAMILIES, loss_of, no_dropout, outputs

LOGIT_TOL, LOSS_TOL, GRAD_TOL, STAT_TOL = 1e-5, 1e-5, 1e-4, 1e-5
NOISE_FACTOR = 4.0

torch.set_num_threads(1)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def ref_state(model):
    return {k: np.asarray(v._val) for k, v in model.state_dict().items()}


class Zoo:
    """A family's tests; FAMILY names its entry of FAMILIES."""
    FAMILY = None
    PORT_KW = [{}]          # one port model per entry, each held alike

    @property
    def NAME(self):
        return FAMILIES[self.FAMILY][0]

    @property
    def KW(self):
        return FAMILIES[self.FAMILY][1]

    @property
    def HW(self):
        return FAMILIES[self.FAMILY][2]

    @property
    def BATCH(self):
        return FAMILIES[self.FAMILY][3]

    def port(self, state, **kw):
        pm = getattr(pt.vision.models, self.NAME)(
            num_classes=10, device="cpu", **self.KW, **kw)
        assert pm.set_state_dict(dict(state)) == ([], [])
        no_dropout(pm, pt)
        return pm

    @pytest.fixture(scope="class")
    def reference(self):
        """The reference model's weights, eval logits and one training
        forward and backward (loss, grads, moved statistics)."""
        whole = type(self).test_train_step_matches_reference \
            is Zoo.test_train_step_matches_reference
        assert FAMILIES[self.FAMILY][6] == whole, self.FAMILY
        ref.seed(0)
        rm = getattr(ref.vision.models, self.NAME)(num_classes=10,
                                                   **self.KW)
        no_dropout(rm, ref)
        state = ref_state(rm)
        x, y = self.inputs(0)
        rm.eval()
        logits = [np.asarray(o._val) for o in outputs(rm(ref.to_tensor(x)))]
        rm.train()
        out = {"state": state, "logits": logits,
               "names": [n for n, _ in rm.named_parameters()]}
        out.update(self.train_reference(rm, state))
        return out

    def train_reference(self, rm, state):
        """The reference's training forward and backward of the whole
        model: loss, grads and moved statistics."""
        x, y = self.inputs(1)
        loss = loss_of(ref, rm(ref.to_tensor(x)), ref.to_tensor(y))
        loss.backward()
        grads = {n: np.asarray(p.grad._val) for n, p in rm.named_parameters()}
        return {"loss": float(loss.item()), "grads": grads,
                "stats": ref_state(rm)}

    def inputs(self, seed):
        rng = np.random.RandomState(seed)
        return (rng.randn(self.BATCH, 3, self.HW, self.HW).astype("float32"),
                rng.randint(0, 10, (self.BATCH,)).astype("int64"))

    @staticmethod
    def step(pm, x, y, dtype=torch.float32):
        loss = loss_of(pt, pm(torch.tensor(x, dtype=dtype)), torch.tensor(y))
        loss.backward()
        return loss.item(), {n: p.grad.numpy()
                             for n, p in pm.named_parameters()}

    def test_state_dict_names_match_reference(self, reference):
        for kw in self.PORT_KW:
            pm = self.port(reference["state"], **kw)
            assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} \
                == {k: v.shape for k, v in reference["state"].items()}
            assert [n for n, _ in pm.named_parameters()] == \
                reference["names"]

    def test_eval_logits_match_reference(self, reference):
        x, _ = self.inputs(0)
        for kw in self.PORT_KW:
            pm = self.port(reference["state"], **kw)
            pm.eval()
            with torch.no_grad():
                got = outputs(pm(torch.tensor(x)))
            assert len(got) == len(reference["logits"])
            for g, want in zip(got, reference["logits"]):
                assert g.shape == (self.BATCH, 10)
                assert rel_l2(g.numpy(), want) <= LOGIT_TOL, \
                    (kw, rel_l2(g.numpy(), want))

    def test_train_step_matches_reference(self, reference):
        x, y = self.inputs(1)
        exact = self.port(reference["state"])
        exact.to(dtype=torch.float64)
        _, f64 = self.step(exact, x, y, torch.float64)
        exact_stats = {n: b.numpy() for n, b in exact.named_buffers()}
        for kw in self.PORT_KW:
            pm = self.port(reference["state"], **kw)
            loss, grads = self.step(pm, x, y)
            assert abs(loss - reference["loss"]) \
                <= LOSS_TOL * abs(reference["loss"]), (kw, loss)
            for n, g in grads.items():
                noise = rel_l2(g, f64[n])
                gap = rel_l2(g, reference["grads"][n])
                assert gap <= NOISE_FACTOR * noise + GRAD_TOL, \
                    (kw, n, gap, noise)
            for n, b in pm.named_buffers():
                noise = rel_l2(b.numpy(), exact_stats[n])
                gap = rel_l2(b.numpy(), reference["stats"][n])
                assert gap <= NOISE_FACTOR * noise + STAT_TOL, \
                    (kw, n, gap, noise)

    def test_nhwc_matches_nchw(self, reference):
        """data_format="NHWC" is the same network: training loss, eval
        logits and every grad, in f64."""
        x, y = self.inputs(2)
        xt = torch.tensor(x, dtype=torch.float64)
        runs = []
        for fmt, xin in (("NCHW", xt),
                         ("NHWC", xt.permute(0, 2, 3, 1).contiguous())):
            pm = self.port(reference["state"], data_format=fmt,
                           **self.PORT_KW[0])
            pm.to(dtype=torch.float64)
            loss = loss_of(pt, pm(xin), torch.tensor(y))
            loss.backward()
            pm.eval()
            with torch.no_grad():
                logits = [o.numpy() for o in outputs(pm(xin))]
            runs.append((loss.item(), logits,
                         {n: p.grad.numpy()
                          for n, p in pm.named_parameters()}))
        (l0, e0, g0), (l1, e1, g1) = runs
        assert abs(l0 - l1) <= 1e-12 * abs(l0)
        for a, b in zip(e1, e0):
            assert rel_l2(a, b) <= 1e-12
        norm = np.sqrt(sum(float((g ** 2).sum()) for g in g0.values()))
        for n in g0:
            assert np.linalg.norm(g1[n] - g0[n]) <= 1e-10 * norm, n


class ZooBlocks(Zoo):
    """The training step held block by block, for the families where the
    whole model's f32 step is ill-conditioned at a test size: a max-pool
    window whose two largest values lie within f32 rounding of each other
    sends the gradient to either one, and any f32 implementation may pick
    the other (SqueezeNet 1.0 at 2 x 64 x 64: one such window in the last
    pool moves the reference's first-layer grads 2.3% from the f64 truth,
    while every layer and every chain of up to ten layers, fed the same
    activations, agrees with the port within 5e-7), and a BatchNorm over a
    handful of values amplifies rounding (InceptionV3's own f32 loss is
    up to 1.7e-4 from its f64 loss at 2 x 128 x 128). So the port's f64
    model runs the training step and records each block's input and the
    gradient arriving at its output; both packages then run every block
    alone in f32 on those, in training mode, and each block's output, the
    gradient of its input and its parameters' grads must agree within
    LOGIT_TOL (outputs) or GRAD_TOL (grads) plus NOISE_FACTOR x the port's
    own f32 noise on that block (f32 against f64 on the same inputs). The
    loss from the heads' outputs is held to LOSS_TOL the same way.

    The blocks are the family's ``stages`` in
    tests/test_torch_zoo_stages.py, whose ``whole`` flag is False for
    these families."""

    def stages(self, m):
        return FAMILIES[self.FAMILY][4](m)

    @property
    def HEADS(self):
        return FAMILIES[self.FAMILY][5]

    def chain(self, state, dtype):
        """The port's training forward and backward in ``dtype`` through
        the stages: each block's input and output gradient (numpy)."""
        pm = self.port(state)
        pm.to(dtype=dtype)
        x, y = self.inputs(1)
        acts = {None: torch.tensor(x, dtype=dtype)}
        for name, fn, src in self.stages(pm):
            acts[name] = fn(pm, acts[src])
            acts[name].retain_grad()
        loss = loss_of(pt, tuple(acts[h] for h in self.HEADS),
                       torch.tensor(y))
        loss.backward()
        return ({k: v.detach().numpy() for k, v in acts.items()},
                {k: v.grad.numpy() for k, v in acts.items()
                 if k is not None})

    @staticmethod
    def run_block(P, m, fn, x, cot):
        """One block of a model of package P alone: its output, its input's
        grad and its parameters' grads for the output gradient ``cot``."""
        if P is ref:
            xt = ref.to_tensor(x)
            xt.stop_gradient = False
            out = fn(m, xt)
            (out * ref.to_tensor(cot)).sum().backward()
            grads = {n: np.asarray(p.grad._val)
                     for n, p in m.named_parameters() if p.grad is not None}
            m.clear_gradients()
            return np.asarray(out._val), np.asarray(xt.grad._val), grads
        xt = torch.tensor(x).requires_grad_()
        out = fn(m, xt)
        (out * torch.tensor(cot)).sum().backward()
        grads = {n: p.grad.numpy().copy() for n, p in m.named_parameters()
                 if p.grad is not None}
        m.zero_grad(set_to_none=True)
        return out.detach().numpy(), xt.grad.numpy(), grads

    def train_reference(self, rm, state):
        acts, cots = self.chain(state, torch.float64)
        f32 = {k: v.astype("float32") for k, v in acts.items()}
        blocks = {name: self.run_block(ref, rm, fn, f32[src],
                                       cots[name].astype("float32"))
                  for name, fn, src in self.stages(rm)}
        _, y = self.inputs(1)
        loss = loss_of(ref, tuple(ref.to_tensor(blocks[h][0])
                                  for h in self.HEADS), ref.to_tensor(y))
        return {"acts": acts, "cots": cots, "blocks": blocks,
                "loss": float(loss.item())}

    def test_train_step_matches_reference(self, reference):
        acts, cots = reference["acts"], reference["cots"]
        exact = self.port(reference["state"])
        exact.to(dtype=torch.float64)
        _, y = self.inputs(1)
        for kw in self.PORT_KW:
            pm = self.port(reference["state"], **kw)
            outs = {}
            for name, fn, src in self.stages(pm):
                got = self.run_block(pt, pm, fn, acts[src].astype("float32"),
                                     cots[name].astype("float32"))
                f64 = self.run_block(pt, exact, fn, acts[src], cots[name])
                want = reference["blocks"][name]
                outs[name] = got[0]
                for what, tol, g, w, e in (
                        ("out", LOGIT_TOL, got[0], want[0], f64[0]),
                        ("dx", GRAD_TOL, got[1], want[1], f64[1])):
                    noise = rel_l2(g, e)
                    assert rel_l2(g, w) <= NOISE_FACTOR * noise + tol, \
                        (kw, name, what, rel_l2(g, w), noise)
                assert sorted(got[2]) == sorted(want[2]), name
                for n in got[2]:
                    noise = rel_l2(got[2][n], f64[2][n])
                    gap = rel_l2(got[2][n], want[2][n])
                    assert gap <= NOISE_FACTOR * noise + GRAD_TOL, \
                        (kw, name, n, gap, noise)
            loss = loss_of(pt, tuple(torch.tensor(outs[h])
                                     for h in self.HEADS),
                           torch.tensor(y)).item()
            assert abs(loss - reference["loss"]) \
                <= LOSS_TOL * abs(reference["loss"]), (kw, loss)
