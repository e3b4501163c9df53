"""The vision model families of the parity checks, shared by
tests/test_torch_zoo_*.py (the port against the reference on the host)
and chip_smoke.py's vision_zoo_small lane (the port on the card against
the port on the host). This module imports no JAX and nothing of the
reference; the port only where a ResNeXt stem fuses (``_resnet_stem``).

``FAMILIES`` lists each family's constructor, keywords, input size and
batch (the reference test's sizes, tests/test_vision_models.py, or
smaller), its blocks (``stages``), its heads, and whether the host test
holds its whole training step (``whole``) or its blocks one at a time
(see ZooBlocks in tests/test_torch_zoo_cases.py). A whole-model f32
step is ill-conditioned where a max-pool window's two largest values lie
within f32 rounding of each other (the gradient goes to either) or a
BatchNorm sees a handful of values; the card's lane holds every family
block by block, since cuDNN's f32 convs sit further from the host's than
the two packages do from each other there.

A stage is (name, fn(model, x), source): the block's input is the output
of the stage named ``source`` (None: the image). ``heads`` names the
stages whose outputs are logits, the main head first.
"""
import torch

AUX_WEIGHT = 0.3


def outputs(out):
    return out if isinstance(out, tuple) else (out,)


def loss_of(P, out, y):
    """Cross-entropy of the logits; GoogLeNet's aux heads add 0.3 each."""
    outs = outputs(out)
    loss = P.nn.functional.cross_entropy(outs[0], y)
    for aux in outs[1:]:
        loss = loss + AUX_WEIGHT * P.nn.functional.cross_entropy(aux, y)
    return loss


def no_dropout(model, P):
    for layer in model.sublayers():
        if isinstance(layer, P.nn.Dropout):
            layer.p = 0.0


def _chain(parts):
    """Stages that run one after another: [(name, fn), ...]."""
    out, prev = [], None
    for name, fn in parts:
        out.append((name, fn, prev))
        prev = name
    return out


def _top(m, x):
    return m.fc(m.dropout(m.avgpool(x).flatten(1)))


def _features(m, head):
    """Each layer of ``m.features`` alone, then ``head``."""
    return _chain([(f"f{i}", lambda m, x, i=i: m.features[i](x))
                   for i in range(len(m.features))] + [("head", head)])


def alexnet_stages(m):
    return _features(m, lambda m, x: m.classifier(m.avgpool(x).flatten(1)))


def densenet_stages(m):
    """The stem's layers, each dense layer and each transition alone, then
    the last norm and the top."""
    parts = [(n, lambda m, x, n=n: getattr(m, n)(x))
             for n in ("conv1", "norm1", "relu", "pool1")]
    for b, block in enumerate(m.blocks):
        if hasattr(block, "layers"):
            parts += [(f"b{b}.{j}", lambda m, x, b=b, j=j:
                       m.blocks[b].layers[j](x))
                      for j in range(len(block.layers))]
        else:
            parts.append((f"t{b}", lambda m, x, b=b: m.blocks[b](x)))
    return _chain(parts + [("head", lambda m, x: m.classifier(
        m.avgpool(m.relu(m.norm5(x))).flatten(1)))])


def squeezenet_stages(m):
    return _features(m, lambda m, x: m.classifier(x).flatten(1))


_GOOGLENET_BODY = ("inc3a", "inc3b", "pool3", "inc4a", "inc4b", "inc4c",
                   "inc4d", "inc4e", "pool4", "inc5a", "inc5b")


def googlenet_stages(m):
    """The stem's layers one by one (its max pools then see the shared
    inputs), each Inception block, the pools between them, both aux heads
    and the top."""
    out = _chain([(f"stem{i}", lambda m, x, i=i: m.stem[i](x))
                  for i in range(len(m.stem))]
                 + [(n, lambda m, x, n=n: getattr(m, n)(x))
                    for n in _GOOGLENET_BODY] + [("head", _top)])
    return out + [("aux1", lambda m, x: m.aux1(x), "inc4a"),
                  ("aux2", lambda m, x: m.aux2(x), "inc4d")]


def inception_stages(m):
    return _chain([(f"{p}{i}", lambda m, x, p=p, i=i: getattr(m, p)[i](x))
                   for p in ("stem", "blocks")
                   for i in range(len(getattr(m, p)))] + [("head", _top)])


def _resnet_stem(m, x):
    """conv1, bn1 and ReLU as each package's ResNet.forward runs them (the
    port's through the fused op when the model fuses)."""
    if isinstance(m, torch.nn.Module) and m._fused:
        from paddle_tpu_torch.vision.models.resnet import _fcb
        return m.relu(_fcb(x, m.conv1, m.bn1, False))
    return m.relu(m.bn1(m.conv1(x)))


def resnext_stages(m):
    return _chain(
        [("stem", _resnet_stem), ("maxpool", lambda m, x: m.maxpool(x))]
        + [(f"layer{li}.{b}",
            lambda m, x, li=li, b=b: getattr(m, f"layer{li}")[b](x))
           for li, n in zip(range(1, 5), (3, 4, 6, 3)) for b in range(n)]
        + [("head", lambda m, x: m.fc(m.avgpool(x).flatten(1)))])


# name -> (constructor, keywords, input size, batch, stages, heads,
#          whole: the host test holds the whole training step)
FAMILIES = {
    "alexnet": ("alexnet", {}, 64, 2, alexnet_stages, ("head",), True),
    "vgg11": ("vgg11", {}, 32, 2, alexnet_stages, ("head",), True),
    "vgg11_bn": ("vgg11", {"batch_norm": True}, 32, 2, alexnet_stages,
                 ("head",), True),
    "squeezenet1_0": ("squeezenet1_0", {}, 64, 2, squeezenet_stages,
                      ("head",), False),
    "squeezenet1_1": ("squeezenet1_1", {}, 64, 2, squeezenet_stages,
                      ("head",), True),
    "googlenet": ("googlenet", {}, 64, 2, googlenet_stages,
                  ("head", "aux1", "aux2"), False),
    "inception_v3": ("inception_v3", {}, 128, 2, inception_stages,
                     ("head",), False),
    "densenet121": ("densenet121", {}, 64, 2, densenet_stages, ("head",),
                    True),
    "resnext50_32x4d": ("resnext50_32x4d", {}, 64, 2, resnext_stages,
                        ("head",), False),
}
