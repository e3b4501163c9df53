"""The RNN layers and beam-search decoding of the PyTorch/CUDA port
against the JAX reference on the host.

Every layer (SimpleRNN with tanh and relu, LSTM, GRU) one- and
two-directional, with 1 and 2 layers, batch-major and time-major, and
every cell and the generic RNN/BiRNN wrappers, run on the same numpy
inputs with the same weights (seeded arrays through set_state_dict):
outputs and final states within 1e-5, the input's and every weight's
gradient within 1e-4. Beam search (BeamSearchDecoder over a table cell
and over a GRUCell, TransformerBeamSearchDecoder over a transformer
decoder, dynamic_decode, gather_tree): tokens, parents, lengths and
predictions identical, including steps with tied scores (step 0's -1e9
beams, a vocabulary smaller than the beam) and finished beams. A
two-layer LSTM language-model step at width 32: loss within 1e-5, grads
within 1e-4. Then the reference's own RNN and beam-search tests through
both packages, and the arguments the reference never reads (ROADMAP
C-ref-17).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from test_torch_nn_cases import load

torch.set_num_threads(1)

BOTH = pytest.mark.parametrize("P", [ref, pt], ids=["ref", "port"])
OUT_TOL = {"rtol": 1e-5, "atol": 1e-5}
GRAD_TOL = {"rtol": 1e-4, "atol": 1e-4}


@pytest.fixture(autouse=True)
def _global_state():
    """Each test on the host from seed 0; the process-wide state of both
    packages (device, default dtype, global initializer) put back after
    it."""
    before = pt.get_device()
    dtypes = ref.get_default_dtype(), pt.get_default_dtype()
    inits = (ref.nn.initializer._global_initializer(False),
             ref.nn.initializer._global_initializer(True),
             pt.nn.initializer._global_initializer(False),
             pt.nn.initializer._global_initializer(True))
    pt.set_device("cpu")
    ref.seed(0)
    pt.seed(0)
    yield
    pt.set_device(before)
    ref.set_default_dtype(dtypes[0])
    pt.set_default_dtype(dtypes[1])
    ref.nn.initializer.set_global_initializer(*inits[:2])
    pt.nn.initializer.set_global_initializer(*inits[2:])


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t.numpy())


def _flat(out):
    """The tensors of a (nested) output, in order."""
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _run(P, make, arrays, seed, needs_grad=True):
    """Build a layer with ``make(P)``, load seeded weights, run it on
    ``arrays`` and backpropagate a fixed random weighting of every
    output; returns (outputs, {name: grad}, input grads)."""
    layer = load(P, make(P), seed)
    xs = [P.to_tensor(a, stop_gradient=not needs_grad) for a in arrays]
    if P is pt:
        xs = [torch.tensor(a, requires_grad=needs_grad) for a in arrays]
    outs = _flat(layer(*xs))
    rng = np.random.RandomState(seed + 100)
    total = None
    for o in outs:
        w = rng.randn(*tuple(o.shape)).astype("float32")
        term = (o * P.to_tensor(w)).sum()
        total = term if total is None else total + term
    total.backward()
    grads = {n: _np(p.grad) for n, p in layer.named_parameters()}
    return [_np(o) for o in outs], grads, [
        None if x.grad is None else _np(x.grad) for x in xs]


def _compare(make, arrays, seed=0):
    want = _run(ref, make, arrays, seed)
    got = _run(pt, make, arrays, seed)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, **OUT_TOL)
    assert sorted(got[1]) == sorted(want[1])
    for name in want[1]:
        np.testing.assert_allclose(got[1][name], want[1][name],
                                   err_msg=name, **GRAD_TOL)
    for g, w in zip(got[2], want[2]):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_allclose(g, w, **GRAD_TOL)


LAYERS = [("SimpleRNN", {}), ("SimpleRNN", {"activation": "relu"}),
          ("LSTM", {}), ("GRU", {})]


@pytest.mark.parametrize("time_major", [False, True], ids=["batch", "time"])
@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("cls,kw", LAYERS,
                         ids=["rnn_tanh", "rnn_relu", "lstm", "gru"])
def test_rnn_layer_matches_reference(cls, kw, direction, num_layers,
                                     time_major):
    x = np.random.RandomState(1).randn(
        *((7, 3, 5) if time_major else (3, 7, 5))).astype("float32")
    _compare(lambda P: getattr(P.nn, cls)(
        5, 6, num_layers=num_layers, direction=direction,
        time_major=time_major, **kw), [x], seed=2)


@pytest.mark.parametrize("cls", ["SimpleRNN", "LSTM", "GRU"])
def test_rnn_layer_with_initial_states_matches_reference(cls):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 3).astype("float32")
    h = rng.randn(4, 2, 5).astype("float32")
    c = rng.randn(4, 2, 5).astype("float32")

    def make(P):
        return getattr(P.nn, cls)(3, 5, num_layers=2,
                                  direction="bidirectional")

    def run(P):
        layer = load(P, make(P), 4)
        if P is pt:
            xs = [torch.tensor(a, requires_grad=True) for a in (x, h, c)]
        else:
            xs = [P.to_tensor(a, stop_gradient=False) for a in (x, h, c)]
        states = (xs[1], xs[2]) if cls == "LSTM" else xs[1]
        outs = _flat(layer(xs[0], states))
        total = sum((o * P.to_tensor(np.full(tuple(o.shape), 0.5 + i,
                                             "float32"))).sum()
                    for i, o in enumerate(outs))
        total.backward()
        used = xs if cls == "LSTM" else xs[:2]
        return [_np(o) for o in outs] + [_np(t.grad) for t in used]
    for g, w in zip(run(pt), run(ref)):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


CELLS = [("SimpleRNNCell", {}), ("SimpleRNNCell", {"activation": "relu"}),
         ("LSTMCell", {}), ("GRUCell", {})]


@pytest.mark.parametrize("with_states", [False, True],
                         ids=["zero_states", "states"])
@pytest.mark.parametrize("cls,kw", CELLS,
                         ids=["rnn_tanh", "rnn_relu", "lstm", "gru"])
def test_cell_matches_reference(cls, kw, with_states):
    rng = np.random.RandomState(5)
    x = rng.randn(3, 4).astype("float32")
    h = rng.randn(3, 6).astype("float32")
    c = rng.randn(3, 6).astype("float32")
    if not with_states:
        _compare(lambda P: getattr(P.nn, cls)(4, 6, **kw), [x], seed=6)
        return

    def make(P):
        cell = getattr(P.nn, cls)(4, 6, **kw)

        class WithStates(P.nn.Layer):
            def __init__(self):
                super().__init__()
                self.cell = cell

            def forward(self, x, h, c):
                return self.cell(x, (h, c) if cls == "LSTMCell" else h)
        return WithStates()
    _compare(make, [x, h, c], seed=6)


@pytest.mark.parametrize("time_major", [False, True], ids=["batch", "time"])
@pytest.mark.parametrize("is_reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("cell", ["LSTMCell", "GRUCell"])
def test_rnn_wrapper_matches_reference(cell, is_reverse, time_major):
    x = np.random.RandomState(7).randn(
        *((5, 2, 3) if time_major else (2, 5, 3))).astype("float32")
    _compare(lambda P: P.nn.RNN(getattr(P.nn, cell)(3, 4), is_reverse,
                                time_major), [x], seed=8)


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
def test_birnn_wrapper_matches_reference(cell):
    x = np.random.RandomState(9).randn(2, 6, 3).astype("float32")
    _compare(lambda P: P.nn.BiRNN(getattr(P.nn, cell)(3, 4),
                                  getattr(P.nn, cell)(3, 4)), [x], seed=10)


def test_parameter_names_and_default_init_match_reference():
    for cls in ("SimpleRNN", "LSTM", "GRU"):
        r = getattr(ref.nn, cls)(3, 4, num_layers=2, direction="bidirect")
        p = getattr(pt.nn, cls)(3, 4, num_layers=2, direction="bidirect",
                                device="cpu")
        rs, ps = r.state_dict(), p.state_dict()
        assert list(ps) == list(rs), cls
        for name, t in ps.items():
            assert tuple(t.shape) == tuple(rs[name].shape), name
            assert float(t.abs().max()) <= 0.5 + 1e-7, name
        assert ps["weight_ih_l1_reverse"].shape[1] == 8


def test_dropout_between_layers_draws_from_the_layers_generator():
    x = torch.randn(2, 5, 3)
    weights = pt.nn.LSTM(3, 4, num_layers=3, device="cpu").state_dict()

    def run(seed, training=True):
        layer = pt.nn.LSTM(3, 4, num_layers=3, dropout=0.5,
                           generator=torch.Generator().manual_seed(seed),
                           device="cpu")
        layer.set_state_dict(weights)
        layer.train(training)
        return layer(x)[0]
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert torch.equal(run(1, False), run(2, False))


# -- an LSTM language-model step ---------------------------------------------------
def _lm(P, vocab, width):
    class LM(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = P.nn.Embedding(vocab, width)
            self.lstm = P.nn.LSTM(width, width, num_layers=2)
            self.proj = P.nn.Linear(width, vocab)

        def forward(self, ids, h, c):
            out, (h, c) = self.lstm(self.embedding(ids), (h, c))
            return self.proj(out), h, c
    return LM()


def test_lstm_lm_step_matches_reference():
    vocab, width, b, t = 50, 32, 3, 7
    rng = np.random.RandomState(11)
    ids = rng.randint(0, vocab, (b, t + 1)).astype("int64")
    h = rng.randn(2, b, width).astype("float32") * 0.1
    c = rng.randn(2, b, width).astype("float32") * 0.1

    def step(P):
        model = load(P, _lm(P, vocab, width), 12)
        logits, hn, cn = model(P.to_tensor(ids[:, :-1]), P.to_tensor(h),
                               P.to_tensor(c))
        loss = P.nn.functional.cross_entropy(
            logits.reshape([-1, vocab]), P.to_tensor(ids[:, 1:].reshape(-1)))
        loss.backward()
        return (float(_np(loss)), _np(hn), _np(cn),
                {n: _np(p.grad) for n, p in model.named_parameters()})
    got, want = step(pt), step(ref)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], **OUT_TOL)
    np.testing.assert_allclose(got[2], want[2], **OUT_TOL)
    assert sorted(got[3]) == sorted(want[3])
    for name in want[3]:
        np.testing.assert_allclose(got[3][name], want[3][name],
                                   err_msg=name, **GRAD_TOL)


# -- beam search ---------------------------------------------------------------------
def _table_cell(P, table):
    """A cell whose outputs are the rows of ``table`` at the input ids."""
    class TableCell(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.table = P.to_tensor(table)

        def forward(self, inputs, states):
            out = P.gather(self.table, inputs)
            return out, (out,)
    return TableCell()


def _trace(P, dec, inits, steps):
    """Every step's tokens and parents, then the final lengths, log-probs
    and finished flags, by stepping ``dec`` directly."""
    inputs, states = dec.initialize(inits)
    toks, parents = [], []
    for t in range(steps):
        outputs, states, inputs, finished = dec.step(t, inputs, states)
        toks.append(_np(outputs[0]))
        parents.append(_np(outputs[1]))
    return (np.stack(toks), np.stack(parents), _np(states["lengths"]),
            _np(states["log_probs"]), _np(states["finished"]))


def _same_trace(got, want):
    for i in (0, 1, 2, 4):
        assert got[i].dtype == want[i].dtype, i
        np.testing.assert_array_equal(got[i], want[i], err_msg=str(i))
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6, atol=1e-4)


def _tie_table(vocab, end):
    """Scores with exact ties (equal rows) and an end token that wins
    from half the tokens, so beams finish early."""
    rng = np.random.RandomState(13)
    table = np.repeat(rng.randn(vocab // 2 + 1, vocab).astype("float32"),
                      2, axis=0)[:vocab] * 2.0
    table[::2, end] += 3.0
    return table


@pytest.mark.parametrize("vocab,beam", [(7, 3), (3, 4), (6, 6), (9, 1)],
                         ids=["v7b3", "vocab_below_beam", "v6b6", "greedy"])
def test_beam_search_trace_matches_reference(vocab, beam):
    table = _tie_table(vocab, vocab - 1)
    init = np.zeros((2, vocab), "float32")

    def trace(P):
        dec = P.nn.BeamSearchDecoder(_table_cell(P, table), 0, vocab - 1,
                                     beam)
        return _trace(P, dec, P.to_tensor(init), 6)
    got, want = trace(pt), trace(ref)
    _same_trace(got, want)
    assert want[4].any()      # some beam finished


@pytest.mark.parametrize("vocab,beam", [(7, 3), (3, 4)])
def test_dynamic_decode_matches_reference(vocab, beam):
    table = _tie_table(vocab, 0)
    init = np.zeros((3, vocab), "float32")

    def run(P):
        dec = P.nn.BeamSearchDecoder(_table_cell(P, table), 1, 0, beam)
        preds, states, lengths = P.nn.dynamic_decode(
            dec, inits=P.to_tensor(init), max_step_num=9,
            return_length=True)
        tm, _ = P.nn.dynamic_decode(
            P.nn.BeamSearchDecoder(_table_cell(P, table), 1, 0, beam),
            inits=P.to_tensor(init), max_step_num=9, output_time_major=True)
        return [_np(preds), _np(lengths), _np(states["finished"]), _np(tm)]
    for g, w in zip(run(pt), run(ref)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_beam_search_over_a_gru_cell_matches_reference():
    vocab, width = 8, 6

    def trace(P):
        emb = load(P, P.nn.Embedding(vocab, width), 14)
        cell = load(P, P.nn.GRUCell(width, width), 15)
        proj = load(P, P.nn.Linear(width, vocab), 16)
        dec = P.nn.BeamSearchDecoder(cell, 1, 0, 3, embedding_fn=emb,
                                     output_fn=proj)
        init = P.to_tensor(np.random.RandomState(17).randn(
            2, width).astype("float32"))
        return _trace(P, dec, init, 5)
    _same_trace(trace(pt), trace(ref))


def test_top_k_keeps_the_lower_index_first_among_ties():
    from paddle_tpu_torch.nn.decode import top_k_lower_index_first
    scores = torch.tensor([[1.0, 3.0, 3.0, -1e9, 3.0, -1e9 - 1.0, -1e9]])
    values, idx = top_k_lower_index_first(scores, 5)
    assert idx.tolist() == [[1, 2, 4, 0, 3]]
    assert values[0, 4].item() == -1e9


def _transformer_setup(P, beam, seed=0):
    d, vocab, batch = 16, 11, 2
    emb = load(P, P.nn.Embedding(vocab, d), 18)
    decoder = load(P, P.nn.TransformerDecoder(
        P.nn.TransformerDecoderLayer(d, 2, 32, dropout=0.0), 2), 19)
    proj = load(P, P.nn.Linear(d, vocab), 20)
    memory = P.to_tensor(np.random.RandomState(seed).randn(
        batch, 5, d).astype("float32"))

    def cell(ids, caches):
        x = emb(ids).unsqueeze(1)
        out, new_caches = decoder(x, cell.memory, cache=caches)
        return proj(out[:, 0]), new_caches
    mem = (P.nn.BeamSearchDecoder.tile_beam_merge_with_batch(memory, beam)
           if beam > 1 else memory)
    cell.memory = mem
    return cell, decoder, memory, mem


@pytest.mark.parametrize("beam", [1, 3])
def test_transformer_beam_search_matches_reference(beam):
    def run(P):
        cell, decoder, _, mem = _transformer_setup(P, beam)
        dec = P.nn.TransformerBeamSearchDecoder(cell, 1, 0, beam)
        trace = _trace(P, dec, decoder.gen_cache(mem), 5)
        cell, decoder, _, mem = _transformer_setup(P, beam)
        preds, _ = P.nn.dynamic_decode(
            P.nn.TransformerBeamSearchDecoder(cell, 1, 0, beam),
            inits=decoder.gen_cache(mem), max_step_num=6)
        return trace, _np(preds)
    (got, gp), (want, wp) = run(pt), run(ref)
    _same_trace(got, want)
    np.testing.assert_array_equal(gp, wp)


# -- the reference's own tests, through both packages ----------------------------------
@BOTH
def test_lstm(P):
    x = P.to_tensor(np.random.RandomState(0).randn(2, 5, 4).astype("float32"))
    out, (h, c) = P.nn.LSTM(4, 8, num_layers=2)(x)
    assert [list(t.shape) for t in (out, h, c)] == [[2, 5, 8], [2, 2, 8],
                                                    [2, 2, 8]]


@BOTH
def test_bilstm(P):
    x = P.to_tensor(np.random.RandomState(0).randn(2, 5, 4).astype("float32"))
    out, (h, c) = P.nn.LSTM(4, 8, direction="bidirect")(x)
    assert list(out.shape) == [2, 5, 16]


@BOTH
def test_gru_simplernn(P):
    x = P.to_tensor(np.random.RandomState(0).randn(2, 5, 4).astype("float32"))
    out, h = P.nn.GRU(4, 6)(x)
    assert list(out.shape) == [2, 5, 6]
    out, h = P.nn.SimpleRNN(4, 6)(x)
    assert list(out.shape) == [2, 5, 6]


@BOTH
def test_beam1_matches_greedy(P):
    tbl = np.random.RandomState(0).randn(7, 7).astype("float32") * 2.0
    cell = _table_cell(P, tbl)
    dec = P.nn.BeamSearchDecoder(cell, start_token=0, end_token=6,
                                 beam_size=1)
    preds, _ = P.nn.dynamic_decode(
        dec, inits=P.to_tensor(np.zeros((2, 7), "float32")), max_step_num=8)
    tok, greedy = 0, []
    for _ in range(preds.shape[1]):
        tok = int(np.argmax(tbl[tok]))
        greedy.append(tok)
        if tok == 6:
            break
    assert _np(preds)[0, :len(greedy), 0].tolist() == greedy


@BOTH
def test_beam_top_hypothesis_beats_greedy(P):
    v = 5
    tbl = np.full((v, v), -5.0, "float32")
    tbl[0, 1], tbl[0, 2] = 1.0, 0.9
    tbl[1] = [-5, -5, -5, -4.9, -5]
    tbl[2, 3] = tbl[3, 4] = 2.0
    tbl[4, 4] = 0.0
    init = P.to_tensor(np.zeros((1, v), "float32"))

    def best(beam):
        return _np(P.nn.dynamic_decode(
            P.nn.BeamSearchDecoder(_table_cell(P, tbl), 0, v - 1, beam),
            inits=init, max_step_num=3)[0])[0, :, 0]

    def score(seq):
        s, tok = 0.0, 0
        for t in seq:
            row = tbl[tok]
            s += row[t] - (np.log(np.exp(row - row.max()).sum()) + row.max())
            tok = t
        return s
    g, b = best(1), best(3)
    assert score(list(b)) >= score(list(g))
    assert list(b[:2]) == [2, 3]


@BOTH
def test_tile_beam_merge_with_batch(P):
    x = np.arange(6, dtype="float32").reshape(2, 3)
    t = P.nn.BeamSearchDecoder.tile_beam_merge_with_batch(P.to_tensor(x), 2)
    np.testing.assert_allclose(_np(t), np.repeat(x, 2, axis=0))


@BOTH
def test_beam_with_gru_cell_single_state(P):
    P.seed(0)
    dec = P.nn.BeamSearchDecoder(P.nn.GRUCell(6, 6), start_token=1,
                                 end_token=0, beam_size=2,
                                 embedding_fn=P.nn.Embedding(8, 6),
                                 output_fn=P.nn.Linear(6, 8))
    preds, _ = P.nn.dynamic_decode(
        dec, inits=P.to_tensor(np.zeros((3, 6), "float32")), max_step_num=4)
    assert preds.shape[0] == 3 and preds.shape[2] == 2


@BOTH
def test_transformer_shapes_and_beam1_greedy_parity(P):
    cell, decoder, _, mem = _transformer_setup(P, 3)
    preds, _ = P.nn.dynamic_decode(P.nn.TransformerBeamSearchDecoder(
        cell, 1, 0, 3), inits=decoder.gen_cache(mem), max_step_num=6)
    assert preds.shape[0] == 2 and preds.shape[2] == 3
    cell, decoder, memory, mem = _transformer_setup(P, 1)
    preds, _ = P.nn.dynamic_decode(P.nn.TransformerBeamSearchDecoder(
        cell, 1, 0, 1), inits=decoder.gen_cache(mem), max_step_num=6)
    caches = decoder.gen_cache(memory)
    tok = P.to_tensor(np.full((2,), 1, "int32"))
    greedy = []
    for _ in range(6):
        logits, caches = cell(tok, caches)
        tok = P.to_tensor(np.argmax(_np(logits), -1).astype("int32"))
        greedy.append(int(_np(tok)[0]))
        if greedy[-1] == 0:
            break
    assert _np(preds)[0, :len(greedy), 0].tolist() == greedy


@BOTH
def test_untiled_cache_raises(P):
    cell, decoder, memory, _ = _transformer_setup(P, 1)
    with pytest.raises(ValueError):
        P.nn.dynamic_decode(P.nn.TransformerBeamSearchDecoder(cell, 1, 0, 3),
                            inits=decoder.gen_cache(memory), max_step_num=2)


# -- C-ref-17: arguments the reference never reads raise -------------------------------
def _sequence_length_calls():
    x = torch.zeros(2, 3, 4)
    lengths = torch.tensor([3, 2])
    cell = pt.nn.GRUCell(4, 4, device="cpu")
    return {
        "SimpleRNN": lambda: pt.nn.SimpleRNN(4, 4, device="cpu")(
            x, sequence_length=lengths),
        "LSTM": lambda: pt.nn.LSTM(4, 4, device="cpu")(
            x, sequence_length=lengths),
        "GRU": lambda: pt.nn.GRU(4, 4, device="cpu")(
            x, sequence_length=lengths),
        "RNN": lambda: pt.nn.RNN(cell)(x, sequence_length=lengths),
        "BiRNN": lambda: pt.nn.BiRNN(cell, cell)(x, sequence_length=lengths),
    }


@pytest.mark.parametrize("name", ["SimpleRNN", "LSTM", "GRU", "RNN",
                                  "BiRNN"])
def test_sequence_length_raises(name):
    with pytest.raises(NotImplementedError, match="never reads"):
        _sequence_length_calls()[name]()


def test_var_dim_in_state_and_impute_finished_raise():
    with pytest.raises(NotImplementedError, match="C-ref-17"):
        pt.nn.TransformerBeamSearchDecoder(None, 1, 0, 2, var_dim_in_state=1)
    dec = pt.nn.BeamSearchDecoder(_table_cell(pt, np.zeros((3, 3),
                                                            "float32")),
                                  0, 2, 2)
    with pytest.raises(NotImplementedError, match="C-ref-17"):
        pt.nn.dynamic_decode(dec, inits=torch.zeros(1, 3),
                             impute_finished=True)
