"""Sequence decoding: Decoder, BeamSearchDecoder,
TransformerBeamSearchDecoder and dynamic_decode (port of
paddle_tpu/nn/decode.py).

The decode loop runs on the host over whole (batch * beam) tensor steps:
a step is the cell, a float32 log-softmax, the top ``beam`` of the
(beam * vocab) continuations of each source row, and gathers of the
cell's states along the chosen beams. At step 0 beams 1.. start at a
log-probability of -1e9, so the first expansion comes from one live
hypothesis; a finished beam may only emit ``end_token``, at no cost.
``dynamic_decode`` stops when every beam has finished (one host sync a
step, by the reference's design) or after ``max_step_num`` steps.

Ties are common (the -1e9 entries sit 64 apart, one float32 ulp there),
and the reference's ``lax.top_k`` puts the lower flat index first among
equal values, where ``torch.topk`` promises no order (and the host and
the card differ). The port takes a stable descending sort of each row's
beam * vocab scores and keeps its first ``beam``: the same rule as the
reference's, on any device.

The reference never reads ``impute_finished`` of dynamic_decode, nor a
``var_dim_in_state`` other than its default (its caches keep batch *
beam on the leading axis): both raise (ROADMAP C-ref-17).
"""
from __future__ import annotations

import torch

from ..amp.auto_cast import amp_cast

__all__ = ["Decoder", "BeamSearchDecoder", "TransformerBeamSearchDecoder",
           "dynamic_decode"]

NEG_BIG = -1e9


class Decoder:
    """The decode-step interface dynamic_decode drives."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        return outputs, final_states

    @property
    def tracks_own_finished(self):
        return False


def backtrack(tokens, parents):
    """Full sequences from (T, batch, beam) tokens and parent beams, by
    walking the parents back from the last step; each final beam's
    sequence in its column."""
    steps, batch, beam = tokens.shape
    cur = torch.arange(beam, dtype=parents.dtype,
                       device=parents.device).expand(batch, beam)
    seqs = []
    for t in range(steps - 1, -1, -1):
        seqs.append(tokens[t].gather(1, cur.long()))
        cur = parents[t].gather(1, cur.long())
    return torch.stack(seqs[::-1])


def top_k_lower_index_first(scores, k):
    """(values, indices) of the ``k`` largest entries of each row,
    largest first and, among equal values, the lower index first (the
    rule of lax.top_k)."""
    values, indices = torch.sort(scores, dim=-1, descending=True,
                                 stable=True)
    return values[:, :k], indices[:, :k]


def _tile(v, beam_size):
    # (B, ...) -> (B * beam, ...), each row repeated beam_size times
    return v.repeat_interleave(beam_size, dim=0)


class BeamSearchDecoder(Decoder):
    """Beam search over a cell with ``forward(inputs, states) ->
    (outputs, new_states)``; ``embedding_fn`` maps token ids to the
    cell's inputs, ``output_fn`` its outputs to vocabulary logits."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """(B, ...) -> (B * beam, ...): each row repeated ``beam_size``
        times, so every beam of a source row reads its row (encoder
        outputs)."""
        return _tile(x, beam_size)

    def _init_search(self, batch, device):
        lp0 = torch.full((batch, self.beam_size), NEG_BIG,
                         dtype=torch.float32, device=device)
        lp0[:, 0] = 0.0
        init = {"log_probs": lp0,
                "finished": torch.zeros((batch, self.beam_size),
                                        dtype=torch.bool, device=device),
                "lengths": torch.zeros((batch, self.beam_size),
                                       dtype=torch.int32, device=device)}
        ids = torch.full((batch * self.beam_size,), self.start_token,
                         dtype=torch.int32, device=device)
        return ids, init

    def initialize(self, initial_cell_states):
        states = initial_cell_states
        self._single_state = isinstance(states, torch.Tensor)
        if self._single_state:
            states = (states,)
        ids, init = self._init_search(states[0].shape[0], states[0].device)
        init["cell_states"] = tuple(_tile(s, self.beam_size) for s in states)
        return ids, init

    def _search(self, logits, states, new_cell_states):
        """One step of the search from the cell's ``logits`` ((batch *
        beam, vocab)) and new states (a tensor or a sequence of them):
        (outputs, next states, next inputs, finished)."""
        beam = self.beam_size
        logits, = amp_cast("beam_search_step", logits)
        vocab = logits.shape[-1]
        batch = logits.shape[0] // beam
        lps = torch.log_softmax(logits.float(), dim=-1).reshape(
            batch, beam, vocab)
        fin = states["finished"]
        # a finished beam may only emit end_token, at no cost
        fin_row = torch.full((vocab,), NEG_BIG, dtype=torch.float32,
                             device=lps.device)
        fin_row[self.end_token] = 0.0
        lps = torch.where(fin[:, :, None], fin_row, lps)
        total = states["log_probs"][:, :, None] + lps
        top_lp, top_idx = top_k_lower_index_first(
            total.reshape(batch, beam * vocab), beam)
        src_beam = (top_idx // vocab).to(torch.int32)
        tok = (top_idx % vocab).to(torch.int32)
        pick = src_beam.long()
        was_fin = fin.gather(1, pick)
        new_fin = was_fin | (tok == self.end_token)
        new_len = states["lengths"].gather(1, pick) \
            + (~was_fin).to(torch.int32)
        rows = (torch.arange(batch, device=pick.device)[:, None] * beam
                + pick).reshape(-1)
        if isinstance(new_cell_states, torch.Tensor):
            new_cell_states = (new_cell_states,)
        next_states = {
            "cell_states": tuple(s.index_select(0, rows)
                                 for s in new_cell_states),
            "log_probs": top_lp, "finished": new_fin, "lengths": new_len}
        return (tok, src_beam), next_states, tok.reshape(-1), new_fin

    def step(self, time, inputs, states, **kwargs):
        cell_in = self.embedding_fn(inputs) if self.embedding_fn else inputs
        cell_states = states["cell_states"]
        if getattr(self, "_single_state", False):
            cell_states = cell_states[0]
        cell_out, new_cell_states = self.cell(cell_in, cell_states)
        logits = self.output_fn(cell_out) if self.output_fn else cell_out
        return self._search(logits, states, new_cell_states)

    @property
    def tracks_own_finished(self):
        return True

    def finalize(self, outputs, final_states, sequence_lengths):
        """(batch, T, beam) predicted ids from the per-step tokens and
        parents, by backtracking."""
        toks, parents = outputs
        seqs = backtrack(torch.stack(toks), torch.stack(parents))
        return seqs.permute(1, 0, 2), final_states


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Step ``decoder`` until every hypothesis finishes or
    ``max_step_num`` (default 64) steps have run. Returns (outputs,
    final_states[, lengths])."""
    if impute_finished:
        raise NotImplementedError(
            "impute_finished=True: the reference never reads it (ROADMAP "
            "C-ref-17); finished beams already emit end_token at no cost")
    if max_step_num is None:
        max_step_num = 64
    inputs, states = decoder.initialize(inits)
    toks, parents = [], []
    for t in range(int(max_step_num)):
        outputs, states, inputs, finished = decoder.step(t, inputs, states,
                                                         **kwargs)
        toks.append(outputs[0])
        parents.append(outputs[1])
        if bool(finished.all()):
            break
    preds, final_states = decoder.finalize((toks, parents), states,
                                           states["lengths"])
    if output_time_major:
        preds = preds.permute(1, 0, 2)
    if return_length:
        return preds, final_states, final_states["lengths"]
    return preds, final_states


class TransformerBeamSearchDecoder(BeamSearchDecoder):
    """Beam search over a transformer decode step: ``cell(token_ids,
    caches) -> (logits, new_caches)``, the caches being
    TransformerDecoder.gen_cache's nested [layer][Cache(k, v)] structure,
    built from memory already tiled by ``tile_beam_merge_with_batch``
    (batch * beam on every cache tensor's leading axis)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 var_dim_in_state=2):
        if var_dim_in_state != 2:
            raise NotImplementedError(
                f"var_dim_in_state={var_dim_in_state}: the reference never "
                f"reads it; its caches keep batch * beam on the leading "
                f"axis (ROADMAP C-ref-17)")
        super().__init__(cell, start_token, end_token, beam_size)

    @staticmethod
    def _flatten_caches(caches):
        flat, spec = [], []
        for layer_cache in caches:
            if isinstance(layer_cache, (tuple, list)) and not hasattr(
                    layer_cache, "_fields"):
                spec.append([type(c) for c in layer_cache])
                for c in layer_cache:
                    flat.extend([c.k, c.v])
            else:
                spec.append([type(layer_cache)])
                flat.extend([layer_cache.k, layer_cache.v])
        return flat, spec

    @staticmethod
    def _rebuild_caches(flat, spec):
        out, i = [], 0
        for entry in spec:
            rebuilt = []
            for ctype in entry:
                rebuilt.append(ctype(flat[i], flat[i + 1]))
                i += 2
            out.append(rebuilt if len(rebuilt) > 1 else rebuilt[0])
        return out

    def initialize(self, initial_caches):
        """The caches come beam-tiled already, so nothing is tiled here;
        a leading axis that is not a multiple of the beam raises
        ValueError."""
        flat, self._spec = self._flatten_caches(initial_caches)
        self._single_state = False
        batch_beam = flat[0].shape[0]
        if batch_beam % self.beam_size:
            raise ValueError(
                f"cache leading dim {batch_beam} is not a multiple of "
                f"beam_size {self.beam_size}; tile memory with "
                f"tile_beam_merge_with_batch before gen_cache")
        ids, init = self._init_search(batch_beam // self.beam_size,
                                      flat[0].device)
        init["cell_states"] = tuple(flat)
        return ids, init

    def step(self, time, inputs, states, **kwargs):
        caches = self._rebuild_caches(list(states["cell_states"]), self._spec)
        logits, new_caches = self.cell(inputs, caches)
        return self._search(logits, states,
                            self._flatten_caches(new_caches)[0])
