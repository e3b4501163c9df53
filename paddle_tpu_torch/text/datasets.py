"""The NLP datasets (port of paddle_tpu/text/datasets.py): Imdb, Imikolov,
UCIHousing, Conll05st, Movielens, WMT14 and WMT16, and ``viterbi_decode``
with ``ViterbiDecoder``.

Each dataset reads a local ``data_file`` where the reference does (Imdb's
aclImdb tar, UCIHousing's table) and otherwise generates the reference's
synthetic corpus from the same ``np.random.RandomState`` seeds (10 to 22
by dataset and mode), so every sample equals the reference's. Samples are
numpy, as there; ``io.DataLoader`` collates them into tensors.
"""
from __future__ import annotations

import os
import tarfile

import numpy as np
import torch

from ..io import Dataset

__all__ = ["Imdb", "Imikolov", "UCIHousing", "Conll05st", "Movielens",
           "WMT14", "WMT16", "ViterbiDecoder", "viterbi_decode"]


class Imdb(Dataset):
    """Binary sentiment classification; samples = (ids int64[seq], label)."""

    def __init__(self, data_file=None, mode="train", cutoff=150):
        self.mode = mode
        self.vocab_size = 5000
        self.seq_len = 64
        if data_file and os.path.exists(data_file):
            self.docs, self.labels = self._load_tar(data_file, mode, cutoff)
        else:
            rng = np.random.RandomState(10 if mode == "train" else 11)
            n = 2048
            self.labels = rng.randint(0, 2, n).astype("int64")
            # class-conditional token distributions so models can learn
            base = rng.randint(0, self.vocab_size // 2, (n, self.seq_len))
            shift = (self.labels[:, None] * (self.vocab_size // 2))
            self.docs = (base + shift).astype("int64")
        self.word_idx = {f"w{i}": i for i in range(self.vocab_size)}

    def _load_tar(self, path, mode, cutoff):
        pat = f"aclImdb/{mode}/"
        docs, labels = [], []
        vocab = {}
        with tarfile.open(path) as tf:
            for m in tf.getmembers():
                if not m.name.startswith(pat) or not m.name.endswith(".txt"):
                    continue
                if "/pos/" in m.name:
                    y = 1
                elif "/neg/" in m.name:
                    y = 0
                else:
                    continue
                text = tf.extractfile(m).read().decode("utf8", "ignore")
                ids = []
                for w in text.lower().split()[:self.seq_len]:
                    if w not in vocab:
                        vocab[w] = len(vocab) % self.vocab_size
                    ids.append(vocab[w])
                ids += [0] * (self.seq_len - len(ids))
                docs.append(ids)
                labels.append(y)
        return (np.asarray(docs, dtype="int64"),
                np.asarray(labels, dtype="int64"))

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.labels)


class Imikolov(Dataset):
    """PTB-style n-gram LM dataset; samples = tuple of n int64 ids."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=50):
        self.window_size = window_size
        rng = np.random.RandomState(12 if mode == "train" else 13)
        self.vocab_size = 2000
        n = 4096
        # markov-ish stream: next token depends on previous
        stream = np.zeros(n + window_size, dtype="int64")
        for i in range(1, len(stream)):
            stream[i] = (stream[i - 1] * 31 + rng.randint(0, 17)) % self.vocab_size
        self._windows = np.lib.stride_tricks.sliding_window_view(
            stream, window_size)[:n]
        self.word_idx = {f"w{i}": i for i in range(self.vocab_size)}

    def __getitem__(self, idx):
        w = self._windows[idx]
        return tuple(np.asarray(t, dtype="int64") for t in w)

    def __len__(self):
        return len(self._windows)


class UCIHousing(Dataset):
    """Boston housing regression; samples = (feature f32[13], price f32[1])."""

    def __init__(self, data_file=None, mode="train"):
        if data_file and os.path.exists(data_file):
            raw = np.loadtxt(data_file).astype("float32")
        else:
            rng = np.random.RandomState(14)
            n = 506
            x = rng.randn(n, 13).astype("float32")
            w = rng.randn(13).astype("float32")
            y = x @ w + 0.1 * rng.randn(n).astype("float32")
            raw = np.concatenate([x, y[:, None]], axis=1)
        split = int(len(raw) * 0.8)
        raw = raw[:split] if mode == "train" else raw[split:]
        feats = raw[:, :-1]
        mu, sigma = feats.mean(0), feats.std(0) + 1e-8
        self.features = ((feats - mu) / sigma).astype("float32")
        self.prices = raw[:, -1:].astype("float32")

    def __getitem__(self, idx):
        return self.features[idx], self.prices[idx]

    def __len__(self):
        return len(self.prices)


class Conll05st(Dataset):
    """SRL dataset; samples = (word_ids, pred_ids, *ctx_n, mark, label_ids)."""

    def __init__(self, data_file=None, word_dict_file=None,
                 verb_dict_file=None, target_dict_file=None, mode="train"):
        rng = np.random.RandomState(15 if mode == "train" else 16)
        self.word_dict_len = 4000
        self.label_dict_len = 59
        self.pred_len = 300
        n, seq = 1024, 30
        self.words = rng.randint(0, self.word_dict_len, (n, seq)).astype("int64")
        self.preds = rng.randint(0, self.pred_len, (n, seq)).astype("int64")
        self.marks = rng.randint(0, 2, (n, seq)).astype("int64")
        self.labels = rng.randint(0, self.label_dict_len, (n, seq)).astype("int64")

    def __getitem__(self, idx):
        return (self.words[idx], self.preds[idx], self.marks[idx],
                self.labels[idx])

    def __len__(self):
        return len(self.words)


class Movielens(Dataset):
    """ML-1M rating prediction; samples = (user feats…, movie feats…, score)."""

    def __init__(self, data_file=None, mode="train", test_ratio=0.1,
                 rand_seed=0):
        rng = np.random.RandomState(17 if mode == "train" else 18)
        n = 4096
        self.max_usr_id = 6040
        self.max_mov_id = 3952
        self.user_ids = rng.randint(1, self.max_usr_id + 1, n).astype("int64")
        self.genders = rng.randint(0, 2, n).astype("int64")
        self.ages = rng.randint(0, 7, n).astype("int64")
        self.jobs = rng.randint(0, 21, n).astype("int64")
        self.mov_ids = rng.randint(1, self.max_mov_id + 1, n).astype("int64")
        self.categories = rng.randint(0, 18, (n, 3)).astype("int64")
        self.titles = rng.randint(0, 5000, (n, 5)).astype("int64")
        # score correlated with ids so a factorization model can learn
        self.scores = ((self.user_ids % 5 + self.mov_ids % 5) / 2.0 + 0.5
                       ).astype("float32")[:, None]

    def __getitem__(self, idx):
        return (self.user_ids[idx], self.genders[idx], self.ages[idx],
                self.jobs[idx], self.mov_ids[idx], self.categories[idx],
                self.titles[idx], self.scores[idx])

    def __len__(self):
        return len(self.scores)


class _SyntheticTranslation(Dataset):
    def __init__(self, seed, src_vocab, trg_vocab, n=2048, seq=20):
        rng = np.random.RandomState(seed)
        self.src_vocab_size = src_vocab
        self.trg_vocab_size = trg_vocab
        self.src = rng.randint(3, src_vocab, (n, seq)).astype("int64")
        # target = deterministic function of source (learnable mapping)
        self.trg = ((self.src * 7 + 11) % (trg_vocab - 3) + 3).astype("int64")

    def __getitem__(self, idx):
        src = self.src[idx]
        trg = self.trg[idx]
        # (src, trg_in, trg_out) with BOS=1/EOS=2 framing
        trg_in = np.concatenate([[1], trg[:-1]]).astype("int64")
        return src, trg_in, trg

    def __len__(self):
        return len(self.src)


class WMT14(_SyntheticTranslation):
    def __init__(self, data_file=None, mode="train", dict_size=30000):
        super().__init__(19 if mode == "train" else 20, dict_size, dict_size)


class WMT16(_SyntheticTranslation):
    def __init__(self, data_file=None, mode="train", src_dict_size=30000,
                 trg_dict_size=30000, lang="en"):
        super().__init__(21 if mode == "train" else 22, src_dict_size,
                         trg_dict_size)


# -- Viterbi decoding ----------------------------------------------------------
def viterbi_decode(potentials, transition_params, lengths=None,
                   include_bos_eos_tag=True, name=None):
    """(scores, paths) of the best tag sequence of each batch row.

    potentials (B, S, T) emission scores, transition_params (T, T),
    lengths (B,) (default: S each). Plain Viterbi: no start or stop
    transitions whatever ``include_bos_eos_tag`` says, which the reference
    never reads (ROADMAP C-ref-20). Past its length a row's alpha is
    frozen and its backpointer is the identity, so the backtrace carries
    its last real tag through the padding. ``scores`` have the
    potentials' dtype, ``paths`` are int32 (B, S). The scan is a loop over
    S on the device, forward then back: about 4 S launches a call, none
    read on the host.
    """
    B, S, T = potentials.shape
    dev = potentials.device
    lens = (torch.full((B,), S, device=dev) if lengths is None
            else lengths.to(dev))[:, None]
    trans = transition_params.to(potentials.dtype)[None]
    ident = torch.arange(T, device=dev).expand(B, T)
    alpha = potentials[:, 0]
    backps = []
    for t in range(1, S):
        best, best_prev = torch.max(alpha[:, :, None] + trans, dim=1)
        active = t < lens
        alpha = torch.where(active, best + potentials[:, t], alpha)
        backps.append(torch.where(active, best_prev, ident))
    scores, tag = torch.max(alpha, dim=-1)
    tags = [tag]
    for backp in reversed(backps):
        tag = backp.gather(1, tag[:, None])[:, 0]
        tags.append(tag)
    return scores, torch.stack(tags[::-1], dim=1).to(torch.int32)


class ViterbiDecoder:
    """Viterbi decoding with fixed transitions (``viterbi_decode``)."""

    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def __call__(self, potentials, lengths=None):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)
