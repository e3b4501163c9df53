"""paddle.text of the PyTorch/CUDA port against the JAX reference on the
host: every dataset and mode sample for sample (equality: the port
generates the reference's synthetic corpora from the same seeds, and
reads the same local files), viterbi_decode against the reference and a
brute force (paths equal, scores within 1e-5), the C-ref-20 pin
(``include_bos_eos_tag`` is never read: True and False decode alike in
both packages), and the tokenizer's ids and segment ids equal to the
reference's on tests/test_tokenizer.py's cases and on accents, CJK,
control characters and pair truncation.
"""
import io
import itertools
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt


@pytest.fixture(autouse=True)
def _on_host():
    before = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(before)


def val(t):
    return np.asarray(t.numpy())


def assert_samples_equal(rds, pds):
    assert len(rds) == len(pds)
    for i in range(len(rds)):
        r, p = rds[i], pds[i]
        r = r if isinstance(r, tuple) else (r,)
        p = p if isinstance(p, tuple) else (p,)
        assert len(r) == len(p)
        for a, b in zip(r, p):
            assert type(a) is type(b) and np.asarray(a).dtype == \
                np.asarray(b).dtype, (i, type(a), type(b))
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


DATASETS = [("Imdb", {}), ("Imikolov", {}), ("Imikolov", {"window_size": 3}),
            ("UCIHousing", {}), ("Conll05st", {}), ("Movielens", {}),
            ("WMT14", {}), ("WMT14", {"dict_size": 500}), ("WMT16", {}),
            ("WMT16", {"src_dict_size": 300, "trg_dict_size": 200})]


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("name,kw", DATASETS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(DATASETS)])
def test_datasets_equal_reference(name, kw, mode):
    rds = getattr(ref.text, name)(mode=mode, **kw)
    pds = getattr(pt.text, name)(mode=mode, **kw)
    assert isinstance(pds, pt.io.Dataset)
    assert_samples_equal(rds, pds)
    for attr in ("vocab_size", "word_idx", "src_vocab_size",
                 "trg_vocab_size", "word_dict_len", "label_dict_len",
                 "max_usr_id", "max_mov_id"):
        if hasattr(rds, attr):
            assert getattr(pds, attr) == getattr(rds, attr), attr


def test_wmt_targets_framed_with_bos():
    src, trg_in, trg_out = pt.text.WMT16(mode="train")[0]
    assert src.shape == trg_in.shape == trg_out.shape
    assert trg_in[0] == 1
    np.testing.assert_array_equal(trg_in[1:], trg_out[:-1])


def test_local_files_read_as_reference(tmp_path):
    path = tmp_path / "aclImdb.tar"
    docs = {"aclImdb/train/pos/0.txt": "A fine film , a FINE film",
            "aclImdb/train/neg/1.txt": "dull dull plot",
            "aclImdb/test/pos/2.txt": "ok",
            "aclImdb/train/unsup/3.txt": "skipped"}
    with tarfile.open(path, "w") as tf:
        for name, text in docs.items():
            data = text.encode()
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    for mode in ("train", "test"):
        assert_samples_equal(ref.text.Imdb(str(path), mode=mode),
                             pt.text.Imdb(str(path), mode=mode))
    table = tmp_path / "housing.data"
    np.savetxt(table, np.random.RandomState(0).rand(20, 14))
    for mode in ("train", "test"):
        assert_samples_equal(ref.text.UCIHousing(str(table), mode=mode),
                             pt.text.UCIHousing(str(table), mode=mode))


def test_dataloader_collates_text_samples():
    ds = pt.text.Conll05st(mode="test")
    words, preds, marks, labels = next(iter(pt.io.DataLoader(
        ds, batch_size=8, shuffle=False)))
    assert isinstance(words, torch.Tensor) and words.dtype == torch.int64
    np.testing.assert_array_equal(words.numpy(), ds.words[:8])
    np.testing.assert_array_equal(labels.numpy(), ds.labels[:8])


# -- viterbi_decode ----------------------------------------------------------
def brute_force(pot, trans, length):
    best, best_path = -np.inf, None
    for p in itertools.product(range(pot.shape[1]), repeat=length):
        s = pot[0, p[0]] + sum(trans[p[t - 1], p[t]] + pot[t, p[t]]
                               for t in range(1, length))
        if s > best:
            best, best_path = s, p
    return best, best_path


@pytest.mark.parametrize("B,S,T,with_lengths", [
    (2, 5, 4, False), (4, 6, 3, True), (3, 1, 5, False), (5, 9, 6, True)])
def test_viterbi_matches_reference_and_brute_force(B, S, T, with_lengths):
    rng = np.random.RandomState(B * S * T)
    pot = rng.randn(B, S, T).astype("float32")
    trans = rng.randn(T, T).astype("float32")
    lens = (rng.randint(1, S + 1, B).astype("int64") if with_lengths
            else np.full(B, S, "int64"))
    rargs = [ref.to_tensor(pot), ref.to_tensor(trans)]
    pargs = [torch.tensor(pot), torch.tensor(trans)]
    if with_lengths:
        rargs.append(ref.to_tensor(lens))
        pargs.append(torch.tensor(lens))
    rs, rp = ref.text.viterbi_decode(*rargs)
    ps, pp = pt.text.viterbi_decode(*pargs)
    assert pp.dtype == torch.int32 and ps.dtype == torch.float32
    assert pp.shape == (B, S) and ps.shape == (B,)
    np.testing.assert_array_equal(pp.numpy(), val(rp))
    np.testing.assert_allclose(ps.numpy(), val(rs), rtol=1e-5, atol=1e-5)
    if S <= 6:
        for b in range(B):
            best, path = brute_force(pot[b], trans, int(lens[b]))
            assert ps[b].item() == pytest.approx(best, rel=1e-5)
            assert pp[b, :lens[b]].tolist() == list(path)
            # past its length a row repeats its last real tag
            assert (pp[b, lens[b]:] == path[-1]).all()


def test_viterbi_lengths_freeze_padding():
    """tests/test_regressions.py::test_viterbi_lengths_respected on the
    port: emissions past a row's length do not matter."""
    rng = np.random.RandomState(0)
    pot = rng.randn(2, 5, 3).astype("float32")
    trans = rng.randn(3, 3).astype("float32")
    pot2 = pot.copy()
    pot2[:, 2:] = 1e3 * rng.randn(2, 3, 3)
    lens = torch.tensor([2, 2])
    s_a, p_a = pt.text.viterbi_decode(torch.tensor(pot), torch.tensor(trans),
                                      lens)
    s_b, p_b = pt.text.viterbi_decode(torch.tensor(pot2),
                                      torch.tensor(trans), lens)
    torch.testing.assert_close(s_a, s_b)
    assert torch.equal(p_a[:, :2], p_b[:, :2])
    s_ref, _ = pt.text.viterbi_decode(torch.tensor(pot[:, :2]),
                                      torch.tensor(trans))
    torch.testing.assert_close(s_a, s_ref)


def test_viterbi_bos_eos_flag_unread_in_both():
    """C-ref-20 (mirrored): the reference never reads
    include_bos_eos_tag; True and False give the same plain Viterbi in
    both packages, also through ViterbiDecoder."""
    rng = np.random.RandomState(3)
    pot = rng.randn(3, 6, 5).astype("float64")
    trans = rng.randn(5, 5).astype("float64")
    out = {}
    for flag in (True, False):
        rs, rp = ref.text.viterbi_decode(ref.to_tensor(pot),
                                         ref.to_tensor(trans),
                                         include_bos_eos_tag=flag)
        dec = pt.text.ViterbiDecoder(torch.tensor(trans),
                                     include_bos_eos_tag=flag)
        ps, pp = dec(torch.tensor(pot))
        assert ps.dtype == torch.float64
        out[flag] = (val(rs), val(rp), ps.numpy(), pp.numpy())
    for a, b in zip(out[True], out[False]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out[True][3], out[True][1])


def test_text_namespace_binds_the_function():
    import importlib

    import paddle_tpu_torch.text.viterbi_decode  # noqa: F401
    assert callable(pt.text.viterbi_decode)
    mod = importlib.import_module("paddle_tpu_torch.text.viterbi_decode")
    assert mod.viterbi_decode is pt.text.viterbi_decode
    assert set(pt.text.__all__) == set(ref.text.__all__)


# -- the tokenizer -----------------------------------------------------------
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "the", "quick", "brown", "fox", "jump", "##s", "##ed", "over",
         "lazy", "dog", "un", "##want", "##able", "run", "##ning", ",",
         ".", "!", "hello", "world", "你", "好", "cafe", "naive", "resume",
         "##e", "?", "(", ")", "Hello", "world", "é"]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return str(p)


TEXTS = ["The quick brown fox jumps over the lazy dog.",
         "unwantable zebra running!", "你好", "hello, 你好 world",
         "Café naïve RÉSUMÉ (the dog)?", "hello\x00wor​ld\tthe\x07 fox",
         "the　dog\xa0run�ning", "", "    ",
         "a" * 120 + " the", "Hello World"]
PAIRS = [("hello world", "the fox"), ("the dog", "hello"),
         ("the quick brown fox jumps over the lazy dog",
          "unwantable running dog"),
         ("the", "the quick brown fox jumps over the lazy dog again")]


def tokenizers(vocab_file, **kw):
    return (ref.text.FasterTokenizer(ref.text.Vocab.load_vocabulary(
                vocab_file), **kw),
            pt.text.FasterTokenizer(pt.text.Vocab.load_vocabulary(
                vocab_file), **kw))


def assert_same_ids(rout, pout):
    for r, p in zip(rout, pout):
        assert p.dtype == torch.int64 and p.device.type == "cpu"
        np.testing.assert_array_equal(p.numpy(), val(r))


@pytest.mark.parametrize("lower", [True, False])
def test_tokenizer_single_texts_match_reference(vocab_file, lower):
    rtok, ptok = tokenizers(vocab_file, do_lower_case=lower)
    for text in TEXTS:
        assert_same_ids(rtok(text), ptok(text))
    assert_same_ids(rtok(TEXTS), ptok(TEXTS))
    for n in (2, 3, 6, 8):
        assert_same_ids(rtok(TEXTS, max_seq_len=n),
                        ptok(TEXTS, max_seq_len=n))
        assert_same_ids(rtok(TEXTS, max_seq_len=n, pad_to_max_seq_len=True),
                        ptok(TEXTS, max_seq_len=n, pad_to_max_seq_len=True))


def test_tokenizer_pairs_truncate_longest_first(vocab_file):
    rtok, ptok = tokenizers(vocab_file)
    a, b = [p[0] for p in PAIRS], [p[1] for p in PAIRS]
    assert_same_ids(rtok(a, text_pair=b), ptok(a, text_pair=b))
    for n in (5, 7, 10, 16):
        for pad in (False, True):
            kw = dict(max_seq_len=n, pad_to_max_seq_len=pad)
            assert_same_ids(rtok(a, text_pair=b, **kw),
                            ptok(a, text_pair=b, **kw))
    ids, seg = ptok(["hello world"], text_pair=["the fox"], max_seq_len=10,
                    pad_to_max_seq_len=True)
    assert [VOCAB[i] for i in ids[0].tolist()] == [
        "[CLS]", "hello", "world", "[SEP]", "the", "fox", "[SEP]",
        "[PAD]", "[PAD]", "[PAD]"]
    assert seg[0].tolist() == [0, 0, 0, 0, 1, 1, 1, 0, 0, 0]
    for P in (ref, pt):
        with pytest.raises(ValueError):
            P.text.FasterTokenizer(dict(zip(VOCAB, range(len(VOCAB)))))(
                ["a", "b"], text_pair=["c"])


def test_tokenizer_parts_match_reference(vocab_file):
    rv = ref.text.Vocab.load_vocabulary(vocab_file, unk_token="[UNK]")
    pv = pt.text.Vocab.load_vocabulary(vocab_file, unk_token="[UNK]")
    assert pv.token_to_idx == rv.token_to_idx and len(pv) == len(rv)
    assert pv.to_indices(["the", "zebra"]) == rv.to_indices(["the", "zebra"])
    assert pv.to_indices("fox") == rv.to_indices("fox")
    assert ("##s" in pv) and ("zebra" not in pv)
    d = {t: i for i, t in enumerate(VOCAB)}
    assert pt.text.Vocab.from_dict(d).idx_to_token == \
        ref.text.Vocab.from_dict(d).idx_to_token
    for text in TEXTS:
        for lower in (True, False):
            assert pt.text.BasicTokenizer(lower).tokenize(text) == \
                ref.text.BasicTokenizer(lower).tokenize(text)
    for word in ("unwantable", "running", "zebra", "x" * 101, "jumps"):
        for limit in (100, 5):
            assert pt.text.WordpieceTokenizer(pv, max_input_chars_per_word=
                                              limit).tokenize(word) == \
                ref.text.WordpieceTokenizer(rv, max_input_chars_per_word=
                                            limit).tokenize(word)
    words = [["the", "quick", "jumps"], ["hello", "zebra"]]
    rtok, ptok = tokenizers(vocab_file, is_split_into_words=True)
    assert_same_ids(rtok(words), ptok(words))
