"""The port's text stages (``flink_ml_tpu_torch.models.feature.tokenize``,
``.text`` and ``utils.native_text``) against the JAX package's on the same
seeded numpy inputs, after ``tests/test_tokenize.py``, ``test_text.py``
and ``test_native_text.py``.

Tolerances: the host stages (tokenizers, CountVectorizer, HashingTF,
FeatureHasher, IndexToString, IDF's fit) equal the JAX package's bit for
bit: tokens, vocabularies in their tie order, counts, hashes and float64
dtypes.  ``IDFModel.transform`` rounds tf and idf to f32 and multiplies
once in both packages, so it is bit for bit too.  The text example's
LogisticRegression fit (SGD in f32, another summation order) is held
within allclose rtol 1e-3, atol 1e-4.  The port runs on the CPU."""

import json
import shutil

import numpy as np
import pytest

import flink_ml_tpu as J
import flink_ml_tpu_torch as T
from flink_ml_tpu.models import feature as JF
from flink_ml_tpu.models.feature import text as JT
from flink_ml_tpu.utils import native_text as JN
from flink_ml_tpu_torch.models import feature as TF
from flink_ml_tpu_torch.models.feature import text as TT
from flink_ml_tpu_torch.models.feature import tokenize as TK
from flink_ml_tpu_torch.models.feature.transforms import _OnDevice
from flink_ml_tpu_torch.utils import native_text as TN
from flink_ml_tpu_torch.utils.convert import feature_model_from_jax

FIT_TOL = dict(rtol=1e-3, atol=1e-4)

WORDS = ["alpha", "Beta", "GAMMA", "delta", "the", "and", "A", "an", "café",
         "x", "yy", "zzz", "don't", "Ünïcode", "it's", "THE"]


def _new(pkg, name):
    cls = getattr(pkg, name)
    if pkg is TF and issubclass(cls, _OnDevice):
        return cls(device="cpu")
    return cls()


def _both(name, configure=lambda s: s):
    return configure(_new(JF, name)), configure(_new(TF, name))


def _tables(cols):
    return J.Table(dict(cols)), T.Table(dict(cols))


def _texts(n=60, seed=0):
    """Documents with runs of spaces, tabs, newlines, punctuation and
    mixed case (the tokenizers' edge cases)."""
    rng = np.random.default_rng(seed)
    seps = [" ", "  ", "\t", "\n", ", ", "-", " . ", "!  "]
    docs = []
    for _ in range(n):
        k = int(rng.integers(0, 14))
        parts = [str(rng.choice(WORDS)) + str(rng.choice(seps))
                 for _ in range(k)]
        docs.append("".join(parts) + ("  " if rng.random() < 0.3 else ""))
    return np.asarray(docs, dtype=object)


def _token_lists(n=80, vocab=40, seed=1, max_len=30):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    col = np.empty((n,), object)
    for i in range(n):
        # zipf-ish: low ids far more frequent, so frequencies tie in the tail
        ids = np.minimum(rng.zipf(1.6, size=int(rng.integers(0, max_len))),
                         vocab) - 1
        col[i] = [words[j] for j in ids]
    return col


def _for_jax(tmp_path, src):
    """A copy of the port-saved directory ``src`` whose metadata names the
    JAX package's class."""
    dst = tmp_path / "for_jax"
    shutil.copytree(src, dst)
    meta_path = dst / "metadata"
    meta = json.loads(meta_path.read_text())
    assert meta["className"].startswith("flink_ml_tpu_torch.")
    meta["className"] = "flink_ml_tpu." + \
        meta["className"][len("flink_ml_tpu_torch."):]
    meta_path.write_text(json.dumps(meta))
    return str(dst)


def _same_tokens(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert list(x) == list(y)


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


# -- native hashing --------------------------------------------------------

STRINGS = ["", "a", "some token", "café ☕", "colname=value", "x" * 1000,
           "C7=0a1b2c3d"]


def test_fnv1a_equal_in_both_packages_and_native():
    py = np.asarray([TT._fnv1a(s) for s in STRINGS], np.uint64)
    _same_bits(py, np.asarray([JT._fnv1a(s) for s in STRINGS], np.uint64))
    assert TN.native_available()
    _same_bits(TN.fnv1a_batch(STRINGS), py)
    _same_bits(TN.fnv1a_batch(STRINGS), JN.fnv1a_batch(STRINGS))


@pytest.mark.parametrize("binary", [False, True])
def test_native_hashing_tf_equals_jax_and_python_loop(binary):
    docs = _token_lists(40, seed=3)
    docs[0] = ["café", "b", "café"]
    docs[1] = []
    m = 64
    got = TN.hashing_tf(docs, m, binary)
    _same_bits(got, JN.hashing_tf(docs, m, binary))
    loop = np.zeros((len(docs), m))
    for i, doc in enumerate(docs):
        for tok in doc:
            loop[i, TT._fnv1a(tok) % m] += 1.0
    _same_bits(got, (loop > 0).astype(np.float64) if binary else loop)


def test_native_entry_points_say_none_without_the_library(monkeypatch):
    monkeypatch.setattr(TN, "_native_lib", lambda: None)
    assert not TN.native_available()
    assert TN.fnv1a_batch(["a"]) is None
    assert TN.hashing_tf(_token_lists(2), 8, False) is None


# -- tokenizers -------------------------------------------------------------

def test_tokenizer_equal():
    jt, tt = _tables({"input": _texts()})
    js, ts = _both("Tokenizer", lambda s: s.set_features_col("input"))
    _same_tokens(js.transform(jt)[0]["output"], ts.transform(tt)[0]["output"])
    assert TF.Tokenizer().transform(T.Table({"features": np.asarray(
        ["Hello  World", "tail  "], object)}))[0]["output"][0] == \
        ["hello", "", "world"]


@pytest.mark.parametrize("pattern,gaps,min_len,lower", [
    (r"\s+", True, 1, True),
    (r"[-\s,.!]+", True, 1, True),
    (r"[-\s,.!]+", True, 3, False),
    (r"\w+", False, 1, True),
    (r"\w+", False, 2, False),
    (r"[a-z']+", False, 0, True),
])
def test_regex_tokenizer_equal(pattern, gaps, min_len, lower):
    def cfg(s):
        return (s.set_pattern(pattern).set_gaps(gaps)
                .set_min_token_length(min_len).set_to_lowercase(lower))

    jt, tt = _tables({"features": _texts(seed=2)})
    js, ts = _both("RegexTokenizer", cfg)
    _same_tokens(js.transform(jt)[0]["output"], ts.transform(tt)[0]["output"])


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_ngram_equal(n):
    jt, tt = _tables({"features": _token_lists(seed=4, max_len=8)})
    js, ts = _both("NGram", lambda s: s.set_n(n))
    _same_tokens(js.transform(jt)[0]["output"], ts.transform(tt)[0]["output"])


@pytest.mark.parametrize("case_sensitive,words", [
    (False, None), (True, None), (False, ("Alpha", "GAMMA", "x")),
    (True, ("Alpha", "GAMMA", "x", "THE"))])
def test_stop_words_remover_equal(case_sensitive, words):
    def cfg(s):
        s = s.set_case_sensitive(case_sensitive)
        return s if words is None else s.set_stop_words(*words)

    toks = JF.Tokenizer().transform(J.Table({"features": _texts(seed=5)}))[0]
    jt, tt = _tables({"features": toks["output"]})
    js, ts = _both("StopWordsRemover", cfg)
    _same_tokens(js.transform(jt)[0]["output"], ts.transform(tt)[0]["output"])


def test_default_stop_words_and_language_error():
    assert TF.StopWordsRemover.load_default_stop_words() == \
        JF.StopWordsRemover.load_default_stop_words()
    assert TK._ENGLISH_STOP_WORDS == \
        __import__("flink_ml_tpu.models.feature.tokenize",
                   fromlist=["x"])._ENGLISH_STOP_WORDS
    for pkg in (JF, TF):
        with pytest.raises(ValueError, match="no built-in stop words for "
                           "language 'klingon'"):
            pkg.StopWordsRemover.load_default_stop_words("klingon")


# -- CountVectorizer --------------------------------------------------------

@pytest.mark.parametrize("params", [
    {},
    {"vocabulary_size": 7},
    {"min_df": 3.0},
    {"min_df": 0.2, "max_df": 0.9},
    {"max_df": 10.0},
    {"min_tf": 2.0},
    {"min_tf": 0.1},
    {"binary": True},
    {"vocabulary_size": 12, "min_df": 2.0, "min_tf": 0.05, "binary": True},
])
def test_count_vectorizer_equal(params):
    def cfg(s):
        for k, v in params.items():
            getattr(s, f"set_{k}")(v)
        return s

    jt, tt = _tables({"features": _token_lists(seed=6)})
    js, ts = _both("CountVectorizer", cfg)
    jm, tm = js.fit(jt), ts.fit(tt)
    # tie order: (-term frequency, term) in both packages
    assert tm.vocabulary == jm.vocabulary
    _same_bits(jm.transform(jt)[0]["output"], tm.transform(tt)[0]["output"])


def test_count_vectorizer_tie_order_is_lexical():
    col = np.empty((3,), object)
    col[0], col[1], col[2] = ["b", "c", "a"], ["c", "a", "b"], ["d", "e"]
    model = TF.CountVectorizer().fit(T.Table({"features": col}))
    assert model.vocabulary == ["a", "b", "c", "d", "e"]
    assert model.vocabulary == JF.CountVectorizer().fit(
        J.Table({"features": col})).vocabulary


def test_count_vectorizer_model_needs_data():
    for pkg in (JF, TF):
        with pytest.raises(RuntimeError, match="no model data"):
            pkg.CountVectorizerModel().transform(
                T.Table({"features": _token_lists(2)}))


# -- HashingTF / IDF ---------------------------------------------------------

@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("native", [True, False])
def test_hashing_tf_equal(monkeypatch, binary, native):
    """The stage gives the same bits through the native fill and through
    the per-byte Python loop, and equals the JAX package's."""
    if not native:
        monkeypatch.setattr(TN, "hashing_tf", lambda *a: None)
    docs = _token_lists(seed=7)
    docs[0] = ["café", "Ünïcode", "café"]
    jt, tt = _tables({"features": docs})
    js, ts = _both("HashingTF",
                   lambda s: s.set_num_features(50).set_binary(binary))
    _same_bits(js.transform(jt)[0]["output"], ts.transform(tt)[0]["output"])


@pytest.mark.parametrize("min_doc_freq", [0, 2, 10])
def test_idf_equal_bit_for_bit(min_doc_freq):
    counts = JF.CountVectorizer().fit(J.Table({"features": _token_lists(
        seed=8)})).transform(J.Table({"features": _token_lists(seed=8)})
                             )[0]["output"]
    jt, tt = _tables({"features": counts})
    js, ts = _both("IDF", lambda s: s.set_min_doc_freq(min_doc_freq))
    jm, tm = js.fit(jt), ts.fit(tt)
    _same_bits(jm.get_model_data()[0]["idf"], tm.get_model_data()[0]["idf"])
    _same_bits(jm.transform(jt)[0]["output"], tm.transform(tt)[0]["output"])


def test_idf_model_needs_data_and_a_card():
    with pytest.raises(RuntimeError, match="no model data"):
        TF.IDFModel(device="cpu").transform(T.Table({"features": np.ones(
            (2, 2))}))


# -- FeatureHasher ----------------------------------------------------------

def _mixed_columns(n=50, seed=9):
    rng = np.random.default_rng(seed)
    return {
        "age": rng.normal(size=n) * 10,
        "count": rng.integers(0, 5, size=n),
        "city": rng.choice(["sf", "nyc", "café", "la"], size=n),
        "tag": np.asarray(rng.choice(["a", "b", "c"], size=n), dtype=object),
        "flag": rng.random(n) < 0.5,
    }


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("cols", [("age", "count"), ("city", "tag"),
                                  ("age", "city", "count", "tag", "flag")])
def test_feature_hasher_equal(monkeypatch, sparse, native, cols):
    if not native:
        monkeypatch.setattr(TN, "fnv1a_batch", lambda keys: None)
    jt, tt = _tables(_mixed_columns())
    js, ts = _both("FeatureHasher", lambda s: s.set_input_cols(*cols)
                   .set_num_features(16).set_sparse_output(sparse)
                   .set_output_col("h"))
    jo, to = js.transform(jt)[0], ts.transform(tt)[0]
    names = ("h_indices", "h_values") if sparse else ("h",)
    assert to.column_names == jo.column_names
    for name in names:
        _same_bits(jo[name], to[name])


def test_feature_hasher_slots_and_errors():
    t = T.Table({"age": np.asarray([30.0, 40.0]),
                 "city": np.asarray(["sf", "nyc"])})
    mat = (TF.FeatureHasher().set_input_cols("age", "city")
           .set_num_features(64).set_output_col("h").transform(t)[0]["h"])
    assert mat[0, TT._fnv1a("age") % 64] == 30.0
    assert mat[1, TT._fnv1a("city=nyc") % 64] == 1.0
    for pkg in (JF, TF):
        with pytest.raises(ValueError, match="FeatureHasher requires "
                           "inputCols"):
            pkg.FeatureHasher().transform(T.Table({"x": np.ones(1)}))


# -- IndexToString -----------------------------------------------------------

@pytest.mark.parametrize("labels", [["red", "green", "blue"], [10, 20, 30]])
def test_index_to_string_equal_and_errors(labels):
    idx = np.asarray([2, 0, 1, 1])
    jt, tt = _tables({"idx": idx})
    js, ts = _both("IndexToString", lambda s: s.set_labels(labels)
                   .set_features_col("idx").set_output_col("o"))
    _same_bits(js.transform(jt)[0]["o"], ts.transform(tt)[0]["o"])
    for bad in ([3], [-1]):
        msgs = []
        for st in (js, ts):
            with pytest.raises(ValueError) as err:
                st.transform(T.Table({"idx": np.asarray(bad)}))
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1] == "index out of range for 3 labels"
    for pkg in (JF, TF):
        with pytest.raises(RuntimeError, match="set_labels"):
            pkg.IndexToString().transform(T.Table({"features": idx}))


# -- persistence and conversion --------------------------------------------

@pytest.mark.parametrize("name,configure,fits", [
    ("Tokenizer", lambda s: s.set_output_col("t"), False),
    ("RegexTokenizer", lambda s: s.set_pattern(r"\w+").set_gaps(False)
     .set_min_token_length(2), False),
    ("NGram", lambda s: s.set_n(3), False),
    ("StopWordsRemover", lambda s: s.set_stop_words("w1", "w2")
     .set_case_sensitive(True), False),
    ("CountVectorizer", lambda s: s.set_vocabulary_size(9).set_min_tf(2.0),
     True),
    ("HashingTF", lambda s: s.set_num_features(33).set_binary(True), False),
    ("IDF", lambda s: s.set_min_doc_freq(2), True),
    ("FeatureHasher", lambda s: s.set_input_cols("age", "city")
     .set_num_features(20), False),
    ("IndexToString", lambda s: s.set_labels(["p", "q", "r"])
     .set_features_col("count"), False),
])
def test_saves_load_in_the_other_package(tmp_path, name, configure, fits):
    """A stage (a fitted model where the stage is an estimator) saved by
    either package loads in the other and transforms to the same bits."""
    if name in ("FeatureHasher", "IndexToString"):
        cols = _mixed_columns()
        cols["count"] = cols["count"] % 3
    elif name == "IDF":
        cols = {"features": TF.CountVectorizer().fit(T.Table({
            "features": _token_lists(seed=10)})).transform(T.Table({
                "features": _token_lists(seed=10)}))[0]["output"]}
    elif name in ("Tokenizer", "RegexTokenizer"):
        cols = {"features": _texts(seed=10)}
    else:
        cols = {"features": _token_lists(seed=10)}
    jt, tt = _tables(cols)
    js, ts = _both(name, configure)
    if fits:
        js, ts = js.fit(jt), ts.fit(tt)
    out = js.get_output_col()
    want = js.transform(jt)[0]
    js.save(str(tmp_path / "jax"))
    ts.save(str(tmp_path / "port"))
    port_cls = type(ts)
    kw = {"device": "cpu"} if issubclass(port_cls, _OnDevice) else {}
    loaded = port_cls.load(str(tmp_path / "jax"), **kw)
    back = type(js).load(_for_jax(tmp_path, tmp_path / "port"))
    assert type(back) is type(js)
    converted = feature_model_from_jax(js, device="cpu")
    for stage, table in ((loaded, tt), (back, jt), (converted, tt),
                         (ts, tt)):
        got = stage.transform(table)[0]
        if got[out].dtype == object:
            _same_tokens(want[out], got[out])
        else:
            _same_bits(want[out], got[out])


def test_jax_count_vectorizer_model_loads_in_the_port(tmp_path):
    corpus = _token_lists(seed=11)
    jm = (JF.CountVectorizer().set_vocabulary_size(15).set_binary(True)
          .fit(J.Table({"features": corpus})))
    jm.save(str(tmp_path / "cv"))
    tm = TF.CountVectorizerModel.load(str(tmp_path / "cv"))
    assert isinstance(tm, TF.CountVectorizerModel)
    assert tm.vocabulary == jm.vocabulary
    _same_bits(jm.transform(J.Table({"features": corpus}))[0]["output"],
               tm.transform(T.Table({"features": corpus}))[0]["output"])


# -- the text example's pipeline --------------------------------------------

def _example_corpus():
    """``examples/text_pipeline_example.py``'s corpus (400 documents,
    numpy seed 0), built as the example builds it."""
    positive = ["great", "excellent", "wonderful", "amazing", "love"]
    negative = ["terrible", "awful", "horrible", "boring", "hate"]
    filler = ["the", "movie", "was", "plot", "acting", "really", "a", "film"]
    rng = np.random.default_rng(0)
    docs, labels = [], []
    for _ in range(400):
        y = int(rng.random() < 0.5)
        lexicon = positive if y else negative
        words = list(rng.choice(filler, size=6)) + \
            list(rng.choice(lexicon, size=rng.integers(1, 4)))
        rng.shuffle(words)
        docs.append(" ".join(words))
        labels.append(y)
    return {"features": np.asarray(docs, dtype=object),
            "label": np.asarray(labels, np.float64)}


def _example_pipeline(pkg, models, **dev):
    return pkg.Pipeline([
        pkg.models.feature.Tokenizer().set_output_col("tokens"),
        pkg.models.feature.StopWordsRemover().set_features_col("tokens")
        .set_output_col("kept"),
        pkg.models.feature.CountVectorizer().set_features_col("kept")
        .set_output_col("counts"),
        pkg.models.feature.IDF(**dev).set_features_col("counts")
        .set_output_col("tfidf"),
        models.LogisticRegression(**dev).set_features_col("tfidf")
        .set_max_iter(30).set_learning_rate(0.5),
    ])


def test_text_example_pipeline_in_both_packages():
    from flink_ml_tpu.models import classification as JC
    from flink_ml_tpu_torch.models import classification as TC

    jt, tt = _tables(_example_corpus())
    jm = _example_pipeline(J, JC).fit(jt)
    tm = _example_pipeline(T, TC, device="cpu").fit(tt)
    assert tm.stages[2].vocabulary == jm.stages[2].vocabulary
    jo, to = jm.transform(jt)[0], tm.transform(tt)[0]
    _same_bits(jo["counts"], to["counts"])
    _same_bits(jo["tfidf"], to["tfidf"])
    np.testing.assert_allclose(
        tm.stages[4].get_model_data()[0]["coefficients"][0],
        jm.stages[4].get_model_data()[0]["coefficients"][0], **FIT_TOL)
    assert np.mean(to["prediction"] == jo["prediction"]) >= 0.99
    # the selector on the example's tf-idf: the same indices
    sel = {}
    for pkg, table, dev in ((JF, jo, {}), (TF, to, {"device": "cpu"})):
        sel[pkg] = (pkg.UnivariateFeatureSelector(**dev)
                    .set_features_col("tfidf").set_output_col("sel")
                    .set_feature_type("continuous")
                    .set_label_type("categorical")
                    .set_selection_threshold(5).fit(table))
    _same_bits(sel[JF].get_model_data()[0]["indices"],
               sel[TF].get_model_data()[0]["indices"])
