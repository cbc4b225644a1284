"""Token-stream stages: Tokenizer, RegexTokenizer, NGram,
StopWordsRemover, and the fitted CountVectorizer.

Members of the Flink ML 2.x feature surface (the reference snapshot's lib
is KMeans-only — SURVEY §2.8).  Tokenization is inherently host string
work; the vocabulary counting of CountVectorizer and its transform-time
document-term matrix are built with integer ``np.bincount`` passes so the
resulting dense (rows, vocab) matrix lands device-ready for the TF/IDF
device ops downstream (``text.IDF``).

Token columns are numpy object arrays (one token list per row) — the same
convention ``HashingTF`` consumes.

A port of the JAX package's ``models/feature/tokenize.py``.  Every stage
here is host work and takes no ``device``: tokens, vocabularies (and
their tie order), counts and float64 outputs equal the JAX package's bit
for bit.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

import numpy as np

from ...api.stage import Estimator, Model, Transformer
from ...data.table import Table
from ...params.param import (
    BoolParam,
    FloatParam,
    IntParam,
    ParamValidators,
    StringParam,
    StringArrayParam,
)
from ...params.shared import HasFeaturesCol, HasOutputCol
from ...utils import persist

__all__ = [
    "CountVectorizer",
    "CountVectorizerModel",
    "NGram",
    "RegexTokenizer",
    "StopWordsRemover",
    "Tokenizer",
]

# The Glasgow/Snowball English list the Flink ML / Spark
# StopWordsRemover.loadDefaultStopWords("english") family ships.
_ENGLISH_STOP_WORDS = (
    "a about above after again against all am an and any are aren't as at "
    "be because been before being below between both but by can't cannot "
    "could couldn't did didn't do does doesn't doing don't down during "
    "each few for from further had hadn't has hasn't have haven't having "
    "he he'd he'll he's her here here's hers herself him himself his how "
    "how's i i'd i'll i'm i've if in into is isn't it it's its itself "
    "let's me more most mustn't my myself no nor not of off on once only "
    "or other ought our ours ourselves out over own same shan't she she'd "
    "she'll she's should shouldn't so some such than that that's the their "
    "theirs them themselves then there there's these they they'd they'll "
    "they're they've this those through to too under until up very was "
    "wasn't we we'd we'll we're we've were weren't what what's when when's "
    "where where's which while who who's whom why why's with won't would "
    "wouldn't you you'd you'll you're you've your yours yourself yourselves"
).split()


def _tokens_array(rows: Sequence[List[str]]) -> np.ndarray:
    out = np.empty((len(rows),), object)
    for i, r in enumerate(rows):
        out[i] = list(r)
    return out


def _doc_tokens(doc) -> List[str]:
    """Canonical token-list view of one row of a token column."""
    return [str(t) for t in np.ravel(np.asarray(doc, dtype=object))]


def _iter_docs(col: np.ndarray):
    for doc in col:
        yield _doc_tokens(doc)


class _TokenTransformer(HasFeaturesCol, HasOutputCol, Transformer):
    """Shared plumbing: string/token column in, token column out.
    ``_row_fn`` is built once per transform call so per-row work reads no
    params and compiles no regexes."""

    def _row_fn(self):
        raise NotImplementedError

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        col = table[self.get_features_col()]
        fn = self._row_fn()
        rows = [fn(doc) for doc in col]
        return [table.with_column(self.get_output_col(),
                                  _tokens_array(rows))]


_SINGLE_WS = re.compile(r"\s")


class Tokenizer(_TokenTransformer):
    """Lowercase, then split on every single whitespace character — the
    Flink ML / Spark Tokenizer rule (Java ``split("\\s")``): consecutive
    whitespace yields empty interior tokens, trailing empties drop."""

    def _row_fn(self):
        def apply(doc):
            tokens = _SINGLE_WS.split(str(doc).lower())
            while tokens and tokens[-1] == "":
                tokens.pop()
            return tokens
        return apply


class RegexTokenizer(_TokenTransformer):
    """Regex-driven tokenization: ``gaps=True`` splits on matches of
    ``pattern``; ``gaps=False`` emits the matches themselves.  Tokens
    shorter than ``minTokenLength`` are dropped."""

    PATTERN = StringParam("pattern", "Split/match regex.", default=r"\s+")
    GAPS = BoolParam("gaps", "Pattern matches gaps (split) vs tokens.",
                     default=True)
    MIN_TOKEN_LENGTH = IntParam("minTokenLength", "Drop shorter tokens.",
                                default=1,
                                validator=ParamValidators.gt_eq(0))
    TO_LOWERCASE = BoolParam("toLowercase", "Lowercase before tokenizing.",
                             default=True)

    def get_pattern(self) -> str:
        return self.get(RegexTokenizer.PATTERN)

    def set_pattern(self, value: str):
        return self.set(RegexTokenizer.PATTERN, value)

    def set_gaps(self, value: bool):
        return self.set(RegexTokenizer.GAPS, bool(value))

    def set_min_token_length(self, value: int):
        return self.set(RegexTokenizer.MIN_TOKEN_LENGTH, value)

    def set_to_lowercase(self, value: bool):
        return self.set(RegexTokenizer.TO_LOWERCASE, bool(value))

    def _row_fn(self):
        lower = self.get(RegexTokenizer.TO_LOWERCASE)
        pattern = re.compile(self.get_pattern())
        gaps = self.get(RegexTokenizer.GAPS)
        min_len = self.get(RegexTokenizer.MIN_TOKEN_LENGTH)

        def apply(doc):
            text = str(doc).lower() if lower else str(doc)
            tokens = pattern.split(text) if gaps else pattern.findall(text)
            return [t for t in tokens if len(t) >= min_len]
        return apply


class NGram(_TokenTransformer):
    """Token list -> space-joined n-grams (rows shorter than ``n`` yield an
    empty list, the Flink ML NGram contract)."""

    N = IntParam("n", "Gram length.", default=2,
                 validator=ParamValidators.gt_eq(1))

    def get_n(self) -> int:
        return self.get(NGram.N)

    def set_n(self, value: int):
        return self.set(NGram.N, value)

    def _row_fn(self):
        n = self.get_n()

        def apply(doc):
            tokens = _doc_tokens(doc)
            return [" ".join(tokens[i:i + n])
                    for i in range(len(tokens) - n + 1)]
        return apply


class StopWordsRemover(_TokenTransformer):
    """Filter stop words out of a token list.  Defaults to the English
    list; ``caseSensitive=False`` (default) compares casefolded."""

    STOP_WORDS = StringArrayParam(
        "stopWords", "Words to remove.",
        default=tuple(_ENGLISH_STOP_WORDS))
    CASE_SENSITIVE = BoolParam("caseSensitive", "Exact-case comparison.",
                               default=False)

    def get_stop_words(self):
        return self.get(StopWordsRemover.STOP_WORDS)

    def set_stop_words(self, *words: str):
        vals = words[0] if len(words) == 1 and not isinstance(words[0], str) \
            else words
        return self.set(StopWordsRemover.STOP_WORDS,
                        tuple(str(w) for w in vals))

    def set_case_sensitive(self, value: bool):
        return self.set(StopWordsRemover.CASE_SENSITIVE, bool(value))

    @staticmethod
    def load_default_stop_words(language: str = "english"):
        if language != "english":
            raise ValueError(
                f"no built-in stop words for language {language!r}")
        return tuple(_ENGLISH_STOP_WORDS)

    def _row_fn(self):
        if self.get(StopWordsRemover.CASE_SENSITIVE):
            stop = set(self.get_stop_words())
            return lambda doc: [t for t in _doc_tokens(doc) if t not in stop]
        stop = {w.casefold() for w in self.get_stop_words()}
        return lambda doc: [t for t in _doc_tokens(doc)
                            if t.casefold() not in stop]


# ---------------------------------------------------------------------------
# CountVectorizer
# ---------------------------------------------------------------------------

class CountVectorizerParams(HasFeaturesCol, HasOutputCol):
    VOCABULARY_SIZE = IntParam(
        "vocabularySize", "Max vocabulary size.", default=1 << 18,
        validator=ParamValidators.gt(0))
    MIN_DF = FloatParam(
        "minDF", "Min document frequency (fraction if < 1, else count).",
        default=1.0, validator=ParamValidators.gt_eq(0.0))
    MAX_DF = FloatParam(
        "maxDF", "Max document frequency (fraction if < 1, else count).",
        default=float(1 << 62), validator=ParamValidators.gt_eq(0.0))
    MIN_TF = FloatParam(
        "minTF", "Per-document min term frequency filter at transform "
        "(fraction of doc length if < 1, else count).", default=1.0,
        validator=ParamValidators.gt_eq(0.0))
    BINARY = BoolParam("binary", "1/0 presence instead of counts.",
                       default=False)

    def get_vocabulary_size(self) -> int:
        return self.get(CountVectorizerParams.VOCABULARY_SIZE)

    def set_vocabulary_size(self, value: int):
        return self.set(CountVectorizerParams.VOCABULARY_SIZE, value)

    def get_min_df(self) -> float:
        return self.get(CountVectorizerParams.MIN_DF)

    def set_min_df(self, value: float):
        return self.set(CountVectorizerParams.MIN_DF, value)

    def get_max_df(self) -> float:
        return self.get(CountVectorizerParams.MAX_DF)

    def set_max_df(self, value: float):
        return self.set(CountVectorizerParams.MAX_DF, value)

    def get_min_tf(self) -> float:
        return self.get(CountVectorizerParams.MIN_TF)

    def set_min_tf(self, value: float):
        return self.set(CountVectorizerParams.MIN_TF, value)

    def set_binary(self, value: bool):
        return self.set(CountVectorizerParams.BINARY, bool(value))


class CountVectorizerModel(CountVectorizerParams, Model):
    """Vocabulary-indexed term counting: transform emits the dense
    (rows, vocab) document-term matrix in vocabulary order."""

    def __init__(self):
        super().__init__()
        self._vocabulary: Optional[np.ndarray] = None
        self._index: Optional[dict] = None

    @property
    def vocabulary(self) -> List[str]:
        self._require_model()
        return [str(v) for v in self._vocabulary]

    def _set_vocabulary(self, vocab: np.ndarray) -> None:
        self._vocabulary = vocab
        self._index = {str(v): i for i, v in enumerate(vocab)}

    def set_model_data(self, *inputs) -> "CountVectorizerModel":
        (t,) = inputs
        self._set_vocabulary(np.asarray(t["vocabulary"], dtype=np.str_))
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        return [Table({"vocabulary": self._vocabulary})]

    def _require_model(self) -> None:
        if self._vocabulary is None:
            raise RuntimeError("CountVectorizerModel has no model data")

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        self._require_model()
        col = table[self.get_features_col()]
        index = self._index
        v = len(index)
        min_tf = self.get_min_tf()
        out = np.zeros((len(col), v), np.float64)
        for i, tokens in enumerate(_iter_docs(col)):
            ids = [index[t] for t in tokens if t in index]
            if not ids:
                continue
            counts = np.bincount(np.asarray(ids, np.int64), minlength=v)
            bound = min_tf * len(tokens) if min_tf < 1.0 else min_tf
            out[i] = np.where(counts >= bound, counts, 0)
        if self.get(CountVectorizerParams.BINARY):
            out = (out > 0).astype(np.float64)
        return [table.with_column(self.get_output_col(), out)]

    def save(self, path: str) -> None:
        self._require_model()
        persist.save_metadata(self, path)
        persist.save_model_arrays(
            path, "model", {"vocabulary": np.asarray(self._vocabulary)})

    @classmethod
    def load(cls, path: str) -> "CountVectorizerModel":
        model = persist.load_stage_param(path)
        model._set_vocabulary(persist.load_model_arrays(
            path, "model")["vocabulary"].astype(np.str_))
        return model


class CountVectorizer(CountVectorizerParams,
                      Estimator[CountVectorizerModel]):
    """Learns the vocabulary: terms ranked by corpus frequency (ties
    broken lexically for determinism), filtered by document-frequency
    bounds, truncated to ``vocabularySize``."""

    def fit(self, *inputs) -> CountVectorizerModel:
        (table,) = inputs
        col = table[self.get_features_col()]
        n_docs = len(col)
        term_freq: dict = {}
        doc_freq: dict = {}
        for tokens in _iter_docs(col):
            seen = set()
            for t in tokens:
                term_freq[t] = term_freq.get(t, 0) + 1
                if t not in seen:
                    seen.add(t)
                    doc_freq[t] = doc_freq.get(t, 0) + 1

        min_df, max_df = self.get_min_df(), self.get_max_df()
        lo = min_df * n_docs if min_df < 1.0 else min_df
        hi = max_df * n_docs if max_df < 1.0 else max_df
        terms = [t for t, df in doc_freq.items() if lo <= df <= hi]
        terms.sort(key=lambda t: (-term_freq[t], t))
        terms = terms[: self.get_vocabulary_size()]

        model = CountVectorizerModel()
        model.copy_params_from(self)
        model._set_vocabulary(np.asarray(terms, dtype=np.str_))
        return model
