"""The port's Criteo TSV reader (``flink_ml_tpu_torch.data.criteo``)
against the JAX package's, bit for bit, through the native parser and the
Python fallback: ``parse_chunk`` on edge-case lines and on the bench's
synthetic day-file format, the reader's batches serial and range-sharded,
and a reader's Table through the port's mixed LogisticRegression fit.
Tolerance 0 for every parsed array (the same integer and hashing rules);
the fit vs the JAX fit within atol 1e-5 (f32 summation order)."""

import numpy as np
import pytest

import jax

from flink_ml_tpu.data import criteo as JC
import flink_ml_tpu.models as JM
import flink_ml_tpu as J
import flink_ml_tpu_torch as T
from flink_ml_tpu.parallel.mesh import device_mesh, use_mesh
from flink_ml_tpu_torch.data import criteo as TC

PARSERS = ["native", "python"]


@pytest.fixture(params=PARSERS)
def parser(request, monkeypatch):
    """Both packages on one parser: the native library (skipped where it
    cannot be built) or the bit-identical Python fallback."""
    if request.param == "native":
        if TC._native_lib() is None or JC._native_lib() is None:
            pytest.skip("the native parser library could not be built here")
    else:
        for mod in (TC, JC):
            monkeypatch.setattr(mod, "_native_lib", lambda: None)
    assert TC.parser_name() == request.param
    return request.param


def _synth_tsv(rows, rng):
    """The bench's synthetic day-file lines (``bench.py:611``)."""
    ints = rng.integers(0, 1000, size=(rows, 13))
    toks = rng.integers(0, 1 << 32, size=(rows, 26))
    return b"".join(
        b"%d\t%s\t%s\n" % (
            i & 1, b"\t".join(b"%d" % v for v in ints[i]),
            b"\t".join(b"%08x" % v for v in toks[i]))
        for i in range(rows))


def _edge_lines():
    """Empty, negative, non-digit and over-long integers, empty and
    non-UTF-8 tokens, labels other than 0/1, a short and a long line."""
    ints = [b"-5", b"", b"12x", b"9" * 19, b"-0", b"007"] + [b"3"] * 7
    cats = [b"", b"\x80\xffab", b"deadbeef"] + [b"%08x" % i for i in
                                                range(23)]
    lines = [b"\t".join([b"1"] + ints + cats), b"\t".join([b"0"] * 40),
             b"\t".join([b"x"] + ints + cats),
             b"\t".join([b"1"] * 41), b"\t".join([b"0"] + ints + cats)]
    return b"\n".join(lines) + b"\n" + b"1\t2\t3"     # trailing partial line


def _assert_parsed_equal(got, want):
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]


@pytest.mark.parametrize("hash_space,n_reserved", [(997, 13),
                                                   ((1 << 20) - 13, 13),
                                                   (1 << 30, 0)])
def test_parse_chunk_matches_jax(parser, hash_space, n_reserved):
    data = _edge_lines() + _synth_tsv(300, np.random.default_rng(1))
    for max_rows in (2, 1000):
        _assert_parsed_equal(
            TC.parse_chunk(data, max_rows, hash_space, n_reserved),
            JC.parse_chunk(data, max_rows, hash_space, n_reserved))
    dense, cat, label, consumed = TC.parse_chunk(_edge_lines(), 10,
                                                 hash_space, n_reserved)
    assert len(label) == 4 and consumed < len(_edge_lines())
    assert cat.min() >= n_reserved and cat.max() < n_reserved + hash_space


def test_native_and_python_parsers_agree():
    if TC._native_lib() is None:
        pytest.skip("the native parser library could not be built here")
    data = _edge_lines() + _synth_tsv(500, np.random.default_rng(2))
    native = TC.parse_chunk(data, 600, (1 << 20) - 13)
    python = TC._py_parse_chunk(data, 600, (1 << 20) - 13, 13)
    _assert_parsed_equal(native, python)


def test_parse_chunk_rejects_bad_hash_space():
    with pytest.raises(ValueError, match="positive"):
        TC.parse_chunk(b"", 1, 0)
    with pytest.raises(ValueError, match="int32"):
        TC.parse_chunk(b"", 1, 1 << 31)


def _collect(reader):
    batches = list(reader)
    return batches, tuple(np.concatenate([b[k] for b in batches]) for k in
                          ("features_dense", "features_indices", "label"))


@pytest.mark.parametrize("workers", [1, 3])
def test_reader_matches_jax_and_parse_chunk(parser, tmp_path, monkeypatch,
                                            workers):
    """Batches of a two-file corpus (the second without a final newline,
    a malformed line inside) equal the JAX reader's batch for batch, and
    together ``parse_chunk`` of the whole corpus; range-sharded readers
    with tiny ranges give the same rows in the same order."""
    rng = np.random.default_rng(3)
    p1, p2 = tmp_path / "day0.tsv", tmp_path / "day1.tsv"
    p1.write_bytes(_synth_tsv(257, rng) + b"1\t2\n" + _synth_tsv(40, rng))
    p2.write_bytes(_synth_tsv(103, rng)[:-1])
    hash_space = (1 << 20) - 13
    kwargs = dict(batch_rows=64, hash_space=hash_space, workers=workers,
                  chunk_bytes=1 << 12)
    readers = [TC.CriteoTSVReader([str(p1), str(p2)], **kwargs),
               JC.CriteoTSVReader([str(p1), str(p2)], **kwargs)]
    if workers > 1:
        for r, cls in zip(readers, (TC.CriteoTSVReader, JC.CriteoTSVReader)):
            monkeypatch.setattr(r, "_range_tasks", lambda r=r, cls=cls:
                                cls._range_tasks(r, range_bytes=5000))
    (got, got_all), (want, _) = (_collect(r) for r in readers)
    assert len(got) == len(want) == -(-400 // 64)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    whole = TC.parse_chunk(p1.read_bytes() + p2.read_bytes() + b"\n", 1000,
                           hash_space)
    for a, b in zip(got_all, whole[:3]):
        np.testing.assert_array_equal(a, b)
    assert readers[0].num_features == 1 << 20


def test_reader_table_fits_the_mixed_layout(tmp_path):
    """A reader's batches as a Table fit the port's mixed
    LogisticRegression (the ELL plan at 2^14 features) as the JAX
    package's fit does."""
    path = tmp_path / "day.tsv"
    path.write_bytes(_synth_tsv(1200, np.random.default_rng(4)))
    reader = TC.CriteoTSVReader(str(path), batch_rows=500,
                                hash_space=128 * 128 - 13)
    _, (dense, cat, y) = _collect(reader)
    cols = {"features_dense": dense / 1000.0, "features_indices": cat,
            "label": y}

    def configure(est):
        return (est.set_num_features(reader.num_features)
                .set_global_batch_size(400).set_max_iter(2).set_tol(0))

    tmodel = configure(T.LogisticRegression(device="cpu")).fit(T.Table(cols))
    with use_mesh(device_mesh({"data": 1}, devices=jax.devices()[:1])):
        jmodel = configure(JM.LogisticRegression()).fit(J.Table(cols))
    assert tmodel.planned_impl == "ell"
    np.testing.assert_allclose(
        tmodel.get_model_data()[0]["coefficients"],
        jmodel.get_model_data()[0]["coefficients"], atol=1e-5)
    np.testing.assert_allclose(tmodel.loss_log, jmodel.loss_log, atol=1e-6)
