"""The port's data pipeline (``sparkfm_tpu_torch/data/``: schema,
``pack_examples``, libFM load and save on the native and Python paths,
Vectorizer and RelationVectorizer, the MovieLens / Criteo / Avazu loaders
and ``verify``) against the JAX package's on the same inputs: arrays
equal (exactly), files byte-equal, reports equal but for the command
each names."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from sparkfm_tpu.data import batching as jbatching
from sparkfm_tpu.data import datasets as JD
from sparkfm_tpu.data import libfm as jlibfm
from sparkfm_tpu.data import schema as JS
from sparkfm_tpu.data import vectorizer as JV
from sparkfm_tpu.data import verify as JVER
from sparkfm_tpu_torch.data import batching as pbatching
from sparkfm_tpu_torch.data import datasets as PD
from sparkfm_tpu_torch.data import libfm as plibfm
from sparkfm_tpu_torch.data import native_io
from sparkfm_tpu_torch.data import schema as PS
from sparkfm_tpu_torch.data import vectorizer as PV
from sparkfm_tpu_torch.data import verify as PVER

torch.set_num_threads(1)
FIX = os.path.join(os.path.dirname(__file__), "fixtures")
ML = os.path.join(FIX, "ml_fixture")
RATINGS = os.path.join(ML, "ratings.dat")
USERS = os.path.join(ML, "users.dat")


def assert_same_dataset(got, want):
    """Every array of two SparseDatasets equal, dtypes included."""
    for name in ("ids", "vals", "y"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.num_features == want.num_features
    if want.field_ids is None:
        assert got.field_ids is None
    else:
        np.testing.assert_array_equal(got.field_ids, want.field_ids)


@pytest.mark.parametrize("factory,args", [
    ("Identity", ("u",)), ("List", ("genres", "|")), ("Number", ("n",)),
    ("Target", ("y",)), ("Time", ("t",)), ("Hashed", (64, "h")),
    ("Ignored", ("z",))])
def test_schema_columns_match_jax(factory, args):
    got, want = getattr(PS, factory)(*args), getattr(JS, factory)(*args)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "kind":
            assert a.value == b.value
        elif f.name == "transform":
            assert a("86400") == b("86400")
        else:
            assert a == b, f.name


def test_schema_helpers_match_jax():
    cols = [PS.Identity(), PS.Target(), PS.Ignored()]
    assert PS.target_index(cols) == JS.target_index(
        [JS.Identity(), JS.Target(), JS.Ignored()]) == 1
    for mod in (PS, JS):
        with pytest.raises(ValueError, match="exactly one Target"):
            mod.target_index([mod.Identity()])
        with pytest.raises(ValueError, match="num_buckets"):
            mod.Hashed(0)
    assert (list(PS.read_delimited(RATINGS, "::"))
            == list(JS.read_delimited(RATINGS, "::")))


@pytest.mark.parametrize("max_nnz,fields", [(None, False), (3, False),
                                            (None, True)])
def test_pack_examples_matches_jax(max_nnz, fields):
    rng = np.random.default_rng(0)
    rows = [(float(rng.normal()), rng.integers(0, 50, k),
             rng.normal(size=k)) for k in rng.integers(0, 6, 40)]
    fof = rng.integers(0, 4, 50).astype(np.int32) if fields else None
    assert_same_dataset(
        pbatching.pack_examples(rows, 50, max_nnz, fof),
        jbatching.pack_examples(rows, 50, max_nnz, fof))


def _libfm_text(tmp_path):
    p = tmp_path / "edge.libfm"
    p.write_text("# a comment\n1.5 0:1 7:2.5e-3\n\n-2 3:1e5 1:-0.25\n"
                 "0 \n4 12:3 2:1 5:0.5\n")
    return str(p)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kw", [{}, dict(num_features=40, max_nnz=2)])
def test_load_libfm_matches_jax(tmp_path, monkeypatch, native, kw):
    """The native parser (built from native/libfm_parser.cpp) and the
    Python parser each give the JAX package's arrays, on an edge-case file
    and on a file written by save_libfm."""
    if native:
        assert native_io.available("libfm_parser")
    else:
        monkeypatch.setenv("SPARKFM_NO_NATIVE", "1")
    vec = PV.Vectorizer([PS.Identity(), PS.Identity(), PS.Target(),
                         PS.Ignored()])
    ds = vec.fit_transform(PS.read_delimited(RATINGS, "::"))
    written = str(tmp_path / "ml.libfm")
    plibfm.save_libfm(ds, written)
    for path in (_libfm_text(tmp_path), written):
        got = plibfm.load_libfm(path, **kw)
        monkeypatch.delenv("SPARKFM_NO_NATIVE", raising=False)
        want = jlibfm.load_libfm(path, **kw)
        if not native:
            monkeypatch.setenv("SPARKFM_NO_NATIVE", "1")
        assert_same_dataset(got, want)
    if native:
        assert native_io.parse_libfm_padded(written) is not None


def test_native_and_python_parsers_agree(tmp_path, monkeypatch):
    path = _libfm_text(tmp_path)
    nat = plibfm.load_libfm(path)
    monkeypatch.setenv("SPARKFM_NO_NATIVE", "1")
    assert native_io.parse_libfm_padded(path) is None
    assert_same_dataset(plibfm.load_libfm(path), nat)
    empty = tmp_path / "empty.libfm"
    empty.write_text("# nothing\n\n")
    with pytest.raises(ValueError, match="no examples"):
        plibfm.load_libfm(str(empty))


def test_save_libfm_is_byte_equal(tmp_path):
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 100, (30, 4)).astype(np.int32)
    vals = np.where(rng.random((30, 4)) < 0.3, 0.0,
                    rng.normal(size=(30, 4))).astype(np.float32)
    y = rng.normal(size=30).astype(np.float32)
    plibfm.save_libfm(pbatching.SparseDataset(ids, vals, y, 100),
                      str(tmp_path / "p" / "a.libfm"))
    jlibfm.save_libfm(jbatching.SparseDataset(ids, vals, y, 100),
                      str(tmp_path / "j" / "a.libfm"))
    assert ((tmp_path / "p" / "a.libfm").read_bytes()
            == (tmp_path / "j" / "a.libfm").read_bytes())


def _text_rows():
    """Rows exercising every column kind: identity, list, number, time,
    hashed, ignored; one malformed row and one bad target."""
    rng = np.random.default_rng(3)
    rows = []
    for _ in range(60):
        genres = rng.integers(0, 6, rng.integers(0, 4))
        rows.append([f"{rng.normal():.3f}", f"u{rng.integers(9)}",
                     "|".join(f"g{x}" for x in genres),
                     f"{rng.integers(0, 3)}",
                     str(86400 * int(rng.integers(5))),
                     f"cat{rng.integers(50)}", "junk"])
    rows.append(["1.0", "u1"])                      # wrong arity
    rows.append(["x", "u1", "g1", "1", "0", "c", "j"])  # bad target
    return rows


def _schema(mod):
    return [mod.Target("y"), mod.Identity("u"), mod.List("g", "|"),
            mod.Number("n"), mod.Time("t"), mod.Hashed(16, "h"),
            mod.Ignored("z")]


def test_vectorizer_matches_jax(tmp_path):
    """fit/transform on every column kind, save_vocab byte-equal,
    load_vocab, feature_groups_of, OOV on unseen values."""
    rows = _text_rows()
    pv, jv = PV.Vectorizer(_schema(PS)), JV.Vectorizer(_schema(JS))
    assert_same_dataset(pv.fit_transform(rows), jv.fit_transform(rows))
    assert pv.rows_dropped == jv.rows_dropped == 2
    assert (pv.vocabs, pv.offsets, pv.dimension) == (jv.vocabs, jv.offsets,
                                                     jv.dimension)
    unseen = [["2.0", "u-new", "g1|g-new", "0", "0", "cat1", "z"]]
    assert_same_dataset(pv.transform(unseen, max_nnz=8),
                        jv.transform(unseen, max_nnz=8))
    pv.save_vocab(str(tmp_path / "p.json"))
    jv.save_vocab(str(tmp_path / "j.json"))
    assert (tmp_path / "p.json").read_bytes() == (tmp_path /
                                                  "j.json").read_bytes()
    again = PV.Vectorizer(_schema(PS)).load_vocab(str(tmp_path / "p.json"))
    assert_same_dataset(again.transform(rows), pv.transform(rows))
    assert PV.feature_groups_of(pv) == JV.feature_groups_of(jv)
    with pytest.raises(RuntimeError, match="fit"):
        PV.Vectorizer(_schema(PS)).transform(rows)
    with pytest.raises(ValueError, match="not fitted"):
        PV.feature_groups_of(PV.Vectorizer(_schema(PS)))


def test_relation_vectorizer_matches_jax():
    """The users.dat join spliced into the ratings' feature space (the
    materialized form), and the block-structure form
    (``transform_relational``) whose ``materialize()`` is that same
    dataset, as the JAX package's."""
    def build(S, V):
        vec = V.RelationVectorizer([S.Identity("user"), S.Identity("item"),
                                    S.Target("rating"), S.Ignored("ts")])
        vec.add_relation(S.read_delimited(USERS, "::"),
                         [S.Target("uid"), S.Identity("gender"),
                          S.Identity("age"), S.Identity("occ"),
                          S.Ignored("zip")], join_column=0)
        return vec
    rows = list(PS.read_delimited(RATINGS, "::"))[:3000]
    pv, jv = build(PS, PV), build(JS, JV)
    assert_same_dataset(pv.fit_transform(rows), jv.fit_transform(rows))
    assert PV.feature_groups_of(pv) == JV.feature_groups_of(jv)
    with pytest.raises(ValueError, match="target"):
        pv.add_relation([], [PS.Target()], join_column=2)
    prel, jrel = pv.transform_relational(rows), jv.transform_relational(rows)
    for name in ("main_ids", "main_vals", "y", "keys"):
        np.testing.assert_array_equal(getattr(prel, name),
                                      getattr(jrel, name), err_msg=name)
    for t, u in zip(prel.tables, jrel.tables, strict=True):
        assert t.offset == u.offset
        np.testing.assert_array_equal(t.ids, np.asarray(u.ids))
        np.testing.assert_array_equal(t.vals, np.asarray(u.vals))
    # the same rows, the main block's slots first
    flat, mat = pv.transform(rows), prel.materialize()
    for ds in (flat, mat):
        order = np.argsort(ds.ids, axis=1, kind="stable")
        ds.ids = np.take_along_axis(ds.ids, order, axis=1)
        ds.vals = np.take_along_axis(ds.vals, order, axis=1)
    assert_same_dataset(mat, flat)


@pytest.mark.parametrize("source", ["dir", "ratings.dat", "u.data",
                                    "ratings.csv"])
def test_movielens_loaders_match_jax(source):
    path = ML if source == "dir" else os.path.join(ML, source)
    (pds, pvec), (jds, jvec) = (PD.load_movielens(path, max_examples=5000),
                                JD.load_movielens(path, max_examples=5000))
    assert_same_dataset(pds, jds)
    held = list(PD.movielens_rating_rows(path))[5000:5100]
    assert held == list(JD.movielens_rating_rows(path))[5000:5100]
    assert_same_dataset(PD.load_movielens(path, vectorizer=pvec)[0],
                        JD.load_movielens(path, vectorizer=jvec)[0])


def test_movielens_relational_loader_matches_jax():
    """The ratings joined with users.dat (materialized) and the fitted
    RelationVectorizer, as the JAX package's loader gives them."""
    (pds, pvec), (jds, jvec) = (PD.load_movielens_relational(ML),
                                JD.load_movielens_relational(ML))
    assert_same_dataset(pds, jds)
    assert (pvec.offsets, pvec.dimension) == (jvec.offsets, jvec.dimension)


@pytest.mark.parametrize("with_fields", [False, True])
def test_criteo_loader_matches_jax(with_fields):
    path = os.path.join(FIX, "criteo_sample.txt")
    for kw in (dict(num_buckets=1 << 12), dict(max_examples=100)):
        assert_same_dataset(
            PD.load_criteo_tsv(path, with_fields=with_fields, **kw),
            JD.load_criteo_tsv(path, with_fields=with_fields, **kw))


@pytest.mark.parametrize("with_fields", [False, True])
def test_avazu_loader_matches_jax(with_fields):
    path = os.path.join(FIX, "avazu_sample.csv")
    assert_same_dataset(
        PD.load_avazu_csv(path, num_buckets=1 << 14,
                          with_fields=with_fields),
        JD.load_avazu_csv(path, num_buckets=1 << 14,
                          with_fields=with_fields))
    assert PD.zlib_crc("abc") == JD.zlib_crc("abc")


def _same_report(got, want):
    """Equal reports but for the command each names."""
    assert got["repro"] == want["repro"].replace(
        "sparkfm_tpu train", "python -m sparkfm_tpu_torch train")
    assert ({k: v for k, v in got.items() if k != "repro"}
            == {k: v for k, v in want.items() if k != "repro"})


def test_verify_matches_jax(tmp_path):
    """verify() on the fixtures (published row counts fail, the fixture
    counts pass), on an aborted scan, in quick mode and on an unknown
    file."""
    cases = [(os.path.join(ML, "ratings.dat"), {}),
             (os.path.join(ML, "ratings.dat"), dict(expected_rows=12000)),
             (os.path.join(ML, "u.data"), dict(expected_rows=12000)),
             (os.path.join(ML, "ratings.csv"), dict(quick=True))]
    bad = tmp_path / "u.data"
    good = "1\t2\t3\t881250949\n"
    bad.write_text("".join([good] * 3 + ["garbage-line\n"] * 8
                           + [good] * 5))
    cases.append((str(bad), dict(dataset="ml-100k")))
    crit = tmp_path / "train.txt"
    crit.write_text(open(os.path.join(FIX, "criteo_sample.txt")).read())
    cases.append((str(crit), dict(expected_rows=4000)))
    for path, kw in cases:
        _same_report(PVER.verify(path, **kw), JVER.verify(path, **kw))
    assert PVER.verify(os.path.join(ML, "u.data"),
                       expected_rows=12000)["ok"]
    for mod in (PVER, JVER):
        with pytest.raises(ValueError, match="cannot identify"):
            mod.verify(str(tmp_path / "mystery.bin"))
    assert PVER.detect("train.csv") == JVER.detect("train.csv") == "avazu"
    assert json.dumps(sorted(PVER.EXPECTATIONS)) == json.dumps(
        sorted(JVER.EXPECTATIONS))
