"""The port's index planner (spfft_tpu_torch.indexing) against the JAX
package's, on the same triplets: every table equal, the same errors with
the same codes, and index plans carried across with convert.py."""

import dataclasses

import numpy as np
import pytest
import torch

import spfft_tpu
from spfft_tpu import indexing as jidx

import spfft_tpu_torch as sp
from spfft_tpu_torch import convert
from spfft_tpu_torch import indexing as tidx

torch.set_num_threads(2)

DIMS = (1, 2, 11, 12, 13, 16)


def _triplets(n, hermitian, centered, seed):
    """A random shuffled subset of the valid triplets of an n^3 grid
    (hermitian: x >= 0 half; centered: signed indices)."""
    rng = np.random.default_rng(seed)
    if centered:
        c = np.arange(n // 2 - n + 1, n // 2 + 1)
    else:
        c = np.arange(n)
    xs = c[c >= 0] if hermitian else c
    if hermitian and not centered:
        xs = np.arange(n // 2 + 1)
    X, Y, Z = np.meshgrid(xs, c, c, indexing="ij")
    t = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    keep = rng.random(len(t)) < 0.6
    keep[0] = True
    t = t[keep]
    rng.shuffle(t)
    return t.astype(np.int32)


def _assert_same_plan(tp, jp):
    assert tp.transform_type.value == jp.transform_type.value
    assert (tp.dim_x, tp.dim_y, tp.dim_z, tp.centered) == \
        (jp.dim_x, jp.dim_y, jp.dim_z, jp.centered)
    for name in ("value_indices", "stick_keys", "slot_src", "col_inv_t",
                 "scatter_cols_t", "stick_x", "stick_y"):
        a, b = getattr(tp, name), getattr(jp, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    if jp.value_conj is None:
        assert tp.value_conj is None
    else:
        np.testing.assert_array_equal(tp.value_conj, jp.value_conj)
    assert tp.dim_x_freq == jp.dim_x_freq


@pytest.mark.parametrize("n", DIMS)
@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("ttype", ["c2c", "r2c"])
def test_build_index_plan_matches_jax(ttype, centered, n):
    t = _triplets(n, ttype == "r2c", centered, seed=n)
    tp = sp.build_index_plan(sp.TransformType(ttype), n, n, n, t)
    jp = spfft_tpu.build_index_plan(spfft_tpu.TransformType(ttype), n, n,
                                    n, t)
    _assert_same_plan(tp, jp)


def test_hermitian_folding_matches_jax():
    """A full-sphere R2C set (x < 0 included) folds onto conjugate
    mirror sticks identically."""
    n = 12
    c = np.arange(n // 2 - n + 1, n // 2 + 1)
    X, Y, Z = np.meshgrid(c, c, c, indexing="ij")
    m = X * X + Y * Y + Z * Z <= 16
    t = np.stack([X[m], Y[m], Z[m]], axis=1).astype(np.int32)
    tp = sp.build_index_plan(sp.TransformType.R2C, n, n, n, t)
    jp = spfft_tpu.build_index_plan(spfft_tpu.TransformType.R2C, n, n, n, t)
    assert jp.value_conj is not None
    _assert_same_plan(tp, jp)


@pytest.mark.parametrize("allow_wrap", [False, True])
def test_occupied_x_window_matches_jax(allow_wrap):
    rng = np.random.default_rng(3)
    for _ in range(20):
        xs = rng.integers(0, 24, size=rng.integers(1, 10))
        assert tidx.occupied_x_window(xs, 24, allow_wrap) == \
            jidx.occupied_x_window(xs, 24, allow_wrap)


def test_stick_duplicates_across_shards_raise_like_jax():
    shards = [np.array([1, 5, 9]), np.array([2, 5])]
    tidx.check_stick_duplicates([shards[0], shards[1][:1]])
    with pytest.raises(sp.DuplicateIndicesError) as te:
        tidx.check_stick_duplicates(shards)
    with pytest.raises(spfft_tpu.DuplicateIndicesError) as je:
        jidx.check_stick_duplicates(shards)
    assert int(te.value.error_code()) == int(je.value.error_code())


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return info.value


@pytest.mark.parametrize("case", [
    ("c2c", (8, 8, 8), [[8, 0, 0]]),       # x past the positive range
    ("c2c", (8, 8, 8), [[0, -5, 0]]),      # y below the centered range
    ("r2c", (8, 8, 8), [[5, 0, 0]]),       # hermitian x past dim/2
    ("c2c", (0, 8, 8), [[0, 0, 0]]),       # a zero dimension
    ("c2c", (2, 2, 2), [[0, 0, 0]] * 9),   # more values than grid points
    ("c2c", (8, 8, 8), [[0, 0]]),          # not (n, 3)
])
def test_errors_match_jax(case):
    ttype, dims, t = case
    t = np.asarray(t, np.int32)
    te = _raised(lambda: sp.build_index_plan(sp.TransformType(ttype),
                                             *dims, t))
    je = _raised(lambda: spfft_tpu.build_index_plan(
        spfft_tpu.TransformType(ttype), *dims, t))
    assert type(te).__name__ == type(je).__name__
    assert int(te.error_code()) == int(je.error_code())
    assert isinstance(te, sp.GenericError)


def test_error_codes_match_jax():
    from spfft_tpu import errors as jerr
    from spfft_tpu_torch import errors as terr
    assert {e.name: e.value for e in terr.ErrorCode} == \
        {e.name: e.value for e in jerr.ErrorCode}
    for name in dir(jerr):
        cls = getattr(jerr, name)
        if isinstance(cls, type) and issubclass(cls, jerr.GenericError):
            tcls = getattr(terr, name)
            assert int(tcls.code) == int(cls.code), name
            assert [b.__name__ for b in tcls.__mro__] == \
                [b.__name__ for b in cls.__mro__], name


def test_enums_match_jax():
    from spfft_tpu import types as jt
    from spfft_tpu_torch import types as tt
    for name in ("ExchangeType", "ProcessingUnit", "IndexFormat",
                 "TransformType", "Scaling"):
        assert {e.name: e.value for e in getattr(tt, name)} == \
            {e.name: e.value for e in getattr(jt, name)}


@pytest.mark.parametrize("ttype,centered", [("c2c", True), ("c2c", False),
                                            ("r2c", True)])
def test_index_plan_from_arrays_round_trips(ttype, centered):
    t = _triplets(11, ttype == "r2c", centered, seed=5)
    jp = spfft_tpu.build_index_plan(spfft_tpu.TransformType(ttype), 11, 11,
                                    11, t)
    tp = convert.index_plan_from_arrays(dataclasses.asdict(jp))
    _assert_same_plan(tp, jp)


def test_index_plan_from_arrays_rejects_bad_tables():
    jp = spfft_tpu.build_index_plan(spfft_tpu.TransformType.C2C, 4, 4, 4,
                                    np.array([[0, 0, 0], [1, 2, 3]]))
    fields = dataclasses.asdict(jp)
    with pytest.raises(sp.InvalidParameterError):
        convert.index_plan_from_arrays(
            {k: v for k, v in fields.items() if k != "stick_keys"})
    bad = dict(fields, value_indices=np.array([0, 99], np.int32))
    with pytest.raises(sp.InvalidParameterError):
        convert.index_plan_from_arrays(bad)
    bad = dict(fields, stick_keys=fields["stick_keys"][::-1].copy())
    with pytest.raises(sp.InvalidParameterError):
        convert.index_plan_from_arrays(bad)


def test_workloads_match_jax():
    from spfft_tpu.utils import workloads as jw
    from spfft_tpu_torch.utils import workloads as tw
    for n, r in ((12, None), (16, 3), (9, 4)):
        a = tw.spherical_cutoff_triplets(n, r)
        np.testing.assert_array_equal(a, jw.spherical_cutoff_triplets(n, r))
        rng = np.random.default_rng(n)
        a = a[rng.permutation(len(a))]
        np.testing.assert_array_equal(
            tw.sort_triplets_stick_major(a, (n, n, n)),
            jw.sort_triplets_stick_major(a, (n, n, n)))
