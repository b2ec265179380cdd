"""Port parity for the reference's files: the DIA conversions
(``dia_to_csr``, ``from_scipy_dia``), the reference system's matrix
directories (``formats/refio``) and the plan files (``formats/plan_io``).

Arrays must be byte-equal to the JAX package's; matrix files written by
either package must be byte-identical (``upload.tcl`` included) and load
in the other; a plan file saved by either package loads in the other
with byte-equal arrays (``np.savez_compressed`` stamps its zip with a
time, so the files themselves are not compared).
"""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmv_vector_cache_tpu.formats import convert as jconvert
from spmv_vector_cache_tpu.formats import dia as jdia
from spmv_vector_cache_tpu.formats import plan_io as jplan_io
from spmv_vector_cache_tpu.formats import refio as jrefio
from spmv_vector_cache_tpu.formats.cached import build_cached_plan as jcached
from spmv_vector_cache_tpu.formats.cached import coo_tail_from_csr as jtail
from spmv_vector_cache_tpu.formats.chunk import build_chunk_plan as jchunk
from spmv_vector_cache_tpu.formats.packed import build_packed_plan as jpacked
from spmv_vector_cache_tpu.formats.plan import auto_plan as jauto
from spmv_vector_cache_tpu.formats.plan import build_sell_plan as jsell
from spmv_vector_cache_tpu.parallel.dia_sharded import \
    build_sharded_dia_plan as jsharded_dia
from spmv_vector_cache_tpu.parallel.spmv_sharded import \
    build_sharded_plan as jsharded
from spmv_vector_cache_tpu_torch.formats import convert as pconvert
from spmv_vector_cache_tpu_torch.formats import dia as pdia
from spmv_vector_cache_tpu_torch.formats import plan_io, refio
from spmv_vector_cache_tpu_torch.formats.containers import CSC
from spmv_vector_cache_tpu_torch.formats.plan import (auto_plan,
                                                      build_sell_plan, place)
from spmv_vector_cache_tpu_torch.interop import (plan_from_reference,
                                                 plan_to_numpy)
from tests.test_torch_cached import powerlaw_cols, zipf_cols
from tests.test_torch_plan import (assert_plans_equal, banded, both, hybrid,
                                   random_sparse, shuffled_band)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# dia_to_csr, from_scipy_dia
# ---------------------------------------------------------------------------

DIA_CASES = {
    "square": (600, 600, [-130, -7, 0, 3, 200]),
    "wide": (300, 520, [0, 200, 450]),
    "tall": (520, 300, [-400, -1, 0]),
    "past_the_ends": (100, 100, [-150, 0, 120]),
}


@pytest.mark.parametrize("case", sorted(DIA_CASES))
def test_dia_to_csr_byte_equal(case):
    rows, cols, offs = DIA_CASES[case]
    m = banded(rows, offs, seed=1, cols=cols)
    m.data[::7] = 0.0                  # stored zeros are dropped
    ja, pa = both(m)
    jd, pd = jdia.csr_to_dia(ja), pdia.csr_to_dia(pa)
    jc, pc = jdia.dia_to_csr(jd), pdia.dia_to_csr(pd)
    for f in ("data", "indices", "indptr"):
        _same(getattr(pc, f), getattr(jc, f))
    assert pc.shape == jc.shape == (rows, cols)


@pytest.mark.parametrize("case", sorted(DIA_CASES))
def test_from_scipy_dia_byte_equal(case):
    rows, cols, offs = DIA_CASES[case]
    rng = np.random.default_rng(2)
    # offsets out of order, as scipy keeps them
    offs = offs[::-1]
    m = sp.dia_matrix((rng.standard_normal((len(offs), cols)).astype(
        np.float32), offs), shape=(rows, cols))
    jd, pd = jdia.from_scipy_dia(m), pdia.from_scipy_dia(m)
    _same(pd.data, jd.data)
    _same(pd.offsets, jd.offsets)
    assert pd.shape == jd.shape
    dense = np.zeros((rows, cols), np.float32)
    r = np.arange(rows)
    for k, off in enumerate(pd.offsets):
        ok = (r + off >= 0) & (r + off < cols)
        dense[r[ok], r[ok] + off] = pd.data[k, r[ok]]
    np.testing.assert_array_equal(dense, m.toarray())


# ---------------------------------------------------------------------------
# refio
# ---------------------------------------------------------------------------

def _csc(rng, rows, cols, density, uint64=False):
    m = sp.random(rows, cols, density=density, format="csc",
                  random_state=np.random.RandomState(int(rng.integers(1 << 30))),
                  dtype=np.float64)
    m.sort_indices()
    data = m.data
    if uint64:
        data = rng.integers(0, 1 << 40, data.shape[0]).astype(np.uint64)
    return CSC(data=data, indices=m.indices.astype(np.int32),
               indptr=m.indptr.astype(np.int32), shape=m.shape)


def _files(directory):
    out = {}
    for f in sorted(os.listdir(directory)):
        with open(os.path.join(directory, f), "rb") as fh:
            out[f] = fh.read()
    return out


@pytest.mark.parametrize("uint64", [False, True])
def test_refio_writers_byte_identical(tmp_path, uint64):
    rng = np.random.default_rng(3)
    a = _csc(rng, 150, 90, 0.07, uint64=uint64)
    name = "mat-uint64" if uint64 else "mat"
    d = str(tmp_path / name)
    # upload.tcl names absolute paths: both writers write the same path,
    # one after the other
    got_cmds = refio.save_reference_matrix(a, d)
    got = _files(d)
    for f in os.listdir(d):
        os.remove(os.path.join(d, f))
    want_cmds = jrefio.save_reference_matrix(a, d)
    want = _files(d)
    assert got_cmds == want_cmds
    assert got == want
    assert sorted(got) == sorted(
        [f"{name}-{p}.bin" for p in ("meta", "indptr", "inds", "data")]
        + ["upload.tcl"])
    meta = refio.RefMeta.unpack(got[f"{name}-meta.bin"])
    assert meta.pack() == jrefio.RefMeta.unpack(
        want[f"{name}-meta.bin"]).pack()
    assert meta.indptr_base % refio.BURST_ALIGN == 0
    assert (refio.DRAM_BASE, refio.BURST_ALIGN, refio.META_BYTES) == \
        (jrefio.DRAM_BASE, jrefio.BURST_ALIGN, jrefio.META_BYTES)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("uint64", [False, True])
def test_refio_loads_across(tmp_path, writer, uint64):
    rng = np.random.default_rng(4)
    a = _csc(rng, 70, 130, 0.05, uint64=uint64)
    d = str(tmp_path / ("m-uint64" if uint64 else "m"))
    save = refio.save_reference_matrix if writer == "port" else \
        jrefio.save_reference_matrix
    save(a, d, write_upload_script=False)
    y = np.arange(a.shape[0], dtype=np.float64) * 0.5
    (refio.save_golden if writer == "port" else jrefio.save_golden)(y, d)
    got, want = refio.load_reference_matrix(d), jrefio.load_reference_matrix(d)
    for f in ("data", "indices", "indptr"):
        _same(getattr(got, f), getattr(want, f))
    assert got.shape == want.shape == a.shape
    assert got.indices.dtype == np.int32
    assert got.data.dtype == (np.dtype("<u8") if uint64 else np.dtype("<f8"))
    np.testing.assert_array_equal(got.data, a.data)
    _same(refio.load_golden(d), jrefio.load_golden(d))
    assert refio.load_golden(str(tmp_path / "nowhere")) is None


def test_refio_rejects_a_short_payload(tmp_path):
    rng = np.random.default_rng(5)
    a = _csc(rng, 40, 40, 0.1)
    d = str(tmp_path / "m")
    refio.save_reference_matrix(a, d)
    path = os.path.join(d, "m-inds.bin")
    np.fromfile(path, dtype="<u4")[:-1].tofile(path)
    for load in (refio.load_reference_matrix, jrefio.load_reference_matrix):
        with pytest.raises(ValueError, match="payload length"):
            load(d)


def test_matrix_market_round_trip(tmp_path):
    from scipy import io as scipy_io

    m = random_sparse(60, 45, 0.1, seed=6).astype(np.float64)
    path = str(tmp_path / "m.mtx")
    scipy_io.mmwrite(path, m)
    got, want = refio.load_matrix_market(path), jrefio.load_matrix_market(path)
    for f in ("data", "indices", "indptr"):
        _same(getattr(got, f), getattr(want, f))
    assert got.shape == want.shape == m.shape
    np.testing.assert_array_equal(pconvert.to_dense(got), m.toarray())
    # and on through the reference's binary format
    d = str(tmp_path / "mm")
    refio.save_reference_matrix(got, d)
    back = jrefio.load_reference_matrix(d)
    np.testing.assert_array_equal(jconvert.to_dense(back), m.toarray())


# ---------------------------------------------------------------------------
# plan_io
# ---------------------------------------------------------------------------

def _sell_cases():
    return {
        "window": lambda a: dict(),
        "windowless": lambda a: dict(max_window_blocks=0),
        "split": lambda a: dict(split=16),
    }


SAVE_CASES = sorted(_sell_cases())


@pytest.mark.parametrize("case", SAVE_CASES)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sell_plan_file_loads_across(tmp_path, case, writer):
    ja, pa = both(shuffled_band(2048, seed=7))
    kw = _sell_cases()[case](ja)
    jp, pp = jsell(ja, **kw), build_sell_plan(pa, **kw)
    assert_plans_equal(pp, jp)
    path = str(tmp_path / "plan.npz")
    if writer == "port":
        # a placed plan saves as well as a host one
        plan_io.save_plan(place(pp, torch.device("cpu")), path)
    else:
        jplan_io.save_plan(jp, path)
    got, want = plan_io.load_plan(path), jplan_io.load_plan(path)
    assert_plans_equal(got, want)
    assert_plans_equal(got, jp)
    assert got.stats.as_dict() == want.stats.as_dict()
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
    assert meta["suffix"] == jplan_io.config_suffix(jp)
    assert meta["stats"] == jp.stats.as_dict()


def _downgrade(path, version, drop):
    """Rewrite a plan file as an older version: without ``drop``."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k not in drop}
    meta = json.loads(bytes(arrays["meta"].tobytes()).decode())
    meta["version"] = version
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **arrays)


@pytest.mark.parametrize("version,drop", [
    (2, ("window_rows",)), (1, ("window_rows", "cols_win"))])
def test_old_plan_versions_upgrade_alike(tmp_path, version, drop):
    ja, _ = both(shuffled_band(2048, seed=8))
    jp = jsell(ja, window_grain=32)
    path = str(tmp_path / "old.npz")
    jplan_io.save_plan(jp, path)
    _downgrade(path, version, drop)
    got, want = plan_io.load_plan(path), jplan_io.load_plan(path)
    _same(got.window_rows, want.window_rows)
    _same(got.cols_win, want.cols_win)
    _same(got.window_rows, np.asarray(jp.window_rows))
    _same(got.cols_win, np.asarray(jp.cols_win))


def test_unknown_plan_version_raises(tmp_path):
    ja, pa = both(shuffled_band(1024, seed=9))
    path = str(tmp_path / "p.npz")
    plan_io.save_plan(build_sell_plan(pa), path)
    _downgrade(path, 7, ())
    for load in (plan_io.load_plan, jplan_io.load_plan):
        with pytest.raises(ValueError, match="unsupported plan version"):
            load(path)


def _suffix_plans():
    """name: (JAX plan) of every family config_suffix names."""
    band = banded(4096, list(range(-13, 14)), seed=1)
    uni = random_sparse(4096, 4096, 0.002, seed=2)
    return {
        "dia": lambda: jauto(jconvert.from_scipy(band)),
        "hybrid": lambda: jauto(jconvert.from_scipy(hybrid(32768, seed=2))),
        "window": lambda: jsell(jconvert.from_scipy(shuffled_band(
            2048, seed=3))),
        "windowless": lambda: jsell(jconvert.from_scipy(uni),
                                    max_window_blocks=0),
        "split_stripe": lambda: jsell(jconvert.from_scipy(uni), split=8,
                                      stripe_width=1024),
        "cached": lambda: jcached(jconvert.from_scipy(powerlaw_cols(0))),
        "cached_coo_tail": lambda: jcached(jconvert.from_scipy(
            zipf_cols(8192, 1 << 18, 24, 2.0, 300, 3))),
        "packed": lambda: jpacked(jconvert.from_scipy(uni)),
        "coo_tail": lambda: jtail(jconvert.from_scipy(uni)),
    }


@pytest.mark.parametrize("case", sorted(_suffix_plans()))
def test_config_suffix_equal(case):
    jp = _suffix_plans()[case]()
    pp = plan_from_reference(jp, "cpu")
    want = jplan_io.config_suffix(jp)
    assert plan_io.config_suffix(pp) == want
    # a host plan names itself alike
    assert plan_io.config_suffix(plan_to_numpy(pp)) == want


def test_config_suffix_of_families_without_one_raises():
    m = random_sparse(2048, 2048, 0.01, seed=10)
    ja, pa = both(m)
    band = both(banded(2048, [-1, 0, 1], seed=11))
    plans = [jchunk(ja), jsharded(ja, 4),
             jsharded_dia(band[0], 4, sublanes=8)]
    for jp in plans:
        with pytest.raises(AttributeError):
            jplan_io.config_suffix(jp)
        pp = plan_from_reference(jp, "cpu")
        with pytest.raises(AttributeError):
            plan_io.config_suffix(pp)


def test_save_plan_refuses_other_families(tmp_path):
    ja, pa = both(banded(2048, [-1, 0, 1], seed=12))
    jp, pp = jauto(ja), auto_plan(pa)
    assert type(pp).__name__ == type(jp).__name__ == "DiaPlan"
    path = str(tmp_path / "d.npz")
    with pytest.raises(ValueError):
        jplan_io.save_plan(jp, path)
    with pytest.raises(ValueError):
        plan_io.save_plan(pp, path)
