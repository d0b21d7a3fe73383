"""Round-trip tests for the file formats."""

import pytest
import numpy as np

from colate_tpu.formats.coal import CoalFile, write_mut_coal
from colate_tpu.formats.colate_in import read_colate_in, write_colate_in
from colate_tpu.formats.colate_mat import read_colate_mat, write_colate_mat
from colate_tpu.formats.fasta import read_fasta, read_mask, write_fasta
from colate_tpu.formats.mut import MutTable
from helpers.synth import make_mut


def test_mut_roundtrip(tmp_path):
    p = str(tmp_path / "a.mut")
    tbl = make_mut(p, 500, seed=3)
    back = MutTable.read(p)
    np.testing.assert_array_equal(tbl.pos, back.pos)
    np.testing.assert_array_equal(tbl.flipped, back.flipped)
    np.testing.assert_array_equal(tbl.num_branches, back.num_branches)
    # ages go through %g 6-digit formatting then float32 parse
    np.testing.assert_allclose(tbl.age_end, back.age_end, rtol=1e-5)
    assert list(tbl.mutation_type) == list(back.mutation_type)


def test_mut_gz_roundtrip(tmp_path):
    p = str(tmp_path / "a.mut.gz")
    tbl = make_mut(p, 50, seed=4)
    back = MutTable.read(str(tmp_path / "a.mut"))  # .gz fallback
    np.testing.assert_array_equal(tbl.pos, back.pos)


def test_colate_in_roundtrip(tmp_path):
    p = str(tmp_path / "x.colate.in")
    chrom = np.array(["1"] * 5 + ["22"] * 4, dtype=object)
    bp = np.array([10, 20, 30, 40, 50, 5, 6, 7, 8], np.int64)
    anc = np.array([ord(c) for c in "ACGTAACGT"], np.uint8)
    der = np.array([ord(c) for c in "CGTACCGTA"], np.uint8)
    aaf = np.arange(9, dtype=np.int64)
    daf = np.arange(9, dtype=np.int64)[::-1].copy()
    write_colate_in(p, chrom, bp, anc, der, aaf, daf)
    st = read_colate_in(p)
    assert list(st.chrom) == list(chrom)
    np.testing.assert_array_equal(st.bp, bp)
    np.testing.assert_array_equal(st.anc, anc)
    np.testing.assert_array_equal(st.aaf, aaf)
    np.testing.assert_array_equal(st.daf, daf)


def test_coal_roundtrip(tmp_path):
    p = str(tmp_path / "o.coal")
    epochs = np.array([0.0, 0.0, 56.6033, 1000.0, 3.57143e6])
    rates = np.array([[0.0, 1.3e-2, 5e-9, 1e-5, 5e-5]])
    write_mut_coal(p, epochs, rates)
    cf = CoalFile.read(p)
    np.testing.assert_allclose(cf.epochs, epochs, rtol=1e-5)
    np.testing.assert_allclose(cf.rates[0], rates[0], rtol=1e-5)


def test_colate_mat_roundtrip(tmp_path):
    p = str(tmp_path / "m.colate_mat")
    bins = np.linspace(0, 10, 185)
    sh = np.random.default_rng(0).random((2, 185))
    ns = np.random.default_rng(1).random((2, 185))
    write_colate_mat(p, bins, sh, ns)
    b2, s2, n2 = read_colate_mat(p, 2)
    np.testing.assert_allclose(s2, sh, rtol=1e-5)
    np.testing.assert_allclose(n2, ns, rtol=1e-5)


def test_fasta_mask(tmp_path):
    p = str(tmp_path / "m.fa")
    write_fasta(p, "1", "ppNPPNpP")
    seq = read_fasta(p)
    assert seq == "PPNPPNPP"
    mask = read_mask(p)
    assert mask[2] == ord("N")
    assert mask[0] == ord("P")


def test_annotate_ages_matches_tree_coordinates(tmp_path):
    """Mutations::GetAge (mutations.cpp:28-54): in an internally
    consistent tree, the left-descent branch-length sum equals the node's
    age, so age_begin == node age and age_end == parent age."""
    from helpers.synth_anc import make_anc_mut
    from colate_tpu.formats.anc import node_ages
    from colate_tpu.formats.mut import annotate_ages

    anc, tbl = make_anc_mut(str(tmp_path / "ga"), "1", N=8, num_trees=11, seed=3)
    ages = node_ages(anc)  # [T, M] f32 coordinates
    annotate_ages(tbl, anc)
    for i in range(len(tbl)):
        t = int(tbl.tree[i])
        b = tbl.branch[i][0]
        assert tbl.age_begin[i] == pytest.approx(float(ages[t, b]), rel=1e-5)
        par = int(anc.parent[t, b])
        assert tbl.age_end[i] == pytest.approx(float(ages[t, par]), rel=1e-5)


def test_collapsed_matrix_roundtrip(tmp_path):
    """CollapsedMatrix binary layout: (uint64 rows, uint64 cols, data)."""
    import numpy as np

    from colate_tpu.formats.collapsed import read_collapsed, write_collapsed

    g = np.random.default_rng(2)
    a = g.normal(size=(7, 5)).astype(np.float32)
    b = g.integers(0, 100, (3, 9)).astype(np.int32)
    p = tmp_path / "cm.bin"
    with open(p, "wb") as fh:
        write_collapsed(fh, a)
        write_collapsed(fh, b)
    with open(p, "rb") as fh:
        a2 = read_collapsed(fh, np.float32)
        b2 = read_collapsed(fh, np.int32)
    np.testing.assert_array_equal(a, a2)
    np.testing.assert_array_equal(b, b2)
    # byte-level check of the C++ layout
    raw = open(p, "rb").read()
    assert raw[:16] == np.asarray([7, 5], np.uint64).tobytes()
    assert raw[16 : 16 + a.nbytes] == a.tobytes()


@pytest.mark.parametrize("native_reader", [True, False])
def test_mut_read_needs_no_pandas(tmp_path, monkeypatch, native_reader):
    """MutTable.read goes native reader -> reference-grammar parser; no
    tier imports pandas, so the main path runs where pandas is absent."""
    import sys

    from colate_tpu import native

    p = str(tmp_path / "a.mut")
    tbl = make_mut(p, 300, seed=6)
    monkeypatch.setitem(sys.modules, "pandas", None)  # import fails
    if not native_reader:
        monkeypatch.setattr(native, "load", lambda: None)
    elif native.load() is None:
        pytest.skip("native library unavailable")
    back = MutTable.read(p)
    np.testing.assert_array_equal(tbl.pos, back.pos)
    np.testing.assert_array_equal(tbl.num_branches, back.num_branches)
    np.testing.assert_allclose(tbl.age_begin, back.age_begin, rtol=1e-5)
    assert list(tbl.mutation_type) == list(back.mutation_type)
