"""Golden tests: compare_tmp, count_topo, CondCoalRates."""

import filecmp
import os
import subprocess

import numpy as np
import pytest

from helpers.synth import REF_COLATE, make_fixture, make_stream
from helpers.synth_anc import make_anc_mut


@pytest.mark.oracle
def test_compare_tmp_golden(oracle, fixture_small, tmp_path):
    fix = fixture_small
    ref_out = str(tmp_path / "ref_cmp.txt")
    subprocess.run(
        [
            oracle, "--mode", "compare_tmp",
            "--mut", fix["mut_prefix"],
            "--target_tmp", fix["target"],
            "--reference_tmp", fix["reference"],
            "--chr", fix["chrfile"],
            "--seed", "11",
            "-o", ref_out,
        ],
        check=True, capture_output=True, timeout=300,
    )

    class Args:
        mut = fix["mut_prefix"]
        target_tmp = fix["target"]
        reference_tmp = fix["reference"]
        chr_file = fix["chrfile"]
        seed = 11
        output = str(tmp_path / "our_cmp.txt")

    from colate_tpu.models.compare_tmp import run_compare_tmp

    run_compare_tmp(Args())
    assert filecmp.cmp(ref_out, Args.output, shallow=False), "compare_tmp differs"


@pytest.mark.oracle
def test_count_topo_golden(oracle, fixture_small, tmp_path):
    fix = fixture_small
    # conditional stream: reuse the reference stream generator with a new seed
    cond = str(tmp_path / "cond.colate.in")
    make_stream(cond, fix["chroms"], fix["mut_tables"], seed=777, n_hap=8)
    ref_out = str(tmp_path / "ref_topo.txt")
    subprocess.run(
        [
            oracle, "--mode", "count_topo",
            "--mut", fix["mut_prefix"],
            "--target_tmp", fix["target"],
            "--reference_tmp", fix["reference"],
            "-i", cond,
            "--chr", fix["chrfile"],
            "--seed", "13",
            "-o", ref_out,
        ],
        check=True, capture_output=True, timeout=300,
    )

    class Args:
        mut = fix["mut_prefix"]
        target_tmp = fix["target"]
        reference_tmp = fix["reference"]
        input = cond
        chr_file = fix["chrfile"]
        seed = 13
        output = str(tmp_path / "our_topo.txt")

    from colate_tpu.models.compare_tmp import run_count_topo

    run_count_topo(Args())
    assert filecmp.cmp(ref_out, Args.output, shallow=False), "count_topo differs"


@pytest.fixture(scope="module")
def cond_fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("condfix"))
    prefix = os.path.join(root, "trees")
    for i, c in enumerate(["1", "2"]):
        make_anc_mut(prefix, c, N=12, num_trees=19, seed=61 + i)
    chrfile = os.path.join(root, "chr.txt")
    with open(chrfile, "w") as fh:
        fh.write("1\n2\n")
    pop = os.path.join(root, "pop.poplabels")
    with open(pop, "w") as fh:
        fh.write("sample population group sex\n")
        for i in range(6):
            fh.write(f"S{i} {'FOC' if i < 2 else 'CON' if i < 4 else 'OTH'} G1 NA\n")
    return dict(prefix=prefix, chrfile=chrfile, pop=pop)


def _cond_args(prefix, chrfile, pop, out, groups="FOC,CON", boots=1,
               sampling="analytic"):
    class Args:
        input = prefix
        chr_file = chrfile
        poplabels = pop
        bins = "2,6,0.5"
        years_per_gen = None
        lineage_bin = None
        num_bootstraps = boots
        seed = 7
        mask = None
        mask_cutoff = None
        map = None
        coal = None
        output = out

    Args.groups = groups
    Args.sampling = sampling
    return Args


@pytest.mark.oracle
def test_cond_coal_rates_byte_parity_at_scale(oracle, tmp_path):
    """3000 trees, bootstrap: the native kernel's float32 accumulation
    order must reproduce the binary BYTE-FOR-BYTE (the f32 rounding
    pattern over millions of scalar adds is observable output)."""
    from colate_tpu import native

    if native.load() is None:
        pytest.skip("native kernel unavailable")
    root = str(tmp_path)
    prefix = os.path.join(root, "trees")
    make_anc_mut(prefix, "1", N=14, num_trees=3000, snps_per_tree=3, seed=9)
    chrfile = os.path.join(root, "chr.txt")
    with open(chrfile, "w") as fh:
        fh.write("1\n")
    pop = os.path.join(root, "pop.poplabels")
    with open(pop, "w") as fh:
        fh.write("sample population group sex\n")
        for i in range(7):
            fh.write(f"S{i} {'FOC' if i < 2 else 'CON' if i < 4 else 'OTH'} G1 NA\n")
    ref_out = os.path.join(root, "ref.txt")
    subprocess.run(
        [REF_COLATE, "--mode", "CondCoalRates", "-i", prefix, "--chr", chrfile,
         "--poplabels", pop, "--groups", "FOC,CON", "--bins", "2,6,0.5",
         "--seed", "7", "--num_bootstraps", "4", "-o", ref_out],
        check=True, capture_output=True, timeout=300,
    )
    from colate_tpu.models.cond_coal import run_cond_coal

    out = os.path.join(root, "our.txt")
    run_cond_coal(
        _cond_args(prefix, chrfile, pop, out, boots=4, sampling="mc_parity")
    )
    with open(ref_out) as fh:
        ref = fh.read()
    with open(out) as fh:
        ours = fh.read()
    assert ref == ours

    # the default analytic f64 kernel (cn_cond_chrom_fast) must agree
    # with the replay to f32 accumulation tolerance at the same scale
    out2 = os.path.join(root, "our_analytic.txt")
    run_cond_coal(_cond_args(prefix, chrfile, pop, out2, boots=4))
    with open(out2) as fh:
        ours2 = fh.read()
    assert ours2.splitlines()[0] == ref.splitlines()[0]
    n_checked = 0
    for r, o in zip(ref.splitlines()[1:], ours2.splitlines()[1:]):
        rp, op = r.split(), o.split()
        assert rp[:4] == op[:4], (r, o)
        if rp[4] not in ("nan", "-nan", "inf", "-inf"):
            np.testing.assert_allclose(
                float(op[4]), float(rp[4]), rtol=1e-4, err_msg=(r, o)
            )
            n_checked += 1
    assert n_checked > 50


@pytest.mark.oracle
def test_cond_coal_rates_ancient_golden(oracle, tmp_path):
    """Nonzero sample ages route through the per-pair truncation variant
    (coal.cpp:4885-4999) — byte parity with the binary."""
    from colate_tpu import native

    if native.load() is None:
        pytest.skip("native kernel unavailable")
    root = str(tmp_path)
    prefix = os.path.join(root, "trees")
    ages = [0.0, 40.0, 0.0, 125.0, 0.0, 0.0, 7.5, 0.0, 0.0, 310.0, 0.0, 0.0]
    make_anc_mut(prefix, "1", N=12, num_trees=400, seed=23, sample_ages=ages)
    chrfile = os.path.join(root, "chr.txt")
    with open(chrfile, "w") as fh:
        fh.write("1\n")
    pop = os.path.join(root, "pop.poplabels")
    with open(pop, "w") as fh:
        fh.write("sample population group sex\n")
        for i in range(6):
            fh.write(f"S{i} {'FOC' if i < 2 else 'CON' if i < 4 else 'OTH'} G1 NA\n")
    ref_out = os.path.join(root, "ref.txt")
    subprocess.run(
        [REF_COLATE, "--mode", "CondCoalRates", "-i", prefix, "--chr", chrfile,
         "--poplabels", pop, "--groups", "FOC,CON", "--bins", "2,6,0.5",
         "--seed", "7", "-o", ref_out],
        check=True, capture_output=True, timeout=300,
    )
    from colate_tpu.models.cond_coal import run_cond_coal

    out = os.path.join(root, "our.txt")
    run_cond_coal(_cond_args(prefix, chrfile, pop, out))
    with open(ref_out) as fh:
        ref = fh.read()
    with open(out) as fh:
        ours = fh.read()
    assert ref == ours


@pytest.mark.oracle
def test_cond_coal_rates_mask_map_golden(oracle, cond_fixture, tmp_path):
    """Mask passing-fraction + genetic-map recrate filters against the
    reference binary (coal.cpp:5296-5385 window + cursor semantics)."""
    import numpy as np

    from colate_tpu.formats.mut import MutTable

    root = str(tmp_path)
    g = np.random.default_rng(5)
    mask_prefix = os.path.join(root, "mask")
    map_prefix = os.path.join(root, "map")
    for c in ["1", "2"]:
        # mask must cover every window position (the binary reads
        # mask.seq[pos] unchecked); ~60% P with N patches
        mt = MutTable.read(cond_fixture["prefix"] + f"_chr{c}.mut")
        L = int(mt.pos[-1]) + 10_000
        # the effective cutoff is the hardcoded 0.9 (the binary ignores
        # --mask_cutoff in this mode); ~95% P puts windows on both sides
        seq = np.where(g.random(L) < 0.95, ord("P"), ord("N")).astype(np.uint8)
        with open(f"{mask_prefix}_chr{c}.fa", "w") as fh:
            fh.write(">mask\n" + bytes(seq).decode() + "\n")
        # map with varied rates so some windows exceed the 0.1 cutoff;
        # the final point must cover every window (past it the binary's
        # cursor walk reads out of bounds — genuine UB, untestable)
        bps = np.sort(g.choice(np.arange(1, L - 1), size=11, replace=False))
        bps = np.append(bps, L)
        # mostly cold map with a few hot segments above the 0.1 cM/Mb cutoff
        rates = np.where(
            g.random(bps.size) < 0.3,
            g.uniform(0.5, 3.0, bps.size),
            g.uniform(0.0, 0.05, bps.size),
        )
        gen = np.concatenate([[0.0], np.cumsum(rates[:-1] * np.diff(bps) / 1e6)])
        with open(f"{map_prefix}_chr{c}.txt", "w") as fh:
            fh.write("pos COMBINED_rate Genetic_Map\n")
            for b, r, gn in zip(bps, rates, gen):
                fh.write(f"{b} {r} {gn}\n")

    ref_out = str(tmp_path / "ref_maskmap.txt")
    subprocess.run(
        [
            REF_COLATE, "--mode", "CondCoalRates",
            "-i", cond_fixture["prefix"],
            "--chr", cond_fixture["chrfile"],
            "--poplabels", cond_fixture["pop"],
            "--groups", "FOC,CON",
            "--bins", "2,6,0.5",
            "--mask", mask_prefix,
            "--map", map_prefix,
            "--seed", "7",
            "-o", ref_out,
        ],
        check=True, capture_output=True, timeout=300,
    )

    class Args:
        input = cond_fixture["prefix"]
        chr_file = cond_fixture["chrfile"]
        poplabels = cond_fixture["pop"]
        groups = "FOC,CON"
        bins = "2,6,0.5"
        years_per_gen = None
        lineage_bin = None
        num_bootstraps = 1
        seed = 7
        mask = mask_prefix
        mask_cutoff = None
        map = map_prefix
        coal = None
        output = str(tmp_path / "our_maskmap.txt")

    from colate_tpu.models.cond_coal import run_cond_coal

    run_cond_coal(Args())
    with open(ref_out) as fh:
        ref_lines = fh.read().splitlines()
    with open(Args.output) as fh:
        our_lines = fh.read().splitlines()
    assert len(ref_lines) == len(our_lines)
    n_rates = 0
    for r, o in zip(ref_lines[1:], our_lines[1:]):
        rp, op = r.split(), o.split()
        assert rp[:4] == op[:4], (r, o)
        if rp[4] not in ("nan", "-nan"):
            # %g prints 6 significant digits: a last-digit flip is
            # ~1e-6 relative on top of the true difference
            assert abs(float(rp[4]) - float(op[4])) <= 5e-6 * max(
                abs(float(rp[4])), 1e-30
            ), (r, o)
            n_rates += 1
    assert n_rates > 10  # filters must not have removed everything


@pytest.mark.oracle
@pytest.mark.parametrize("groups", ["FOC,CON", "FOC,NONEXIST"])
def test_cond_coal_rates_golden(oracle, cond_fixture, tmp_path, groups):
    ref_out = str(tmp_path / f"ref_{groups.replace(',', '_')}.txt")
    subprocess.run(
        [
            REF_COLATE, "--mode", "CondCoalRates",
            "-i", cond_fixture["prefix"],
            "--chr", cond_fixture["chrfile"],
            "--poplabels", cond_fixture["pop"],
            "--groups", groups,
            "--bins", "2,6,0.5",
            "--seed", "7",
            "-o", ref_out,
        ],
        check=True, capture_output=True, timeout=300,
    )

    class Args:
        input = cond_fixture["prefix"]
        chr_file = cond_fixture["chrfile"]
        poplabels = cond_fixture["pop"]
        bins = "2,6,0.5"
        years_per_gen = None
        lineage_bin = None
        num_bootstraps = 1
        seed = 7
        mask = None
        mask_cutoff = None
        map = None
        coal = None
        output = str(tmp_path / "our_cond.txt")

    Args.groups = groups
    from colate_tpu.models.cond_coal import run_cond_coal

    run_cond_coal(Args())

    with open(ref_out) as fh:
        ref_lines = fh.read().splitlines()
    with open(Args.output) as fh:
        our_lines = fh.read().splitlines()
    assert ref_lines[0] == our_lines[0]
    assert len(ref_lines) == len(our_lines)
    n_exact = 0
    for r, o in zip(ref_lines[1:], our_lines[1:]):
        rp, op = r.split(), o.split()
        assert rp[:4] == op[:4], (r, o)
        rv, ov = rp[4], op[4]
        if rv in ("nan", "-nan", "inf", "-inf"):
            assert ov in ("nan", "-nan", "inf", "-inf"), (r, o)
        else:
            np.testing.assert_allclose(float(ov), float(rv), rtol=2e-3, err_msg=(r, o))
            n_exact += 1
    assert n_exact > 20
