"""chip_smoke.py's yardstick and its reading of the kernel library past d =
8, on the CPU: the operations and bounds it measures the wide kernels
against, the dispatch table it reads from csrc/vc_phi.cu, the kernel bodies
it counts in the SASS, and the ptxas report it refuses a spill by; and the
32-lane group kernels' arithmetic (transcribed in
tests/test_torch_wide_kernels.py) at d = 32 against the plain twins and
JAX's dense reference.
"""

import torch_threads  # noqa: F401  (one torch thread per process)
import pytest

import chip_smoke
from gpz_tpu_torch.ops import vc_phi
from test_torch_wide_kernels import check_group_backward, check_group_forward


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_group_forward_arithmetic_at_32_bands(dtype):
    check_group_forward(32, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_group_backward_arithmetic_at_32_bands(dtype):
    check_group_backward(32, dtype)


# --- the yardstick at the wide widths ---

@pytest.mark.parametrize("d,fwd,bwd", [(9, 458, 1359), (12, 934, 2820),
                                       (16, 1970, 6000), (32, 13154, 40160)])
def test_chip_smoke_ops_are_pinned_at_the_wide_widths(d, fwd, bwd):
    """Operations per pair that chip_smoke.py's bounds count at the survey
    widths: the functions' work, not any kernel's instructions."""
    assert chip_smoke.fwd_ops(d) == fwd
    assert chip_smoke.bwd_ops(d) == bwd


def test_chip_smoke_bounds_are_pinned_at_nine_bands():
    """At the nine-band training shape (70,000 x 100, d = 9, float64) the
    bounds are 0.0943 ms forward and 0.2799 ms backward, by operations."""
    for kind, ms in (("fwd", 0.0943), ("bwd", 0.2799)):
        b = chip_smoke.bound(kind, 70000, 100, 9, "float64")
        assert b["bound_by"] == "operations"
        assert round(b["bound_ms"], 4) == ms
        assert b["bound_ms"] == b["ops_ms"] > b["bytes_ms"]


# --- chip_smoke.py's reading of the library ---

def test_dispatch_table_is_read_from_the_source():
    table = chip_smoke.dispatch_table()
    assert table["D_MAX"] == 8 and table["GROUP_MAX"] == 32
    for k in ("FWD_REG_MAX", "BWD_REG_MAX"):
        assert table["D_MAX"] < table[k] < table["GROUP_MAX"]
    with open(vc_phi.SOURCE) as fh:
        src = fh.read()
    # every register-design width the table uses is instantiated, no other
    for k, fn in (("FWD_REG_MAX", "reg_fwd_t("), ("BWD_REG_MAX", "reg_bwd_t("),
                  ("BWD_REG_MAX", "reg_bwd_spans_t(")):
        block = src[src.index(fn):]
        block = block[:block.index("#undef GPZ_CASE")]
        for d in range(9, 33):
            assert (f"GPZ_CASE({d})" in block) == (d <= table[k]), (fn, d)


def test_expected_bodies_count_the_table():
    """Both types of: the templates' forward and backward to d = 8, the
    register designs to FWD_REG_MAX / BWD_REG_MAX, the group kernels the
    table uses and the two strided kernels."""
    table = {"D_MAX": 8, "FWD_REG_MAX": 12, "BWD_REG_MAX": 12,
             "GROUP_MAX": 32}
    assert chip_smoke.expected_bodies(table) == 2 * (16 + 4 + 4 + 4 + 2)
    table.update(FWD_REG_MAX=8, BWD_REG_MAX=10)
    assert chip_smoke.expected_bodies(table) == 2 * (16 + 0 + 2 + 4 + 2)


@pytest.mark.parametrize("name,body", [
    ("_ZN12_GLOBAL__N_119vc_lnphi_fwd_kernelIdLi12EEEvPKT_S3_S3_S3_S3_PS1_"
     "iiii", ("vc_lnphi_fwd_kernel", "double", 12)),
    ("_ZN12_GLOBAL__N_124vc_lnphi_bwd_ssum_kernelIfLi9EEEvPKT_S3_S3_S3_S3_"
     "PS1_iiiiii", ("vc_lnphi_bwd_ssum_kernel", "float", 9)),
    ("_ZN12_GLOBAL__N_125vc_lnphi_bwd_group_kernelIdLi32EEEvPKT_S3_S3_S3_"
     "S3_PS1_iiiiii", ("vc_lnphi_bwd_group_kernel", "double", 32)),
    ("_ZN12_GLOBAL__N_124vc_lnphi_fwd_wide_kernelIfEEvPKT_S3_S3_S3_S3_PS1_"
     "iiiS4_", ("vc_lnphi_fwd_wide_kernel", "float", None)),
    ("_ZN12_GLOBAL__N_126vc_lnphi_bwd_reduce_kernelIdEEvPKT_PS1_S4_iii",
     None),
])
def test_kernel_body_names(name, body):
    assert chip_smoke.kernel_body(name) == body


def test_dispatched_wide_bodies_follow_the_table():
    table = {"D_MAX": 8, "FWD_REG_MAX": 12, "BWD_REG_MAX": 10,
             "GROUP_MAX": 32}
    on = chip_smoke.dispatched_wide
    assert on(("vc_lnphi_fwd_kernel", "double", 12), table)
    assert not on(("vc_lnphi_fwd_kernel", "double", 8), table)
    assert on(("vc_lnphi_bwd_ssum_kernel", "float", 10), table)
    assert not on(("vc_lnphi_bwd_ssum_kernel", "float", 11), table)
    assert on(("vc_lnphi_fwd_group_kernel", "double", 16), table)
    assert on(("vc_lnphi_bwd_group_kernel", "double", 32), table)
    assert not on(("vc_lnphi_bwd_kernel", "double", 8), table)
    assert not on(("vc_lnphi_fwd_wide_kernel", "double", None), table)
    assert chip_smoke.body_for("bwd", 11, table) == (
        "vc_lnphi_bwd_group_kernel", 16)
    assert chip_smoke.body_for("fwd", 12, table) == (
        "vc_lnphi_fwd_kernel", 12)
    assert chip_smoke.body_for("fwd", 17, table) == (
        "vc_lnphi_fwd_group_kernel", 32)


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119vc_lnphi_fwd_kernelIdLi12EEEvPKT_S3_S3_S3_S3_PS1_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119vc_lnphi_fwd_kernelIdLi12EEEvPKT_S3_S3_S3_S3_PS1_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 222 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119vc_lnphi_bwd_kernelIdLi8EEEvPKT_S3_S3_S3_S3_PS1_iiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119vc_lnphi_bwd_kernelIdLi8EEEvPKT_S3_S3_S3_S3_PS1_iiiii
    56 bytes stack frame, 56 bytes spill stores, 56 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_build_report_reads_ptxas_and_fails_on_a_dispatched_spill():
    """The <double, 8> template's spill (d = 8 is not past D_MAX) is
    reported, not refused; a spill in a body the table uses past D_MAX
    fails the run."""
    table = chip_smoke.dispatch_table()
    reports = chip_smoke.build_report(PTXAS_LOG, table)
    assert [r["registers"] for r in reports.values()] == [222, 255]
    assert [r["spill_stores"] for r in reports.values()] == [0, 56]
    bad = PTXAS_LOG.replace("0 bytes spill stores", "8 bytes spill stores", 1)
    with pytest.raises(chip_smoke.SmokeFailure, match="spills"):
        chip_smoke.build_report(bad, table)


# --- the library's parts and phase 21's widths ---

def test_parts_are_counted_from_the_source():
    """build() compiles one part per GPZ_IN_PART(k) of the source (0 ... 4
    in csrc/vc_phi.cu), and a source without them as one."""
    with open(vc_phi.SOURCE, "rb") as fh:
        src = fh.read()
    assert vc_phi.parts(src) == 5
    assert vc_phi.parts(src.replace(b"GPZ_IN_PART(4)", b"GPZ_IN_PART(3)")) \
        == 4
    assert vc_phi.parts(b"__global__ void k() {}") == 1


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_wide_small_widths_reach_every_dispatched_body(dtype):
    """Phase 21's 300 x 37 cases launch, in each type, both group widths
    with idle lanes and without, a register width, and the strided kernels;
    in float64 every register width and every d of the 16-lane groups."""
    table = chip_smoke.dispatch_table()
    widths = chip_smoke.WIDE_SMALL[dtype]
    bodies = {chip_smoke.body_for(kind, d, table)
              for kind in ("fwd", "bwd") for d in widths if d <= 32}
    for kind, k in (("fwd", "FWD_REG_MAX"), ("bwd", "BWD_REG_MAX")):
        # each group width the table uses, with idle lanes and without
        for g in (16, 32):
            if table[k] < g:
                assert (f"vc_lnphi_{kind}_group_kernel", g) in bodies
                assert g in widths
                assert any(max(table[k], g - 16) < d < g for d in widths)
        assert any(8 < d <= table[k] for d in widths)
    assert any(d > 32 for d in widths)
    if dtype == "float64":  # every width of the register designs
        assert set(range(9, max(table["FWD_REG_MAX"],
                                table["BWD_REG_MAX"]) + 1)) <= set(widths)


@pytest.mark.parametrize("n,d,m", chip_smoke.WIDE_MANY_BASES)
def test_many_bases_cases_pass_the_grid_second_dimension(n, d, m):
    """Each case's chunks of the group kernels (16-lane forward 32 bases,
    32-lane 16; backward 256 / G) outnumber the 65,535 a grid's second
    dimension holds, and stay within one call's pairs."""
    g = 16 if d <= 16 else 32
    table = chip_smoke.dispatch_table()
    assert d > table["BWD_REG_MAX"] and d <= table["GROUP_MAX"]
    assert -(-m // (256 // g)) > 65535
    if g == 32:
        assert -(-m // 16) > 65535
    assert n * m <= vc_phi.MAX_PAIRS


def test_many_bases_inputs_repeat_a_pool_of_sigmas():
    import torch

    gen = torch.Generator().manual_seed(3)
    X, psi, P, Sigma, lds = chip_smoke.many_bases_inputs(
        gen, 4, 6, 2000, torch.float64, "cpu")
    assert X.shape == (4, 6) and psi.shape == (4, 6, 6)
    assert P.shape == (2000, 6) and Sigma.shape == (2000, 6, 6)
    assert all(t.is_contiguous() for t in (X, psi, P, Sigma, lds))
    assert torch.equal(Sigma[5], Sigma[5 + 997])
    assert not torch.equal(Sigma[5], Sigma[6])
    assert not torch.equal(P[5], P[5 + 997])
    torch.testing.assert_close(lds, torch.linalg.slogdet(Sigma)[1])
    assert bool((torch.linalg.eigvalsh(Sigma)[:, 0] > 0.4).all())
    assert bool((torch.linalg.eigvalsh(psi)[:, 0] > 0.1).all())


def test_ab_groups_source_moves_only_the_table():
    """wide_kernels_ab.py's `groups` library: this source with both
    register designs' entries at 8, every other byte the same; a source
    without the entries is refused."""
    import wide_kernels_ab

    with open(vc_phi.SOURCE, "rb") as fh:
        src = fh.read()
    got = wide_kernels_ab.groups_source(src)
    for k in (b"FWD_REG_MAX", b"BWD_REG_MAX"):
        assert b"constexpr int " + k + b" = 8;" in got
    assert len(got.splitlines()) == len(src.splitlines())
    assert sum(a != b for a, b in zip(got.splitlines(),
                                      src.splitlines())) == 2
    with pytest.raises(RuntimeError, match="FWD_REG_MAX"):
        wide_kernels_ab.groups_source(b"int x;")
