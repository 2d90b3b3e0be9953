"""The frozen arithmetic against the numbers it was copied for."""

import pytest

from portbench import counts, spec as specs
from portbench.families import progen
from portbench.tests.tiny import CHECKOUT


def raw_config(name):
    return specs.load_config(CHECKOUT / "portbench" / "configs"
                             / f"{name}.json")


def config(name):
    return progen.Spec.from_dict(raw_config(name))


def test_bound_ms_gives_the_kernel_tables_bound_column():
    """PERF.md's kernel table: A1, L1, L2 at base's batch 8, A2 at its
    micro-batch 4."""
    base = config("base")
    at8, at4 = progen.kernel_bounds(base, 8), progen.kernel_bounds(base, 4)
    assert round(at8["A1"]["bound_ms"], 4) == 0.0200
    assert at8["A1"]["bound_by"] == "bytes"
    assert round(at4["A2"]["bound_ms"], 4) == 0.0217
    assert at4["A2"]["bound_by"] == "operations"
    assert round(at8["L1"]["bound_ms"], 4) == 0.0100
    assert round(at8["L2"]["bound_ms"], 4) == 0.0313


@pytest.mark.parametrize("name, flops, params", [
    ("base", 2_722_844_160, 401_378_560),
    ("large", 7_902_830_592, 1_223_815_168)])
def test_flops_per_token_and_parameters(name, flops, params):
    spec = config(name)
    assert spec.num_params() == params
    assert progen.flops_per_token(spec) == flops


def test_the_program_counts_the_same_parameters():
    from progen_tpu_torch.config import ProGenConfig

    for name in ("base", "large"):
        raw = raw_config(name)
        assert ProGenConfig.from_dict(specs.program_dict(raw)).num_params() \
            == config(name).num_params()


def test_visible_pairs():
    assert counts.visible_pairs(1024, 512) == 524_800
    assert counts.visible_pairs(8, 4, halo=True) == 8 * 4 + 4 * 5


@pytest.mark.parametrize("name, rid", [
    ("void (anonymous namespace)::fwd_tc_kernel<__nv_bfloat16, 64>(x)",
     "A1"),
    ("void (anonymous namespace)::kv_tc_kernel<__nv_bfloat16, 128>(x)",
     "A2"),
    ("void progen_attn_tc::rows_tc_kernel<__nv_bfloat16, 64, false>(x)",
     "A2"),
    ("void (anonymous namespace)::norm_shift_kernel<__nv_bfloat16, 1, 2>()",
     "L1"),
    ("void (anonymous namespace)::sgu_mix_tc_kernel<__nv_bfloat16>(x)",
     "L2"),
    ("void (anonymous namespace)::local_attention_fwd_kernel<float, 64>(x)",
     "A1"),
    ("void (anonymous namespace)::kv_kernel<float, 64>(x)", "A2"),
    ("void progen_attn::rows_kernel<float, 64, true>(x)", "A2"),
    ("void (anonymous namespace)::halo_tc_kernel<__nv_bfloat16, 64>(x)",
     "A3"),
    ("void (anonymous namespace)::halo_kernel<float, 64>(x)", "A3"),
    ("void (anonymous namespace)::sgu_gate_stats<float>(x)", "L2"),
    ("void (anonymous namespace)::sgu_gate_norm<__nv_bfloat16>(x)", "L2"),
    ("void (anonymous namespace)::sgu_mix_kernel<float>(x)", "L2"),
    ("void at::native::vectorized_elementwise_kernel<4, float>(x)", None),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128", None)])
def test_kernel_names(name, rid):
    assert counts.kernel_matcher(progen.KERNEL_NAMES)(name) == rid


def test_train_step_work_counts_remat_forwards():
    base = config("base")
    passes = progen.train_step_passes(base, 4)
    calls = progen.kernel_calls(base, **passes)
    # PERF.md's launches a base step: A1 192, A2 96, L1 384, L2 16
    assert calls == {"A1": 192, "A2": 96, "L1": 384, "L2": 16}


def test_kernels_roofline_goes_silent_without_a_kernel():
    base = config("base")
    passes = dict(rows=4, forwards=8, backwards=4)
    work = counts.traced_work(progen, base, passes)
    assert work == progen.work_ms(base, 4, forwards=8, backwards=4)
    spent = {rid: 2 * ms / 1e3 for rid, ms in work.items()}
    assert counts.kernels_roofline(work, spent) == pytest.approx(50)
    del spent["L1"]
    assert counts.kernels_roofline(work, spent) is None
