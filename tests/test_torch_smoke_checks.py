"""The checks ``chip_smoke.py`` holds the tensor-core flash kernels to, run
here on the CPU where they need no card.

* ``sdpa_witness`` -- the yardstick the bf16 forward and dK/dV kernels are
  held against -- computes the same function as the plain versions:
  causal or not, GQA, ALiBi (as the row-shifted mask ``slope * (key -
  query)``), a sliding window; in fp32 the two agree to rounding.
* ``check_witnessed`` passes an output within the one-ulp tolerance, or
  within WITNESS_FACTOR of SDPA's error, and stops the smoke otherwise.
* ``check_flash`` sends every bf16 output of the tensor-core kernels, dQ
  included, to that rule, and fp32 ones to the plain tolerance.
* ``sass_counts`` reads the wgmma, TMA and wgmma-wait (WARPGROUP.DEPBAR)
  counts of exactly the bf16 and fp16 tensor-core instantiations out of
  ``cuobjdump -sass`` text; ``must_not_spill`` names the instantiations
  whose ptxas spills fail the build phase.
* The serving features' checks: the divergence rule (a greedy token may
  leave the baseline only at a near-tie of the baseline's logits) and the
  B4 launch counts expected from the dispatch shapes of chunked,
  speculative and ``decode_chunk`` runs, held here against a tiny engine
  whose plain paged attention counts its calls.
* Phase 7's ``ds_bench train`` runs: each CLI model's head dim and shape,
  how a run is named, and the launches ``train_launches`` expects of a
  run, held against a counted CPU run through the plain versions at head
  dims 80 and 96, and of the Gemma-2B training path's train_batch calls
  (head dim 256, 8 heads over one kv head); ``d_suffix`` names each head
  dim's kernel rows.
* Phase ckpt's helpers: the launch count of the resumed run (phase 7's
  formula for its train_batch calls, held here against a counted CPU run
  through the plain versions), the disk-space reckoning (it fails up front
  when the disk is short), and the bitwise / witness rule.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_plain, flash_attention_fwd_plain)
from torch_threads import _one_torch_thread  # noqa: F401

WITNESS_CASES = [  # (B, S, H, Hkv, causal, ALiBi, window)
    (2, 40, 4, 4, True, False, None),
    (1, 37, 4, 2, False, False, None),
    (1, 37, 4, 2, True, True, None),
    (2, 40, 4, 4, True, False, 9),
    (1, 33, 8, 2, True, True, 12),
]


@pytest.mark.parametrize("B,S,H,Hkv,causal,alibi,window", WITNESS_CASES)
def test_sdpa_witness_is_the_plain_function(B, S, H, Hkv, causal, alibi,
                                            window):
    rng = np.random.default_rng(7)
    D, scale = 16, 1.0 / math.sqrt(16)
    q, dout = (torch.from_numpy(rng.standard_normal((B, S, H, D),
                                                    dtype=np.float32))
               for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hkv, D),
                                                 dtype=np.float32))
            for _ in range(2))
    bias = dict(alibi_slopes=alibi_slopes(H) if alibi else None,
                window=window)
    o, lse = flash_attention_fwd_plain(q, k, v, scale, causal, **bias)
    want = (o,) + tuple(flash_attention_bwd_plain(q, k, v, o, lse, dout,
                                                  scale, causal, **bias))
    got = chip_smoke.sdpa_witness(q, k, v, dout, scale, causal, **bias)
    for name, g, w in zip(("O", "dQ", "dK", "dV"), got, want):
        assert g.shape == w.shape, name
        torch.testing.assert_close(g, w, atol=2e-5, rtol=2e-5, msg=name)


def _readings(seed=3):
    """(exact, SDPA-like output, want) with SDPA's error 1e-2 relative."""
    g = torch.Generator().manual_seed(seed)
    exact = torch.randn(4096, generator=g)
    sdpa = exact + 1e-2 * torch.randn(4096, generator=g)
    return exact, sdpa, exact.clone()


def test_check_witnessed_passes_one_ulp_outputs():
    exact, sdpa, want = _readings()
    got = want.to(torch.bfloat16)         # one rounding of the same value
    err = chip_smoke.check_witnessed("one-ulp", got, want, exact, sdpa)
    assert err == pytest.approx((got.float() - want).abs().max().item())


def test_check_witnessed_passes_within_sdpa_error():
    exact, sdpa, want = _readings()
    g = torch.Generator().manual_seed(4)
    got = (exact + 1.5e-2 * torch.randn(4096, generator=g)).to(
        torch.bfloat16)
    chip_smoke.check_witnessed("within", got, want, exact, sdpa)


def test_check_witnessed_stops_beyond_sdpa_error():
    exact, sdpa, want = _readings()
    g = torch.Generator().manual_seed(5)
    got = (exact + 5e-2 * torch.randn(4096, generator=g)).to(torch.bfloat16)
    with pytest.raises(SystemExit):
        chip_smoke.check_witnessed("beyond", got, want, exact, sdpa)


_SASS = """
        code for sm_90a
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_fwd_cu_016flash_fwd_kernelI13__nv_bfloat16Lb1ELb0ELi128EEEvNS_9FwdParamsE
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0110*/                   UTMALDG.4D [UR12], [UR4] ;
        /*0200*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
        /*0210*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;
        /*0220*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_fwd_cu_016flash_fwd_kernelIfLb1ELb0ELi128EEEvNS_9FwdParamsE
        /*0100*/                   FFMA R1, R2, R3, R4 ;
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_fwd_cu_016flash_fwd_kernelI13__nv_bfloat16Lb0ELb1ELi128EEEvNS_9FwdParamsE
        /*0100*/                   FFMA R1, R2, R3, R4 ;
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_fwd_cu_016flash_fwd_kernelI6__halfLb1ELb0ELi64EEEvNS_9FwdParamsE
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0200*/                   HGMMA.64x128x16.F32.F16 R24, gdesc[UR8], RZ, !UPT ;
"""


def test_sass_counts_reads_the_bf16_instantiations():
    counts = chip_smoke.sass_counts(_SASS, "flash_fwd_kernel")
    # the fp32 instantiation is not counted; a bf16 one without wgmma or
    # TMA shows as zeros, which phase_sass refuses; fp16 ones and the head
    # dim (the last template argument) are read too
    assert counts == {("bf16", True, False, 128): (2, 2, 1),
                      ("bf16", False, True, 128): (0, 0, 0),
                      ("fp16", True, False, 64): (1, 1, 0)}
    assert chip_smoke.sass_counts(_SASS, "flash_bwd_dkv_kernel") == {}


_SASS_DQ = """
        code for sm_90a
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_bwd_cu_019flash_bwd_dq_kernelI13__nv_bfloat16Lb0ELb0ELi128EEEvNS_8DqParamsE
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0200*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
        /*0210*/                   HGMMA.64x128x16.F32.BF16 R88, R152, gdesc[UR12], R88, gsb0 ;
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_bwd_cu_019flash_bwd_dq_kernelI13__nv_bfloat16Lb1ELb1ELi64EEEvNS_8DqParamsE
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0110*/                   UTMALDG.4D [UR12], [UR4] ;
        /*0200*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_bwd_cu_019flash_bwd_dq_kernelIfLb1ELb1ELi64EEEvNS_8DqParamsE
        /*0100*/                   FFMA R1, R2, R3, R4 ;
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_bwd_cu_020flash_bwd_dkv_kernelI13__nv_bfloat16Lb0ELb0ELi128EEEvNS_9DkvParamsE
        /*0200*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
"""


def test_sass_counts_reads_the_dq_instantiations():
    """The dQ kernel shares its library with dK/dV: each template's bf16
    instantiations are read apart, its fp32 one not at all."""
    assert ("flash_attention_bwd", "flash_bwd_dq_kernel") in \
        chip_smoke.TENSOR_CORE_KERNELS
    assert chip_smoke.sass_counts(_SASS_DQ, "flash_bwd_dq_kernel") == {
        ("bf16", False, False, 128): (2, 1, 0),
        ("bf16", True, True, 64): (1, 2, 0)}
    assert chip_smoke.sass_counts(_SASS_DQ, "flash_bwd_dkv_kernel") == {
        ("bf16", False, False, 128): (1, 0, 0)}


def _flash_case(dtype):
    """Inputs of a small causal GQA case in ``dtype``, the plain forward's
    (O, LSE) as a kernel would return them, the plain backward from those
    (what check_flash holds a kernel's dQ, dK, dV to, rounded), the exact
    fp32 gradients and SDPA's."""
    rng = np.random.default_rng(9)
    B, S, H, Hkv, D = 1, 48, 4, 2, 16
    q, dout = (torch.from_numpy(rng.standard_normal(
        (B, S, H, D), dtype=np.float32)).to(dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal(
        (B, S, Hkv, D), dtype=np.float32)).to(dtype) for _ in range(2))
    scale = 1.0 / math.sqrt(D)
    f32 = [x.float() for x in (q, k, v, dout)]
    o, lse = flash_attention_fwd_plain(*f32[:3], scale, True)
    out = o.to(dtype)
    want = flash_attention_bwd_plain(*f32[:3], out.float(), lse, f32[3],
                                     scale, True)
    exact = flash_attention_bwd_plain(*f32[:3], o, lse, f32[3], scale, True)
    sdpa = chip_smoke.sdpa_witness(q, k, v, dout, scale, True)[1:]
    return (q, k, v, dout), scale, out, lse, want, exact, sdpa


def _check_flash_dq(dtype, dq):
    inputs, scale, out, lse, want, _, _ = _flash_case(dtype)
    noted = {}
    chip_smoke.check_flash(lambda kern, dn, e: noted.update({kern: e}), "",
                           "cpu", inputs, scale, True, {}, out, lse,
                           (dq,) + tuple(w.to(dtype) for w in want[1:]))
    return noted


@pytest.mark.parametrize("factor,passes", [(1.5, True), (3.0, False)])
def test_check_flash_holds_bf16_dq_to_the_witness(factor, passes, capsys):
    """A bf16 dQ whose error against the exact answer is ``factor`` times
    SDPA's: outside the one-ulp tolerance either way, so only the witness
    rule passes it -- within 2x SDPA's error, and not at 3x."""
    _, _, _, _, want, exact, sdpa = _flash_case(torch.bfloat16)
    dq = (exact[0] + factor * (sdpa[0].float() - exact[0])).to(
        torch.bfloat16)
    _, bad = chip_smoke._outside("dQ", dq, want[0].to(torch.bfloat16))
    assert bad > 0
    if passes:
        noted = _check_flash_dq(torch.bfloat16, dq)
        assert set(noted) == {"flash_attention_fwd", "flash_attention_bwd_dq",
                              "flash_attention_bwd_dkv"}
        line = [ln for ln in capsys.readouterr().out.splitlines()
                if "flash_attention_bwd_dq cpu dQ" in ln]
        assert len(line) == 1 and "kernel/SDPA" in line[0]
    else:
        with pytest.raises(SystemExit):
            _check_flash_dq(torch.bfloat16, dq)


def test_check_flash_keeps_fp32_dq_on_the_plain_tolerance():
    """fp32 dQ keeps check_close's 1e-4: a 1e-3 relative change fails."""
    _, _, _, _, want, _, _ = _flash_case(torch.float32)
    _check_flash_dq(torch.float32, want[0].clone())
    with pytest.raises(SystemExit):
        _check_flash_dq(torch.float32, want[0] * (1 + 1e-3))


_SASS_NEW = """
        code for sm_90a
                Function : _ZN60_GLOBAL__N__0_19_sparse_attention_cu_016sparse_tc_kernelI13__nv_bfloat16Li16ELi64EEEvNS_8TcParamsE
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0200*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
        /*0210*/                   HGMMA.64x64x16.F32.BF16 R24, R88, gdesc[UR12], R24, gsb0 ;
                Function : _ZN60_GLOBAL__N__0_19_sparse_attention_cu_016sparse_tc_kernelI13__nv_bfloat16Li128ELi128EEEvNS_8TcParamsE
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0110*/                   UTMALDG.4D [UR12], [UR4] ;
        /*0200*/                   HGMMA.64x128x16.F32.BF16 R24, R88, gdesc[UR12], R24, gsb0 ;
                Function : _ZN60_GLOBAL__N__0_19_sparse_attention_cu_016sparse_tc_kernelI6__halfLi32ELi128EEEvNS_8TcParamsE
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0200*/                   HGMMA.64x64x16.F32.F16 R24, gdesc[UR8], RZ, !UPT ;
        /*0210*/                   HGMMA.64x128x16.F32.F16 R24, R88, gdesc[UR12], R24, gsb0 ;
                Function : _ZN60_GLOBAL__N__0_19_sparse_attention_cu_023sparse_attention_kernelIfLi16ELi64EEEvPKT_S3_S3_PS1_PKiS6_iiiff
        /*0100*/                   FFMA R1, R2, R3, R4 ;
                Function : _ZN66_GLOBAL__N__0_25_ragged_paged_attention_cu_024ragged_prefill_tc_kernelI13__nv_bfloat16Li128EEEvNS_13PrefillParamsE
        /*0100*/                   UTMALDG.3D [UR8], [UR4] ;
        /*0110*/                   UTMALDG.2D [UR12], [UR4] ;
        /*0200*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
                Function : _ZN66_GLOBAL__N__0_25_ragged_paged_attention_cu_024ragged_prefill_tc_kernelI6__halfLi128EEEvNS_13PrefillParamsE
        /*0100*/                   UTMALDG.3D [UR8], [UR4] ;
        /*0200*/                   HGMMA.64x128x16.F32.F16 R24, gdesc[UR8], RZ, !UPT ;
        /*0210*/                   HGMMA.64x128x16.F32.F16 R24, R88, gdesc[UR12], R24, gsb0 ;
                Function : _ZN66_GLOBAL__N__0_25_ragged_paged_attention_cu_024ragged_prefill_tc_kernelI13__nv_bfloat16Li64EEEvNS_13PrefillParamsE
        /*0100*/                   UTMALDG.3D [UR8], [UR4] ;
        /*0200*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
        /*0210*/                   HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR12], R88, gsb0 ;
        /*0220*/                   WARPGROUP.DEPBAR.LE gsb0, 0x1 ;
                Function : _ZN66_GLOBAL__N__0_25_ragged_paged_attention_cu_029ragged_paged_attention_kernelIfLi128ELi16EEEvPKT_S3_S3_PS1_PKiS6_S6_S6_S6_S6_iiiiif
        /*0100*/                   FFMA R1, R2, R3, R4 ;
                Function : _ZN66_GLOBAL__N__0_25_ragged_paged_attention_cu_024ragged_prefill_tc_kernelI6__halfLi256EEEvNS_13PrefillParamsE
        /*0100*/                   UTMALDG.3D [UR8], [UR4] ;
        /*0110*/                   UTMALDG.2D [UR12], [UR4] ;
        /*0200*/                   HGMMA.64x64x16.F32.F16 R24, gdesc[UR8], RZ, !UPT ;
        /*0210*/                   HGMMA.64x256x16.F32.F16 R88, R152, gdesc[UR12], R88, gsb0 ;
        /*0220*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
"""


def test_sass_counts_reads_the_sparse_and_prefill_instantiations():
    """B6's tensor-core kernel by element type (bf16, fp16), block and head
    dim; B4's prefill kernel by element type (bf16, fp16) and head dim
    (64, 80, 96, 128, 256); their CUDA-core kernels are not counted."""
    kernels = dict((k, s) for s, k in chip_smoke.TENSOR_CORE_KERNELS)
    assert kernels["sparse_tc_kernel"] == "sparse_attention"
    assert kernels["ragged_prefill_tc_kernel"] == "ragged_paged_attention"
    assert chip_smoke.sass_counts(_SASS_NEW, "sparse_tc_kernel") == {
        ("bf16", 16, 64): (2, 1, 0), ("bf16", 128, 128): (1, 2, 0),
        ("fp16", 32, 128): (2, 1, 0)}
    assert chip_smoke.sass_counts(_SASS_NEW, "ragged_prefill_tc_kernel") == {
        ("bf16", 128): (1, 2, 0), ("fp16", 128): (2, 1, 0),
        ("bf16", 64): (2, 1, 1), ("fp16", 256): (2, 2, 1)}
    # every template's expected instantiations: 4 flash forms x (bf16,
    # fp16) x head dims (64, 80, 96, 128, 256), (bf16, fp16) x 4 blocks x
    # 2 head dims sparse, (bf16, fp16) x (64, 80, 96, 128, 256)
    assert {k: v[2] for k, v in chip_smoke.SASS_TEMPLATES.items()} == {
        "flash_fwd_kernel": 40, "flash_bwd_dq_kernel": 40,
        "flash_bwd_dkv_kernel": 40, "sparse_tc_kernel": 16,
        "ragged_prefill_tc_kernel": 10}


_SASS_D80_96 = """
        code for sm_90a
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_bwd_cu_020flash_bwd_dkv_kernelI13__nv_bfloat16Lb0ELb0ELi80EEEvNS_9DkvParamsE
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0200*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
        /*0210*/                   HGMMA.64x80x16.F32.BF16 R88, R152, gdesc[UR12], R88, gsb0 ;
        /*0220*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_bwd_cu_020flash_bwd_dkv_kernelI6__halfLb1ELb0ELi96EEEvNS_9DkvParamsE
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0210*/                   HGMMA.64x96x16.F32.F16 R88, R152, gdesc[UR12], R88, gsb0 ;
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_bwd_cu_020flash_bwd_dkv_kernelIfLb0ELb0ELi96EEEvNS_9DkvParamsE
        /*0100*/                   FFMA R1, R2, R3, R4 ;
"""


def test_sass_counts_reads_the_head_dim_80_and_96_instantiations():
    """The flash kernels' D=80 and D=96 forms are read by their last
    template argument, bf16 and fp16 apart; the fp32 form is not
    counted."""
    assert chip_smoke.sass_counts(_SASS_D80_96, "flash_bwd_dkv_kernel") == {
        ("bf16", False, False, 80): (2, 1, 1),
        ("fp16", True, False, 96): (1, 1, 0)}


_SASS_D256 = """
        code for sm_90a
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_fwd_cu_016flash_fwd_kernelI13__nv_bfloat16Lb0ELb0ELi256EEEvNS_9FwdParamsE
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0200*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
        /*0210*/                   HGMMA.64x256x16.F32.BF16 R88, R152, gdesc[UR12], R88, gsb0 ;
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_fwd_cu_016flash_fwd_kernelI6__halfLb1ELb1ELi256EEEvNS_9FwdParamsE
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0210*/                   HGMMA.64x256x16.F32.F16 R88, R152, gdesc[UR12], R88, gsb0 ;
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_fwd_cu_016flash_fwd_kernelIfLb0ELb0ELi256EEEvNS_9FwdParamsE
        /*0100*/                   FFMA R1, R2, R3, R4 ;
"""


_SASS_D64_BWD = """
        code for sm_90a
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_bwd_cu_019flash_bwd_dq_kernelI13__nv_bfloat16Lb0ELb0ELi64EEEvNS_8DqParamsE
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0110*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0200*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
        /*0210*/                   HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR12], R88, gsb0 ;
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_bwd_cu_019flash_bwd_dq_kernelI6__halfLb1ELb1ELi64EEEvNS_8DqParamsE
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0210*/                   HGMMA.64x64x16.F32.F16 R88, R152, gdesc[UR12], R88, gsb0 ;
        /*0220*/                   WARPGROUP.DEPBAR.LE gsb0, 0x1 ;
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_bwd_cu_019flash_bwd_dq_kernelIfLb0ELb0ELi64EEEvNS_8DqParamsE
        /*0100*/                   FFMA R1, R2, R3, R4 ;
"""


def test_sass_counts_reads_the_head_dim_64_backward_instantiations():
    """B2's persistent bodies at head dim 64 are read by their template
    arguments, bf16 and fp16 apart (phase 2 then holds each to HGMMA and
    UTMALDG); the fp32 CUDA-core form is not counted."""
    assert chip_smoke.sass_counts(_SASS_D64_BWD, "flash_bwd_dq_kernel") == {
        ("bf16", False, False, 64): (2, 2, 0),
        ("fp16", True, True, 64): (1, 1, 1)}


def test_backward_factors_hold_b2_against_sdpas_whole_backward():
    """B2's two kernels are judged as a pair against SDPA's backward, which
    returns dQ, dK and dV together, and so is the backward as the training
    path calls it; a kernel alone is never set against the whole call."""
    f = chip_smoke.backward_factors(called_ms=1.07, pair_ms=0.6961,
                                    sdpa_bwd_ms=0.5059)
    assert f == pytest.approx({"called": 1.07 / 0.5059,
                               "pair": 0.6961 / 0.5059})
    assert f["pair"] == pytest.approx(1.376, abs=1e-3)
    assert chip_smoke.backward_factors(0.2, 0.1, 0.2) == {"called": 1.0,
                                                          "pair": 0.5}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_check_delta_holds_a_reordered_sum_and_stops_a_wrong_one(dtype,
                                                                 capsys):
    """The delta check passes the plain version's values summed in another
    order (fp32, within DELTA_TOL of sum |dO O|) and stops a result that
    misses one element of a row."""
    from deepspeed_tpu_torch.ops.flash_attention import \
        flash_attention_bwd_delta_plain
    rng = np.random.default_rng(3)
    out, dout = (torch.from_numpy(rng.standard_normal(
        (2, 40, 3, 80)).astype(np.float32)).to(dtype) for _ in range(2))
    prod = (dout.float() * out.float()).transpose(1, 2)
    reordered = prod.flip(-1).cumsum(-1)[..., -1].contiguous()
    chip_smoke.check_delta("delta", reordered, out, dout)
    want = flash_attention_bwd_delta_plain(out, dout)
    short = want - prod[..., 7]
    with pytest.raises(SystemExit):
        chip_smoke.check_delta("delta", short, out, dout)
    assert "FAIL: delta" in capsys.readouterr().out


def test_sass_counts_reads_the_head_dim_256_instantiations():
    """The flash kernels' D=256 forms are read by their last template
    argument, bf16 and fp16 apart; the fp32 form (CUDA cores) is not
    counted."""
    assert chip_smoke.sass_counts(_SASS_D256, "flash_fwd_kernel") == {
        ("bf16", False, False, 256): (2, 1, 0),
        ("fp16", True, True, 256): (1, 1, 0)}


@pytest.mark.parametrize("D,suffix", [(128, ""), (64, "_d64"), (80, "_d80"),
                                      (96, "_d96"), (256, "_d256")])
def test_d_suffix_names_each_head_dim(D, suffix):
    """The kernels JSON names a flash form by its head dim: the rows first
    measured at 128 keep their bare names."""
    assert chip_smoke.d_suffix(D) == suffix


@pytest.mark.parametrize("name", ["FLASH_CASES_D64", "FLASH_CASES_D80",
                                  "FLASH_CASES_D96"])
def test_persistent_forward_cases_keep_an_odd_walk(name):
    """The persistent forward (head dims 64, 80, 96) walks q tiles in pairs
    of one (batch, head), and the persistent backward at the same head
    dims walks its dQ q tiles and dK/dV key tiles the same way: the kernel
    phase keeps a causal case over an odd B * H whose length does not
    tile, a GQA and a non-causal case, and at every one of the three head
    dims one with an odd count of 128-row tiles (a unit of one tile)."""
    cases = getattr(chip_smoke, name)
    odd = [(S, causal) for _, B, S, H, _, causal, _ in cases
           if (B * H) % 2 and S % 128]
    assert any(causal for _, causal in odd)
    assert any(H != Hkv for _, _, _, H, Hkv, _, _ in cases)
    assert not all(causal for *_, causal, _ in cases)
    assert any(causal and -(-S // 128) % 2 for S, causal in odd)


def test_cli_models_are_the_benchmark_shapes_at_their_head_dims():
    """Each ds_bench train model the smoke drives has the head dim its
    rows are named for, and is the JAX benchmark's shape; the flags name
    the run."""
    from deepspeed_tpu_torch.benchmarks.training import MODELS, model_config
    for model, D in chip_smoke.CLI_HEAD_DIMS.items():
        cfg = model_config(model, chip_smoke.CLI_DEFAULTS["seq"])
        assert cfg.head_dim == D and model in MODELS
    assert chip_smoke.CLI_DEFAULTS["model"] == "gpt_350m"
    assert sorted(chip_smoke.CLI_HEAD_DIMS.values()) == [64, 80, 96]
    assert chip_smoke.cli_label() == "(no flags)"
    assert chip_smoke.cli_label("gpt_2_7b") == "--model gpt_2_7b"
    for name in chip_smoke.D80_96_MODELS:
        model, seq, _ = chip_smoke._train_model(name)
        assert model_config(model, seq).head_dim == \
            chip_smoke.CLI_HEAD_DIMS[name]
    assert chip_smoke.FP16_CLI_MODEL in chip_smoke.D80_96_MODELS


@pytest.mark.parametrize("head_dim", [80, 96])
def test_train_launches_match_a_counted_cli_run(head_dim):
    """The launches phase 7 expects of a ds_bench train run --
    ``train_launches`` of its config over the warm-up and the timed steps
    -- against a counted CPU run of ``run_benchmark`` through the plain
    versions, 2 layers of 2 heads at head dim 80 and 96."""
    from deepspeed_tpu_torch.benchmarks.training import (model_config,
                                                         run_benchmark)
    from deepspeed_tpu_torch.ops import adam, flash_attention
    shape = dict(hidden_size=2 * head_dim, n_layers=2, n_heads=2)
    cfg = model_config(shape, 16, vocab_size=256)
    assert cfg.head_dim == head_dim
    flash_attention.flash_attention_fwd_plain.calls = 0
    flash_attention.flash_attention_bwd_plain.calls = 0
    flash_attention.flash_attention_bwd_delta_plain.calls = 0
    adam.reference_impl.calls = 0
    out = run_benchmark(shape, batch=2, gas=2, seq=16, steps=2,
                        vocab_size=256, device="cpu")
    want = chip_smoke.train_launches(cfg, 2, 3)
    assert flash_attention.flash_attention_fwd_plain.calls == \
        want["flash_attention_fwd"] == 2 * 2 * 2 * 3
    assert flash_attention.flash_attention_bwd_plain.calls == \
        want["flash_attention_bwd_dq"] == want["flash_attention_bwd_dkv"]
    assert flash_attention.flash_attention_bwd_delta_plain.calls == \
        want["flash_attention_bwd_delta"] == want["flash_attention_bwd_dq"]
    assert adam.reference_impl.calls == want["fused_adam"] == 3
    assert not any(v for k, v in want.items() if "biased" in k)
    assert np.isfinite(out["losses"]).all()


def test_gemma_train_launches_match_a_counted_run():
    """This slice's path: the Gemma-2B training shape is GEMMA_2B with
    per-layer remat (8 heads of 256 over one kv head, 2,506,172,416
    parameters), and the launches phase 7 expects of its train_batch calls
    (``train_launches``: the forward twice a layer and micro-batch, remat
    recomputing it; dQ and dK/dV once; B3 once a call) hold against a
    counted CPU run through the plain versions of a 2-layer Gemma-wired
    model with those heads, through ``initialize(...).train_batch``."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.benchmarks.training import ds_config
    from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                        TransformerConfig)
    from deepspeed_tpu_torch.ops import adam, flash_attention
    assert chip_smoke.GEMMA_TRAIN == dict(chip_smoke.GEMMA_2B, remat=True)
    full = TransformerConfig(**chip_smoke.GEMMA_TRAIN)
    assert (full.n_layers, full.n_heads, full.kv_heads, full.head_dim) == \
        (18, 8, 1, 256)
    assert full.num_params() == chip_smoke.GEMMA_PARAMS["Gemma-2B"]
    cfg = TransformerConfig(**dict(
        chip_smoke.GEMMA_TRAIN, hidden_size=64, n_layers=2,
        head_dim_override=256, ffn_hidden_size=128, vocab_size=256,
        embed_scale=8.0))
    model = chip_smoke.scale_embedding(
        CausalTransformerLM(cfg, device="cpu").init(0))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=ds_config(2, 2), device="cpu")
    flash_attention.flash_attention_fwd_plain.calls = 0
    flash_attention.flash_attention_bwd_plain.calls = 0
    adam.reference_impl.calls = 0
    ids = np.random.default_rng(4).integers(0, 256, (3, 2, 2, 16))
    losses = [float(engine.train_batch(batch={"input_ids": x})) for x in ids]
    want = chip_smoke.train_launches(cfg, 2, 3)
    assert flash_attention.flash_attention_fwd_plain.calls == \
        want["flash_attention_fwd"] == 2 * 2 * 2 * 3
    assert flash_attention.flash_attention_bwd_plain.calls == \
        want["flash_attention_bwd_dq"] == want["flash_attention_bwd_dkv"]
    assert adam.reference_impl.calls == want["fused_adam"] == 3
    assert not any(v for k, v in want.items() if "biased" in k)
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("kernel,want", [
    ("void dsdecode::split_tc_kernel<__nv_bfloat16, Seqs<64>, 8>(P)", True),
    ("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, true, "
     "false, 64>((anonymous namespace)::FwdParams)", True),
    ("void (anonymous namespace)::flash_fwd_kernel<__half, false, false, "
     "64>((anonymous namespace)::FwdParams)", True),
    ("void (anonymous namespace)::ragged_prefill_tc_kernel<__half, 64>("
     "(anonymous namespace)::PrefillParams)", True),
    ("_ZN66_GLOBAL__N__0_25_ragged_paged_attention_cu_024ragged_prefill_tc_"
     "kernelI13__nv_bfloat16Li64EEEvNS_13PrefillParamsE", True),
    ("_ZN55_GLOBAL__N__0_22_flash_attention_fwd_cu_016flash_fwd_kernelI6__"
     "halfLb0ELb1ELi64EEEvNS_9FwdParamsE", True),
    # the bf16 / fp16 head-dim-80 and -96 forms of B1 and B2
    ("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, false, "
     "false, 96>((anonymous namespace)::FwdParams)", True),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<__half, true, "
     "false, 80>((anonymous namespace)::DqParams)", True),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel<__nv_bfloat16, "
     "false, true, 96>((anonymous namespace)::DkvParams)", True),
    ("_ZN55_GLOBAL__N__0_22_flash_attention_bwd_cu_020flash_bwd_dkv_"
     "kernelI13__nv_bfloat16Lb0ELb0ELi80EEEvNS_9DkvParamsE", True),
    # head dim 256: B4's tensor-core prefill tiles and the CUDA-core tiles
    # of B4 and B5 (the split-key body is held at every head dim)
    ("void (anonymous namespace)::ragged_prefill_tc_kernel<__half, 256>("
     "(anonymous namespace)::PrefillParams)", True),
    ("_ZN66_GLOBAL__N__0_25_ragged_paged_attention_cu_024ragged_prefill_tc_"
     "kernelI13__nv_bfloat16Li256EEEvNS_13PrefillParamsE", True),
    ("void (anonymous namespace)::decode_attention_kernel<float, 256, 16>("
     "float const*, float const*, float const*, float*, int const*, int, "
     "int, int, int, int, float)", True),
    ("void (anonymous namespace)::ragged_paged_attention_kernel<__half, "
     "256, 16>(__half const*)", True),
    ("void dsdecode::split_tc_kernel<__half, 8, (anonymous namespace)::"
     "PagedSeqs<256> >(P)", True),
    # the staged tensor-core body at head dim 256 (B4 and B5, 5-8 rows)
    ("void dsdecode::split_staged_kernel<__nv_bfloat16, 8, (anonymous "
     "namespace)::PagedSeqs<256> >(dsdecode::SplitParams<(anonymous "
     "namespace)::PagedSeqs<256> >)", True),
    ("void dsdecode::split_staged_kernel<__half, 5, (anonymous namespace)::"
     "ContiguousSeqs<256> >(P)", True),
    ("_ZN8dsdecode19split_staged_kernelI6__halfLi8EN58_GLOBAL__N__0_19_"
     "decode_attention_cu_014ContiguousSeqsILi256EEEEEvNS_11SplitParamsIT1_"
     "EE", True),
    # head dim 256 of B1 and B2, every dtype (the fp32 CUDA-core form
    # too), and B6's fp16 form
    ("void (anonymous namespace)::flash_bwd_dkv_kernel<__half, false, "
     "false, 256>((anonymous namespace)::DkvParams)", True),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<float, true, true, "
     "256>((anonymous namespace)::DqParams)", True),
    ("_ZN55_GLOBAL__N__0_22_flash_attention_fwd_cu_016flash_fwd_kernelI13__"
     "nv_bfloat16Lb1ELb0ELi256EEEvNS_9FwdParamsE", True),
    ("_ZN55_GLOBAL__N__0_22_flash_attention_bwd_cu_020flash_bwd_dkv_"
     "kernelIfLb0ELb0ELi256EEEvNS_9DkvParamsE", True),
    ("void (anonymous namespace)::sparse_tc_kernel<__half, 16, 128>("
     "(anonymous namespace)::TcParams)", True),
    ("_ZN60_GLOBAL__N__0_19_sparse_attention_cu_016sparse_tc_kernelI6__"
     "halfLi64ELi64EEEvNS_8TcParamsE", True),
    ("void (anonymous namespace)::sparse_tc_kernel<__nv_bfloat16, 16, "
     "128>((anonymous namespace)::TcParams)", False),
    # the D = 128 bodies and the fp32 CUDA-core ones are printed, not held
    ("void (anonymous namespace)::flash_bwd_dkv_kernel<float, false, "
     "false, 96>((anonymous namespace)::DkvParams)", False),
    ("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, false, "
     "false, 128>((anonymous namespace)::FwdParams)", False),
    ("void (anonymous namespace)::flash_fwd_kernel<float, false, false, "
     "64>((anonymous namespace)::FwdParams)", False),
    ("void (anonymous namespace)::ragged_prefill_tc_kernel<__nv_bfloat16, "
     "128>((anonymous namespace)::PrefillParams)", False),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<__nv_bfloat16, false, "
     "false, 128>((anonymous namespace)::DqParams)", False),
    # the persistent backward at head dim 64 (dQ and dK/dV)
    ("void (anonymous namespace)::flash_bwd_dq_kernel<__nv_bfloat16, false, "
     "false, 64>((anonymous namespace)::DqParams)", True),
    ("_ZN55_GLOBAL__N__0_22_flash_attention_bwd_cu_020flash_bwd_dkv_"
     "kernelI6__halfLb1ELb1ELi64EEEvNS_9DkvParamsE", True),
    # B4's prefill tiles on the shared consumer at 80, 96 and 256, and the
    # staged decode body at 5-8 rows at 80 and 96 (gpt_2_7b's verify
    # window) and its combine
    ("void (anonymous namespace)::ragged_prefill_tc_kernel<__half, 80>("
     "(anonymous namespace)::PrefillParams)", True),
    ("_ZN66_GLOBAL__N__0_25_ragged_paged_attention_cu_024ragged_prefill_"
     "tc_kernelI13__nv_bfloat16Li96EEEvNS_13PrefillParamsE", True),
    ("void (anonymous namespace)::ragged_prefill_tc_kernel<__nv_bfloat16, "
     "256>((anonymous namespace)::PrefillParams)", True),
    ("void dsdecode::combine_kernel<__half, 5, (anonymous namespace)::"
     "PagedSeqs<80> >(dsdecode::SplitParams<(anonymous namespace)::"
     "PagedSeqs<80> >)", True),
    ("void dsdecode::split_staged_kernel<__nv_bfloat16, 5, (anonymous "
     "namespace)::PagedSeqs<80> >(dsdecode::SplitParams<(anonymous "
     "namespace)::PagedSeqs<80> >)", True),
    ("_ZN8dsdecode19split_staged_kernelI6__halfLi8EN58_GLOBAL__N__0_19_"
     "decode_attention_cu_014ContiguousSeqsILi96EEEEEvNS_11SplitParamsIT1_"
     "EE", True),
    # head dim 16 (the benches' tiny model): the CUDA-core split body at
    # every row count, its combine, and B4's and B5's CUDA-core tiles
    ("void dsdecode::split_kernel<__nv_bfloat16, 8, (anonymous namespace)::"
     "PagedSeqs<16> >(dsdecode::SplitParams<(anonymous namespace)::"
     "PagedSeqs<16> >)", True),
    ("void dsdecode::combine_kernel<float, 1, (anonymous namespace)::"
     "ContiguousSeqs<16> >(dsdecode::SplitParams<(anonymous namespace)::"
     "ContiguousSeqs<16> >)", True),
    ("void (anonymous namespace)::ragged_paged_attention_kernel<"
     "__nv_bfloat16, 16, 16>(const T1 *, const T1 *, const T1 *, T1 *, "
     "const int *, const int *, const int *, const int *, const int *, "
     "const int *, int, int, int, int, int, float)", True),
    ("_ZN55_GLOBAL__N__0_22_decode_attention_cu_023decode_attention_kernelI"
     "6__halfLi16ELi16EEEvPKT_S4_S4_PS2_PKiiiiiif", True),
    ("void (anonymous namespace)::decode_attention_kernel<float, 128, 16>("
     "const T1 *, const T1 *, const T1 *, T1 *, const int *, int, int, "
     "int, int, int, float)", False)])
def test_must_not_spill_names_decode_and_d64_consumers(kernel, want):
    """The build phase fails on a spill in the split-key decode body, in
    every bf16 / fp16 head-dim-64 instantiation of B1's forward and B4's
    prefill tiles (the shared D = 64 consumer), in every bf16 / fp16
    head-dim-64, -80 and -96 form of B1 and B2 (B2's persistent bodies at
    all three), in every head-dim-256 form of B1 and B2 (fp32 included)
    and in B6's fp16 form, by demangled or mangled name; other kernels'
    spills are only printed."""
    assert chip_smoke.must_not_spill(kernel) is want


def _paged_case(seed=11):
    """A small paged state: 3 sequences of ragged lengths, GQA 4/2."""
    from deepspeed_tpu_torch.ops.paged_attention import PagedAllocator
    rng = np.random.default_rng(seed)
    ctx, T, H, Hkv, D, page = [9, 13, 5], 4, 4, 2, 16, 4
    alloc = PagedAllocator(16, page, max_pages_per_seq=4,
                           reserve_scratch=True)
    for s, c in enumerate(ctx):
        alloc.allocate(s, c)
    tables = torch.as_tensor(alloc.block_table([0, 1, 2]))
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (16, Hkv, page, D), dtype=np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((3, T, H, D), dtype=np.float32))
    return q, kp, vp, tables, torch.tensor(ctx, dtype=torch.int32)


def test_paged_sdpa_is_the_plain_function():
    """B4's bf16 yardstick computes what the plain version does."""
    from deepspeed_tpu_torch.ops.cuda.ragged_paged_attention import \
        paged_attention_plain
    q, kp, vp, tables, lens = _paged_case()
    torch.testing.assert_close(
        chip_smoke.paged_sdpa(q, kp, vp, tables, lens),
        paged_attention_plain(q, kp, vp, tables, lens), atol=2e-5,
        rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_sparse_sdpa_is_the_plain_function(causal):
    """B6's bf16 yardstick computes what the plain version does, rows that
    see no key 0 included."""
    from deepspeed_tpu_torch.ops.sparse_attention import \
        sparse_attention_plain
    rng = np.random.default_rng(12)
    B, S, H, D, block = 2, 64, 4, 16, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (B, S, H, D), dtype=np.float32)) for _ in range(3))
    layout = rng.random((H, 4, 4)) < 0.5
    layout[:, 1] = False                       # q block 1 sees nothing
    want = sparse_attention_plain(q, k, v, layout, block, causal=causal)
    got = chip_smoke.sparse_sdpa(q, k, v, layout, block, causal)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    assert float(got[:, block:2 * block].abs().max()) == 0.0


def test_check_output_holds_bf16_to_the_witness_and_fp32_to_1e4():
    """A bf16 forward output passes at one ulp or within 2x SDPA's error
    and stops beyond it; fp32 keeps check_close's 1e-4."""
    exact, sdpa, _ = _readings()
    g = torch.Generator().manual_seed(6)
    noise = torch.randn(4096, generator=g)
    chip_smoke.check_output("one-ulp", exact.to(torch.bfloat16), exact,
                            lambda: sdpa)
    chip_smoke.check_output("within", (exact + 1.5e-2 * noise).to(
        torch.bfloat16), exact, lambda: sdpa)
    with pytest.raises(SystemExit):
        chip_smoke.check_output("beyond", (exact + 5e-2 * noise).to(
            torch.bfloat16), exact, lambda: sdpa)
    chip_smoke.check_output("fp32", exact.clone(), exact, None)
    with pytest.raises(SystemExit):
        chip_smoke.check_output("fp32 off", exact * (1 + 1e-3), exact, None)


# ---------------------------------------------------- serving features
def test_divergence_rule_passes_a_tie_and_fails_a_clear_margin():
    prompts = [[1, 2], [3, 4, 5]]
    base = [[1, 2, 7, 8, 9], [3, 4, 5, 6, 6]]
    same_as_base = [list(b) for b in base]
    flipped = [[1, 2, 7, 11, 12], [3, 4, 5, 6, 6]]   # request 0, index 1
    limit = chip_smoke.divergence_limit("bfloat16", 10.0)
    assert limit == pytest.approx(
        chip_smoke.DIVERGENCE_ULPS * 2.0 ** -8 * 10.0)
    tie = {(0, 1): (0.01, 10.0)}
    clear = {(0, 1): (2.0 * limit, 10.0)}
    assert chip_smoke.check_divergence(
        "same", base, same_as_base, prompts, clear, "bfloat16") == (2, [])
    same, rows = chip_smoke.check_divergence("tie", base, flipped, prompts,
                                             tie, "bfloat16")
    assert same == 1 and rows == [(0, 1, 0.01, limit)]
    with pytest.raises(SystemExit):
        chip_smoke.check_divergence("clear", base, flipped, prompts, clear,
                                    "bfloat16")
    # a margin the baseline never recorded cannot excuse a divergence
    with pytest.raises(SystemExit):
        chip_smoke.check_divergence("unknown", base, flipped, prompts, {},
                                    "bfloat16")
    # a request cut short (EOS) diverges where the shorter one ends
    assert chip_smoke.first_divergence([1, 2, 3, 4], [1, 2, 3], 1) == 2
    assert chip_smoke.first_divergence([1, 2, 3], [1, 2, 3], 1) is None


def test_record_margins_keeps_the_top2_gap_and_refuses_nonfinite():
    sampled = []
    eng = type("E", (), {})()
    eng._sample = lambda req, logits: sampled.append(len(req.out)) or 0
    margins = chip_smoke.record_margins(eng)
    req = type("R", (), {"req_id": 3, "out": [5, 6]})()
    eng._sample(req, np.array([0.5, 2.0, 1.25, -4.0], np.float32))
    assert margins == {(3, 2): (0.75, 4.0)} and sampled == [2]
    with pytest.raises(SystemExit):
        eng._sample(req, np.array([0.5, np.nan], np.float32))


def _counted_run(sched=None, draft=False, decode_chunk=1, lens=(5, 20, 3,
                                                               33, 9)):
    """A tiny fp32 engine on the CPU through the plain paged attention,
    whose calls count B4's launches: returns (engine, calls, prompts)."""
    from deepspeed_tpu_torch.inference.serving import ServingEngine
    from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                        TransformerConfig)
    from deepspeed_tpu_torch.ops.cuda import ragged_paged_attention as rp
    cfg = TransformerConfig.tiny(hidden_size=64, n_heads=4, n_kv_heads=2,
                                 n_layers=3)
    model = CausalTransformerLM(cfg, device="cpu").init(0)
    dmodel = CausalTransformerLM(TransformerConfig.tiny(
        hidden_size=32, n_heads=4, n_kv_heads=1, n_layers=2),
        device="cpu").init(1) if draft else None
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in lens]
    eng = ServingEngine(model, max_batch=2, page_size=8, max_seq=64,
                        dtype=torch.float32, decode_chunk=decode_chunk,
                        serving={"scheduler": sched or {}},
                        draft_model=dmodel)
    rp.paged_attention_plain.calls = 0
    eng.generate(prompts, max_new_tokens=6)
    return eng, rp.paged_attention_plain.calls, prompts


@pytest.mark.parametrize("kind", ["monolithic", "decode_chunk", "chunked",
                                  "speculative"])
def test_expected_b4_launches_match_a_counted_run(kind):
    chunk = 8
    sched = {"policy": "chunked", "prefill_chunk_tokens": chunk}
    if kind == "speculative":
        sched["speculative"] = {"enabled": True, "num_draft_tokens": 3}
    eng, calls, prompts = _counted_run(
        sched if kind in ("chunked", "speculative") else None,
        draft=kind == "speculative",
        decode_chunk=4 if kind == "decode_chunk" else 1)
    st = eng.scheduler.sched_stats
    lens = [len(p) for p in prompts]
    if kind in ("chunked", "speculative"):
        assert st["prefill_chunks"] == chip_smoke.prefill_chunks(lens, chunk)
        n_prefills = 0
    else:
        n_prefills = len(prompts)
    want, target, draft = chip_smoke.expected_b4_launches(
        3, st, n_prefills=n_prefills,
        decode_chunk=4 if kind == "decode_chunk" else 1,
        draft_layers=2 if kind == "speculative" else 0,
        gamma=3 if kind == "speculative" else 0,
        draft_chunks=chip_smoke.prefill_chunks(lens, chunk)
        if kind == "speculative" else 0)
    assert calls == want and eng.stats["model_calls"] == target
    if kind == "speculative":
        assert draft == st["draft_calls"] > 0
    assert chip_smoke.prefill_chunks([17, 8, 1], 8, cached=[8, 0, 0]) == 4


def test_expected_b4_launches_count_a_call_once():
    """A B4 wrapper call counts one launch whatever it launches (the
    decode form's chunks and combine, the prefill tiles): the smoke's
    launch formula is a layer a model call, target and draft."""
    st = {"prefill_chunks": 5, "decode_steps": 7, "spec_windows": 3}
    assert chip_smoke.expected_b4_launches(28, st, n_prefills=2) == (
        28 * 14, 14, 3)
    assert chip_smoke.expected_b4_launches(
        14, st, decode_chunk=4, draft_layers=9, gamma=4, draft_chunks=6) == (
        14 * 33 + 9 * 21, 33, 21)


# --------------------------------------- serving at head dims 80 and 96
@pytest.mark.parametrize("head_dim", [80, 96, 256])
def test_b4_form_launches_match_a_counted_serve_run(head_dim, monkeypatch):
    """The kernels JSON's B4 rows of a monolithic serve run --
    ``b4_form_launches``: a launch a layer a decode step, and a layer a
    prompt's prefill by its bucket -- against a tiny engine of head dim 80
    and 96 (and Gemma's 256) on the CPU whose plain paged attention
    records each call's query length (through the dense attention it
    calls); only the buckets asked for are kept."""
    from deepspeed_tpu_torch.inference.serving import ServingEngine
    from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                        TransformerConfig)
    from deepspeed_tpu_torch.ops.cuda import ragged_paged_attention as rp
    seen, real = [], rp.dense_attention    # what the plain version calls
    monkeypatch.setattr(rp, "dense_attention",
                        lambda q, *a, **k: seen.append(q.shape[1]) or
                        real(q, *a, **k))
    cfg = TransformerConfig.tiny(hidden_size=2 * head_dim, n_heads=2,
                                 n_layers=3)
    model = CausalTransformerLM(cfg, device="cpu").init(0)
    lens = [5, 20, 3, 33, 9, 16]
    rng = np.random.default_rng(1)
    eng = ServingEngine(model, max_batch=2, page_size=8, max_seq=64,
                        dtype=torch.float32)
    eng.generate([rng.integers(0, 256, (n,)).tolist() for n in lens],
                 max_new_tokens=6)
    steps = eng.scheduler.sched_stats["decode_steps"]
    got = chip_smoke.b4_form_launches(3, steps, lens, "_d80")
    assert got["ragged_paged_attention_d80"] == 3 * steps == \
        seen.count(1)
    by_bucket = {}
    for T in seen:
        if T > 1:
            key = f"ragged_paged_attention_prefill_{T}_d80"
            by_bucket[key] = by_bucket.get(key, 0) + 1
    assert {k: v for k, v in got.items() if "prefill" in k} == by_bucket
    assert sum(got.values()) == len(seen) == 3 * eng.stats["model_calls"]
    assert chip_smoke.b4_form_launches(3, steps, lens, "_d80", (8, 16)) == {
        "ragged_paged_attention_d80": 3 * steps,
        "ragged_paged_attention_prefill_8_d80": 3 * 2,     # prompts 5, 3
        "ragged_paged_attention_prefill_16_d80": 3 * 2}    # 9, 16


def test_bench_launches_match_counted_bench_runs(monkeypatch):
    """Phases (b) and (c)'s expected launches -- ``serving_bench_launches``
    (B4 a layer a model call of the two continuous-batching engines, their
    prefills by bucket, the rest decode rows; B5 a layer a call of the
    sequential generates, prompts apart from steps) and
    ``inference_bench_launches`` -- against the benches run on the CPU at
    tiny (head dim 16), each plain call's query length recorded through
    the dense attention it calls."""
    from deepspeed_tpu_torch.benchmarks import inference, serving
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    from deepspeed_tpu_torch.ops.cuda import ragged_paged_attention as rp
    seen = []
    for mod, kind in ((rp, "ragged"), (da, "decode")):
        monkeypatch.setattr(mod, "dense_attention",
                            lambda q, *a, kind=kind, real=mod.dense_attention,
                            **k: seen.append((kind, q.shape[1])) or
                            real(q, *a, **k))
    res = serving.run_benchmark("tiny", requests=5, max_batch=2,
                                prompt_len=12, gen=3, page_size=8,
                                decode_chunk=2, device="cpu")
    lens, _ = serving.prompt_mix(5, 12, 256)
    got = chip_smoke.serving_bench_launches(2, res, lens, 12 + 3 + 8, "_d16")
    want = {}
    for kind, T in seen:
        if kind == "ragged":
            key = ("ragged_paged_attention_d16" if T == 1 else
                   f"ragged_paged_attention_prefill_{T}_d16")
        else:
            key = "decode_attention_d16" + ("" if T == 1 else "_prefill")
        want[key] = want.get(key, 0) + 1
    assert got == want
    assert {k for k in got if "prefill_" in k} == {
        "ragged_paged_attention_prefill_8_d16",
        "ragged_paged_attention_prefill_16_d16"}
    assert chip_smoke._kernel_totals(got) == {
        "ragged_paged_attention": 2 * (
            res["model_calls"]["continuous_batching"] +
            res["model_calls"]["continuous_batching_chunk2"]),
        "decode_attention": 2 * res["model_calls"][
            "sequential_single_stream"]}
    seen.clear()
    inference.benchmark("tiny", "fp32", 1, 8, 3, 1, device="cpu")
    assert chip_smoke.inference_bench_launches(2, 1, 3, "_d16") == {
        "decode_attention_d16_prefill": seen.count(("decode", 8)),
        "decode_attention_d16": seen.count(("decode", 1))} == {
        "decode_attention_d16_prefill": 2 * 4,
        "decode_attention_d16": 2 * 4 * 2}


def test_generate_launches_match_a_counted_generate():
    """``generate_launches``: one B5 launch a layer a model call of
    ``generate`` (the prompt's prefill, then new - 1 decode steps),
    against a counted CPU run through the plain version at head dim 96."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                        TransformerConfig)
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    cfg = TransformerConfig.tiny(hidden_size=192, n_heads=2, n_layers=3)
    model = CausalTransformerLM(cfg, device="cpu").init(0)
    ids = np.random.default_rng(2).integers(0, 256, (2, 7))
    da.decode_attention_plain.calls = 0
    out = deepspeed_tpu_torch.init_inference(
        model, dtype="fp32", device="cpu").generate(ids, 5)
    assert tuple(out.shape) == (2, 12)
    assert da.decode_attention_plain.calls == \
        chip_smoke.generate_launches(3, 5) == 15
    assert chip_smoke.generate_launches(32) == 32 * chip_smoke.GEN_NEW


def test_decode_work_is_the_bytes_and_operations_of_a_step():
    """B5's decode step at the new serving paths' shapes (B=4, 32 kv heads,
    length 144): every K and V byte once plus q and o -- at head dim 80
    5.90 MB of K/V and 40,960 bytes of q and o, a bound of 1.77 us at
    3.35 TB/s; at 96, 7.08 MB and 49,152 -- and 4 D operations a head per
    (query, key) pair: bound by bytes."""
    for D, kv in ((80, 5_898_240), (96, 7_077_888)):
        nbytes, ops = chip_smoke.decode_work(4, 32, 32, 144, D, 2)
        assert nbytes == kv + 4 * 2 * 32 * D * 2
        assert ops == 4 * 4 * 32 * D * 144
        bound_ms, by = chip_smoke._bound(nbytes, ops, "bfloat16")
        assert by == "bytes" and bound_ms == nbytes / 3.35e12 * 1e3
    assert chip_smoke._bound(*chip_smoke.decode_work(
        4, 32, 32, 144, 80, 2), "bfloat16")[0] == pytest.approx(1.773e-3,
                                                                 rel=1e-3)


@pytest.mark.parametrize("ctx,T", [([137, 145, 9], 1), ([300, 457], 200),
                                   ([768], 256), ([14, 30], 5)])
def test_paged_work_counts_what_the_mask_lets_through(ctx, T):
    """B4's work over sequences of ``ctx`` tokens, the last T the queries:
    the (query, key) pairs are those the causal-ragged mask of the plain
    version lets through, counted here from the mask itself; the bytes
    are each sequence's K and V once, q and o once."""
    H, Hkv, D = 4, 2, 96
    S = max(ctx)
    qpos = torch.tensor(ctx)[:, None] - T + torch.arange(T)[None]
    mask = torch.arange(S)[None, None] <= qpos[:, :, None]
    nbytes, ops = chip_smoke.paged_work(ctx, T, H, Hkv, D, 2)
    assert ops == 4 * H * D * int(mask.sum())
    assert nbytes == 2 * (2 * Hkv * D * sum(ctx) + 2 * len(ctx) * T * H * D)


# ---------------------------------------------- serving at head dim 256
def test_gemma_configs_are_the_published_shapes():
    """The serve-d256 phase's two models: Gemma-7B's 8,537,680,896
    parameters (HF's "8.54B": 16 heads of 256, H * dh = 4096 != d = 3072)
    and Gemma-2B's 2,506,172,416 (8 heads of 256 over one kv head), both
    with GeGLU, the embedding scale sqrt(d) and a tied head, as
    ``GemmaPolicy.build`` maps google/gemma-7b's and -2b's config.json;
    the smoke's own check passes them."""
    from deepspeed_tpu_torch.models.transformer import TransformerConfig
    g7, g2 = (TransformerConfig(**chip_smoke.GEMMA_7B),
              TransformerConfig(**chip_smoke.GEMMA_2B))
    assert g7.num_params() == 8_537_680_896
    assert g2.num_params() == 2_506_172_416
    assert g7.head_dim == g2.head_dim == 256
    assert g7.n_heads * g7.head_dim == 4096 != g7.hidden_size
    assert (g7.kv_heads, g2.n_heads // g2.kv_heads) == (16, 8)
    for g in (g7, g2):
        assert g.gated and g.tie_embeddings and g.activation == "gelu"
        assert g.embed_scale == g.hidden_size ** 0.5
    assert chip_smoke.gemma_configs() == (g7, g2)


def test_generate_launches_match_a_counted_gemma_generate():
    """``generate_launches`` at head dim 256 and a group of 8 over one kv
    head (Gemma-2B's attention), the embedding scale on: one B5 launch a
    layer a model call, against a counted CPU run through the plain
    version."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                        TransformerConfig)
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    cfg = TransformerConfig.tiny(hidden_size=64, n_heads=8, n_kv_heads=1,
                                 head_dim_override=256, n_layers=2,
                                 activation="gelu", gated_mlp=True,
                                 embed_scale=8.0, tie_embeddings=True)
    model = CausalTransformerLM(cfg, device="cpu").init(0)
    ids = np.random.default_rng(3).integers(0, 256, (2, 5))
    da.decode_attention_plain.calls = 0
    out = deepspeed_tpu_torch.init_inference(
        model, dtype="fp32", device="cpu").generate(ids, 4)
    assert tuple(out.shape) == (2, 9)
    assert da.decode_attention_plain.calls == \
        chip_smoke.generate_launches(2, 4) == 8


def test_work_of_the_gemma_2b_step_at_4096_keys():
    """The kernels JSON's row off the paths: Gemma-2B's B5 step (B=4, 8
    query heads over one kv head of 256) at 4096 cached keys moves 16.8
    MB -- 16,777,216 bytes of K/V and 32,768 of q and o -- a bound of 5.0
    us at 3.35 TB/s, set by bytes."""
    nbytes, ops = chip_smoke.decode_work(4, 8, 1, 4096, 256, 2)
    assert nbytes == 16_777_216 + 4 * 2 * 8 * 256 * 2 == 16_809_984
    assert ops == 4 * 4 * 8 * 256 * 4096
    bound_ms, by = chip_smoke._bound(nbytes, ops, "bfloat16")
    assert by == "bytes" and bound_ms == pytest.approx(5.018e-3, rel=1e-3)
    assert chip_smoke.OFF_PATH_D256 == "decode_attention_d256_gqa8_len4096"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("T,H,Hkv,B", [(1, 8, 1, 4), (2, 16, 4, 4),
                                       (8, 16, 16, 1), (5, 16, 16, 1)])
def test_chunk_edges_straddle_the_head_dim_256_chunk(T, H, Hkv, B, dtype):
    """Phase 3's chunk-edge lengths at head dim 256 (the Gemma shapes'
    5-8-row forms over S_max 2048, one wave of 132 slots: the staged
    body's plan) straddle the plan's chunk c -- c - 1, c, c + 1 and the
    second chunk's end -- and its last chunk's, and come B at a time."""
    from deepspeed_tpu_torch.ops.cuda.decode_attention import (
        DECODE_MIN_CHUNK_STAGED, decode_splits)
    S = 2048
    n, c = decode_splits(B, T, H, Hkv, S, 132, dtype, 256)
    assert n > 1 and c % 64 == 0 and c >= DECODE_MIN_CHUNK_STAGED
    edges = chip_smoke.chunk_edge_lengths(n, c, T, S, B)
    assert {c - 1, c, c + 1} <= set(edges)
    assert 2 * c + 1 > S or {2 * c - 1, 2 * c, 2 * c + 1} <= set(edges)
    assert all(T <= x <= S for x in edges) and len(edges) % B == 0


def test_work_of_the_gemma_steps():
    """B5's decode step and B4's prefill at the Gemma shapes: Gemma-7B's
    step (B=4, 16 / 16 heads of 256, length 144) moves 9,437,184 bytes of
    K/V and Gemma-2B's (8 / 1) 589,824, both bound by bytes; a 1024-token
    prefill of Gemma-7B's heads does 4 D operations per pair of the causal
    mask, 8.7 us at 989 TFLOP/s, under the 10.0 us its 33.6 MB take at
    3.35 TB/s: bytes bound it too."""
    for H, Hkv, kv in ((16, 16, 9_437_184), (8, 1, 589_824)):
        nbytes, ops = chip_smoke.decode_work(4, H, Hkv, 144, 256, 2)
        assert nbytes == kv + 4 * 2 * H * 256 * 2
        assert ops == 4 * 4 * H * 256 * 144
        assert chip_smoke._bound(nbytes, ops, "bfloat16")[1] == "bytes"
    nbytes, ops = chip_smoke.paged_work([1024], 1024, 16, 16, 256, 2)
    assert ops == 4 * 16 * 256 * 1024 * 1025 // 2
    assert nbytes == 4 * 1024 * 16 * 256 * 2
    assert chip_smoke._bound(nbytes, ops, "bfloat16") == (
        nbytes / 3.35e12 * 1e3, "bytes")


# ------------------------------------------------------------ phase ckpt
def test_resume_launches_are_phase_7s_formula_for_a_counted_run():
    """The plain versions count one call per kernel launch: a 2-step run
    of a 3-layer model from ``initialize(training_data=...)`` and
    ``train_batch(data_iter=...)`` calls them as the formula says."""
    import dataclasses
    from deepspeed_tpu_torch.benchmarks.training import model_config
    from deepspeed_tpu_torch.ops import adam, flash_attention
    cfg = model_config(dict(hidden_size=64, n_layers=3, n_heads=4), 16,
                       vocab_size=256)
    engine, loader = chip_smoke.ckpt_engine(
        cfg, 0, {}, device="cpu", training_data=chip_smoke.ckpt_dataset(cfg))
    it = iter(chip_smoke.skipped_iter(engine, chip_smoke.ckpt_dataset(cfg),
                                      chip_smoke.TRAIN_GAS))
    flash_attention.flash_attention_fwd_plain.calls = 0
    flash_attention.flash_attention_bwd_plain.calls = 0
    adam.reference_impl.calls = 0
    run = chip_smoke.ckpt_steps(engine, it)
    want = chip_smoke.ckpt_resume_launches(cfg)
    assert flash_attention.flash_attention_fwd_plain.calls == \
        want["flash_attention_fwd"] == 2 * 3 * chip_smoke.TRAIN_GAS * 2
    # one plain backward computes dQ, dK and dV together
    assert flash_attention.flash_attention_bwd_plain.calls == \
        want["flash_attention_bwd_dq"] == want["flash_attention_bwd_dkv"]
    assert adam.reference_impl.calls == want["fused_adam"] == 2
    assert not any(v for k, v in want.items() if "biased" in k or k in (
        "decode_attention", "ragged_paged_attention", "sparse_attention"))
    assert len(run["losses"]) == len(run["norms"]) == chip_smoke.CKPT_STEPS
    # the child rebuilds this config from its spec file
    spec = {"cfg": dataclasses.asdict(cfg)}
    assert chip_smoke._spec_cfg(spec) == cfg


def test_disk_reckoning_fails_when_short(capsys):
    n, n_small = 1_011_165_184, 205_000_000
    need = chip_smoke.ckpt_disk_need(n, n_small)
    # the sync and async tags (12 B / param each) and the universal dir
    assert need == int(1.1 * 28 * n)
    assert chip_smoke.ckpt_disk_need(1000, 10_000) == int(1.1 * 60 * 10_000)
    chip_smoke.check_disk(need, need, "/x")
    with pytest.raises(SystemExit):
        chip_smoke.check_disk(need - 1, need, "/x")
    assert "needs 31.1 GB free under /x" in capsys.readouterr().out


def test_resume_verdict_bitwise_or_within_the_witness_gap():
    ref = {"losses": [10.5, 10.25], "norms": [0.8, 0.7],
           "crc": {"master": 1, "m": 2, "v": 3}}
    same = {k: (dict(v) if isinstance(v, dict) else list(v))
            for k, v in ref.items()}
    assert chip_smoke.resume_verdict(ref, same, None) == (True, "bitwise")
    # bitwise witness: any difference fails, a crc as much as a loss
    off_crc = dict(same, crc={"master": 1, "m": 2, "v": 4})
    assert not chip_smoke.resume_verdict(ref, off_crc, None)[0]
    off_loss = dict(same, losses=[10.5, np.nextafter(10.25, 11)])
    assert not chip_smoke.resume_verdict(ref, off_loss, None)[0]
    # a witness that did not repeat: held to WITNESS_FACTOR x its gap
    gap = 1e-3
    near = dict(off_crc, losses=[10.5 * (1 + 1.5 * gap), 10.25])
    far = dict(off_crc, losses=[10.5 * (1 + 2.5 * gap), 10.25])
    assert chip_smoke.resume_verdict(ref, near, gap)[0]
    assert not chip_smoke.resume_verdict(ref, far, gap)[0]
