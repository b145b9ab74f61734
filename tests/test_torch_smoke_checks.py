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
* ``sass_counts`` reads the wgmma and TMA counts of exactly the bf16 and
  fp16 tensor-core instantiations out of ``cuobjdump -sass`` text.
* The serving features' checks: the divergence rule (a greedy token may
  leave the baseline only at a near-tie of the baseline's logits) and the
  B4 launch counts expected from the dispatch shapes of chunked,
  speculative and ``decode_chunk`` runs, held here against a tiny engine
  whose plain paged attention counts its calls.
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
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_fwd_cu_016flash_fwd_kernelI13__nv_bfloat16Lb1ELb0EEEvNS_9FwdParamsE
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0110*/                   UTMALDG.4D [UR12], [UR4] ;
        /*0200*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
        /*0210*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_fwd_cu_016flash_fwd_kernelIfLb1ELb0EEEvNS_9FwdParamsE
        /*0100*/                   FFMA R1, R2, R3, R4 ;
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_fwd_cu_016flash_fwd_kernelI13__nv_bfloat16Lb0ELb1EEEvNS_9FwdParamsE
        /*0100*/                   FFMA R1, R2, R3, R4 ;
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_fwd_cu_016flash_fwd_kernelI6__halfLb1ELb0EEEvNS_9FwdParamsE
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0200*/                   HGMMA.64x128x16.F32.F16 R24, gdesc[UR8], RZ, !UPT ;
"""


def test_sass_counts_reads_the_bf16_instantiations():
    counts = chip_smoke.sass_counts(_SASS, "flash_fwd_kernel")
    # the fp32 instantiation is not counted; a bf16 one without wgmma or
    # TMA shows as zeros, which phase_sass refuses; fp16 ones are read too
    assert counts == {("bf16", True, False): (2, 2),
                      ("bf16", False, True): (0, 0),
                      ("fp16", True, False): (1, 1)}
    assert chip_smoke.sass_counts(_SASS, "flash_bwd_dkv_kernel") == {}


_SASS_DQ = """
        code for sm_90a
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_bwd_cu_019flash_bwd_dq_kernelI13__nv_bfloat16Lb0ELb0EEEvNS_8DqParamsE
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0200*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
        /*0210*/                   HGMMA.64x128x16.F32.BF16 R88, R152, gdesc[UR12], R88, gsb0 ;
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_bwd_cu_019flash_bwd_dq_kernelI13__nv_bfloat16Lb1ELb1EEEvNS_8DqParamsE
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0110*/                   UTMALDG.4D [UR12], [UR4] ;
        /*0200*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_bwd_cu_019flash_bwd_dq_kernelIfLb1ELb1EEEvNS_8DqParamsE
        /*0100*/                   FFMA R1, R2, R3, R4 ;
                Function : _ZN55_GLOBAL__N__0_22_flash_attention_bwd_cu_020flash_bwd_dkv_kernelI13__nv_bfloat16Lb0ELb0EEEvNS_9DkvParamsE
        /*0200*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
"""


def test_sass_counts_reads_the_dq_instantiations():
    """The dQ kernel shares its library with dK/dV: each template's bf16
    instantiations are read apart, its fp32 one not at all."""
    assert ("flash_attention_bwd", "flash_bwd_dq_kernel") in \
        chip_smoke.TENSOR_CORE_KERNELS
    assert chip_smoke.sass_counts(_SASS_DQ, "flash_bwd_dq_kernel") == {
        ("bf16", False, False): (2, 1), ("bf16", True, True): (1, 2)}
    assert chip_smoke.sass_counts(_SASS_DQ, "flash_bwd_dkv_kernel") == {
        ("bf16", False, False): (1, 0)}


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
                Function : _ZN60_GLOBAL__N__0_19_sparse_attention_cu_016sparse_tc_kernelILi16ELi64EEEvNS_8TcParamsE
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0200*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
        /*0210*/                   HGMMA.64x64x16.F32.BF16 R24, R88, gdesc[UR12], R24, gsb0 ;
                Function : _ZN60_GLOBAL__N__0_19_sparse_attention_cu_016sparse_tc_kernelILi128ELi128EEEvNS_8TcParamsE
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0110*/                   UTMALDG.4D [UR12], [UR4] ;
        /*0200*/                   HGMMA.64x128x16.F32.BF16 R24, R88, gdesc[UR12], R24, gsb0 ;
                Function : _ZN60_GLOBAL__N__0_19_sparse_attention_cu_023sparse_attention_kernelIfLi16ELi64EEEvPKT_S3_S3_PS1_PKiS6_iiiff
        /*0100*/                   FFMA R1, R2, R3, R4 ;
                Function : _ZN66_GLOBAL__N__0_25_ragged_paged_attention_cu_024ragged_prefill_tc_kernelI13__nv_bfloat16EEvNS_13PrefillParamsE
        /*0100*/                   UTMALDG.3D [UR8], [UR4] ;
        /*0110*/                   UTMALDG.2D [UR12], [UR4] ;
        /*0200*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
                Function : _ZN66_GLOBAL__N__0_25_ragged_paged_attention_cu_024ragged_prefill_tc_kernelI6__halfEEvNS_13PrefillParamsE
        /*0100*/                   UTMALDG.3D [UR8], [UR4] ;
        /*0200*/                   HGMMA.64x128x16.F32.F16 R24, gdesc[UR8], RZ, !UPT ;
        /*0210*/                   HGMMA.64x128x16.F32.F16 R24, R88, gdesc[UR12], R24, gsb0 ;
                Function : _ZN66_GLOBAL__N__0_25_ragged_paged_attention_cu_029ragged_paged_attention_kernelIfLi128ELi16EEEvPKT_S3_S3_PS1_PKiS6_S6_S6_S6_S6_iiiiif
        /*0100*/                   FFMA R1, R2, R3, R4 ;
"""


def test_sass_counts_reads_the_sparse_and_prefill_instantiations():
    """B6's tensor-core kernel by (block, head dim), B4's prefill kernel
    by element type (bf16, fp16); their CUDA-core kernels are not
    counted."""
    kernels = dict((k, s) for s, k in chip_smoke.TENSOR_CORE_KERNELS)
    assert kernels["sparse_tc_kernel"] == "sparse_attention"
    assert kernels["ragged_prefill_tc_kernel"] == "ragged_paged_attention"
    assert chip_smoke.sass_counts(_SASS_NEW, "sparse_tc_kernel") == {
        (16, 64): (2, 1), (128, 128): (1, 2)}
    assert chip_smoke.sass_counts(_SASS_NEW, "ragged_prefill_tc_kernel") == {
        ("bf16",): (1, 2), ("fp16",): (2, 1)}
    # every template's expected instantiations: 4 flash forms x (bf16,
    # fp16), 4 x 2 sparse, 2 (bf16, fp16)
    assert {k: v[2] for k, v in chip_smoke.SASS_TEMPLATES.items()} == {
        "flash_fwd_kernel": 8, "flash_bwd_dq_kernel": 8,
        "flash_bwd_dkv_kernel": 8, "sparse_tc_kernel": 8,
        "ragged_prefill_tc_kernel": 2}


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
