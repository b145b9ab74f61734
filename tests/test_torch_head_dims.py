"""Head dims no kernel takes are refused at construction on the card.

The flash kernels (B1, B2) and the serving kernels (B4, B5) take head
dims 64, 80, 96, 128 and 256, and the serving kernels 16 too (the
benches' tiny model); the block-sparse kernel (B6) takes 64 and
128.  So gpt_760m (96), gpt_2_7b (80), a Phi-3-mini-shaped model (96) and
the Gemma shapes (256) train and are served on the card, and a 48 does
neither.  A model of a head dim its
path's kernels do not take raises
``NotImplementedError`` naming ROADMAP A16 where it is built for the
card: ``initialize`` (which ``ds_bench
train``'s ``run_benchmark`` reaches), ``init_inference`` and
``create_serving_engine``; ``SparseSelfAttention`` learns the head dim
only at its call and raises there.  On the CPU the same model runs
through the plain versions.  The card path is reached
without a card: a device of "cuda" is checked before anything is put on
it (the serving engine through a stub model whose device is "cuda", as
``tests/test_torch_fp16_training.py`` does).
"""

import types

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference.serving import ServingEngine
from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                    TransformerConfig,
                                                    check_servable,
                                                    check_trainable)
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from torch_threads import _one_torch_thread  # noqa: F401

# GPT-style, 2 layers, 2 heads of 96 (gpt_760m's head dim)
GPT96 = dict(hidden_size=192, n_heads=2, activation="gelu",
             use_rmsnorm=False, use_rope=False, norm_bias=True,
             tie_embeddings=True)
TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": 2,
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
A16 = "head_dim 96 not in .*ROADMAP A16"
A16_256 = "head_dim 256 not in .*ROADMAP A16"
A16_48 = "head_dim 48 not in .*ROADMAP A16"


def _model(**kw):
    cfg = TransformerConfig.tiny(**dict(GPT96, **kw))
    return CausalTransformerLM(cfg, device="cpu").init(0)


def _ids(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape)


@pytest.mark.parametrize("head_dim", [64, 128, 80, 96, 256, 48, 16])
def test_card_checks_by_head_dim(head_dim):
    """64, 80, 96, 128 and 256 pass both checks on the card (80 and 96
    pass serving's since B4 and B5 take them, 256 training's since B1 and
    B2 do); 16 (the benches' tiny model) passes serving's, since B4 and B5
    take it, and training's raises naming A16; 48 raises naming A16 at
    both.  Every head dim passes both on the CPU."""
    cfg = TransformerConfig.tiny(hidden_size=2 * head_dim, n_heads=2)
    assert cfg.head_dim == head_dim
    for check, taken in ((check_trainable, (64, 80, 96, 128, 256)),
                         (check_servable, (16, 64, 80, 96, 128, 256))):
        check(cfg, "cpu")
        if head_dim in taken:
            check(cfg, torch.device("cuda"))
        else:
            with pytest.raises(NotImplementedError,
                               match=f"head_dim {head_dim} .*ROADMAP A16"):
                check(cfg, "cuda")


def test_initialize_refuses_head_dim_96_on_the_card():
    """Head dim 48 is refused on the card: 96 and then 256, which this test
    refused before their flash forms were ported, now train there
    (``test_card_checks_by_head_dim``,
    ``test_gemma_2b_shape_passes_the_card_checks``)."""
    model = _model(hidden_size=96)
    assert model.config.head_dim == 48
    with pytest.raises(NotImplementedError, match=A16_48):
        deepspeed_tpu_torch.initialize(model=model, config=TRAIN_CONFIG,
                                       device="cuda")
    # the same model trains on the CPU through the plain versions
    engine, *_ = deepspeed_tpu_torch.initialize(model=model,
                                                config=TRAIN_CONFIG,
                                                device="cpu")
    losses = [float(engine.train_batch(batch={"input_ids": _ids((2, 16))}))
              for _ in range(2)]
    assert np.isfinite(losses).all()


def test_gemma_2b_shape_passes_the_card_checks():
    """google/gemma-2b's shape as ``GemmaPolicy.build`` maps it: 8 query
    heads of 256 over one kv head (MQA), GeGLU, embeddings times sqrt(d),
    tied -- the port builds and trains it on the card: both checks pass
    there (no weights are made here)."""
    from deepspeed_tpu_torch.models.transformer import check_supported
    cfg = TransformerConfig(
        vocab_size=256000, hidden_size=2048, n_layers=18, n_heads=8,
        n_kv_heads=1, ffn_hidden_size=16384, max_seq_len=8192,
        rope_theta=10000.0, norm_eps=1e-6, activation="gelu",
        gated_mlp=True, embed_scale=2048 ** 0.5, use_rmsnorm=True,
        use_rope=True, tie_embeddings=True, remat=True)
    assert (cfg.head_dim, cfg.n_heads, cfg.kv_heads) == (256, 8, 1)
    assert cfg.num_params() == 2_506_172_416
    check_supported(cfg)
    check_trainable(cfg, "cuda")
    check_servable(cfg, "cuda")


def test_init_inference_refuses_head_dim_96_on_the_card():
    """Head dim 48 is refused on the card: 96, which this test refused
    before B5's forms at 80 and 96 were ported, and 256, which it refused
    before B5's forms at 256 were, now pass ``check_servable`` there
    (``test_card_checks_by_head_dim``)."""
    model = _model(hidden_size=96)
    assert model.config.head_dim == 48
    with pytest.raises(NotImplementedError, match=A16_48):
        deepspeed_tpu_torch.init_inference(model, dtype="fp32",
                                           device="cuda")
    eng = deepspeed_tpu_torch.init_inference(model, dtype="fp32",
                                             device="cpu")
    out = eng.generate(_ids((2, 5)), 3)
    assert np.asarray(out).shape == (2, 8)


def test_serving_engine_refuses_head_dim_96_on_the_card():
    """Head dim 48: the serving engine raises before it allocates its
    page pool on the card; with the plain backend (the smoke's
    comparison) it goes on.  Head dims 96 and 256, which this test
    refused before B4's forms at 80 and 96, then at 256, were ported, now
    reach the page pool on the card."""
    model = _model(hidden_size=96)
    assert model.config.head_dim == 48
    made = []

    def stub(cfg):
        return types.SimpleNamespace(
            config=cfg, device=torch.device("cuda"),
            init_paged_caches=lambda *a, **k: made.append(k["dtype"]))

    with pytest.raises(NotImplementedError, match=A16_48):
        deepspeed_tpu_torch.create_serving_engine(
            stub(model.config), max_batch=2, page_size=8, max_seq=32)
    assert made == []
    ServingEngine(stub(model.config), max_batch=2, page_size=8, max_seq=32,
                  serving={"attention_backend": "plain"})
    assert made == [torch.bfloat16]
    for hidden, head_dim in ((192, 96), (512, 256)):
        cfg = _model(hidden_size=hidden).config
        assert cfg.head_dim == head_dim
        deepspeed_tpu_torch.create_serving_engine(
            stub(cfg), max_batch=2, page_size=8, max_seq=32)
    assert made == [torch.bfloat16] * 3
    # on the CPU the plain versions serve head dim 48
    se = deepspeed_tpu_torch.create_serving_engine(
        model, max_batch=2, page_size=8, max_seq=32, dtype="fp32")
    out = se.generate([list(range(1, 6)), list(range(7, 10))], 3)
    assert [len(x) for x in out] == [5 + 3, 3 + 3]   # prompt + new
    assert se.leak_report() == {}


def test_tiny_serves_on_the_card_and_trains_only_off_it():
    """``TransformerConfig.tiny`` at the benches' width (hidden 64, 4 heads:
    head dim 16): ``init_inference`` and the serving engine take it on the
    card (B4 and B5 serve head dim 16); ``initialize`` refuses it there
    naming A16 (B1 and B2 do not take 16) and trains it on the CPU."""
    cfg = TransformerConfig.tiny(hidden_size=64, n_heads=4)
    assert cfg.head_dim == 16
    check_servable(cfg, "cuda")
    made = []
    stub = types.SimpleNamespace(
        config=cfg, device=torch.device("cuda"),
        init_paged_caches=lambda *a, **k: made.append(k["dtype"]))
    deepspeed_tpu_torch.create_serving_engine(stub, max_batch=2,
                                              page_size=8, max_seq=32)
    assert made == [torch.bfloat16]
    model = CausalTransformerLM(cfg, device="cpu").init(0)
    with pytest.raises(NotImplementedError,
                       match="head_dim 16 not in .*ROADMAP A16"):
        deepspeed_tpu_torch.initialize(model=model, config=TRAIN_CONFIG,
                                       device="cuda")
    engine, *_ = deepspeed_tpu_torch.initialize(model=model,
                                                config=TRAIN_CONFIG,
                                                device="cpu")
    assert np.isfinite(float(engine.train_batch(
        batch={"input_ids": _ids((2, 16))})))


def test_sparse_self_attention_refuses_head_dim_96_on_the_card():
    """SparseSelfAttention sees the head dim at its call: the kernel path
    raises naming A16 before any device check, at 96 and at Gemma's 256
    (which B4 and B5 now serve); the CPU's plain path takes it."""
    attn = tsa.SparseSelfAttention(tsa.FixedSparsityConfig(
        num_heads=2, block=16, num_local_blocks=2), backend="cuda")
    rng = np.random.default_rng(3)
    q256 = torch.zeros(1, 64, 2, 256)
    with pytest.raises(NotImplementedError, match=A16_256):
        attn(q256, q256, q256)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 64, 2, 96), dtype=np.float32)) for _ in range(3))
    with pytest.raises(NotImplementedError, match=A16):
        attn(q, k, v)
    plain = tsa.SparseSelfAttention(tsa.FixedSparsityConfig(
        num_heads=2, block=16, num_local_blocks=2))
    out = plain(q, k, v)
    assert out.shape == q.shape and torch.isfinite(out).all()
