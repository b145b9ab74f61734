"""Block-sparse attention (the reference's
``deepspeed/ops/sparse_attention/``)."""

from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    SparseAttentionUtils, SparseSelfAttention, expand_layout_mask,
    sparse_attention, sparse_attention_plain)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
    FixedSparsityConfig, LocalSlidingWindowSparsityConfig, SparsityConfig,
    VariableSparsityConfig)

__all__ = [
    "SparsityConfig", "DenseSparsityConfig", "FixedSparsityConfig",
    "VariableSparsityConfig", "BigBirdSparsityConfig",
    "BSLongformerSparsityConfig", "LocalSlidingWindowSparsityConfig",
    "SparseSelfAttention", "SparseAttentionUtils", "sparse_attention",
    "sparse_attention_plain", "expand_layout_mask",
]
