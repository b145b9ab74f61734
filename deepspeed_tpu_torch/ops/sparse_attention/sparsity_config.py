"""Block-sparsity layout configs.

The port's own copy of ``deepspeed_tpu/ops/sparse_attention/
sparsity_config.py`` (the port imports nothing of the JAX package): the
same seven classes -- the base ``SparsityConfig`` and the Dense / Fixed /
Variable / BigBird / BSLongformer / LocalSlidingWindow family of the
reference's ``deepspeed/ops/sparse_attention/sparsity_config.py`` -- with
the same arithmetic and the same seeded numpy random draws, so every
layout is bit-identical to the JAX package's.  Each config builds a
per-head boolean block layout [num_heads, num_blocks, num_blocks]; a set
bit means the (row-block, col-block) tile of attention is computed.  They
are numpy only; the block-sparse kernel takes them as tile tables.
"""

from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base: block size + head layout bookkeeping."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(
                f"seq_len {seq_len} must be divisible by block {self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), dtype=bool)

    def check_and_propagate_first_head_layout(self, layout: np.ndarray
                                              ) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks attended (degenerate case for testing/perf baselines)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = True
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Fixed local windows + periodic global blocks (the Sparse Transformer
    pattern).  ``num_local_blocks`` per window; the last
    ``num_global_blocks`` of each window are global: they attend/are
    attended everywhere (respecting directionality)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        assert attention in ("unidirectional", "bidirectional")
        self.attention = attention
        if horizontal_global_attention:
            assert attention == "bidirectional", \
                "horizontal global attention requires bidirectional"
        self.horizontal_global_attention = horizontal_global_attention
        if num_different_global_patterns > 1:
            assert different_layout_per_head, \
                "different global patterns need different_layout_per_head"
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        for h in range(self.num_layout_heads):
            # local windows
            for start in range(0, n, self.num_local_blocks):
                end = min(start + self.num_local_blocks, n)
                for r in range(start, end):
                    hi = (r + 1) if self.attention == "unidirectional" else end
                    layout[h, r, start:hi] = True
            # global columns: representative block(s) of each window;
            # pattern index rotates across heads
            pat = (h % self.num_different_global_patterns)
            for start in range(0, n, self.num_local_blocks):
                g_lo = start + self.num_local_blocks - (pat + 1) * \
                    self.num_global_blocks
                g_lo = max(start, g_lo)
                g_hi = min(g_lo + self.num_global_blocks, n, start +
                           self.num_local_blocks)
                for g in range(g_lo, g_hi):
                    if self.attention == "unidirectional":
                        layout[h, g:, g] = True     # later rows see global g
                    else:
                        layout[h, :, g] = True
                        if self.horizontal_global_attention:
                            layout[h, g, :] = True
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Variable local window sizes + random blocks + global first blocks."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.rng = np.random.default_rng(seed)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        for h in range(self.num_layout_heads):
            # variable local windows: cycle through the size list
            start, wi = 0, 0
            while start < n:
                w = self.local_window_blocks[
                    min(wi, len(self.local_window_blocks) - 1)]
                end = min(start + w, n)
                for r in range(start, end):
                    hi = (r + 1) if self.attention == "unidirectional" else end
                    layout[h, r, start:hi] = True
                start, wi = end, wi + 1
            # random blocks per row
            for r in range(n):
                limit = (r + 1) if self.attention == "unidirectional" else n
                for _ in range(self.num_random_blocks):
                    layout[h, r, int(self.rng.integers(0, limit))] = True
            # global columns
            cols = self._global_cols(n)
            for g in cols:
                if self.attention == "unidirectional":
                    layout[h, g:, g] = True
                else:
                    layout[h, :, g] = True
                    if self.horizontal_global_attention:
                        layout[h, g, :] = True
        return self.check_and_propagate_first_head_layout(layout)

    def _global_cols(self, n):
        if self.global_block_end_indices:
            cols = []
            for lo, hi in zip(self.global_block_indices,
                              self.global_block_end_indices):
                cols.extend(range(lo, min(hi, n)))
            return cols
        return [g for g in self.global_block_indices if g < n]


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird: random + sliding window + global first/last blocks."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1,
                 num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1,
                 attention: str = "bidirectional", seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.rng = np.random.default_rng(seed)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        g = self.num_global_blocks
        for h in range(self.num_layout_heads):
            for r in range(n):
                lo, hi = max(0, r - w), min(n, r + w + 1)
                if self.attention == "unidirectional":
                    hi = min(hi, r + 1)
                layout[h, r, lo:hi] = True
                limit = (r + 1) if self.attention == "unidirectional" else n
                for _ in range(self.num_random_blocks):
                    layout[h, r, int(self.rng.integers(0, limit))] = True
            # global: first g block rows/cols (+ last g for bidirectional)
            layout[h, :, :g] = True
            layout[h, :g, :] = (layout[h, :g, :] if
                                self.attention == "unidirectional" else True)
            if self.attention == "bidirectional":
                layout[h, :, n - g:] = True
                layout[h, n - g:, :] = True
            else:
                # causal: zero out the upper triangle contributions added
                tri = np.tril(np.ones((n, n), dtype=bool))
                layout[h] &= tri
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + explicit global blocks."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for r in range(n):
                lo, hi = max(0, r - w), min(n, r + w + 1)
                if self.attention == "unidirectional":
                    hi = min(hi, r + 1)
                layout[h, r, lo:hi] = True
            cols = (self.global_block_indices
                    if not self.global_block_end_indices else
                    [c for lo, hi in zip(self.global_block_indices,
                                         self.global_block_end_indices)
                     for c in range(lo, min(hi, n))])
            for g in cols:
                if g >= n:
                    continue
                if self.attention == "unidirectional":
                    layout[h, g:, g] = True
                else:
                    layout[h, :, g] = True
                    layout[h, g, :] = True
        return self.check_and_propagate_first_head_layout(layout)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Pure sliding window (optionally causal)."""

    def __init__(self, num_heads: int, block: int = 16,
                 num_sliding_window_blocks: int = 3,
                 attention: str = "unidirectional"):
        super().__init__(num_heads, block, different_layout_per_head=False)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        full = self.num_sliding_window_blocks
        for r in range(n):
            if self.attention == "unidirectional":
                lo = max(0, r - full + 1)
                layout[0, r, lo:r + 1] = True
            else:
                layout[0, r, max(0, r - w):min(n, r + w + 1)] = True
        layout[1:] = layout[0]
        return layout
