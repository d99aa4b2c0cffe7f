"""Block-vector layout: deal.II ``BlockVector`` as a flat concatenated tensor.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.ops.blocks``.
``split`` returns views; ``concat`` copies.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .linop import LinOp

__all__ = ["BlockLayout", "block_operator"]


@dataclass(frozen=True)
class BlockLayout:
    sizes: tuple

    @property
    def offsets(self) -> tuple:
        return tuple(int(o) for o in np.cumsum([0] + list(self.sizes)))

    @property
    def total(self) -> int:
        return int(sum(self.sizes))

    @property
    def n_blocks(self) -> int:
        return len(self.sizes)

    def split(self, x):
        offs = self.offsets
        return tuple(x[offs[i]:offs[i + 1]] for i in range(self.n_blocks))

    def concat(self, blocks):
        return torch.cat(list(blocks), dim=0)


def block_operator(layout_rows: BlockLayout, layout_cols: BlockLayout,
                   blocks) -> LinOp:
    """Block operator from an n x m grid of LinOps/None (None = zero block),
    deal.II ``block_operator<n,m>``."""

    def mv(x):
        xs = layout_cols.split(x)
        out = []
        for i in range(layout_rows.n_blocks):
            acc = None
            for j in range(layout_cols.n_blocks):
                op = blocks[i][j]
                if op is not None:
                    y = op(xs[j])
                    acc = y if acc is None else acc + y
            if acc is None:
                acc = torch.zeros(layout_rows.sizes[i], dtype=x.dtype,
                                  device=x.device)
            out.append(acc)
        return layout_rows.concat(out)

    return LinOp(mv, (layout_rows.total, layout_cols.total))
