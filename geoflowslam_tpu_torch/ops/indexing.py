"""Index helpers that pin down what XLA leaves to its own order.

* `topk_stable`: `jax.lax.top_k` breaks ties by the lowest index;
  `torch.topk` promises no order among equal values. A stable sort does.
* `scatter_set`: `x.at[idx].set(v, mode="drop")` drops out-of-range rows,
  and with duplicate targets XLA's sequential scatter keeps the last
  update. PyTorch raises on the former and leaves the winner undefined on
  CUDA for the latter. Here the highest source row wins, on every device,
  through a `scatter_reduce("amax")` of the row index; losers and
  out-of-range rows are written to a scratch row that is sliced off.
"""
from __future__ import annotations

import torch


def topk_stable(x: torch.Tensor, k: int, largest: bool = True):
    """(values, indices) of the k largest (or smallest) along the last dim,
    ties broken by the lowest index, like jax.lax.top_k."""
    vals, idx = torch.sort(x, dim=-1, descending=largest, stable=True)
    return vals[..., :k], idx[..., :k]


def scatter_set(dst: torch.Tensor, idx: torch.Tensor,
                val: torch.Tensor) -> torch.Tensor:
    """Out-of-place `dst[idx] = val` along dim 0, highest source row wins on
    duplicate targets, targets outside [0, len(dst)) dropped.

    idx: [P] int; val: [P, *dst.shape[1:]] (or broadcastable to it)."""
    n = dst.shape[0]
    idx = idx.reshape(-1).long()
    rows = torch.arange(idx.shape[0], device=dst.device)
    inb = (idx >= 0) & (idx < n)
    safe = torch.where(inb, idx, n)
    winner = torch.full((n + 1,), -1, dtype=torch.long, device=dst.device)
    winner = winner.scatter_reduce(0, safe, rows, "amax", include_self=True)
    keep = inb & (winner[safe] == rows)
    target = torch.where(keep, idx, n)
    buf = torch.cat([dst, dst[:1]], dim=0) if n > 0 else dst.new_zeros(
        (1,) + tuple(dst.shape[1:]))
    val = torch.broadcast_to(val.to(dst.dtype),
                             (idx.shape[0],) + tuple(dst.shape[1:]))
    buf[target] = val
    return buf[:n]


def scatter_set_2d(dst: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                   val: torch.Tensor) -> torch.Tensor:
    """`dst.at[rows, cols].set(val, mode="drop")` for a [R, C, ...] table,
    with the scatter_set rules over the flattened (row, col) index."""
    r, c = dst.shape[0], dst.shape[1]
    rows = rows.reshape(-1).long()
    cols = cols.reshape(-1).long()
    ok = (rows >= 0) & (rows < r) & (cols >= 0) & (cols < c)
    flat = torch.where(ok, rows * c + cols, r * c)
    tail = tuple(dst.shape[2:])
    v = val.reshape((-1,) + tail) if val.dim() > len(tail) else val
    out = scatter_set(dst.reshape((r * c,) + tail), flat, v)
    return out.reshape(dst.shape)
