"""The route of the padded-sparse and CSR layers (``fused_s2v_layer_sparse``,
``fused_s2v_layer_csr``) and of the CSR aggregate (``csr_aggregate``) on
the card: the row walk or the windowed walk.

Both routes are hand-written kernels that sum each output as one fmaf
chain in slot order, with the same θ4 epilogue (none for the aggregate),
so they give the same bits (``csrc/s2v_gather.cu``, ``csrc/s2v_csr.cu``).  The windowed walk
(``csrc/s2v_window.cuh``) streams the whole graph's x through every block
of 128 output nodes; the row walk reads x once per slot from L2 and
nothing per block.  So the windowed walk pays only where x is small next
to the lists: :func:`walk_route` compares the windows' bytes with the
lists' bytes, from the shapes alone.
"""
from __future__ import annotations

from typing import Optional

import torch

WALKS = ("rows", "windows")
WINDOW_NODES = 128        # output nodes per block of the windowed walk
# The windowed walk is chosen while its windows move at most WINDOW_RATIO
# times the lists' bytes.  Measured by ``chip_smoke.py --only
# fused_s2v_layer_sparse,fused_s2v_layer_csr`` (its route sweep, K = 32,
# f32, on an H100 SXM): the windowed walk won at every ratio up to 2 (at
# 2: 0.17 ms against the row walk's 0.25, B = 8, N = 4096), and at N =
# 20480, B = 1 it lost from 2.5 up (0.67 against 0.59 ms); at N = 4096 it
# was no slower even at 8, so the crossover moves with N, and 2 is the
# largest ratio that won at both.
WINDOW_RATIO = 2.0


def check_walk(walk: Optional[str]) -> None:
    """``walk`` forces a route (tests and chip_smoke.py only): None, "rows"
    or "windows"; anything else raises, on any device."""
    if walk is not None and walk not in WALKS:
        raise ValueError(f"unknown walk {walk!r}; available: None or "
                         f"{list(WALKS)}")


def window_bytes(b: int, k: int, n: int, nl: int) -> int:
    """Bytes of x the windowed walk streams: each of the B·⌈Nl / 128⌉
    blocks reads its graph's N node rows of KP = K rounded up to 4 floats."""
    kp = k + -k % 4
    return b * -(-nl // WINDOW_NODES) * n * kp * 4


def walk_route(b: int, k: int, n: int, nl: int, slots: int) -> str:
    """The route of one launch over B graphs of N nodes of x (K rows), Nl
    output nodes and ``slots`` (id, factor) list slots in all (B·Nl·D for
    padded lists, B·E for CSR): "windows" when the windows' bytes are at
    most WINDOW_RATIO times the lists' 8 bytes a slot, else "rows"."""
    return ("windows" if window_bytes(b, k, n, nl) <= WINDOW_RATIO * 8 * slots
            else "rows")


def padded_node_major(x: torch.Tensor) -> torch.Tensor:
    """(B, K, M) → a (B, M, KP) copy with KP = K rounded up to a multiple
    of 4 and zeros in the added rows, so the windowed walk copies and reads
    one node's K values as whole 16-byte vectors."""
    pad = -x.shape[1] % 4
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    return x.transpose(1, 2).contiguous()


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it starts on 16 bytes (every tensor the caching
    allocator gives does), else an aligned copy, so the windowed walk reads
    its slots as 16-byte groups."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
