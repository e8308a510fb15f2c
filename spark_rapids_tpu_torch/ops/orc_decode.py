"""Device ORC decode: MSB-first bit-unpack and zigzag in plain torch ops.

Counterpart of ``spark_rapids_tpu/ops/orc_decode.py``. The RLEv2 run
structure is host metadata (``io/orc_native.py``); the packed payload bits
decode here. ORC packs values MSB-first and widths vary per run, so each
value carries its own bit offset and width: an 8-byte big-endian window per
value, one logical shift, one mask. The reference leaves this to XLA (no
Pallas kernel), so the port runs it as torch ops on the stripe's device.
"""

from __future__ import annotations

import torch


def unpack_msb_device(packed: torch.Tensor, bit_offsets: torch.Tensor,
                      widths: torch.Tensor, capacity: int) -> torch.Tensor:
    """(bytes,) uint8 + per-value bit offsets and widths (MSB-first packing)
    → (capacity,) int64 raw (pre-zigzag) values. Widths are at most 56, so
    the 8-byte window always covers offset % 8 + width bits."""
    nbytes = packed.shape[0]
    b0 = bit_offsets >> 3
    sh = bit_offsets & 7
    window = torch.zeros((capacity,), dtype=torch.int64,
                         device=packed.device)
    for k in range(8):
        byte = packed[(b0 + k).clamp(0, max(nbytes - 1, 0))].to(torch.int64)
        window = window | (byte << (8 * (7 - k)))
    w = widths.to(torch.int64)
    # torch's >> is arithmetic; the sign copies it drags in lie above bit
    # sh + w - 1 >= w - 1, so the width mask takes them off as a logical
    # shift would (w = 0 marks a constant slot: the mask is 0)
    shifted = window >> (64 - sh - w).clamp(max=63)
    mask = torch.where(w >= 64, torch.full_like(w, -1),
                       (torch.ones_like(w) << w) - 1)
    return shifted & mask


def zigzag_decode(v: torch.Tensor) -> torch.Tensor:
    """ORC/protobuf zigzag: (v >>> 1) ^ -(v & 1) on int64."""
    logical = (v >> 1) & 0x7FFFFFFFFFFFFFFF
    return logical ^ -(v & 1)


def decode_intv2_device(packed: torch.Tensor, bit_offsets, widths,
                        const_mask, const_vals, signed: bool,
                        capacity: int) -> torch.Tensor:
    """Merge the device-unpacked DIRECT runs with the host-decoded constant
    runs: positions with const_mask take const_vals; the rest unpack (and
    zigzag when signed)."""
    raw = unpack_msb_device(packed, bit_offsets, widths, capacity)
    vals = zigzag_decode(raw) if signed else raw
    return torch.where(const_mask, const_vals, vals)
