"""American Soundex on the device, in plain torch: the `sdx_eq` stat.

The counterpart of `strsim_tpu/ops/phonetic.py` (`soundex_code`,
`soundex_equal`), which is XLA code in the JAX package, so it has no kernel
here either. Spec (classic American Soundex with the H/W rule):

  1. Only ASCII letters [A-Za-z] take part; every other char (pads included)
     is skipped with no effect on the state.
  2. The first letter is kept, uppercased, and its digit seeds "previous".
  3. Later letters map to digit classes BFPV 1, CGJKQSXZ 2, DT 3, L 4, MN 5,
     R 6, AEIOUYHW 0 (not coded).
  4. A letter is coded iff its digit is non-zero and differs from
     "previous"; every letter but H and W then sets "previous" to its digit.
  5. The code is the first letter and the first 3 coded digits, zero-padded,
     packed as ord(first) * 1000 + d1 * 100 + d2 * 10 + d3; no letter packs
     to 0.

The JAX package steps through the positions; here one pass over [B, L]
tensors finds, for each letter, the last letter before it that set
"previous" (a running maximum of positions), so the cost does not grow with
a loop over the width.
"""
from __future__ import annotations

import torch

# digit class per letter A..Z
_DIGITS = (0, 1, 2, 3, 0, 1, 2, 0, 0, 2, 2, 4, 5, 5, 0, 1, 2, 6, 2, 3, 0, 1, 0, 2, 0, 2)


def soundex_code(a: torch.Tensor, len_a: torch.Tensor) -> torch.Tensor:
    """[B] int32 packed codes of the rows of a [B, L] codepoint tile. As in
    the JAX package, only the first max(len_a) columns are read: past each
    row's length lie pads, which rule 1 skips."""
    n, width = a.shape
    steps = int(torch.clamp(len_a.long(), 0, width).max()) if n else 0
    if steps == 0:
        return torch.zeros(n, dtype=torch.int32, device=a.device)
    x = a[:, :steps].long()
    pos = torch.arange(steps, device=a.device).expand(n, steps)
    lower = (x >= 97) & (x <= 122)
    letter = lower | ((x >= 65) & (x <= 90))
    u = torch.where(lower, x - 32, x)
    table = torch.tensor(_DIGITS, dtype=torch.int64, device=a.device)
    d = torch.where(letter, table[(u - 65).clamp(0, 25)], 0)

    first_pos = torch.where(letter, pos, steps).min(1, keepdim=True).values  # steps: none
    first = torch.where(first_pos < steps, u.gather(1, first_pos.clamp(max=steps - 1)), 0)
    # letters that set "previous": the first one, then every one but H and W
    sets_prev = letter & ((pos == first_pos) | ((u != 72) & (u != 87)))
    last_set = torch.cummax(torch.where(sets_prev, pos, -1), dim=1).values
    before = torch.cat([torch.full((n, 1), -1, dtype=torch.int64, device=a.device),
                        last_set[:, :-1]], 1)  # last setter strictly before each position
    prev = torch.where(before >= 0, d.gather(1, before.clamp(min=0)), 0)
    coded = letter & (pos > first_pos) & (d != 0) & (d != prev)
    rank = torch.cumsum(coded.long(), 1) - 1
    pow10 = torch.tensor((100, 10, 1, 0), dtype=torch.int64, device=a.device)
    code = torch.where(coded & (rank < 3), d * pow10[rank.clamp(0, 3)], 0).sum(1)
    first = first[:, 0]
    return torch.where(first == 0, 0, first * 1000 + code).to(torch.int32)


def soundex_equal(a, b, len_a, len_b) -> torch.Tensor:
    """[B] int32: 1 where the rows' soundex codes are equal (two rows with no
    letter share the empty code)."""
    return (soundex_code(a, len_a) == soundex_code(b, len_b)).to(torch.int32)
