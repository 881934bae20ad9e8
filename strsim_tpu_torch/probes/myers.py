"""Four A/B probes of the Myers scan (K1, `ops/levenshtein_cuda.py`) and of
the fused lev + jaro kernel (K5, `ops/lev_jaro_cuda.py`), K16-K19.

Each is a hand-written CUDA kernel with its plain torch version here, the
counterpart of one TPU probe of `tools/`:

  K16 `myers_eq_scan`   tools/ab_myers_pallas.py `_scan_kernel` :92: Myers
      at one word a row (L <= 32) over equality words built outside the
      kernel (`pattern_eq_words`, the tool's XLA build :184-195), [L, B]
      int32, bit i of word j = (a_i == b_j) over a padded with PAD_A to 32
      chars. `unroll=False` is the scan with a runtime trip count (the
      tool's `fori_loop`), `unroll=True` the step unrolled over a width
      known when the kernel is built (the tool's static steps).
  K17 `myers_ineq`      tools/ab_myers_pallas.py `_ineq_kernel` :113: the
      same scan with each step's word built in the kernel by 32 compares
      against a's chars (padded with PAD_A to 32), on int8 or int32 tiles.
  K18 `myers_swar`      tools/ab_myers_swar.py `_kernel_swar` :54: the
      words built four pattern chars a compare (a's bytes packed four to a
      word, fill bytes 0xFF; xor, the exact zero-byte test, a multiply that
      gathers the four high bits into a nibble); int8 tiles only.
  K19 `fused_lev_jaro`  tools/ab_fused_lj.py `_fused_kernel` :86: the jaro
      greedy scan storing b's equality word for every a-position, a bit
      transpose of those words, and the Myers scan reading the transposed
      words: raw (lev, m, t), t on byte rank slots, no len-1/len-1 patch;
      int8 tiles, L <= 31.

K16-K18 share the probe's Myers step: pv all ones, mv 0, the score starting
at la and moved by the bit `max(la - 1, 0) % 32` of Ph and Mh at every
step j < lb (of the L steps). That is the edit distance wherever both
lengths are >= 1; rows with an empty side give what the probe gives.

The JAX helpers the probes import: `levenshtein_pallas_scan._WORD` is
`WORD` below, `_ALL_ONES` `MASK`, `_SUB` (the TPU's sublane fold of a
block) has no counterpart; `jaro_pallas_scan._satmask` is `_satmask` below
(`lanes.cuh:low_bits` in the kernel) and `_pack_params(4)` the byte slots
of `_byte_slots` (`kSlotShift` in the kernel). The TPU tools' `block_rows`
sweeps (8192 and 32768 in ab_myers_pallas.py, 8192 in the others) are grid
blocks with no counterpart on the card: the kernels give a row a thread,
128 threads a block.

The wrappers launch their kernel on CUDA tensors (a build or launch failure
raises) and run the plain version on CPU tensors. Tiles follow
`ops/_build.py:check_tiles`. Launch counts: "myers_eq_scan" (and
"myers_eq_scan.unroll"), "myers_ineq", "myers_swar", "fused_lev_jaro".
"""
from __future__ import annotations

from typing import Tuple

import torch

from strsim_tpu_torch.ops import _build
from strsim_tpu_torch.probes.jaro import _to_int32
from strsim_tpu_torch.utils.encode import PAD_A

WORD = 32  # one equality word a row: the probes' W = 1
MASK = 0xFFFFFFFF
FUSED_MAX_WIDTH = 31  # K19: one flag word, as the TPU probe
_DTYPES = (torch.int8, torch.int32)

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _myers_scan(eq_at, len_a, len_b, steps: int) -> torch.Tensor:
    """The probe's Myers recurrence at one word (ab_myers_pallas.py
    `_init_state`, `_myers_step`) over int64 words masked to 32 bits:
    `eq_at(j)` gives step j's [B] word; every step j < steps runs, its
    update kept where j < lb."""
    la, lb = len_a.long(), len_b.long()
    hbit = torch.clamp(la - 1, min=0) % WORD
    pv = torch.full_like(la, MASK)
    mv = torch.zeros_like(la)
    score = la.clone()
    for j in range(steps):
        eq = eq_at(j)
        active = j < lb
        xh = (((eq & pv) + pv) & MASK ^ pv) | eq
        xv = eq | mv
        ph = (mv | ~(xh | pv)) & MASK
        mh = pv & xh
        ph_s = ((ph << 1) | 1) & MASK
        mh_s = (mh << 1) & MASK
        score = score + torch.where(active, ((ph >> hbit) & 1) - ((mh >> hbit) & 1), 0)
        pv = torch.where(active, (mh_s | ~(xv | ph_s)) & MASK, pv)
        mv = torch.where(active, ph_s & xv, mv)
    return score.to(torch.int32)


def _check_lengths(n: int, device, len_a, len_b) -> None:
    for name, t in (("len_a", len_a), ("len_b", len_b)):
        if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 [{n}], got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, the words on {device}")


# --- K16: equality words built outside the kernel ----------------------------

def pattern_eq_words(a, b) -> torch.Tensor:
    """[L, B] int32: word j of row r has bit i = (a_i == b_j), a padded
    with PAD_A to 32 chars (tools/ab_myers_pallas.py:184-195), the bits
    kept exact through int64. a, b: [B, L] tiles, L <= 32."""
    n, width = a.shape
    if width > WORD:
        raise ValueError(f"tile width {width} outside 1..{WORD}")
    acc = torch.zeros((n, width), dtype=torch.int64, device=a.device)
    for i in range(WORD):
        a_i = a[:, i:i + 1] if i < width else torch.full_like(a[:, :1], PAD_A)
        acc |= (a_i == b).long() << i
    return _to_int32(acc).t().contiguous()


def myers_eq_scan(eq, len_a, len_b, unroll: bool = False) -> torch.Tensor:
    """K16: [B] int32 distances from [L, B] int32 equality words
    (`pattern_eq_words`), L <= 32, contiguous, on the lengths' device."""
    if eq.dim() != 2 or eq.dtype != torch.int32 or not eq.is_contiguous():
        raise ValueError(f"eq must be contiguous int32 [L, B], got {eq.dtype} {tuple(eq.shape)}")
    width, n = eq.shape
    if not 1 <= width <= WORD:
        raise ValueError(f"word count {width} outside 1..{WORD}")
    _check_lengths(n, eq.device, len_a, len_b)
    if eq.device.type == "cpu":
        return myers_eq_scan_plain(eq, len_a, len_b, unroll)
    if eq.device.type != "cuda":
        raise ValueError(f"unsupported device {eq.device}")
    out = torch.empty(n, dtype=torch.int32, device=eq.device)
    if n:
        counts = ("myers_eq_scan",) + (("myers_eq_scan.unroll",) if unroll else ())
        _build.call("probe_myers", "strsim_probe_myers_eq_scan", counts, eq.device,
                    eq.data_ptr(), len_a.data_ptr(), len_b.data_ptr(), out.data_ptr(), n, width,
                    int(unroll))
    return out


def myers_eq_scan_plain(eq, len_a, len_b, unroll: bool = False) -> torch.Tensor:
    """The probe's scan over the given words; both loop forms give this."""
    words = eq.long() & MASK
    return _myers_scan(lambda j: words[j], len_a, len_b, eq.shape[0])


def myers_eq_arm(a, b, len_a, len_b, unroll: bool = False) -> torch.Tensor:
    """K16's arm of the A/B: `pattern_eq_words` in torch, then the kernel,
    as the TPU tool's "scan" and "unroll" variants (:184-205)."""
    return myers_eq_scan(pattern_eq_words(a, b), len_a, len_b, unroll)


# --- K17: equality words by 32 compares in the kernel ---------------------------

def myers_ineq(a, b, len_a, len_b) -> torch.Tensor:
    """K17: [B] int32 distances; a, b: [B, L] int8/int32 tiles, L <= 32."""
    if not _build.check_tiles(a, b, len_a, len_b, WORD, _DTYPES):
        return myers_ineq_plain(a, b, len_a, len_b)
    out = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    _build.launch("probe_myers", "strsim_probe_myers_ineq", ("myers_ineq",),
                  a, b, len_a, len_b, (out,), a.element_size())
    return out


def myers_ineq_plain(a, b, len_a, len_b) -> torch.Tensor:
    """Each step's word from the 32 compares of `pattern_eq_words`."""
    eq = pattern_eq_words(a, b)
    return myers_eq_scan_plain(eq, len_a, len_b)


# --- K18: equality words four chars a compare -----------------------------------

_REPL, _L7F, _H8, _GATHER = 0x01010101, 0x7F7F7F7F, 0x80808080, 0x00204081


def _check_int8(name, a, b) -> None:
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"{name} takes int8 tiles only (a byte a char), got {a.dtype} and {b.dtype}")


def myers_swar(a, b, len_a, len_b) -> torch.Tensor:
    """K18: [B] int32 distances; a, b: [B, L] int8 tiles, L <= 32. int32
    tiles raise TypeError: their chars do not fit a byte."""
    _check_int8("myers_swar", a, b)
    if not _build.check_tiles(a, b, len_a, len_b, WORD, (torch.int8,)):
        return myers_swar_plain(a, b, len_a, len_b)
    out = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    _build.launch("probe_myers", "strsim_probe_myers_swar", ("myers_swar",),
                  a, b, len_a, len_b, (out,))
    return out


def swar_eq_words(a, b) -> torch.Tensor:
    """[L, B] int64 words of tools/ab_myers_swar.py's build (:79-93): a's
    bytes four to a word (fill bytes 0xFF past L), each compared with b_j's
    byte repeated four times by the exact zero-byte test of their xor, the
    four high bits gathered into nibble k of the word; bits i <
    4 ceil(L / 4)."""
    n, width = a.shape
    ap = []
    for k in range(-(-width // 4)):
        word = torch.zeros(n, dtype=torch.int64, device=a.device)
        for byte in range(4):
            i = 4 * k + byte
            v = a[:, i].long() & 0xFF if i < width else torch.full_like(word, 0xFF)
            word |= v << (8 * byte)
        ap.append(word)
    out = torch.zeros((width, n), dtype=torch.int64, device=a.device)
    for j in range(width):
        bb = (b[:, j].long() & 0xFF) * _REPL
        for k, word in enumerate(ap):
            x = word ^ bb
            t = ~(((x & _L7F) + _L7F) | x) & _H8
            out[j] |= (((t * _GATHER) & MASK) >> 28) << (4 * k)
    return out


def myers_swar_plain(a, b, len_a, len_b) -> torch.Tensor:
    """The probe's scan over `swar_eq_words`; int8 tiles only."""
    _check_int8("myers_swar", a, b)
    words = swar_eq_words(a, b)
    return _myers_scan(lambda j: words[j], len_a, len_b, a.shape[1])


# --- K19: jaro's equality words, transposed, feed Myers --------------------------

def fused_lev_jaro(a, b, len_a, len_b) -> Triple:
    """K19: raw ([B] lev, [B] m, [B] t) int32, no len-1/len-1 patch; a, b:
    [B, L] int8 tiles, L <= 31. int32 tiles raise TypeError."""
    _check_int8("fused_lev_jaro", a, b)
    if not _build.check_tiles(a, b, len_a, len_b, FUSED_MAX_WIDTH, (torch.int8,)):
        return fused_lev_jaro_plain(a, b, len_a, len_b)
    lev, m, t = (torch.empty(a.shape[0], dtype=torch.int32, device=a.device) for _ in range(3))
    _build.launch("probe_fused_lj", "strsim_probe_fused_lev_jaro", ("fused_lev_jaro",),
                  a, b, len_a, len_b, (lev, m, t))
    return lev, m, t


def _satmask(k: torch.Tensor) -> torch.Tensor:
    """The k lowest bits, saturating at k <= 0 and k >= 32."""
    base = (1 << torch.clamp(k, 0, WORD - 1)) - 1
    return torch.where(k >= WORD, MASK, torch.where(k <= 0, 0, base))


def _byte_slots(slots, rank, v, words: int) -> torch.Tensor:
    """Rank `rank`'s char v (sign-extended, as the probe's i32 lanes hold
    it) ORed into byte rank % 4 of word rank // 4 (`_pack_params(4)`)."""
    val = (v << ((rank & 3) << 3)) & MASK
    hit = torch.arange(words, device=v.device)[None, :] == (rank >> 2)[:, None]
    return slots | torch.where(hit, val[:, None], 0)


def fused_lev_jaro_plain(a, b, len_a, len_b) -> Triple:
    """The probe's steps on any device: the greedy scan over b's equality
    words with jaro's bound max(la, lb) // 2 - 1, each side's matched chars
    in rank order a byte a rank, t the unequal bytes of the two, and the
    Myers scan over the transposed words (bit i of word j = (a_i == b_j),
    i < L). int8 tiles, L <= 31."""
    _check_int8("fused_lev_jaro", a, b)
    n, width = a.shape
    if width > FUSED_MAX_WIDTH:
        raise ValueError(f"tile width {width} outside 1..{FUSED_MAX_WIDTH}")
    la, lb = len_a.long(), len_b.long()
    ai, bi = a.long(), b.long()
    pos = torch.arange(width, device=a.device)
    words = -(-width // 4)
    bound = torch.maximum(la, lb) // 2 - 1
    flag = torch.zeros_like(la)
    m = torch.zeros_like(la)
    seq_a = torch.zeros((n, words), dtype=torch.int64, device=a.device)
    for i in range(width):
        active = (i < la) & (i < lb + bound)
        win = _satmask(torch.minimum(i + bound, lb - 1) + 1) & ~_satmask(i - bound) & MASK
        eqw = ((bi == ai[:, i:i + 1]).long() << pos).sum(1)
        cand = torch.where(active, eqw & ~flag & win, 0)
        flag |= cand & -cand
        found = cand != 0
        seq_a = _byte_slots(seq_a, m, torch.where(found, ai[:, i], 0), words)
        m += found.long()
    seq_b = torch.zeros_like(seq_a)
    rank = torch.zeros_like(la)
    for j in range(width):
        fbit = ((flag >> j) & 1) != 0
        seq_b = _byte_slots(seq_b, rank, torch.where(fbit, bi[:, j], 0), words)
        rank += fbit.long()
    x = seq_a ^ seq_b
    t = sum((((x >> (8 * s)) & 0xFF) != 0).sum(1) for s in range(4))
    lev = _myers_scan(lambda j: ((ai == bi[:, j:j + 1]).long() << pos).sum(1), len_a, len_b, width)
    return lev, m.to(torch.int32), t.to(torch.int32)
